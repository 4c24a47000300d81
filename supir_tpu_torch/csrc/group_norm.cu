// K2: GroupNorm(32) with an optional fused SiLU for Hopper (sm_90a), one
// thread-block cluster per (batch, group) slab.
//
// Replaces supir_tpu/ops/groupnorm.py:_gn_silu_kernel (:40, pallas_call
// :118): over NCHW-contiguous x (bf16, fp16 or fp32), the fp32 sum and sum
// of squares of each (b, g) slab of cg * H * W elements, var = max(E[x^2] -
// mean^2, 0), rstd = 1 / sqrt(var + eps), the per-channel affine, SiLU when
// asked, and the result written once in x's dtype.
//
// What bounds it: bytes. A few flops per element against one read and one
// write of x puts it far below the H100's ridge point.
//
// Design: the slab's statistics are a reduction over the whole slab, and
// the normalisation needs them before it can write anything. The TPU kernel
// walked the slab twice over a sequential grid (stats, then normalise);
// the first design, a Triton pair, did the same in two launches and read x
// twice. Here one launch does both: a cluster of R CTAs owns one slab, cut
// into R contiguous parts (ops/groupnorm.py:gn_plan chooses R and the
// part). Each CTA sums its part in fp32 in a fixed order with 16-byte
// loads and publishes (sum, sumsq); after cluster.sync every CTA reads the
// R partials over distributed shared memory in rank order, so every CTA
// computes the same mean and rstd and two runs give the same bits, with no
// atomics and no scratch. Then it reads its part again and normalises it.
// That second pass walks the part backwards, so that it starts on the bytes
// the first pass read last: its first block is still in registers (a part
// of one block, 16 KB, is read once) and the next ones are the likeliest to
// be in L2. Where GroupNorm runs, x has just been written by the op before
// it and sits in the H100's 50 MB L2 as far as it fits; there, holding
// each part in shared memory between the two passes (one device-memory
// read, bulk copies on mbarriers) measured slower than this second read
// (PERF.md §6), so the kernel has no such mode.
// The ragged head and tail of a part (a slab whose byte offset or length is
// not a multiple of 16) go through plain loads and stores. A CTA signals the
// cluster barrier once it has read its peers' partials and waits on it
// before exit, so no CTA leaves while a peer may still read its shared
// memory. A cluster of more than 8 CTAs is launched with the non-portable
// cluster size allowed; the entry point checks with the occupancy API that
// the cluster can be placed and returns an error if not.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_launch.cuh"

namespace cg = cooperative_groups;

namespace {

// The layout constants below are mirrored by ops/groupnorm.py (GN_*).
constexpr int GN_THREADS = 256;
constexpr int GN_WARPS = GN_THREADS / 32;
constexpr int GN_UNROLL = 4;       // 16-byte loads in flight per thread
constexpr int GN_MIN_CTAS = 4;     // CTAs an SM holds by registers (launch bounds: at most 64 a thread)

// planted faults, for the smoke run's controls only
enum GnFault { GN_FAULT_NONE = 0, GN_FAULT_DROP_RANK = 1, GN_FAULT_OWN_SLICE = 2, GN_FAULT_AFFINE_SHIFT = 3,
               GN_FAULT_NEIGHBOUR_GROUP = 4 };

struct GnArgs {
  const void* x;
  void* y;
  const void* w;
  const void* b;
  int slab;     // elements per (b, g) slab
  int part;     // elements per rank; rank r owns [r * part, min((r + 1) * part, slab))
  int hw;       // elements per channel
  unsigned hw_mul;  // e / hw as __umulhi(e, hw_mul) >> hw_shift (0: hw is 1), exact for every int e >= 0
  int hw_shift;
  int cpg;      // channels per group
  int groups;
  int nslabs;   // B * groups
  float eps;
  int silu;
  int wcode;    // the affine's dtypes: 0 fp32, 1 bf16, 2 fp16
  int bcode;
  int fault;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }
template <>
__device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

__device__ __forceinline__ float param(const void* p, int code, int i) {
  if (code == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (code == 2) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float finish(float v, int silu) { return silu ? __fdividef(v, 1.0f + __expf(-v)) : v; }

template <typename T>
__device__ __forceinline__ void accumulate(const uint4& u, float& s, float& ss) {
  const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int k = 0; k < 16 / (int)sizeof(T); ++k) {
    const float v = to_f(t[k]);
    s += v;
    ss = fmaf(v, v, ss);
  }
}

// the channel (within the group) of slab element e, e / hw by the plan's
// round-up multiplier (ops/groupnorm.py:fast_div)
__device__ __forceinline__ int channel_of(int e, const GnArgs& a) {
  return a.hw_mul ? static_cast<int>(__umulhi(static_cast<unsigned>(e), a.hw_mul) >> a.hw_shift) : e;
}

// the 16 bytes of output for the vector whose first element is e (within
// the slab); sc/sh hold the group's per-channel scale (w * rstd) and shift
template <typename T>
__device__ __forceinline__ uint4 normalise(const uint4& u, int e, const GnArgs& a, float mean, const float* sc,
                                           const float* sh) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const T* t = reinterpret_cast<const T*>(&u);
  uint4 out;
  T* o = reinterpret_cast<T*>(&out);
  const int c = channel_of(e, a);
  if (e + VEC <= (c + 1) * a.hw) {  // the whole vector in one channel
    const float scale = sc[c], shift = sh[c];
#pragma unroll
    for (int k = 0; k < VEC; ++k) o[k] = from_f<T>(finish((to_f(t[k]) - mean) * scale + shift, a.silu));
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int ck = channel_of(e + k, a);
      o[k] = from_f<T>(finish((to_f(t[k]) - mean) * sc[ck] + sh[ck], a.silu));
    }
  }
  return out;
}

template <typename T>
__global__ void __launch_bounds__(GN_THREADS, GN_MIN_CTAS) gn_kernel(const GnArgs a) {
  constexpr int VEC = 16 / (int)sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nranks = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int s = blockIdx.y;
  const int g = s % a.groups;
  const int e0 = min(rank * a.part, a.slab);
  const int e1 = min(e0 + a.part, a.slab);
  const int n = e1 - e0;
  const T* xs = static_cast<const T*>(a.x) + static_cast<long long>(s) * a.slab;
  T* ys = static_cast<T*>(a.y) + static_cast<long long>(s) * a.slab;
  // x and y share their offset mod 16 (the wrapper sees to it), so one
  // split serves both: `head` elements up to the first 16-byte boundary,
  // nvec aligned vectors, then the tail
  const int head = min(n, static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(xs + e0) & 15)) & 15) / sizeof(T)));
  const int nvec = (n - head) / VEC;
  const int tail0 = head + nvec * VEC;
  const int ntail = n - tail0;

  // shared memory: [red: sum, sumsq][warp partials][mean, rstd][scale[cg], shift[cg]]
  float* red = reinterpret_cast<float*>(smem);
  float* warp_part = red + 4;
  float* stats = warp_part + 2 * GN_WARPS;
  float* sc = stats + 4;
  float* sh = sc + a.cpg;
  const uint4* body_g = reinterpret_cast<const uint4*>(xs + e0 + head);

  // pass 1: this CTA's (sum, sumsq), each thread over a fixed set of
  // elements in a fixed order, then a fixed tree; the last block of loads
  // stays in registers for pass 2, which starts with it
  float sum = 0.f, sumsq = 0.f;
  if (tid < head) {
    const float v = to_f(xs[e0 + tid]);
    sum += v;
    sumsq = fmaf(v, v, sumsq);
  }
  const int step = GN_THREADS * GN_UNROLL;
  const int blocks = (nvec + step - 1) / step;
  uint4 buf[GN_UNROLL];
  for (int base = 0; base < nvec; base += step) {
#pragma unroll
    for (int u = 0; u < GN_UNROLL; ++u) {
      const int v = base + u * GN_THREADS + tid;
      if (v < nvec) buf[u] = body_g[v];
    }
#pragma unroll
    for (int u = 0; u < GN_UNROLL; ++u)
      if (base + u * GN_THREADS + tid < nvec) accumulate<T>(buf[u], sum, sumsq);
  }
  if (tid < ntail) {
    const float v = to_f(xs[e0 + tail0 + tid]);
    sum += v;
    sumsq = fmaf(v, v, sumsq);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    sumsq += __shfl_xor_sync(0xffffffffu, sumsq, off);
  }
  if ((tid & 31) == 0) {
    warp_part[2 * (tid >> 5)] = sum;
    warp_part[2 * (tid >> 5) + 1] = sumsq;
  }
  __syncthreads();
  if (tid == 0) {
    float s1 = 0.f, s2 = 0.f;
    for (int w = 0; w < GN_WARPS; ++w) {
      s1 += warp_part[2 * w];
      s2 += warp_part[2 * w + 1];
    }
    red[0] = s1;
    red[1] = s2;
  }

  // the cluster's statistics: every CTA sums the R partials in rank order
  cluster.sync();
  if (tid < 32) {
    // lane r reads rank r's partials (all loads in flight at once), then
    // lane 0 adds them in rank order
    float p1 = 0.f, p2 = 0.f;
    if (tid < nranks && !(a.fault == GN_FAULT_DROP_RANK && tid == nranks - 1)) {
      const float* peer = cluster.map_shared_rank(red, tid);
      p1 = peer[0];
      p2 = peer[1];
    }
    float s1 = 0.f, s2 = 0.f;
    for (int r = 0; r < nranks; ++r) {
      s1 += __shfl_sync(0xffffffffu, p1, r);
      s2 += __shfl_sync(0xffffffffu, p2, r);
    }
    float count = static_cast<float>(a.slab);
    if (a.fault == GN_FAULT_OWN_SLICE) {
      s1 = red[0];
      s2 = red[1];
      count = static_cast<float>(max(n, 1));
    }
    const float mean = s1 / count;
    const float var = fmaxf(s2 / count - mean * mean, 0.f);
    if (tid == 0) {
      stats[0] = mean;
      stats[1] = 1.0f / sqrtf(var + a.eps);
    }
  }
  __syncthreads();
  const float mean = stats[0];
  const float rstd = stats[1];
  // the affine of the channels this part touches
  if (n > 0) {
    const int c_lo = e0 / a.hw, c_hi = (e1 - 1) / a.hw;
    const int channels = a.cpg * a.groups;
    for (int c = c_lo + tid; c <= c_hi; c += GN_THREADS) {
      int ch = g * a.cpg + c;
      if (a.fault == GN_FAULT_AFFINE_SHIFT) ch = (ch + 1) % channels;
      sc[c] = param(a.w, a.wcode, ch) * rstd;
      sh[c] = param(a.b, a.bcode, ch);
    }
  }
  __syncthreads();
  // done with the peers' shared memory; the matching wait is at the end
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");

  // pass 2: normalise, affine, SiLU, one write
  if (tid < head) {
    const int e = e0 + tid;
    const int c = e / a.hw;
    ys[e] = from_f<T>(finish((to_f(xs[e]) - mean) * sc[c] + sh[c], a.silu));
  }
  if (tid < ntail) {
    const int e = e0 + tail0 + tid;
    const int c = e / a.hw;
    ys[e] = from_f<T>(finish((to_f(xs[e]) - mean) * sc[c] + sh[c], a.silu));
  }
  uint4* out = reinterpret_cast<uint4*>(ys + e0 + head);
  const int first = e0 + head;
  const bool neighbour = a.fault == GN_FAULT_NEIGHBOUR_GROUP;
  const uint4* src = body_g;
  if (neighbour)
    src = reinterpret_cast<const uint4*>(static_cast<const T*>(a.x) +
                                         static_cast<long long>((s + 1) % a.nslabs) * a.slab + e0 + head);
  for (int i = 0; i < blocks; ++i) {
    const int base = (blocks - 1 - i) * step;  // backwards: the last block first
    if (i != 0 || neighbour) {  // else buf still holds this block
#pragma unroll
      for (int u = 0; u < GN_UNROLL; ++u) {
        const int v = base + u * GN_THREADS + tid;
        if (v < nvec) buf[u] = src[v];
      }
    }
#pragma unroll
    for (int u = 0; u < GN_UNROLL; ++u) {
      const int v = base + u * GN_THREADS + tid;
      if (v < nvec) out[v] = normalise<T>(buf[u], first + v * VEC, a, mean, sc, sh);
    }
  }
  __syncwarp();
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

int run(const GnArgs& a, int dtype, int ranks, int smem, cudaStream_t stream, int* clusters_out) {
  if (ranks < 1 || ranks > 16 || a.slab <= 0 || a.part <= 0 || a.hw <= 0 || a.cpg <= 0 || a.groups <= 0 ||
      a.nslabs <= 0 || a.nslabs > 65535 || static_cast<long long>(ranks) * a.part < a.slab || a.hw_shift < 0 ||
      a.hw_shift > 31 || (a.hw_mul == 0) != (a.hw == 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return cluster_launch(gn_kernel<float>, ranks, a.nslabs, 0, GN_THREADS, smem, stream, clusters_out, a);
  if (dtype == 1)
    return cluster_launch(gn_kernel<__nv_bfloat16>, ranks, a.nslabs, 0, GN_THREADS, smem, stream, clusters_out, a);
  if (dtype == 2)
    return cluster_launch(gn_kernel<__half>, ranks, a.nslabs, 0, GN_THREADS, smem, stream, clusters_out, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry points for ctypes. x, y [B, C, *] contiguous, x's dtype
// (0 fp32, 1 bf16, 2 fp16), x and y at the same offset mod 16; w, b [C]
// (their dtype codes wcode, bcode). The geometry (ranks, part, smem) and
// the division by hw (hw_mul, hw_shift) come from ops/groupnorm.py:gn_plan.
// Returns 0, a cudaError_t, or -1 when the cluster cannot be placed
// (cudaOccupancyMaxActiveClusters 0).
extern "C" int supir_group_norm(const void* x, void* y, const void* w, const void* b, int dtype, int wcode,
                                int bcode, int slab, int hw, unsigned hw_mul, int hw_shift, int cpg, int groups,
                                int nslabs, float eps, int silu, int ranks, int part, int smem, int fault,
                                void* stream) {
  const GnArgs a{x, y, w, b, slab, part, hw, hw_mul, hw_shift, cpg, groups, nslabs, eps, silu, wcode, bcode, fault};
  return run(a, dtype, ranks, smem, static_cast<cudaStream_t>(stream), nullptr);
}

// How many clusters of this geometry the device holds at once
// (cudaOccupancyMaxActiveClusters), into *clusters; returns 0 or a
// cudaError_t.
extern "C" int supir_group_norm_clusters(int dtype, int ranks, int part, int smem, int* clusters) {
  const GnArgs a{nullptr, nullptr, nullptr, nullptr, part, part, 1, 0u, 0, 1, 1, 1, 0.f, 0, 0, 0, 0};
  return run(a, dtype, ranks, smem, nullptr, clusters);
}
