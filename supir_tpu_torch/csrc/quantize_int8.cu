// K8: per-output-channel absmax int8 quantization for Hopper (sm_90a), one
// thread-block cluster per tile of columns.
//
// Replaces supir_tpu/ops/quantize.py:_quant_kernel (:21, pallas_call :49,
// quantize_int8 :39): for w [cin, cout] fp32,
//   scale[c] = max_k |w[k, c]| * float(1 / 127)   (as XLA computes the JAX
//              function's absmax / 127 off the TPU)
//   q[k, c]  = clip(floor(w[k, c] / max(scale[c], 1e-12) + u), -127, 127)
// with u ~ U[0, 1) (stochastic rounding, as the TPU kernel draws it from its
// PRNG), or q = clip(round_half_even(w / scale)) when `stochastic` is 0, as
// the JAX function does off the TPU (:43-48). u is (r >> 8) * 2^-24 for a
// 32-bit Philox4x32-10 output r (curand) keyed by the seed, with element e
// taking word e % 4 of counter e / 4: nothing random is read from memory,
// and the same seed gives the same bytes. The division is a true IEEE
// division (no fast-math flag, no reciprocal), so nearest mode is bit for
// bit the plain version's and JAX's.
//
// What bounds it: bytes. It reads 4 bytes and writes 1 per weight, against
// a division and a quarter of a Philox draw per element.
//
// Design: the scale of a column is a reduction over all cin rows, and the
// quantization needs it before it can write anything. The TPU kernel held
// the whole matrix in VMEM. The first design (`supir_quantize_int8_first`
// below, kept as the comparator) zeroed an amax scratch, merged 64-row slabs
// with atomicMax, then read w a second time to quantize, storing one byte
// at a time. Here a cluster of R CTAs owns a tile of COLS columns x all cin
// rows (ops/quantize.py:int8_plan), each CTA a slice of the rows: it loads
// its slice once into shared memory with 2-D TMA boxes over the fp32 [cin,
// cout] matrix (each box on its own mbarrier, all issued at once), takes its
// column maxima, and after cluster.sync reads the R CTAs' maxima over
// distributed shared memory, one (rank, column) a thread (the maximum of
// non-negative floats does not depend on the order). Then it quantizes from
// shared memory: a thread takes 4 consecutive columns of a row, which share
// one Philox counter when cout % 4 == 0, from one curand4 draw, and four
// neighbouring lanes join their bytes into one 16-byte store when cout % 16
// == 0. Rank 0 writes the tile's scales. The grid holds as many clusters as
// the card places at once, and each walks every gridDim-th tile, issuing
// the next tile's boxes once it has quantized this one (a second buffer,
// to load under the quantization, would halve the CTAs an SM holds). w is
// read once, with no scratch and no atomics. The slices are small enough
// that several CTAs share an SM (40 KB and 4 CTAs of 256 threads at cin
// 5120), so one CTA's loads and cluster exchange run under another's
// quantization, which is what paces the kernel: with the quantization
// taken out the loads, maxima and exchange alone ran near the bytes bound
// on the H100 (PERF.md §6). Where cout % 4 != 0 (no tensor map: a row's
// stride is not a multiple of 16 bytes) the slice is loaded with plain
// loads and every element takes its own counter and word, so the bytes
// stay the first design's.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <curand_kernel.h>
#include <stdint.h>
#include <string.h>

#include "cluster_launch.cuh"
#include "flash_attn_tma.cuh"  // mbarriers, encode_tiled

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------- the cluster kernel

// The layout constants below are mirrored by ops/quantize.py (Q8_*).
constexpr int Q8_MAX_BOXES = 8;

// planted faults, for the smoke run's controls only
enum Q8Fault { Q8_FAULT_NONE = 0, Q8_FAULT_DROP_RANK = 1, Q8_FAULT_ROTATE_WORDS = 2, Q8_FAULT_SHIFT_TILE = 3 };

struct Q8Args {
  const float* w;
  int8_t* q;
  float* scale;
  int cin, cout;
  int cols;      // tile width: 32 columns, or 16, 8, 4 for very tall matrices
  int rows;      // rows per rank
  int box_rows;  // rows per TMA box
  int nboxes;
  int tma;       // 1: the slice arrives by TMA boxes, 0: by plain loads
  int vec16;     // cout % 16 == 0 and q 16-byte aligned: 16-byte stores
  unsigned long long seed;
  int stochastic;
  int fault;
};

__device__ __forceinline__ float quant_one(float w, float s, unsigned int word, int stochastic) {
  const float scaled = w / fmaxf(s, 1e-12f);
  float v;
  if (stochastic) {
    const float u = static_cast<float>(word >> 8) * (1.0f / 16777216.0f);
    v = floorf(scaled + u);
  } else {
    v = rintf(scaled);
  }
  return fminf(fmaxf(v, -127.f), 127.f);
}

__device__ __forceinline__ uint32_t pack4(float a, float b, float c, float d) {
  return (static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(static_cast<int>(a))))) |
         (static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(static_cast<int>(b)))) << 8) |
         (static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(static_cast<int>(c)))) << 16) |
         (static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(static_cast<int>(d)))) << 24);
}

// issue the TMA boxes of tile `tile`'s slice (thread 0)
__device__ __forceinline__ void load_slice(const CUtensorMap* map, const Q8Args& a, float* slice, uint64_t* bars,
                                           int tile, int r0) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  for (int k = 0; k < a.nboxes; ++k) {
    const uint32_t bar = smem_u32(bars + k);
    mbar_expect_tx(bar, static_cast<uint32_t>(a.box_rows * a.cols * 4));
    const uint32_t dst = smem_u32(slice + k * a.box_rows * a.cols);
    // rows and columns past the matrix arrive as zeros
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
        ::"r"(dst), "l"(m), "r"(bar), "r"(tile * a.cols), "r"(r0 + k * a.box_rows) : "memory");
  }
}

// A cluster walks the tiles blockIdx.y, + gridDim.y, ... (the grid holds
// as many clusters as the card places at once); a CTA issues the next
// tile's boxes once it has quantized this one, and other CTAs on its SM
// work meanwhile.
template <int THREADS>
__global__ void __launch_bounds__(THREADS) q8_kernel(const __grid_constant__ CUtensorMap map, const Q8Args a) {
  constexpr int WARPS = THREADS / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nranks = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int tiles = (a.cout + a.cols - 1) / a.cols;
  const int r0 = rank * a.rows;
  const int nrows = max(0, min(a.rows, a.cin - r0));
  // shared memory: [the slice: nboxes * box_rows rows x cols fp32][Q8_MAX_BOXES mbarriers]
  //                [maxima per warp][2 x this CTA's column maxima][the tile's scales][the ranks' maxima]
  float* slice = reinterpret_cast<float*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(slice + a.nboxes * a.box_rows * a.cols);
  float* warp_max = reinterpret_cast<float*>(bars + Q8_MAX_BOXES);  // [warps][cols]
  float* cmax = warp_max + WARPS * a.cols;                           // [2][cols]
  float* scl = cmax + 2 * a.cols;
  float* peer_max = scl + a.cols;                                      // [ranks][cols]
  const int tpr = a.cols / 4;        // threads per row, 4 columns each
  const int rps = THREADS / tpr;  // rows per step
  const int jc = 4 * (tid % tpr);

  if (a.tma) {
    if (tid == 0) {
      for (int k = 0; k < Q8_MAX_BOXES; ++k) mbar_init(smem_u32(bars + k), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0 && blockIdx.y < tiles) load_slice(&map, a, slice, bars, blockIdx.y, r0);
  }

  int it = 0;
  for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y, ++it) {
    float* cm = cmax + (it & 1) * a.cols;
    const int col0 = tile * a.cols;
    if (!a.tma) {
      const int src_col0 = col0 + (a.fault == Q8_FAULT_SHIFT_TILE ? 1 : 0);
      for (int i = tid; i < nrows * a.cols; i += THREADS) {
        const int r = i / a.cols, c = i - r * a.cols;
        const int col = src_col0 + c;
        slice[i] = col < a.cout ? a.w[static_cast<long long>(r0 + r) * a.cout + col] : 0.f;
      }
      __syncthreads();
    }

    // this CTA's column maxima: thread t takes 4 columns (t % tpr) of rows
    // t / tpr, + rps, ...; the lanes sharing columns merge by shuffles,
    // then the warps through shared memory
    float m0 = 0.f, m1 = 0.f, m2 = 0.f, m3 = 0.f;
    for (int k = 0; k < a.nboxes; ++k) {
      if (a.tma) mbar_wait(smem_u32(bars + k), it & 1);
      const int end = min(nrows, (k + 1) * a.box_rows);
      for (int r = k * a.box_rows + tid / tpr; r < end; r += rps) {
        const float4 v = *reinterpret_cast<const float4*>(slice + r * a.cols + jc);
        m0 = fmaxf(m0, fabsf(v.x));
        m1 = fmaxf(m1, fabsf(v.y));
        m2 = fmaxf(m2, fabsf(v.z));
        m3 = fmaxf(m3, fabsf(v.w));
      }
    }
    for (int off = tpr; off < 32; off <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
      m2 = fmaxf(m2, __shfl_xor_sync(0xffffffffu, m2, off));
      m3 = fmaxf(m3, __shfl_xor_sync(0xffffffffu, m3, off));
    }
    if ((tid & 31) < tpr) {
      float* wm = warp_max + (tid >> 5) * a.cols + jc;
      wm[0] = m0;
      wm[1] = m1;
      wm[2] = m2;
      wm[3] = m3;
    }
    __syncthreads();
    if (tid < a.cols) {
      float m = 0.f;
      for (int w = 0; w < WARPS; ++w) m = fmaxf(m, warp_max[w * a.cols + tid]);
      cm[tid] = m;
    }

    // the tile's maxima over the cluster; a CTA writes this buffer of
    // maxima again two tiles on, after the next cluster.sync, which every
    // peer reaches only once it has read this one
    cluster.sync();
    // every (rank, column) read by its own thread, all in flight at once
    for (int i = tid; i < nranks * a.cols; i += THREADS) {
      const int r = i / a.cols;
      peer_max[i] = a.fault == Q8_FAULT_DROP_RANK && r == nranks - 1 ? 0.f
                                                                      : cluster.map_shared_rank(cm, r)[i - r * a.cols];
    }
    __syncthreads();
    if (tid < a.cols) {
      float m = 0.f;
      for (int r = 0; r < nranks; ++r) m = fmaxf(m, peer_max[r * a.cols + tid]);
      const float s = m * (1.0f / 127.0f);
      scl[tid] = s;
      if (rank == 0 && col0 + tid < a.cout) a.scale[col0 + tid] = s;
    }
    __syncthreads();

    // quantize from shared memory
    if (a.cout % 4 == 0) {
      const float s0 = scl[jc], s1 = scl[jc + 1], s2 = scl[jc + 2], s3 = scl[jc + 3];
      const int col = col0 + jc;
      const int steps = (nrows + rps - 1) / rps;
      for (int i = 0; i < steps; ++i) {
        const int r = i * rps + tid / tpr;
        const bool live = r < nrows && col < a.cout;
        uint32_t packed = 0;
        const long long e = static_cast<long long>(r0 + r) * a.cout + col;
        if (live) {
          uint4 rnd = make_uint4(0u, 0u, 0u, 0u);
          if (a.stochastic) {
            curandStatePhilox4_32_10_t st;
            curand_init(a.seed, static_cast<unsigned long long>(e >> 2), 0ull, &st);
            rnd = curand4(&st);
            if (a.fault == Q8_FAULT_ROTATE_WORDS) rnd = make_uint4(rnd.y, rnd.z, rnd.w, rnd.x);
          }
          const float4 v = *reinterpret_cast<const float4*>(slice + r * a.cols + jc);
          packed = pack4(quant_one(v.x, s0, rnd.x, a.stochastic), quant_one(v.y, s1, rnd.y, a.stochastic),
                         quant_one(v.z, s2, rnd.z, a.stochastic), quant_one(v.w, s3, rnd.w, a.stochastic));
        }
        if (a.vec16) {
          // lanes 4j..4j+3 hold 16 consecutive columns of one row (tpr is
          // a multiple of 4 here): the first of them stores all 16 bytes
          const uint32_t b1 = __shfl_down_sync(0xffffffffu, packed, 1);
          const uint32_t b2 = __shfl_down_sync(0xffffffffu, packed, 2);
          const uint32_t b3 = __shfl_down_sync(0xffffffffu, packed, 3);
          if (live && (tid & 3) == 0) *reinterpret_cast<uint4*>(a.q + e) = make_uint4(packed, b1, b2, b3);
        } else if (live) {
          *reinterpret_cast<uint32_t*>(a.q + e) = packed;
        }
      }
    } else {
      // ragged: each element its own counter and word
      for (int i = tid; i < nrows * a.cols; i += THREADS) {
        const int r = i / a.cols, c = i - r * a.cols;
        const int col = col0 + c;
        if (col >= a.cout) continue;
        const long long e = static_cast<long long>(r0 + r) * a.cout + col;
        unsigned int word = 0;
        if (a.stochastic) {
          curandStatePhilox4_32_10_t st;
          curand_init(a.seed, static_cast<unsigned long long>(e >> 2), 0ull, &st);
          const uint4 rnd = curand4(&st);
          const int wi = (static_cast<int>(e & 3) + (a.fault == Q8_FAULT_ROTATE_WORDS ? 1 : 0)) & 3;
          word = wi == 0 ? rnd.x : wi == 1 ? rnd.y : wi == 2 ? rnd.z : rnd.w;
        }
        a.q[e] = static_cast<int8_t>(static_cast<int>(quant_one(slice[i], scl[c], word, a.stochastic)));
      }
    }
    __syncthreads();
    // the slice is free: the next tile's boxes
    if (a.tma && tid == 0 && tile + static_cast<int>(gridDim.y) < tiles)
      load_slice(&map, a, slice, bars, tile + gridDim.y, r0);
  }
  // no CTA leaves while a peer may still read its maxima
  cluster.sync();
}

template <int THREADS>
int launch(const Q8Args& a, int ranks, int smem, cudaStream_t stream, int* clusters_out) {
  alignas(64) CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (a.tma && !clusters_out) {
    EncodeTiled fn;
    const cudaError_t err = encode_tiled(&fn);
    if (err != cudaSuccess) return static_cast<int>(err);
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(a.cout), static_cast<cuuint64_t>(a.cin)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(a.cout) * 4};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(a.cols), static_cast<cuuint32_t>(a.box_rows)};
    const cuuint32_t unit[2] = {1, 1};
    const CUresult r = fn(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(a.w), dims, strides, box, unit,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  }
  // a persistent grid: as many clusters as the card places, at most one a tile
  return cluster_launch(q8_kernel<THREADS>, ranks, 0, (a.cout + a.cols - 1) / a.cols, THREADS, smem, stream,
                        clusters_out, map, a);
}

// ------------------------------------------------- the first design

constexpr int FIRST_THREADS = 256;
constexpr int ROWS_PER_SLAB = 64;

__global__ void __launch_bounds__(FIRST_THREADS)
colmax_kernel(const float* __restrict__ w, int cin, int cout, unsigned int* __restrict__ amax) {
  const int c = blockIdx.x * FIRST_THREADS + threadIdx.x;
  if (c >= cout) return;
  const int r0 = blockIdx.y * ROWS_PER_SLAB;
  const int r1 = min(cin, r0 + ROWS_PER_SLAB);
  float m = 0.f;
  for (int r = r0; r < r1; ++r) m = fmaxf(m, fabsf(w[(size_t)r * cout + c]));
  atomicMax(amax + c, __float_as_uint(m));
}

__global__ void __launch_bounds__(FIRST_THREADS)
quant_kernel(const float* __restrict__ w, long long n, int cout,
             const unsigned int* __restrict__ amax, unsigned long long seed, int stochastic,
             int8_t* __restrict__ q, float* __restrict__ scale_out) {
  const long long t = (long long)blockIdx.x * FIRST_THREADS + threadIdx.x;
  const long long e0 = 4 * t;
  if (e0 >= n) return;
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (stochastic) {
    curandStatePhilox4_32_10_t st;
    curand_init(seed, (unsigned long long)t, 0ull, &st);
    r = curand4(&st);
  }
  const unsigned int words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long e = e0 + i;
    if (e >= n) break;
    const int c = (int)(e % cout);
    const float s = __uint_as_float(amax[c]) * (1.0f / 127.0f);
    const float v = quant_one(w[e], s, words[i], stochastic);
    q[e] = (int8_t)(int)v;
    if (e < cout) scale_out[e] = s;
  }
}

}  // namespace

// Plain C entry points for ctypes. w fp32 [cin, cout] row-major, q int8
// [cin, cout], scale fp32 [cout]; the geometry (cols, ranks, rows, box_rows,
// nboxes, smem) from ops/quantize.py:int8_plan. Returns 0, a cudaError_t,
// minus the CUresult of a failed tensor-map encode, or -1 when the cluster
// cannot be placed (cudaOccupancyMaxActiveClusters 0; also the count, into
// *clusters_out, when that is not null, without launching).
extern "C" int supir_quantize_int8(const void* w, int cin, int cout, int cols, int ranks, int rows, int box_rows,
                                   int nboxes, int threads, unsigned long long seed, int stochastic, void* q,
                                   void* scale, int smem, int fault, void* stream, int* clusters_out) {
  if (cin <= 0 || cout <= 0 || ranks < 1 || ranks > 16 || static_cast<long long>(ranks) * rows < cin ||
      nboxes < 1 || nboxes > Q8_MAX_BOXES || static_cast<long long>(nboxes) * box_rows < rows || box_rows > 256 ||
      (cols != 4 && cols != 8 && cols != 16 && cols != 32) || (cout + cols - 1) / cols > 65535 ||
      (threads != 256 && threads != 512))
    return static_cast<int>(cudaErrorInvalidValue);
  Q8Args a{static_cast<const float*>(w), static_cast<int8_t*>(q), static_cast<float*>(scale), cin, cout, cols, rows,
           box_rows, nboxes, 0, 0, seed, stochastic, fault};
  // the shifted-tile fault loads through the plain path: a TMA box's
  // column coordinate stays a multiple of 16 bytes
  a.tma = cout % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 && fault != Q8_FAULT_SHIFT_TILE;
  a.vec16 = cout % 16 == 0 && cols % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return threads == 256 ? launch<256>(a, ranks, smem, s, clusters_out) : launch<512>(a, ranks, smem, s, clusters_out);
}

// The first design, for comparisons on the card only: amax is a zeroed
// uint32 [cout] scratch, q int8 [cin, cout], scale fp32 [cout]. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int supir_quantize_int8_first(const void* w, int cin, int cout, void* amax, unsigned long long seed,
                                         int stochastic, void* q, void* scale, void* stream) {
  if (cin <= 0 || cout <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  unsigned int* am = static_cast<unsigned int*>(amax);
  const dim3 g1((cout + FIRST_THREADS - 1) / FIRST_THREADS, (cin + ROWS_PER_SLAB - 1) / ROWS_PER_SLAB);
  colmax_kernel<<<g1, FIRST_THREADS, 0, s>>>(wf, cin, cout, am);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)cin * cout;
  const long long threads = (n + 3) / 4;
  const unsigned int blocks = (unsigned int)((threads + FIRST_THREADS - 1) / FIRST_THREADS);
  quant_kernel<<<blocks, FIRST_THREADS, 0, s>>>(wf, n, cout, am, seed, stochastic,
                                          static_cast<int8_t*>(q), static_cast<float*>(scale));
  return (int)cudaGetLastError();
}
