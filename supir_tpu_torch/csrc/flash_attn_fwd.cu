// K1 and K3: flash-attention forward for Hopper (sm_90a), bf16 in/out,
// optionally causal; K3 also writes the row logsumexp; either with ALiBi.
//
// K1 replaces supir_tpu/ops/flash_attention.py:_attn_kernel_packed (:35) and
// _attn_kernel_packed_single (:123), both launched from _flash_primal (:363).
// The TPU pair exists because of TPU layout (128-lane head packing, one
// closed-form variant when all keys fit one VMEM block); on the card one
// kernel covers both.
//
// K3 replaces _attn_kernel (:164) with with_lse=True, launched from
// _flash_fwd_lse (:434, pallas_call :459): the forward rule of the
// flash_attention custom_vjp. It is the same kernel instantiated with
// WITH_LSE, which also stores lse = logsumexp(scale * q k^T) per query row
// in natural-log units, as the TPU kernel stores it (:233-239). The running
// max m is kept in raw-score units and l sums exp2((s - m) * scale * log2 e),
// so lse = m * scale + ln(l). The TPU stored it lane-broadcast as
// [B*H, S_pad, 128] for its (8, 128) tiling; here it is a plain [B, H, S]
// fp32 array. The backward (flash_attn_bwd.cu, K4) reads it.
//
// What it computes: O = softmax(Q K^T / sqrt(D)) V over q [B,S,H,D] and
// k/v [B,T,H,D], D 64 or 128, read in place through TMA tensor maps (the
// head dim contiguous), with fp32 running max, sum and accumulator. Keys
// past T (the ragged last tile) are masked out. With `causal` (the TPU
// kernels' `causal` flag, reached from _flash_primal :350,356; S == T),
// query row i sees keys 0..i only: key tiles wholly above the diagonal are
// never loaded, and the tiles that cut it are masked per row.
//
// ALiBi (MPT's positional bias, the TPU kernel's `alibi` branch, :197-201,
// with its slopes operand :395-396, :456-458): given fp32 slopes [H], head h
// adds slope_h * (col - (T - 1)) to its scaled scores, T the unpadded key
// length, causal or not; null slopes add nothing. The running max stays in
// raw q.k units, so the bias enters as slope_h / scale * (col - (T - 1)):
// the max, the sum and the lse then all see the biased scores, and the lse
// written is the natural-log logsumexp of the biased scaled scores. The
// offset -(T - 1) cancels in O (it is constant along a row) but not in the
// lse, which the backward reads. ALIBI is a template flag, so the kernels
// without it carry no bias code.
//
// What bounds it: at the main paths' shapes attention is compute-bound
// (S*T*D multiply-adds against S*D loads), so the design keeps the tensor
// cores fed and every intermediate out of shared memory:
// - Block: 128 query rows of one (batch, head), 384 threads. Warpgroup 0 is
//   the producer: one thread issues every TMA copy, and `setmaxnreg` takes
//   the warpgroup down to 24 registers. Warpgroups 1 and 2 are consumers
//   of 64 rows each and go up to 240 (2*128*240 + 128*24 = 64,512 of the
//   SM's 65,536).
// - Copies: Q once, then K and V tiles of 128 keys into a ring of STAGES
//   stages, each with a "full" mbarrier for K, one for V (so S = Q K^T can
//   start before V lands) and an "empty" one the consumers' 8 warps arrive
//   on when they are done with the stage. TMA writes the 128-byte swizzle
//   that wgmma reads; a 128-byte row holds 64 head-dim columns, so a tile
//   at D = 128 is two 64-column slabs. Rows past S or T arrive as zeros.
//   Shared memory: D = 128, 32 KB of Q + 2 x 64 KB of K/V = 160 KB; D = 64,
//   80 KB.
// - S = Q K^T: wgmma m64n128k16, both operands from shared memory, K-major
//   (the head dim is contiguous in q and k); the k16 step advances the
//   descriptor by 32 bytes inside a slab.
// - Softmax on the accumulator fragment: a thread holds rows g and g+8 of
//   its warp's 16 (g = lane / 4) and 32 columns of each, so the row max
//   needs two shuffles within the four lanes of a row, and the row sum none
//   until the end. exp2 with the scale folded in. ALiBi adds its bias per
//   column; the causal and ragged masks run only on the tiles that cut the
//   diagonal or T.
// - O += P V: P goes to bf16 in registers, where the m64n128 accumulator's
//   layout is the A fragment's of four k16 steps (wgmma's register-A form);
//   V [keys, D] is MN-major, read through the transpose-B bit. Neither S
//   nor P goes to shared memory; O stays in registers and is rescaled by
//   the correction factor.
// - Epilogue: O is normalised in registers, written swizzled into the
//   warpgroup's own Q rows (its products are done), and stored from there
//   in 16-byte vectors; rows past S are clipped. The lse comes from the
//   lane that owns the row.
// - Grid: B*H x ceil(S/128), query blocks in reverse order when causal, so
//   the heaviest blocks start first.
// Later work, not here: a persistent scheduler, overlapping one
// warpgroup's softmax with the other's products, the next tile's Q K^T
// issued before this tile's softmax, fp8, clusters.
//
// Tensor maps: ops/flash_attention.py:tma_plan turns q, k and v into plans
// (dims innermost-first, byte strides, boxes, and the map position of the
// seq, head and batch coordinates, an axis of stride 0 or extent 1 dropped:
// MPT's multiquery k/v are expanded over heads with stride 0). The host
// code below encodes them with cuTensorMapEncodeTiled, fetched at run time
// through cudaGetDriverEntryPoint (no -lcuda link), and passes them as
// __grid_constant__ kernel parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 128;                  // query rows per block
constexpr int BN = 128;                  // keys per K/V tile
constexpr int SLAB = 64;                 // head-dim columns per 128-byte swizzle slab
constexpr int SLAB_BYTES = 128 * 128;    // one slab of a 128-row tile
constexpr int STAGES = 2;                // K/V ring depth
constexpr int THREADS = 384;             // producer warpgroup + two consumer warpgroups
constexpr int PLAN_LEN = 15;             // see tma_plan: rank, dims[4], strides[3], box[4], positions[3]
constexpr float NEG_INF = -1e30f;

template <int D>
struct Smem {
  static constexpr int SLABS = D / SLAB;
  static constexpr int TILE = SLABS * SLAB_BYTES;   // one 128-row tile of Q, K or V
  static constexpr int Q = 0;
  static constexpr int K = Q + TILE;                // stage s at K + s * TILE
  static constexpr int V = K + STAGES * TILE;
  static constexpr int BAR = V + STAGES * TILE;     // full_q, full_k[STAGES], full_v[STAGES], empty[STAGES]
  static constexpr int ALLOC = BAR + 8 * (1 + 3 * STAGES) + 1024;  // + slack to align the base to 1024
};

// where the seq, head and batch coordinates go in a tensor map (1..3), -1
// for an axis dropped from it
struct MapPos {
  int rank, seq, head, batch;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ int map_coord(const MapPos& p, int i, int row, int h, int b) {
  return (p.seq == i ? row : 0) + (p.head == i ? h : 0) + (p.batch == i ? b : 0);
}

// one 128-row tile (all its slabs) from `map` at sequence row `row` of
// (batch b, head h) into shared memory at dst; completes on `bar`
template <int SLABS>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, const MapPos& p, uint32_t bar,
                                         int row, int h, int b) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  const int c1 = map_coord(p, 1, row, h, b), c2 = map_coord(p, 2, row, h, b), c3 = map_coord(p, 3, row, h, b);
#pragma unroll
  for (int s = 0; s < SLABS; ++s) {
    const uint32_t to = dst + s * SLAB_BYTES;
    const int c0 = s * SLAB;
    if (p.rank == 2)
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
          ::"r"(to), "l"(m), "r"(bar), "r"(c0), "r"(c1) : "memory");
    else if (p.rank == 3)
      asm volatile(
          "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
          "[%2];\n" ::"r"(to), "l"(m), "r"(bar), "r"(c0), "r"(c1), "r"(c2) : "memory");
    else
      asm volatile(
          "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
          "[%2];\n" ::"r"(to), "l"(m), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
  }
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1): start
// address, leading and stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand (Q or K rows of 128 bytes): 8-row groups 1024 bytes apart;
// the leading offset is unused under the swizzle
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) { return smem_desc(addr, 16, 1024); }

// MN-major operand (V, [keys, D]): 8-key groups 1024 bytes apart along K,
// 64-column slabs SLAB_BYTES apart along N
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) { return smem_desc(addr, SLAB_BYTES, 1024); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (+)= A B^T over one k16 step, A and B K-major in shared memory
// (128-byte swizzle); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D += A B over one k16 step, A (four bf16x2 registers a thread) from
// registers, B MN-major in shared memory (transpose-B bit, 128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D += A B over one k16 step, A (four bf16x2 registers a thread) from
// registers, B MN-major in shared memory (transpose-B bit, 128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the product O += P V at either head dim, chosen by the accumulator's size
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t* a, uint64_t db) { wgmma_rs_m64n64(d, a, db); }
__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t* a, uint64_t db) { wgmma_rs_m64n128(d, a, db); }

template <int D, bool WITH_LSE, bool ALIBI>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, MapPos qpos, MapPos kpos, MapPos vpos,
                 bf16* __restrict__ o, float* __restrict__ lse, const float* __restrict__ slopes, int H, int S,
                 int T, long long osb, long long oss, long long osh, float scale_log2, int causal) {
  using L = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the 128-byte swizzle repeats every 1024 bytes
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full_q = base + L::BAR;
  const uint32_t full_k = full_q + 8, full_v = full_k + 8 * STAGES, empty = full_v + 8 * STAGES;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BM;
  const int kv_end = causal ? min(T, q0 + BM) : T;
  const int n_tiles = (kv_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, L::TILE);
      tma_tile<L::SLABS>(base + L::Q, &qmap, qpos, full_q, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(empty + 8 * s, ((t / STAGES) & 1) ^ 1);  // a fresh barrier passes parity 1
        mbar_expect_tx(full_k + 8 * s, L::TILE);
        tma_tile<L::SLABS>(base + L::K + s * L::TILE, &kmap, kpos, full_k + 8 * s, t * BN, h, b);
        mbar_expect_tx(full_v + 8 * s, L::TILE);
        tma_tile<L::SLABS>(base + L::V + s * L::TILE, &vmap, vpos, full_v + 8 * s, t * BN, h, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup: rows q0 + 64 cw ...
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int first = q0 + 64 * cw;              // the warpgroup's first row
  const int row0 = first + 16 * warp + g;      // this thread's rows: row0 and row0 + 8
  const int lim0 = causal ? min(T, row0 + 1) : T;
  const int lim1 = causal ? min(T, row0 + 9) : T;
  // ALiBi slope in raw score units (scale = scale_log2 / log2 e)
  const float ab = ALIBI ? slopes[h] * 1.4426950408889634f / scale_log2 : 0.f;
  const uint32_t q_rows = base + L::Q + cw * 64 * 128;  // the warpgroup's 64 rows of each Q slab

  float acc[D / 2];  // O: rows row0 (acc[4j], acc[4j+1]) and row0 + 8 (acc[4j+2], acc[4j+3]), cols 8j + 2tq
  float sc[BN / 2];  // S, the same layout over the tile's 128 keys
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;  // running max, raw score units
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the running sum

  mbar_wait(full_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const uint32_t parity = (t / STAGES) & 1;
    const int k0 = t * BN;
    const uint32_t k_tile = base + L::K + s * L::TILE, v_tile = base + L::V + s * L::TILE;

    // S = Q K^T over the head dim, k16 steps of 32 bytes inside each slab
    mbar_wait(full_k + 8 * s, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * SLAB_BYTES + (kk % 4) * 32;
      wgmma_ss_m64n128(sc, desc_kmajor(q_rows + off), desc_kmajor(k_tile + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    if (ALIBI) {
      const float c0 = static_cast<float>(k0 + 2 * tq + 1 - T);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float bias = ab * (c0 + static_cast<float>(8 * j + e));
          sc[4 * j + e] += bias;
          sc[4 * j + 2 + e] += bias;
        }
    }
    if (k0 + BN > T || (causal && k0 + BN - 1 > first)) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + 2 * tq + e;
          if (col >= lim0) sc[4 * j + e] = NEG_INF;
          if (col >= lim1) sc[4 * j + 2 + e] = NEG_INF;
        }
    }

    // online softmax: the four lanes of a row share its max
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int w = 1; w < 4; w *= 2) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    const float corr0 = fast_exp2((m0 - mx0) * scale_log2), corr1 = fast_exp2((m1 - mx1) * scale_log2);
    m0 = mx0;
    m1 = mx1;
    const float off0 = mx0 * scale_log2, off1 = mx1 * scale_log2;
    // P in bf16 pairs; p[4kk..4kk+3] is the A fragment of keys 16kk..16kk+15
    uint32_t p[BN / 4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float p00 = fast_exp2(fmaf(sc[4 * j], scale_log2, -off0));
      const float p01 = fast_exp2(fmaf(sc[4 * j + 1], scale_log2, -off0));
      const float p10 = fast_exp2(fmaf(sc[4 * j + 2], scale_log2, -off1));
      const float p11 = fast_exp2(fmaf(sc[4 * j + 3], scale_log2, -off1));
      sum0 += p00 + p01;
      sum1 += p10 + p11;
      p[2 * j] = pack_bf16(p00, p01);
      p[2 * j + 1] = pack_bf16(p10, p11);
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= corr0;
      acc[4 * j + 1] *= corr0;
      acc[4 * j + 2] *= corr1;
      acc[4 * j + 3] *= corr1;
    }

    // O += P V over the tile's keys, k16 steps of 16 rows (2048 bytes)
    mbar_wait(full_v + 8 * s, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) wgmma_pv(acc, p + 4 * kk, desc_mnmajor(v_tile + kk * 16 * 128));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  // epilogue: the row sums, O normalised into the warpgroup's Q rows
  // (swizzled as TMA wrote them), then 16-byte stores of the rows below S
#pragma unroll
  for (int w = 1; w < 4; w *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  unsigned char* rows = smem + L::Q + cw * 64 * 128;
  const int r0 = 16 * warp + g;  // r0 and r0 + 8 share r0 % 8, the swizzle's row phase
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    unsigned char* chunk = rows + (j / 8) * SLAB_BYTES + (((j % 8) ^ (r0 & 7)) * 16) + tq * 4;
    *reinterpret_cast<uint32_t*>(chunk + r0 * 128) = pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    *reinterpret_cast<uint32_t*>(chunk + (r0 + 8) * 128) = pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");  // the warpgroup's rows are written
  bf16* ob = o + b * osb + h * osh;
  for (int i = tid; i < 64 * (D / 8); i += 128) {
    const int r = i / (D / 8), c = i % (D / 8);
    if (first + r < S)
      *reinterpret_cast<uint4*>(ob + (first + r) * oss + c * 8) = *reinterpret_cast<const uint4*>(
          rows + (c / 8) * SLAB_BYTES + r * 128 + (((c % 8) ^ (r & 7)) * 16));
  }
  if (WITH_LSE && tq == 0) {
    constexpr float LN2 = 0.6931471805599453f;
    float* lrow = lse + static_cast<long long>(bh) * S;
    if (row0 < S) lrow[row0] = m0 * scale_log2 * LN2 + logf(fmaxf(l0, 1e-30f));
    if (row0 + 8 < S) lrow[row0 + 8] = m1 * scale_log2 * LN2 + logf(fmaxf(l1, 1e-30f));
  }
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded
cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (!cached) {
    void* entry = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &entry, 12000, cudaEnableDefault,
                                                       &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &entry, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || !entry) return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiled>(entry);
  }
  *fn = cached;
  return cudaSuccess;
}

// A plan of PLAN_LEN values (ops/flash_attention.py:tma_plan): rank, dims
// innermost-first (4), byte strides of dims 1.. (3), box (4), and the map
// positions of the seq, head and batch coordinates (3). Returns the
// CUresult of the encode.
CUresult encode(EncodeTiled fn, CUtensorMap* map, MapPos* pos, const void* ptr, const long long* plan) {
  const int rank = static_cast<int>(plan[0]);
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    dims[i] = static_cast<cuuint64_t>(plan[1 + i]);
    box[i] = static_cast<cuuint32_t>(plan[8 + i]);
    if (i) strides[i - 1] = static_cast<cuuint64_t>(plan[4 + i]);
  }
  *pos = MapPos{rank, static_cast<int>(plan[12]), static_cast<int>(plan[13]), static_cast<int>(plan[14])};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, static_cast<cuuint32_t>(rank), const_cast<void*>(ptr), dims,
            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

struct Maps {
  CUtensorMap q, k, v;
  MapPos qp, kp, vp;
};

template <int D, bool WITH_LSE, bool ALIBI>
cudaError_t launch(const Maps& m, bf16* o, float* lse, const float* slopes, int B, int H, int S, int T,
                   const long long* ost, float scale_log2, int causal, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D, WITH_LSE, ALIBI>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::ALLOC);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + BM - 1) / BM);
  flash_fwd_kernel<D, WITH_LSE, ALIBI><<<grid, THREADS, Smem<D>::ALLOC, stream>>>(m.q, m.k, m.v, m.qp, m.kp, m.vp, o, lse, slopes, H, S, T,
                                                     ost[0], ost[1], ost[2], scale_log2, causal);
  return cudaGetLastError();
}

// 0 on success, a cudaError_t (> 0) from the entry-point query or the
// launch, or minus the CUresult of a failed tensor-map encode
template <bool WITH_LSE>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse, const void* slopes, int B, int H,
             int S, int T, int D, int causal, const long long* plans, const long long* ost, float scale,
             void* stream) {
  EncodeTiled fn;
  const cudaError_t found = encode_tiled(&fn);
  if (found != cudaSuccess) return static_cast<int>(found);
  Maps m;
  const void* ptrs[3] = {q, k, v};
  CUtensorMap* maps[3] = {&m.q, &m.k, &m.v};
  MapPos* pos[3] = {&m.qp, &m.kp, &m.vp};
  for (int i = 0; i < 3; ++i) {
    const CUresult r = encode(fn, maps[i], pos[i], ptrs[i], plans + i * PLAN_LEN);
    if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  }
  const float scale_log2 = scale * 1.4426950408889634f;
  bf16* ob = static_cast<bf16*>(o);
  const float* sl = static_cast<const float*>(slopes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 64 && sl) err = launch<64, WITH_LSE, true>(m, ob, lse, sl, B, H, S, T, ost, scale_log2, causal, s);
  else if (D == 64) err = launch<64, WITH_LSE, false>(m, ob, lse, sl, B, H, S, T, ost, scale_log2, causal, s);
  else if (D == 128 && sl) err = launch<128, WITH_LSE, true>(m, ob, lse, sl, B, H, S, T, ost, scale_log2, causal, s);
  else if (D == 128) err = launch<128, WITH_LSE, false>(m, ob, lse, sl, B, H, S, T, ost, scale_log2, causal, s);
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry point for ctypes. plans: three tensor-map plans of
// PLAN_LEN values each (q, k, v; ops/flash_attention.py:tma_plan); o's
// strides in elements (batch, seq, head; the head dim has stride 1).
// causal is 0 or 1 (then S == T). slopes: fp32 [H] ALiBi slopes on the
// device, or null for none. Returns 0 on success, a cudaError_t, or minus
// the CUresult of a failed tensor-map encode.
extern "C" int supir_flash_attn_fwd_bf16(const void* q, const void* k, const void* v, void* o, const void* slopes,
                                         int B, int H, int S, int T, int D, int causal, const long long* plans,
                                         long long osb, long long oss, long long osh, float scale, void* stream) {
  const long long ost[3] = {osb, oss, osh};
  return dispatch<false>(q, k, v, o, nullptr, slopes, B, H, S, T, D, causal, plans, ost, scale, stream);
}

// K3: the same, and lse [B, H, S] fp32 (contiguous) receives each query
// row's natural-log logsumexp of the scaled (and ALiBi-biased) scores.
extern "C" int supir_flash_attn_fwd_lse_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                                             const void* slopes, int B, int H, int S, int T, int D, int causal,
                                             const long long* plans, long long osb, long long oss, long long osh,
                                             float scale, void* stream) {
  const long long ost[3] = {osb, oss, osh};
  return dispatch<true>(q, k, v, o, static_cast<float*>(lse), slopes, B, H, S, T, D, causal, plans, ost, scale,
                        stream);
}
