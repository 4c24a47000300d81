// K4 fp32: the flash-attention backward for Hopper (sm_90a) in fp32, on the
// tensor cores: fp32 q, k, v, o, lse and dO in, fp32 dQ, dK and dV out,
// every product taken as three TF32 products (3xTF32) on wgmma, fed by
// TMA; optionally causal, optionally with ALiBi.
//
// It replaces supir_tpu/ops/flash_attention.py:_bwd_dq_kernel (:499,
// pallas_call :637) and _bwd_dkv_kernel (:539, pallas_call :663), driven by
// _flash_bwd (:592), for fp32 inputs: the TPU kernels write their gradients
// in q's dtype, so a trainer whose model computes in fp32 differentiates its
// flash sites in fp32 there. flash_attn_bwd.cu is the bf16 instance; this
// file is its fp32 twin, on the 3xTF32 route of flash_attn_fwd_fp32.cu
// (K1 fp32), whose split and TF32 products it shares through
// flash_attn_tf32.cuh.
//
// What it computes, from the forward's residuals q, k, v [B,S|T,H,D], o and
// lse [B,H,S] (K3 fp32's natural-log logsumexp of the scaled scores) and the
// output gradient dO, as _bwd_scores (:481-497) and the two kernels do:
//   P  = exp(scale * Q K^T - lse)          recomputed per tile, never stored
//   delta = rowsum(dO * O)                 a pre-pass, in fp32
//   dS = P * (dO V^T - delta)
//   dQ = scale * dS K,  dK = scale * dS^T Q,  dV = P^T dO
// Keys past T, queries past S and, with `causal` (S == T), keys after the
// query get P = 0.
//
// K4 ALiBi fp32 is the same kernels given fp32 slopes [H] (null: no bias):
// the recomputed scores get the forward's bias back, as _bwd_scores adds it
// (:489-490), P = exp(scale * Q K^T + slope_h * (col - (T - 1)) - lse),
// with the product by the scale and the bias' product and sum each rounded
// to fp32 (__fmul_rn, __fadd_rn, never contracted into an FMA) before the
// lse is subtracted, as K3 ALiBi fp32 and the plain version round them, so
// P is the forward's: at MPT-7B's slopes the biased scores reach ~1700,
// where any other rounding moves P by ~1e-5, the whole of the bound. Both
// kernels take the score through one helper, `scaled_score`. The delta
// pre-pass needs no bias; the slopes get no gradient (static in JAX's
// custom VJP).
//
// What bounds it: operations. The function needs five [S x T x D] products
// (S, dP, dQ, dK, dV), each three TF32 products here; this design does
// seven, since S and dP are computed in both kernels. That is the TPU's
// split into a dQ kernel and a dK/dV kernel, kept because every output
// element is then written by exactly one block: no atomics, and two runs
// give the same bits. Bound: 3 x 5 x 2 B H S T D flops at TF32's 495
// TFLOP/s ([1,4096,10,64]: 0.651 ms; the seven products' work 0.911 ms).
//
// Design (both kernels one template, `DKV` false for dQ, true for dK/dV):
// - Block: a producer warpgroup and two consumer warpgroups (384 threads)
//   on ROWS = 64 owned rows of one (b, h): queries in the dQ kernel, keys in
//   the dK/dV kernel. Tiles of R = 32 rows of the other side stream through.
//   Consumer 0 forms the scores (S = Q K^T, or S^T = K Q^T) and P; consumer
//   1 forms dP (dO V^T, or dP^T = V dO^T), takes P from consumer 0 through
//   shared memory (each thread's 16 values, in the accumulator layout both
//   share: no re-layout) and forms dS. Then consumer 1 takes dQ += dS K (or
//   dK += dS^T Q) and, in the dK/dV kernel, consumer 0 dV += P^T dO. Each
//   output accumulates in fp32 registers, each tile's product going into a
//   fresh accumulator first (the tensor cores' own fp32 sums stray over
//   thousands of steps, as K1 fp32 measured: 4.3e-5 at T = 6144).
// - Owned operands (Q and dO, or K and V) land raw once by TMA. TF32 wgmma
//   reads K-major operands only, and these are the A of S and dP: each
//   consumer reads its rows' A fragments from the raw tile with plain
//   shared loads (each warp's 32 lanes on 32 banks), two k8 steps at a
//   time, splits them in registers and issues their three products from
//   registers into a fresh accumulator while the next chunk loads (two
//   register sets), the chunks' sums added in fp32.
// - Streamed operands (K and V, or Q and dO): the producer warpgroup's
//   thread 0 issues every copy; all 128 split. The first (U: K or Q) lands
//   in a landing buffer and is split into U hi and lo (K-major, the B of S
//   or S^T) and U^T hi and lo; the second (W: V or dO) lands in its stage's
//   W hi slot and is split in place, into W lo and, in the dK/dV kernel, W^T
//   hi and lo. U^T and W^T are the B of dQ += dS K, dK += dS^T Q and dV +=
//   P^T dO, written [D rows][R] in the VT_KEY order, so P and dS go from
//   their accumulators to the A fragments without an exchange. The lane
//   map is K1 fp32's V^T map: lane (s4, d4, z) of warp w takes row
//   8 (c / 2) + 2 s4 + c % 2 of the tile, c = w ^ 5z, at columns
//   d = 4 i + d4, which puts every raw read, in-place write and transposed
//   write of a warp on 32 distinct banks.
// - Shared memory (bytes; owned 2 x 64 D 4, landing 32 D 4, stage 6 (dQ)
//   or 8 (dK/dV) x 32 D 4, the P exchange 8 KB, barriers and 1 KB of
//   alignment slack): D = 64, two stages: dQ 148,544, dK/dV 181,312;
//   D = 128, one stage (a second does not fit 227 KB): dQ 189,480,
//   dK/dV 222,248. One block an SM (384 threads at up to 168 registers).
// - Registers: 384 threads launch at 168; setmaxnreg takes the producer
//   to 72 (40 at D = 128; it keeps nothing: each thread reads, splits and
//   writes one value at a time) and the consumers to 216 (232), within
//   which a consumer holds its fp32 sums (D/2), the score tile (16), two
//   sets of A fragments and chunk accumulators (2 x 32), and for the
//   output product a fresh accumulator of 64 columns (32 at D = 128: 64
//   spilled). Without setmaxnreg, or at 216, the D = 128 instances
//   spilled.
// - Pre-pass (flash_bwd_fp32_rows_kernel): lse and delta per query row into
//   [B*H, S_pad] rows (S_pad = S rounded up to 128), lse +inf and delta 0
//   past S, so P is 0 on padded queries with no mask.
// - Causal: the dQ kernel's blocks stop at their diagonal tile (query blocks
//   in reverse order, the heaviest first), the dK/dV kernel's start at it;
//   the masks run only on tiles that cut the diagonal or T.
// - Launch: the pre-pass, then the dQ kernel on a side stream forked from
//   the caller's and the dK/dV kernel on the caller's, joined after both.
// Two runs are bit-identical: every sum has a fixed order. On an H100
// (PERF.md §6; chip_smoke.py [kernels] K4 fp32 and tools/flash_fp32_ab.py
// --backward) it reads 14-22 % of the 3xTF32 bound (4-8 % at the 32-block
// shapes), 0.54-0.79x SDPA fp32's backward's time: each consumer's chain per
// tile (product, P or dS, the exchange, the output product) leaves the
// tensor cores idle between links.
//
// FAULT (a runtime argument, for the checks only): 1 delta dropped (dS = P
// dP), 2 dK without the scale, 3 the causal diagonal not masked, 4 P read
// with the lse in log2 units, 5 every product on one TF32 product (hi hi:
// plain TF32), 6 the lo part of the transposed operands dropped (dQ, dK and
// dV without hi_a lo_b), 7 the transposed operands written in row order
// (without the fragment permutation).

#include <math.h>

#include "flash_attn_tma.cuh"
#include "flash_attn_tf32.cuh"

namespace {

constexpr int ROWS = 64;            // rows a block owns: queries (dQ) or keys (dK/dV)
constexpr int R = 32;               // rows of a streamed tile: keys (dQ) or queries (dK/dV)
constexpr int THREADS = 384;        // producer warpgroup + two consumer warpgroups
constexpr int PAD = 128;            // the pre-pass pads each (b, h)'s rows to a multiple of PAD
constexpr int BAR_P_FULL = 2, BAR_P_EMPTY = 3;  // named barriers of the P exchange (1: the producer's)
constexpr int F_NO_DELTA = 1, F_DK_SCALE = 2, F_DIAGONAL = 3, F_LSE_LOG2 = 4, F_ONE_PRODUCT = 5, F_NO_T_LO = 6,
              F_T_ORDER = 7;
constexpr float LOG2E = 1.4426950408889634f;

template <int D, bool DKV>
struct Layout {
  static constexpr int STAGES = D == 64 ? 2 : 1;
  static constexpr int SLABS = D / FP32_SLAB;
  // setmaxnreg's split of 64,512 registers (65,536 never completes): 128 x
  // 72 + 256 x 216, or at D = 128, where the consumers need more, 128 x 40
  // + 256 x 232 (at D = 64 a producer of 40 spilled)
  static constexpr int PRODUCER_REGS = D == 64 ? 72 : 40;
  static constexpr int CONSUMER_REGS = D == 64 ? 216 : 232;
  static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS == 64512, "the block's registers");
  static constexpr int OWN = ROWS * D * 4;   // one owned operand, raw
  static constexpr int TILE = R * D * 4;     // one streamed operand: raw, hi, lo, transposed hi or lo
  static constexpr int X = 0;                // owned: the A of S (Q, or K) ...
  static constexpr int Y = OWN;              // ... and of dP (dO, or V)
  static constexpr int LAND = 2 * OWN;       // raw U of the next tile
  static constexpr int RING = LAND + TILE;   // stage s at RING + s * STAGE:
  static constexpr int U_HI = 0, U_LO = TILE, W_HI = 2 * TILE, W_LO = 3 * TILE;  // K-major (W's raw lands in W_HI)
  static constexpr int UT_HI = 4 * TILE, UT_LO = 5 * TILE, WT_HI = 6 * TILE, WT_LO = 7 * TILE;  // [D][R], VT_KEY
  static constexpr int STAGE = (DKV ? 8 : 6) * TILE;
  static constexpr int PBUF = RING + STAGES * STAGE;  // P, consumer 0 to consumer 1: 16 floats a thread
  static constexpr int BAR = PBUF + ROWS * R * 4;     // own_full, land_full, w_full[S], ready[S], empty[S]
  static constexpr int ALLOC = BAR + 8 * (2 + 3 * STAGES) + 1024;  // + slack to align the base to 1024
  static_assert(ALLOC <= 232448, "one block's shared memory");
};

__device__ __forceinline__ void named_sync(int id) { asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory"); }
__device__ __forceinline__ void named_arrive(int id) { asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory"); }

__device__ __forceinline__ float lds(const unsigned char* p) { return *reinterpret_cast<const float*>(p); }

// P's exponent, the scaled score less the row's lse: scale s - l, or with
// ALiBi scale s + bias - l (bias = slope_h (col - (T - 1))), each step
// rounded to fp32 as the forward and the plain version round it
template <bool ALIBI>
__device__ __forceinline__ float scaled_score(float s, float scale, float bias, float l) {
  const float x = __fmul_rn(s, scale);
  return __fsub_rn(ALIBI ? __fadd_rn(x, bias) : x, l);
}

__device__ __forceinline__ float alibi_bias(float slope, int col, int T) {
  return __fmul_rn(slope, static_cast<float>(col - (T - 1)));
}

// One streamed tile split into TF32 pairs by the producer warpgroup: this
// thread's tile row `row` (raw at src: K-major, D/32 slabs of R rows x 128
// bytes, 128-byte swizzle) at columns d = 4 i + d4; hi and lo go to the same
// places of the hi and lo tiles (src may be hi: each value is read and
// written by one thread), and with TRANSPOSE to the transposed tiles [D][R]
// (one slab), row d, slot 4 c + s4.
template <int D, bool TRANSPOSE>
__device__ __forceinline__ void split_rows(const unsigned char* src, unsigned char* hi, unsigned char* lo,
                                           unsigned char* hi_t, unsigned char* lo_t, int row, int c, int s4,
                                           int d4) {
  const int r7 = row & 7;
#pragma unroll 8
  for (int i = 0; i < D / 4; ++i) {
    const int at = (i / 8) * R * 128 + row * 128 + (((i % 8) ^ r7) << 4) + 4 * d4;
    uint32_t xh, xl;
    tf32_split(lds(src + at), xh, xl);
    *reinterpret_cast<uint32_t*>(hi + at) = xh;
    *reinterpret_cast<uint32_t*>(lo + at) = xl;
    if (TRANSPOSE) {
      const int d = 4 * i + d4;
      const int tat = d * 128 + ((c ^ (d & 7)) << 4) + 4 * s4;
      *reinterpret_cast<uint32_t*>(hi_t + tat) = xh;
      *reinterpret_cast<uint32_t*>(lo_t + tat) = xl;
    }
  }
}

// acc = X B^T over the head dim in 3xTF32: X this warpgroup's owned rows (r0
// and r0 + 8 a thread) of a raw K-major tile (D/32 slabs of ROWS rows), A
// from registers, loaded and split a chunk of STEPS k8 steps at a time
// into one of two register sets; B a streamed tile's K-major hi and lo (D/32 slabs
// of R rows). Each chunk goes into a fresh accumulator (its small terms
// first), added to acc in fp32 in chunk order: the tensor cores' own sums
// truncate, and over the head dim in one accumulator their bias, amplified
// where dP - delta cancels, put MPT-7B's gradients 3.2e-5 from the fp32
// plain version. A set and its accumulator are kept until the wait that
// retires their products. `one`: hi hi only (FAULT 5).
template <int D>
__device__ __forceinline__ void owned_product(float (&acc)[R / 2], const unsigned char* own, uint32_t b_hi,
                                              uint32_t b_lo, int r0, int tq, bool one) {
  constexpr int STEPS = 2;  // k8 steps a chunk
  constexpr int CHUNKS = D / 8 / STEPS;
  uint32_t ah[2][4 * STEPS], al[2][4 * STEPS];
  float part[2][R / 2];
  const int ph = r0 & 7;  // r0 and r0 + 8 share the swizzle's row phase
#pragma unroll
  for (int i = 0; i < R / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int set = c & 1;
    if (c >= 2) {  // chunk c - 2's products are done: its sum joins acc, its set is free
      wgmma_wait<1>();
      fence_regs(part[set]);
      keep_regs(ah[set]);
      keep_regs(al[set]);
#pragma unroll
      for (int i = 0; i < R / 2; ++i) acc[i] += part[set][i];
    }
    const int k0 = c * STEPS;                                   // the chunk's first k8 step
    const unsigned char* slab = own + (k0 / 4) * ROWS * 128;    // four k8 steps a slab
#pragma unroll
    for (int m = 0; m < STEPS; ++m) {  // k8 step k0 + m: the slab's columns 8n + tq and 8n + tq + 4
      const int n = k0 % 4 + m;
      const int lo_ch = ((2 * n) ^ ph) << 4, hi_ch = ((2 * n + 1) ^ ph) << 4;
      tf32_split(lds(slab + r0 * 128 + lo_ch + 4 * tq), ah[set][4 * m], al[set][4 * m]);
      tf32_split(lds(slab + (r0 + 8) * 128 + lo_ch + 4 * tq), ah[set][4 * m + 1], al[set][4 * m + 1]);
      tf32_split(lds(slab + r0 * 128 + hi_ch + 4 * tq), ah[set][4 * m + 2], al[set][4 * m + 2]);
      tf32_split(lds(slab + (r0 + 8) * 128 + hi_ch + 4 * tq), ah[set][4 * m + 3], al[set][4 * m + 3]);
    }
    // B's k8 step k0 + m: slab k0 / 4, 32 bytes a step inside it
    const uint32_t at = (k0 / 4) * R * 128 + (k0 % 4) * 32;
    wgmma_fence();
    if (!one) {
#pragma unroll
      for (int m = 0; m < STEPS; ++m)
        wgmma_tf32_rs(part[set], al[set] + 4 * m, desc_kmajor(b_hi + at + m * 32), m);
#pragma unroll
      for (int m = 0; m < STEPS; ++m) wgmma_tf32_rs(part[set], ah[set] + 4 * m, desc_kmajor(b_lo + at + m * 32), 1);
    }
#pragma unroll
    for (int m = 0; m < STEPS; ++m)
      wgmma_tf32_rs(part[set], ah[set] + 4 * m, desc_kmajor(b_hi + at + m * 32), !one || m > 0);
    wgmma_commit();
  }
  // the last two chunks, in order
  wgmma_wait<1>();
  fence_regs(part[CHUNKS & 1]);
#pragma unroll
  for (int i = 0; i < R / 2; ++i) acc[i] += part[CHUNKS & 1][i];
  wgmma_wait_all();
  fence_regs(part[(CHUNKS - 1) & 1]);
#pragma unroll
  for (int i = 0; i < R / 2; ++i) acc[i] += part[(CHUNKS - 1) & 1][i];
  keep_regs(ah[0]);
  keep_regs(al[0]);
  keep_regs(ah[1]);
  keep_regs(al[1]);
}

// sums += A B over the tile's R columns in 3xTF32, COLS output columns at a
// time into a fresh accumulator first: A (P or dS) from registers, B a
// transposed tile's hi and lo ([D][R], VT_KEY order; rows COLS q ..
// COLS (q + 1) - 1 for the q-th pass). FAULT 5: hi hi only; FAULT 6:
// without hi_a lo_b.
template <int D>
__device__ __forceinline__ void output_product(float (&sums)[D / 2], uint32_t (&ah)[R / 2], uint32_t (&al)[R / 2],
                                               uint32_t bt_hi, uint32_t bt_lo, int fault) {
  constexpr int COLS = D == 64 ? 64 : 32;  // 64 at D = 128 spilled
#pragma unroll
  for (int q = 0; q < D / COLS; ++q) {
    const uint32_t hi = bt_hi + q * COLS * 128, lo = bt_lo + q * COLS * 128;
    float part[COLS / 2];
    wgmma_fence();
    if (fault != F_ONE_PRODUCT) {
#pragma unroll
      for (int kk = 0; kk < R / 8; ++kk) wgmma_tf32_rs(part, al + 4 * kk, desc_kmajor(hi + kk * 32), kk > 0);
      if (fault != F_NO_T_LO) {
#pragma unroll
        for (int kk = 0; kk < R / 8; ++kk) wgmma_tf32_rs(part, ah + 4 * kk, desc_kmajor(lo + kk * 32), 1);
      }
    }
#pragma unroll
    for (int kk = 0; kk < R / 8; ++kk)
      wgmma_tf32_rs(part, ah + 4 * kk, desc_kmajor(hi + kk * 32), fault != F_ONE_PRODUCT || kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < COLS / 2; ++i) sums[COLS / 2 * q + i] += part[i];
  }
  keep_regs(ah);
  keep_regs(al);
}

// lse and delta = rowsum(dO * O) of every query row into [B*H, S_pad] rows,
// one warp a row, the lanes' sums combined in a fixed order; past S lse is
// +inf and delta 0
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_fp32_rows_kernel(const float* __restrict__ o, const float* __restrict__ dout, const float* __restrict__ lse,
                           float* __restrict__ lse_rows, float* __restrict__ delta_rows, int H, int S, int S_pad,
                           long long n, long long osb, long long oss, long long osh, long long gsb, long long gss,
                           long long gsh) {
  const long long r = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  if (r >= n) return;
  const int lane = threadIdx.x % 32;
  const int s = static_cast<int>(r % S_pad);
  const long long bh = r / S_pad;
  const long long b = bh / H, h = bh % H;
  float acc = 0.f;
  if (s < S) {
    const float* orow = o + b * osb + s * oss + h * osh;
    const float* grow = dout + b * gsb + s * gss + h * gsh;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) acc = fmaf(orow[lane + 32 * i], grow[lane + 32 * i], acc);
  }
#pragma unroll
  for (int w = 16; w > 0; w /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) {
    lse_rows[r] = s < S ? lse[bh * S + s] : __int_as_float(0x7f800000);  // +inf
    delta_rows[r] = s < S ? acc : 0.f;
  }
}

// The dQ kernel (DKV false: owned queries, streamed keys; X Q, Y dO, U K, W
// V; out_b dQ) and the dK/dV kernel (DKV true: owned keys, streamed queries;
// X K, Y V, U Q, W dO; out_b dK, out_a dV).
template <int D, bool DKV, bool ALIBI>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_fp32_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap ymap,
                      const __grid_constant__ CUtensorMap umap, const __grid_constant__ CUtensorMap wmap,
                      MapPos xpos, MapPos ypos, MapPos upos, MapPos wpos, const float* __restrict__ lse_rows,
                      const float* __restrict__ delta_rows, const float* __restrict__ slopes,
                      float* __restrict__ out_b, float* __restrict__ out_a, int H, int S, int T, int S_pad,
                      float scale, int causal, int fault) {
  using L = Layout<D, DKV>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the 128-byte swizzle repeats every 1024 bytes
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t own_full = base + L::BAR, land_full = own_full + 8, w_full = own_full + 16;
  const uint32_t ready = w_full + 8 * STAGES, empty = ready + 8 * STAGES;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const bool masked = causal && fault != F_DIAGONAL;
  // the block's first owned row and the streamed rows it reads, [s_begin, s_end)
  int first, s_begin, s_end;
  if (DKV) {
    first = blockIdx.y * ROWS;
    s_begin = masked ? first : 0;  // causal: earlier queries see none of the block's keys
    s_end = S;
  } else {
    first = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * ROWS;  // causal: the heaviest first
    s_begin = 0;
    s_end = masked ? min(T, first + ROWS) : T;
  }
  const int n_tiles = (s_end - s_begin + R - 1) / R;

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    mbar_init(land_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(w_full + 8 * s, 1);
      mbar_init(ready + 8 * s, 128);  // every splitter thread
      mbar_init(empty + 8 * s, 8);    // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: thread 0 copies, all 128 split
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(L::PRODUCER_REGS) : "memory");
    const int tid = threadIdx.x;
    if (tid == 0) {
      mbar_expect_tx(own_full, 2 * L::OWN);
      tma_tile<L::SLABS, ROWS, R, FP32_SLAB>(base + L::X, &xmap, xpos, own_full, first, h, b);
      tma_tile<L::SLABS, ROWS, R, FP32_SLAB>(base + L::Y, &ymap, ypos, own_full, first, h, b);
      mbar_expect_tx(land_full, L::TILE);
      tma_tile<L::SLABS, R, R, FP32_SLAB>(base + L::LAND, &umap, upos, land_full, s_begin, h, b);
    }
    const int lane = tid % 32, s4 = lane & 3, d4 = (lane >> 2) & 3;
    const int c = (tid / 32) ^ (5 * (lane >> 4));
    // the tile row whose values this thread splits, and so the row its
    // transposed slot 4 c + s4 holds: VT_KEY order (FAULT 7: row order)
    const int row = fault == F_T_ORDER ? 4 * c + s4 : 8 * (c >> 1) + 2 * s4 + (c & 1);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      const int r0 = s_begin + t * R;
      unsigned char* st = smem + L::RING + s * L::STAGE;
      mbar_wait(empty + 8 * s, ((t / STAGES) & 1) ^ 1);  // a fresh barrier passes parity 1
      if (tid == 0) {
        mbar_expect_tx(w_full + 8 * s, L::TILE);
        tma_tile<L::SLABS, R, R, FP32_SLAB>(base + L::RING + s * L::STAGE + L::W_HI, &wmap, wpos, w_full + 8 * s, r0,
                                            h, b);
      }
      mbar_wait(land_full, t & 1);
      split_rows<D, true>(smem + L::LAND, st + L::U_HI, st + L::U_LO, st + L::UT_HI, st + L::UT_LO, row, c, s4, d4);
      // every splitter has read the landing buffer: its reads ordered before
      // the next copy's writes, which come through the async proxy
      fence_to_async();
      producer_sync();
      if (tid == 0 && t + 1 < n_tiles) {
        mbar_expect_tx(land_full, L::TILE);
        tma_tile<L::SLABS, R, R, FP32_SLAB>(base + L::LAND, &umap, upos, land_full, r0 + R, h, b);
      }
      mbar_wait(w_full + 8 * s, (t / STAGES) & 1);
      split_rows<D, DKV>(st + L::W_HI, st + L::W_HI, st + L::W_LO, st + L::WT_HI, st + L::WT_LO, row, c, s4, d4);
      fence_to_async();
      mbar_arrive(ready + 8 * s);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::CONSUMER_REGS) : "memory");
  const int role = threadIdx.x / 128 - 1;  // 0: scores and P (and dV); 1: dP, dS and dQ (or dK)
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int r0 = 16 * warp + g;  // this thread's owned rows: r0 and r0 + 8 of the block's 64
  const int row0 = first + r0;
  const long long rows_at = static_cast<long long>(bh) * S_pad;
  const float slope = ALIBI ? slopes[h] : 0.f;
  const float lse_unit = fault == F_LSE_LOG2 ? LOG2E : 1.f;
  // the dQ kernel's rows are queries: their lse (consumer 0) or delta
  // (consumer 1); the dK/dV kernel's rows are keys: their ALiBi bias
  const float* own_rows = role == 0 ? lse_rows : delta_rows;
  const float v0 = DKV ? 0.f : own_rows[rows_at + row0] * (role == 0 ? lse_unit : 1.f);
  const float v1 = DKV ? 0.f : own_rows[rows_at + row0 + 8] * (role == 0 ? lse_unit : 1.f);
  const float bias0 = ALIBI && DKV ? alibi_bias(slope, row0, T) : 0.f;
  const float bias1 = ALIBI && DKV ? alibi_bias(slope, row0 + 8, T) : 0.f;
  const unsigned char* own = smem + (role == 0 ? L::X : L::Y);
  float4* pbuf = reinterpret_cast<float4*>(smem + L::PBUF);

  float sums[D / 2];  // the output: rows r0 (sums[4j], [4j + 1]) and r0 + 8 ([4j + 2], [4j + 3]), cols 8j + 2tq
#pragma unroll
  for (int i = 0; i < D / 2; ++i) sums[i] = 0.f;
  float sc[R / 2];                  // S or S^T, then P (consumer 0); dP or dP^T, then dS (consumer 1)
  uint32_t ah[R / 2], al[R / 2];    // P or dS as the A fragments of the output product

  mbar_wait(own_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const int c0 = s_begin + t * R;  // the tile's first streamed row
    const uint32_t sa = base + L::RING + s * L::STAGE;
    mbar_wait(ready + 8 * s, (t / STAGES) & 1);
    owned_product<D>(sc, own, sa + (role == 0 ? L::U_HI : L::W_HI), sa + (role == 0 ? L::U_LO : L::W_LO), r0, tq,
                     fault == F_ONE_PRODUCT);
    if (role == 0) {
      // P: the dQ kernel's columns are keys (the bias by column, the lse by
      // row), the dK/dV kernel's queries (the bias by row, the lse by column)
      const bool edge = DKV ? masked && c0 < first + ROWS : c0 + R > T || (masked && c0 + R - 1 > first);
#pragma unroll
      for (int j = 0; j < R / 8; ++j) {
        const int col = c0 + 8 * j + 2 * tq;
        float l00 = v0, l01 = v0, l10 = v1, l11 = v1;
        if (DKV) {
          const float2 l = *reinterpret_cast<const float2*>(lse_rows + rows_at + col);
          l00 = l10 = l.x * lse_unit;
          l01 = l11 = l.y * lse_unit;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float cb = ALIBI && !DKV ? alibi_bias(slope, col + e, T) : 0.f;
          float p0 = expf(scaled_score<ALIBI>(sc[4 * j + e], scale, DKV ? bias0 : cb, e ? l01 : l00));
          float p1 = expf(scaled_score<ALIBI>(sc[4 * j + 2 + e], scale, DKV ? bias1 : cb, e ? l11 : l10));
          if (edge) {
            if (DKV) {  // queries before the key
              if (col + e < row0) p0 = 0.f;
              if (col + e < row0 + 8) p1 = 0.f;
            } else {  // keys past T or after the query
              if (col + e >= T || (masked && col + e > row0)) p0 = 0.f;
              if (col + e >= T || (masked && col + e > row0 + 8)) p1 = 0.f;
            }
          }
          sc[4 * j + e] = p0;
          sc[4 * j + 2 + e] = p1;
        }
      }
      if (t > 0) named_sync(BAR_P_EMPTY);  // consumer 1 has read the previous tile's P
#pragma unroll
      for (int j = 0; j < R / 8; ++j)
        pbuf[j * 128 + tid] = make_float4(sc[4 * j], sc[4 * j + 1], sc[4 * j + 2], sc[4 * j + 3]);
      named_arrive(BAR_P_FULL);
      if (DKV) {  // dV += P^T dO
        a_fragment(sc, ah, al);
        output_product<D>(sums, ah, al, sa + L::WT_HI, sa + L::WT_LO, fault);
      }
    } else {
      // dS = P (dP - delta), delta by row (dQ) or by column (dK/dV)
      named_sync(BAR_P_FULL);
      float4 p[R / 8];
#pragma unroll
      for (int j = 0; j < R / 8; ++j) p[j] = pbuf[j * 128 + tid];
      if (t + 1 < n_tiles) named_arrive(BAR_P_EMPTY);
#pragma unroll
      for (int j = 0; j < R / 8; ++j) {
        float d00 = v0, d01 = v0, d10 = v1, d11 = v1;
        if (DKV) {
          const float2 dl = *reinterpret_cast<const float2*>(delta_rows + rows_at + c0 + 8 * j + 2 * tq);
          d00 = d10 = dl.x;
          d01 = d11 = dl.y;
        }
        if (fault == F_NO_DELTA) d00 = d01 = d10 = d11 = 0.f;
        sc[4 * j] = __fmul_rn(p[j].x, __fsub_rn(sc[4 * j], d00));
        sc[4 * j + 1] = __fmul_rn(p[j].y, __fsub_rn(sc[4 * j + 1], d01));
        sc[4 * j + 2] = __fmul_rn(p[j].z, __fsub_rn(sc[4 * j + 2], d10));
        sc[4 * j + 3] = __fmul_rn(p[j].w, __fsub_rn(sc[4 * j + 3], d11));
      }
      // dQ += dS K, or dK += dS^T Q
      a_fragment(sc, ah, al);
      output_product<D>(sums, ah, al, sa + L::UT_HI, sa + L::UT_LO, fault);
    }
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  // epilogue: consumer 1's dQ (or dK) times the scale, consumer 0's dV;
  // rows past S (or T) clipped; 8-byte stores, each 32-byte sector whole
  if (!DKV && role == 0) return;
  const int n_rows = DKV ? T : S;
  const float mul = role == 0 || (DKV && fault == F_DK_SCALE) ? 1.f : scale;
  float* out = (role == 0 ? out_a : out_b) + (static_cast<long long>(b) * n_rows * H + h) * D + 2 * tq;
  const long long rs = static_cast<long long>(H) * D;
  if (row0 < n_rows) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(out + row0 * rs + 8 * j) = make_float2(sums[4 * j] * mul, sums[4 * j + 1] * mul);
  }
  if (row0 + 8 < n_rows) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(out + (row0 + 8) * rs + 8 * j) =
          make_float2(sums[4 * j + 2] * mul, sums[4 * j + 3] * mul);
  }
}

// ------------------------------------------------------------------ host

struct Maps {
  CUtensorMap q, k, v, d;
  MapPos qp, kp, vp, dp;
};

struct Args {
  const float* lse_rows;
  const float* delta_rows;
  const float* slopes;
  float *dq, *dk, *dv;
  int B, H, S, T, S_pad;
  float scale;
  int causal, fault;
};

template <int D, bool DKV, bool ALIBI>
cudaError_t launch_one(const Maps& m, const Args& a, cudaStream_t stream) {
  using L = Layout<D, DKV>;
  const cudaError_t err = cudaFuncSetAttribute(flash_bwd_fp32_kernel<D, DKV, ALIBI>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, L::ALLOC);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, ((DKV ? a.T : a.S) + ROWS - 1) / ROWS);
  if (DKV)  // X K, Y V, U Q, W dO
    flash_bwd_fp32_kernel<D, true, ALIBI><<<grid, THREADS, L::ALLOC, stream>>>(
        m.k, m.v, m.q, m.d, m.kp, m.vp, m.qp, m.dp, a.lse_rows, a.delta_rows, a.slopes, a.dk, a.dv, a.H, a.S, a.T,
        a.S_pad, a.scale, a.causal, a.fault);
  else  // X Q, Y dO, U K, W V
    flash_bwd_fp32_kernel<D, false, ALIBI><<<grid, THREADS, L::ALLOC, stream>>>(
        m.q, m.d, m.k, m.v, m.qp, m.dp, m.kp, m.vp, a.lse_rows, a.delta_rows, a.slopes, a.dq, nullptr, a.H, a.S, a.T,
        a.S_pad, a.scale, a.causal, a.fault);
  return cudaGetLastError();
}

// the pre-pass, then the dQ kernel on the side stream and the dK/dV kernel
// on `stream`, joined
template <int D, bool ALIBI>
cudaError_t launch(const Maps& m, const Args& a, const float* o, const float* dout, const float* lse, float* lse_rows,
                   float* delta_rows, const long long* st, cudaStream_t stream) {
  Fork* fork;
  cudaError_t err = device_fork(&fork);
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(a.B) * a.H * a.S_pad;
  flash_bwd_fp32_rows_kernel<D><<<static_cast<unsigned>((n + 7) / 8), 256, 0, stream>>>(
      o, dout, lse, lse_rows, delta_rows, a.H, a.S, a.S_pad, n, st[0], st[1], st[2], st[3], st[4], st[5]);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = cudaEventRecord(fork->ready, stream)) != cudaSuccess) return err;
  if ((err = cudaStreamWaitEvent(fork->side, fork->ready, 0)) != cudaSuccess) return err;
  if ((err = launch_one<D, false, ALIBI>(m, a, fork->side)) != cudaSuccess) return err;
  if ((err = cudaEventRecord(fork->done, fork->side)) != cudaSuccess) return err;
  if ((err = launch_one<D, true, ALIBI>(m, a, stream)) != cudaSuccess) return err;
  return cudaStreamWaitEvent(stream, fork->done, 0);
}

}  // namespace

// Plain C entry point for ctypes. plans: four tensor-map plans of PLAN_LEN
// values each (q, k, v, dout at R-row boxes of 32 fp32 columns;
// ops/flash_attention.py:tma_plan). strides: 6 element strides, (batch,
// seq, head) of o and dout; the head dim has stride 1. lse is [B, H, S]
// fp32 (contiguous); rows is fp32 scratch of 2 * B * H * S_pad values, S_pad
// = S rounded up to 128; slopes: fp32 [H] ALiBi slopes on the device, or
// null for none; dq [B,S,H,D], dk and dv [B,T,H,D] fp32 contiguous. causal
// is 0 or 1 (then S == T); fault 0 is the kernel, 1-7 its planted faults.
// Launches the pre-pass, the dQ kernel and the dK/dV kernel on `stream`
// (the dQ kernel on a side stream forked from it and joined back); returns
// 0, the cudaError_t of the entry-point query or of the first launch that
// fails, or minus the CUresult of a failed tensor-map encode.
extern "C" int supir_flash_attn_bwd_fp32(const void* q, const void* k, const void* v, const void* o,
                                         const void* dout, const void* lse, void* rows, const void* slopes,
                                         void* dq, void* dk, void* dv, int B, int H, int S, int T, int D, int causal,
                                         const long long* plans, const long long* strides, float scale, int fault,
                                         void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || T <= 0 || (D != 64 && D != 128)) return static_cast<int>(cudaErrorInvalidValue);
  if ((S + ROWS - 1) / ROWS > 65535 || (T + ROWS - 1) / ROWS > 65535) return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled fn;
  const cudaError_t found = encode_tiled(&fn);
  if (found != cudaSuccess) return static_cast<int>(found);
  Maps m;
  const void* ptrs[4] = {q, k, v, dout};
  CUtensorMap* maps[4] = {&m.q, &m.k, &m.v, &m.d};
  MapPos* pos[4] = {&m.qp, &m.kp, &m.vp, &m.dp};
  for (int i = 0; i < 4; ++i) {
    const CUresult r = encode(fn, maps[i], pos[i], ptrs[i], plans + i * PLAN_LEN, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
    if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  }
  const int S_pad = (S + PAD - 1) / PAD * PAD;
  float* lse_rows = static_cast<float*>(rows);
  float* delta_rows = lse_rows + static_cast<long long>(B) * H * S_pad;
  const Args a{lse_rows, delta_rows, static_cast<const float*>(slopes), static_cast<float*>(dq),
               static_cast<float*>(dk), static_cast<float*>(dv), B, H, S, T, S_pad, scale, causal, fault};
  const float* of = static_cast<const float*>(o);
  const float* gf = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64)
    err = slopes ? launch<64, true>(m, a, of, gf, lf, lse_rows, delta_rows, strides, s)
                 : launch<64, false>(m, a, of, gf, lf, lse_rows, delta_rows, strides, s);
  else
    err = slopes ? launch<128, true>(m, a, of, gf, lf, lse_rows, delta_rows, strides, s)
                 : launch<128, false>(m, a, of, gf, lf, lse_rows, delta_rows, strides, s);
  return static_cast<int>(err);
}
