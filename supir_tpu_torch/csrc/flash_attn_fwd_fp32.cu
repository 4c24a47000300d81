// K1 fp32: the flash-attention forward for Hopper (sm_90a) in fp32, on the
// tensor cores: fp32 q, k, v and output, every product of Q K^T and P V
// taken as three TF32 products (3xTF32) on wgmma, fed by TMA; fp32 running
// max, sum and accumulator; optionally causal.
//
// It replaces supir_tpu/ops/flash_attention.py:_attn_kernel_packed (:35) and
// _attn_kernel_packed_single (:123), launched from _flash_primal (:363), for
// fp32 inputs: the TPU kernels run in the inputs' dtype
// (out_shape=jax.ShapeDtypeStruct(qb.shape, q.dtype), :373), so an engine
// with fp32 parameters (--full_params, --diff_dtype fp32) attends in fp32
// there. flash_attn_fwd.cu is the bf16 instance; this file is its fp32
// twin. The TPU's 128-lane head packing and its single-block variant are
// TPU layout and have no counterpart here.
//
// K3 fp32 is the same kernel with an lse pointer (a runtime argument, not
// an instance: null for K1 fp32): it replaces _attn_kernel (:164) with
// with_lse=True, launched from _flash_fwd_lse (:434, pallas_call :459) for
// fp32 inputs (out_shape q.dtype, :467-470), and also stores each query
// row's natural-log logsumexp of the scaled scores, lse = m scale + ln(l),
// [B, H, S] fp32, as K3 does in flash_attn_fwd.cu. The fp32 ring
// (parallel/ring_attention.py) and the fp32 trainers' FlashAttention
// forward run it; K4 fp32 (flash_attn_bwd_fp32.cu) reads its lse.
//
// K3 ALiBi fp32 is the same kernel with ALiBi (MPT's positional bias: the
// TPU kernel's `alibi` branch, :197-201, with its slopes operand :395-396,
// :456-458), with or without the lse, for fp32 inputs: an MPT at the JAX
// module's default dtype (supir_tpu/captioner/mpt.py:113, :195) runs it at
// every flash site. Given fp32 slopes [H], head h's scores become
// scale * q.k + slope_h * (col - (T - 1)), T the unpadded key length, as
// the TPU kernel computes them (:193-201): the product by the scale and the
// bias' product and sum are each rounded to fp32 there (__fmul_rn,
// __fadd_rn: nvcc may not contract them into one FMA), and the running
// max, the exp2 (its factor log2 e, not scale log2 e) and the lse
// (m + ln(l)) then all run in those scaled units. So the bias enters in the
// running max's units, 3xTF32 leaves it alone (it is added in fp32 after
// the three products), the lse holds the whole bias with its -(T - 1)
// offset (which cancels in O, constant along a row, but not in the lse K4
// reads), and a key masked after the bias is -inf, never finite again.
// ALIBI is a template flag: the instances without it carry no bias code.
// The rounding is the TPU kernel's and the plain version's on purpose: at
// MPT-7B's slopes and T = 2048 the biased scores reach ~1700, where an fp32
// ulp is 1.2e-4, so each score carries a rounding of up to 6e-5 that is
// part of the function the plain version computes. A kernel that rounded
// them otherwise (in raw q.k units, as the bf16 instance adds its bias, or
// relative to the row, exactly) would stand ~1e-5 from the plain version
// in relative L2 at [1,2048,32,128] causal, at K1 fp32's bound, whatever
// its own accuracy (PERF.md §6).
//
// What it computes: O = softmax(Q K^T / sqrt(D)) V over q [B,S,H,D] and
// k/v [B,T,H,D], D 64 or 128, read in place through TMA tensor maps
// (ops/flash_attention.py:tma_plan, 32-column slabs of 128 bytes: views of
// one packed qkv, k/v expanded over heads with stride 0). Keys past T (the
// ragged last tile) are masked; rows past S arrive as zeros and are never
// stored. With `causal` (S == T) query i sees keys 0..i: key tiles wholly
// above a warpgroup's rows are not multiplied, the tiles that cut the
// diagonal are masked per element. Each row's running max m is kept in raw
// q.k units and P = exp2((s - m) * scale * log2 e), as the TPU kernel
// computes it (:84-86); a row with no key yet subtracts 0, so no NaN
// arises; O / max(l, 1e-30) (:114-116).
//
// 3xTF32. The tensor cores take fp32 operands only as TF32 (10 mantissa
// bits: they do not read an fp32 word's low 13 mantissa bits), and one TF32
// product misses the 1e-5 bound that --full_params is held to by some 30x.
// Each operand x is split into hi = x rounded to TF32 (its bits + 0x1000,
// the low 13 cleared: nearest, ties away from zero) and lo = x - hi (exact
// in fp32), and lo too is handed over with its low 13 bits cleared, so
// what the tensor cores read is defined whatever they do with those bits
// (ops/flash_attention.py:flash_fp32_emulate walks exactly this on the
// CPU). A product is lo_a hi_b + hi_a lo_b + hi_a hi_b, the small terms
// first, into one fp32 accumulator; lo_a lo_b (~2^-22 of it) is dropped.
//
// What bounds it: operations, 3 x 4 B H S T D flops at TF32's 495 TFLOP/s
// ([2,4096,10,64]: 0.52 ms; the CUDA-core bound of the first design was
// 1.28 ms); the bytes (q, k, v, out once: 84 MB, 0.025 ms) are far below.
// Beside the products every score takes an exp2 (B H S T of them, 16 a
// clock an SM: a sixth of the bound) and a split, and every K and V
// element a split in shared memory, so the CUDA-core work is kept to
// integer add-and-mask and runs on warps apart from the products:
// - Block: BM query rows of one (batch, head), 128 at D = 64 (two consumer
//   warpgroups of 64 rows), 64 at D = 128 (one), and a producer warpgroup
//   in front. Key tiles of BN keys: 64 at D = 64, 32 at D = 128, so every
//   tile (BN x D fp32) is 16 KB and Q (BM x D) 32 KB at either head dim.
// - Producer warpgroup (setmaxnreg 120): thread 0 issues every TMA copy,
//   all 128 threads split. Q lands once (128-byte swizzle) and is split in
//   place: hi over the raw words, lo into a second tile at the same
//   swizzled places. K and V of one tile land raw in one landing buffer;
//   the splitters read it into registers (8 float4 of K and 32 words of V a
//   thread), free it (each fences its reads against the async proxy, then
//   a named barrier, then thread 0 issues the next tile's copy, which lands
//   while they write), and write a ring of two stages, each K hi, K lo,
//   V^T hi and V^T lo; every thread fences its writes to the async proxy
//   and arrives on the stage's "ready" barrier. The consumers' 4 or 8 warps
//   arrive on its "empty" barrier when their products are done with it.
// - TF32 wgmma takes K-major operands only (the transpose bits exist for
//   16-bit types alone). Q (A) and K (B of S = Q K^T) are K-major as
//   stored; V, the B of O += P V, is not, so the splitters write V^T
//   [D][keys] (32-key slabs of 128-byte rows, the 128-byte swizzle).
// - The fragment permutation. S's accumulator gives lane (g, t) of a warp
//   the columns 2t and 2t + 1 of every 8-column group (rows g and g + 8);
//   the TF32 A operand from registers wants k-indices t and t + 4 of every
//   k8 step. So slot p of each 8-key group of a V^T row holds key
//   VT_KEY[p] = 2 (p % 4) + p / 4: a lane's score of key 2t meets V^T's
//   slot t, that of key 2t + 1 slot t + 4, and P goes from the accumulator
//   to the A fragment without an exchange. The split pass writes V^T in
//   that order at no cost. Its lanes are laid out so that every read of
//   raw V and every write of V^T hits 32 distinct banks: lane (s4, d4, z)
//   of warp w (s4 = lane % 4, d4 = lane / 4 % 4, z = lane / 16) writes
//   16-byte chunk c = w ^ 5z of V^T's row d = 4 i + d4 at word s4, for
//   i = 0 .. D/4 - 1 and each 32-key slab.
// - Consumers (setmaxnreg 192 at D = 64, 240 at D = 128): S = Q K^T,
//   wgmma m64nBNk8 with both operands in shared memory, 3 D/8 products; the
//   online softmax on S's fragment (a row's max over its four lanes, two
//   shuffles; the sum per lane until the end); the masks only on the tiles
//   that cut T or the diagonal; P split in registers straight into the A
//   fragment's order; P V, wgmma m64nDk8 with A from registers, 3 BN/8
//   products into a fresh accumulator while O, in registers, is rescaled;
//   then O += P V in fp32 adds, so the tensor cores' sums never run over
//   more than one tile's keys.
// - Shared memory, either head dim: Q hi and lo 64 KB, the landing buffer
//   32 KB, two stages of 64 KB: 224 KB, one block an SM.
// - Epilogue: O / max(l, 1e-30) from registers in 8-byte stores (each
//   32-byte sector whole), rows past S clipped.
// - Grid: B*H x ceil(S/BM), query blocks in reverse order when causal (the
//   heaviest first).
// Two runs are bit-identical: every sum has a fixed order.
//
// Chosen by measurement on an H100 (PERF.md §6; chip_smoke.py
// [kernels] K1 fp32 and tools/flash_fp32_ab.py): the tiles are the largest
// whose Q, landing buffer and two split stages fit one block's 227 KB; a
// third stage does not fit. The landing buffer frees each raw tile as soon
// as it is in registers, so the next copy overlaps the split. The fresh P V
// accumulator costs ~4 % of the time and keeps O within 6e-7 of an fp64
// reference at T = 6144; O accumulated in the tensor cores across every
// tile strayed by 7e-6 at T = 1024 and 4.3e-5 at 6144. The kernel reads
// 45-58 % of the 3xTF32 bound at the restore's shapes, 2.4-3.0x SDPA
// fp32's speed; what likely paces it is S's wgmma, both operands from
// shared memory at N = 64 (128 bytes a clock at the TF32 rate, the SM's
// whole shared-memory bandwidth), beside the split pass' traffic. Taking
// S's issue in turns between the two consumer warpgroups (ping-pong on
// named barriers) measured 0.5-2.7 % faster, within a call's spread, and
// is left out. The D = 128 instance (one consumer warpgroup, 32-key
// tiles) runs on no path.
//
// FAULT instantiations exist for planted faults only (checks): 1 the
// accumulator is not rescaled when the max rises, 2 the ragged last key tile
// is not masked, 3 the causal diagonal is not masked, 4 S on one product
// (hi hi: plain TF32), 5 P V without V's lo part, 6 V^T written in key
// order (without the fragment permutation), 7 the lse in log2 units; with
// ALIBI only: 8 the bias added to the raw q.k (before the scale: the slope
// left in the wrong units), 9 the -(T - 1) offset dropped (O as it was in
// exact arithmetic, the lse off by slope_h (T - 1)).

#include <climits>
#include <math.h>

#include "flash_attn_tma.cuh"
#include "flash_attn_tf32.cuh"

namespace {

constexpr int STAGES = 2;          // split K / V^T stages
constexpr int PRODUCER_REGS = 120;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Tiles {
  static constexpr int BM = D == 64 ? 128 : 64;  // query rows per block
  static constexpr int BN = D == 64 ? 64 : 32;   // keys per K/V tile
  static constexpr int CW = BM / 64;             // consumer warpgroups
  static constexpr int THREADS = 128 * (1 + CW);
  // the block's registers stay within 64,512 of the SM's 65,536 (as 384 x 168 at launch): a larger
  // request never completes
  static constexpr int CONSUMER_REGS = D == 64 ? 192 : 240;  // 128 x 120 + 256 x 192 = 64,512
  static constexpr int SLABS = D / FP32_SLAB;
  static constexpr int QT = BM * D * 4;          // bytes of Q's hi (or lo) tile
  static constexpr int KT = BN * D * 4;          // bytes of one K or V tile (raw, hi or lo)
  static constexpr int Q_HI = 0;
  static constexpr int Q_LO = QT;
  static constexpr int LAND = 2 * QT;            // raw K, then raw V, of the next tile
  static constexpr int RING = LAND + 2 * KT;     // stage s at RING + s * STAGE: K hi, K lo, V^T hi, V^T lo
  static constexpr int STAGE = 4 * KT;
  static constexpr int BAR = RING + STAGES * STAGE;  // q_full, q_ready, land_full, ready[STAGES], empty[STAGES]
  static constexpr int ALLOC = BAR + 8 * (3 + 2 * STAGES) + 1024;  // + slack to align the base to 1024
  static_assert(ALLOC <= 232448, "one block's shared memory");
};

// ALiBi: a raw score s as the softmax of the ALiBi instance sees it, scale
// s + bias with each step rounded to fp32 (FAULT 8: the bias added to the
// raw score, then scaled)
template <int FAULT>
__device__ __forceinline__ float alibi_score(float s, float scale, float bias) {
  return FAULT == 8 ? __fmul_rn(__fadd_rn(s, bias), scale) : __fadd_rn(__fmul_rn(s, scale), bias);
}

template <int D, int FAULT, bool ALIBI>
__global__ void __launch_bounds__(Tiles<D>::THREADS, 1)
flash_fwd_fp32_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, MapPos qpos, MapPos kpos, MapPos vpos,
                      float* __restrict__ o, float* __restrict__ lse, const float* __restrict__ slopes, int H,
                      int S, int T, long long osb, long long oss, long long osh, float scale, float scale_log2,
                      int causal) {
  using L = Tiles<D>;
  constexpr int BM = L::BM, BN = L::BN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the 128-byte swizzle repeats every 1024 bytes
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t q_full = base + L::BAR, q_ready = q_full + 8, land_full = q_full + 16;
  const uint32_t ready = q_full + 24, empty = ready + 8 * STAGES;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BM;
  const int kv_end = causal ? min(T, q0 + BM) : T;
  const int n_tiles = (kv_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_ready, 128);
    mbar_init(land_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(ready + 8 * s, 128);        // every splitter thread
      mbar_init(empty + 8 * s, 4 * L::CW);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: thread 0 copies, all 128 split
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    const int tid = threadIdx.x;
    if (tid == 0) {
      mbar_expect_tx(q_full, L::QT);
      tma_tile<L::SLABS, BM, BM, FP32_SLAB>(base + L::Q_HI, &qmap, qpos, q_full, q0, h, b);
      mbar_expect_tx(land_full, 2 * L::KT);
      tma_tile<L::SLABS, BN, BN, FP32_SLAB>(base + L::LAND, &kmap, kpos, land_full, 0, h, b);
      tma_tile<L::SLABS, BN, BN, FP32_SLAB>(base + L::LAND + L::KT, &vmap, vpos, land_full, 0, h, b);
    }
    // Q: hi over the raw words, lo at the same places of the second tile
    mbar_wait(q_full, 0);
    for (int i = tid; i < L::QT / 16; i += 128) {
      uint4 hi, lo;
      tf32_split4(*reinterpret_cast<const float4*>(smem + L::Q_HI + 16 * i), hi, lo);
      *reinterpret_cast<uint4*>(smem + L::Q_HI + 16 * i) = hi;
      *reinterpret_cast<uint4*>(smem + L::Q_LO + 16 * i) = lo;
    }
    fence_to_async();
    mbar_arrive(q_ready);

    // V^T: lane (s4, d4, z) of warp w takes chunk c = w ^ 5z (words
    // s4) of rows d = 4 i + d4, i < D/4, of each 32-key slab: the keys of
    // slot 4 c + s4 of the slab, VT_KEY order (FAULT 6: key order)
    const int lane = tid % 32, s4 = lane & 3, d4 = (lane >> 2) & 3;
    const int c = (tid / 32) ^ (5 * (lane >> 4));
    const int key = FAULT == 6 ? 4 * c + s4 : 8 * (c >> 1) + 2 * s4 + (c & 1);  // in its slab
    const int k7 = key & 7;                         // the raw V row's swizzle phase
    constexpr int V_ITEMS = L::KT / 4 / 128;        // 32 words of V a thread
    constexpr int K_ITEMS = L::KT / 16 / 128;       // 8 float4 of K a thread
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      mbar_wait(land_full, t & 1);
      float4 kr[K_ITEMS];
      float vr[V_ITEMS];
#pragma unroll
      for (int j = 0; j < K_ITEMS; ++j) kr[j] = *reinterpret_cast<const float4*>(smem + L::LAND + 16 * (tid + 128 * j));
#pragma unroll
      for (int it = 0; it < V_ITEMS; ++it) {
        const int i = it % (D / 4), ks = it / (D / 4);  // row group of V^T (d = 4 i + d4), key slab
        // raw V [BN][D]: slab (4 i) / 32 of 32 columns, row 32 ks + key, 16-byte chunk i % 8 swizzled
        vr[it] = *reinterpret_cast<const float*>(smem + L::LAND + L::KT + (i / 8) * BN * 128 + (32 * ks + key) * 128 +
                                                 (((i % 8) ^ k7) << 4) + 4 * d4);
      }
      // every splitter has read the landing buffer: its reads ordered before
      // the next copy's writes, which come through the async proxy (without
      // the fence the copy overtook some of them on the card)
      fence_to_async();
      producer_sync();
      if (tid == 0 && t + 1 < n_tiles) {
        mbar_expect_tx(land_full, 2 * L::KT);
        tma_tile<L::SLABS, BN, BN, FP32_SLAB>(base + L::LAND, &kmap, kpos, land_full, (t + 1) * BN, h, b);
        tma_tile<L::SLABS, BN, BN, FP32_SLAB>(base + L::LAND + L::KT, &vmap, vpos, land_full, (t + 1) * BN, h, b);
      }
      mbar_wait(empty + 8 * s, ((t / STAGES) & 1) ^ 1);  // a fresh barrier passes parity 1
      unsigned char* st = smem + L::RING + s * L::STAGE;
#pragma unroll
      for (int j = 0; j < K_ITEMS; ++j) {
        uint4 hi, lo;
        tf32_split4(kr[j], hi, lo);
        *reinterpret_cast<uint4*>(st + 16 * (tid + 128 * j)) = hi;
        *reinterpret_cast<uint4*>(st + L::KT + 16 * (tid + 128 * j)) = lo;
      }
#pragma unroll
      for (int it = 0; it < V_ITEMS; ++it) {
        const int i = it % (D / 4), ks = it / (D / 4);
        const int d = 4 * i + d4;
        // V^T [D][BN]: slab ks of 32 keys, row d, chunk c swizzled, word s4
        const int at = ks * D * 128 + d * 128 + ((c ^ (d & 7)) << 4) + 4 * s4;
        uint32_t hi, lo;
        tf32_split(vr[it], hi, lo);
        *reinterpret_cast<uint32_t*>(st + 2 * L::KT + at) = hi;
        *reinterpret_cast<uint32_t*>(st + 3 * L::KT + at) = lo;
      }
      fence_to_async();
      mbar_arrive(ready + 8 * s);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::CONSUMER_REGS) : "memory");
  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup: rows q0 + 64 cw ...
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int first = q0 + 64 * cw;          // the warpgroup's first row
  const int row0 = first + 16 * warp + g;  // this thread's rows: row0 and row0 + 8
  // the keys a row sees: those below T (FAULT 2: every key loaded) and, with
  // `causal`, up to the row (FAULT 3: past it too)
  const int t_lim = FAULT == 2 ? INT_MAX : T;
  const int lim0 = causal && FAULT != 3 ? min(t_lim, row0 + 1) : t_lim;
  const int lim1 = causal && FAULT != 3 ? min(t_lim, row0 + 9) : t_lim;
  // causal: the tiles past the warpgroup's last row are not multiplied
  const int wg_tiles = causal ? (min(T, first + 64) + BN - 1) / BN : n_tiles;
  const uint32_t q_hi = base + L::Q_HI + cw * 64 * 128, q_lo = base + L::Q_LO + cw * 64 * 128;
  // ALiBi: the head's slope, and the softmax in scaled units (exp2's factor
  // log2 e); without it the softmax runs in raw q.k units (scale log2 e)
  const float slope = ALIBI ? slopes[h] : 0.f;
  const float unit_log2 = ALIBI ? LOG2E : scale_log2;

  float acc[D / 2];  // O: rows row0 (acc[4j], acc[4j+1]) and row0 + 8 (acc[4j+2], acc[4j+3]), cols 8j + 2tq
  float sc[BN / 2];  // S, the same layout over the tile's keys
  uint32_t ph[BN / 2], pl[BN / 2];  // P's TF32 pair, A fragments: k8 step j at [4j, 4j + 4)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, raw score units (ALiBi: scaled)
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the running sum

  mbar_wait(q_ready, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(ready + 8 * s, (t / STAGES) & 1);
    if (t < wg_tiles) {
      const int k0 = t * BN;
      const uint32_t k_hi = base + L::RING + s * L::STAGE, k_lo = k_hi + L::KT;
      const uint32_t v_hi = k_lo + L::KT, v_lo = v_hi + L::KT;

      // S = Q K^T over the head dim, k8 steps of 32 bytes inside each slab
      wgmma_fence();
      if (FAULT != 4) {
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk)
          wgmma_tf32(sc, desc_kmajor(q_lo + (kk / 4) * BM * 128 + (kk % 4) * 32),
                     desc_kmajor(k_hi + (kk / 4) * BN * 128 + (kk % 4) * 32), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk)
          wgmma_tf32(sc, desc_kmajor(q_hi + (kk / 4) * BM * 128 + (kk % 4) * 32),
                     desc_kmajor(k_lo + (kk / 4) * BN * 128 + (kk % 4) * 32), 1);
      }
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
        wgmma_tf32(sc, desc_kmajor(q_hi + (kk / 4) * BM * 128 + (kk % 4) * 32),
                   desc_kmajor(k_hi + (kk / 4) * BN * 128 + (kk % 4) * 32), FAULT != 4 || kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      if (ALIBI) {  // the bias before the masks, so a masked key stays -inf (FAULT 9: no -(T - 1))
        const int c0 = k0 + 2 * tq - (FAULT == 9 ? 0 : T - 1);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float bias = __fmul_rn(slope, static_cast<float>(c0 + 8 * j + e));
            sc[4 * j + e] = alibi_score<FAULT>(sc[4 * j + e], scale, bias);
            sc[4 * j + 2 + e] = alibi_score<FAULT>(sc[4 * j + 2 + e], scale, bias);
          }
      }
      if ((FAULT != 2 && k0 + BN > T) || (causal && FAULT != 3 && k0 + BN - 1 > first)) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + 8 * j + 2 * tq + e;
            if (col >= lim0) sc[4 * j + e] = -INFINITY;
            if (col >= lim1) sc[4 * j + 2 + e] = -INFINITY;
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
      const float sub0 = mx0 == -INFINITY ? 0.f : mx0;  // a row with no key yet: every p is 0
      const float sub1 = mx1 == -INFINITY ? 0.f : mx1;
      const float corr0 = exp2f((m0 - sub0) * unit_log2), corr1 = exp2f((m1 - sub1) * unit_log2);
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float p00 = exp2f((sc[4 * j] - sub0) * unit_log2);
        const float p01 = exp2f((sc[4 * j + 1] - sub0) * unit_log2);
        const float p10 = exp2f((sc[4 * j + 2] - sub1) * unit_log2);
        const float p11 = exp2f((sc[4 * j + 3] - sub1) * unit_log2);
        sum0 += p00 + p01;
        sum1 += p10 + p11;
        // k-indices tq and tq + 4 of rows g and g + 8 are keys 2 tq and 2 tq + 1 (VT_KEY)
        tf32_split(p00, ph[4 * j], pl[4 * j]);
        tf32_split(p10, ph[4 * j + 1], pl[4 * j + 1]);
        tf32_split(p01, ph[4 * j + 2], pl[4 * j + 2]);
        tf32_split(p11, ph[4 * j + 3], pl[4 * j + 3]);
      }
      l0 = l0 * corr0 + sum0;
      l1 = l1 * corr1 + sum1;

      // P V of the tile's keys into a fresh accumulator, k8 steps of 32 bytes
      // inside each slab of V^T; O takes it in fp32 adds
      float pv[D / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk)
        wgmma_tf32_rs(pv, pl + 4 * kk, desc_kmajor(v_hi + (kk / 4) * D * 128 + (kk % 4) * 32), kk > 0);
      if (FAULT != 5) {
#pragma unroll
        for (int kk = 0; kk < BN / 8; ++kk)
          wgmma_tf32_rs(pv, ph + 4 * kk, desc_kmajor(v_lo + (kk / 4) * D * 128 + (kk % 4) * 32), 1);
      }
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk)
        wgmma_tf32_rs(pv, ph + 4 * kk, desc_kmajor(v_hi + (kk / 4) * D * 128 + (kk % 4) * 32), 1);
      wgmma_commit();
      if (FAULT != 1) {  // O's rescale runs beside the products
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j] *= corr0;
          acc[4 * j + 1] *= corr0;
          acc[4 * j + 2] *= corr1;
          acc[4 * j + 3] *= corr1;
        }
      }
      wgmma_wait_all();
      fence_regs(pv);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] += pv[i];
    }
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  // epilogue: the row sums over the four lanes of a row, O normalised, the
  // rows below S stored
#pragma unroll
  for (int w = 1; w < 4; w *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  const float n0 = fmaxf(l0, 1e-30f), n1 = fmaxf(l1, 1e-30f);
  float* out = o + b * osb + h * osh + 2 * tq;
  if (row0 < S) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(out + row0 * oss + 8 * j) = make_float2(acc[4 * j] / n0, acc[4 * j + 1] / n0);
  }
  if (row0 + 8 < S) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(out + (row0 + 8) * oss + 8 * j) =
          make_float2(acc[4 * j + 2] / n1, acc[4 * j + 3] / n1);
  }
  // K3 fp32: lse = m scale + ln(l) in natural-log units of the scaled
  // scores (ALiBi: m is in those units already, lse = m + ln(l)), one lane
  // of each row's quad stores it (FAULT 7: log2 units)
  if (lse != nullptr && tq == 0) {
    constexpr float LN2 = 0.6931471805599453f;
    float* lrow = lse + static_cast<long long>(bh) * S;
    if (ALIBI) {
      if (row0 < S) lrow[row0] = m0 + logf(n0);
      if (row0 + 8 < S) lrow[row0 + 8] = m1 + logf(n1);
    } else if (FAULT == 7) {
      if (row0 < S) lrow[row0] = m0 * scale_log2 + log2f(n0);
      if (row0 + 8 < S) lrow[row0 + 8] = m1 * scale_log2 + log2f(n1);
    } else {
      if (row0 < S) lrow[row0] = m0 * scale_log2 * LN2 + logf(n0);
      if (row0 + 8 < S) lrow[row0 + 8] = m1 * scale_log2 * LN2 + logf(n1);
    }
  }
}

// ------------------------------------------------------------------ host

struct Maps {
  CUtensorMap q, k, v;
  MapPos qp, kp, vp;
};

// the kernel's arguments past the tensor maps
struct Args {
  float* o;
  float* lse;
  const float* slopes;
  int B, H, S, T;
  long long ost[3];
  float scale, scale_log2;
  int causal;
};

template <int D, int FAULT, bool ALIBI>
cudaError_t launch(const Maps& m, const Args& a, cudaStream_t stream) {
  using L = Tiles<D>;
  const cudaError_t err = cudaFuncSetAttribute(flash_fwd_fp32_kernel<D, FAULT, ALIBI>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, L::ALLOC);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.S + L::BM - 1) / L::BM);
  flash_fwd_fp32_kernel<D, FAULT, ALIBI><<<grid, L::THREADS, L::ALLOC, stream>>>(
      m.q, m.k, m.v, m.qp, m.kp, m.vp, a.o, a.lse, a.slopes, a.H, a.S, a.T, a.ost[0], a.ost[1], a.ost[2], a.scale,
      a.scale_log2, a.causal);
  return cudaGetLastError();
}

// the instances: without ALiBi the kernel and faults 1-7, with it (slopes
// given) the kernel and faults 8 and 9; any other pairing is refused
template <int D>
cudaError_t dispatch(const Maps& m, const Args& a, int fault, cudaStream_t s) {
  if ((a.S + Tiles<D>::BM - 1) / Tiles<D>::BM > 65535) return cudaErrorInvalidValue;
  if (a.slopes != nullptr) {
    switch (fault) {
      case 0: return launch<D, 0, true>(m, a, s);
      case 8: return launch<D, 8, true>(m, a, s);
      case 9: return launch<D, 9, true>(m, a, s);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (fault) {
    case 0: return launch<D, 0, false>(m, a, s);
    case 1: return launch<D, 1, false>(m, a, s);
    case 2: return launch<D, 2, false>(m, a, s);
    case 3: return launch<D, 3, false>(m, a, s);
    case 4: return launch<D, 4, false>(m, a, s);
    case 5: return launch<D, 5, false>(m, a, s);
    case 6: return launch<D, 6, false>(m, a, s);
    case 7: return launch<D, 7, false>(m, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace {

// both entry points: lse null for K1 fp32, slopes null for no ALiBi
int forward(const void* q, const void* k, const void* v, void* o, float* lse, const void* slopes, int B, int H, int S,
            int T, int D, int causal, const long long* plans, long long osb, long long oss, long long osh,
            float scale, int fault, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || T <= 0 || (D != 64 && D != 128)) return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled fn;
  const cudaError_t found = encode_tiled(&fn);
  if (found != cudaSuccess) return static_cast<int>(found);
  Maps m;
  const void* ptrs[3] = {q, k, v};
  CUtensorMap* maps[3] = {&m.q, &m.k, &m.v};
  MapPos* pos[3] = {&m.qp, &m.kp, &m.vp};
  for (int i = 0; i < 3; ++i) {
    const CUresult r = encode(fn, maps[i], pos[i], ptrs[i], plans + i * PLAN_LEN, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
    if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  }
  const Args a{static_cast<float*>(o), lse, static_cast<const float*>(slopes), B, H, S, T, {osb, oss, osh}, scale,
               scale * LOG2E, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = D == 64 ? dispatch<64>(m, a, fault, s) : dispatch<128>(m, a, fault, s);
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry point for ctypes: fp32 q [B,S,H,D], k/v [B,T,H,D], o
// [B,S,H,D]. slopes: fp32 [H] ALiBi slopes on the device, or null for none.
// plans: three tensor-map plans of PLAN_LEN values each (q, k, v;
// ops/flash_attention.py:tma_plan of fp32 operands: 32-column boxes of BM
// rows for q, BN for k and v); o's strides in elements (batch, seq, head;
// the head dim has stride 1, o 8-byte aligned). causal is 0 or 1 (then
// S == T). fault 0 is the kernel, 1-6 its planted faults without ALiBi, 8
// and 9 with it. Returns 0, a cudaError_t, or minus the CUresult of a
// failed tensor-map encode.
extern "C" int supir_flash_attn_fwd_fp32(const void* q, const void* k, const void* v, void* o, const void* slopes,
                                         int B, int H, int S, int T, int D, int causal, const long long* plans,
                                         long long osb, long long oss, long long osh, float scale, int fault,
                                         void* stream) {
  return forward(q, k, v, o, nullptr, slopes, B, H, S, T, D, causal, plans, osb, oss, osh, scale, fault, stream);
}

// K3 fp32: the same, and lse [B, H, S] fp32 (contiguous) receives each
// query row's natural-log logsumexp of the scaled (and ALiBi-biased)
// scores; fault 7 writes it in log2 units.
extern "C" int supir_flash_attn_fwd_lse_fp32(const void* q, const void* k, const void* v, void* o, void* lse,
                                             const void* slopes, int B, int H, int S, int T, int D, int causal,
                                             const long long* plans, long long osb, long long oss, long long osh,
                                             float scale, int fault, void* stream) {
  return forward(q, k, v, o, static_cast<float*>(lse), slopes, B, H, S, T, D, causal, plans, osb, oss, osh, scale,
                 fault, stream);
}
