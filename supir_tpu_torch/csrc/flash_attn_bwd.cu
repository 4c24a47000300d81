// K4: flash-attention backward for Hopper (sm_90a), bf16 in/out, optionally
// causal, optionally with ALiBi.
//
// Replaces supir_tpu/ops/flash_attention.py:_bwd_dq_kernel (:499, pallas_call
// :637) and _bwd_dkv_kernel (:539, pallas_call :663), driven by _flash_bwd
// (:592-685), the backward rule of the flash_attention custom_vjp (:305-325),
// with the scores of _bwd_scores (:481-497).
//
// What it computes, from the forward's residuals q, k, v [B,S|T,H,D], o and
// lse [B,H,S] (K3's natural-log logsumexp of the scaled, biased scores) and
// the output gradient dO:
//   P  = exp(scale * Q K^T + bias - lse)   recomputed per tile, never stored
//   delta = rowsum(dO * O)                 a pre-pass, as XLA did it (:608)
//   dS = P * (dO V^T - delta)
//   dQ = scale * dS K,  dK = scale * dS^T Q,  dV = P^T dO
// Keys past T, queries past S and, with `causal` (S == T), keys after the
// query get P = 0. ALiBi (the `alibi` branch of _bwd_scores): with fp32
// slopes [H] (null for none) the recomputed scores get the forward's bias
// back, slope_h * (key - (T - 1)) in scaled units, i.e. slope_h / scale *
// (key - (T - 1)) in the raw q.k units the kernels keep; the bias has no
// gradient, so delta and the products do not change.
//
// What bounds it: operations. The function needs five [S x T x D] products
// (S, dP, dQ, dK, dV); this design does seven, since S and dP are computed
// in both kernels. That is the price of the TPU's split into a dQ kernel
// and a dK/dV kernel, kept here because every output element is then
// written by exactly one block: no atomics, and two runs give the same
// bits. (An fp32 dQ accumulated by atomics across key blocks would save the
// two products and lose that.) Every product is a `wgmma.mma_async` with
// fp32 accumulation (flash_attn_tma.cuh: wgmma_ss, wgmma_rs), every Q, dO,
// K and V tile a `cp.async.bulk.tensor` copy completing on an mbarrier
// (tma_tile); no score tile goes to shared memory.
//
// Both kernels have the forward's block shape (flash_attn_fwd.cu): 384
// threads, warpgroup 0 the producer (one thread issues every TMA copy;
// setmaxnreg takes it to 24 registers), warpgroups 1 and 2 consumers of 64
// owned rows each (raised to 240), a 2-stage ring of streamed tiles with a
// full barrier per operand and an empty barrier per stage (one arrival per
// consumer warp). Both sides of a ring loop over the block's own tile count,
// so the barrier phases hold for blocks of any length. Every TMA box is 64
// rows of one 128-byte swizzle slab (a 128-row tile is two boxes); rows past
// S or T arrive as zeros.
//
// - The pre-pass (flash_bwd_delta_kernel) writes delta and lse * log2 e per
//   query row into [B*H, S_pad] fp32 scratch, S_pad = S rounded up to BLOCK,
//   with delta 0 and lse * log2 e = +inf past S: P is then 0 on padded
//   query rows with no mask, and every 64-row slice is 16-byte aligned, so
//   the dK/dV kernel takes it by a 1-D bulk copy beside its Q and dO tiles.
//   (The lse itself is [B,H,S]: its rows are not 16-byte aligned when S is
//   not a multiple of 4.)
// - flash_bwd_dkv_kernel (4 products): a block owns BLOCK keys of one
//   (b, h); K and V arrive once, then Q and dO tiles of BOX queries stream
//   through the ring, with the tile's lse and delta slices on the Q and dO
//   barriers. Per tile and warpgroup: S^T = K Q^T and dP^T = V dO^T on
//   wgmma m64n64k16 from shared memory, K-major; P^T = exp2(S^T scale log2 e
//   + bias - lse2), the lse indexed by column and the ALiBi bias one
//   constant per accumulator row (the key is the row); dV += P^T dO is
//   issued as soon as P^T is in registers and runs while dS^T = P^T (dP^T -
//   delta) is formed; dK += dS^T Q. Both on the register-A wgmma (the
//   m64n64 accumulator's layout is the A fragment's of four k16 steps), dO
//   and Q read MN-major through the transpose-B bit. Causal: the block
//   starts at the diagonal query tile; a warpgroup skips a tile whose
//   queries all precede its keys; the mask runs only on tiles that cut the
//   diagonal. Registers at D = 128: dK and dV 64 + 64, S^T and dP^T 32 + 32,
//   P^T and dS^T 16 + 16 packed.
// - flash_bwd_dq_kernel (3 products): a block owns BLOCK queries; Q, dO and
//   its rows' lse and delta come in once, K and V tiles of KEYS keys stream
//   through the ring. Per tile: S = Q K^T as the forward, dP = dO V^T (both
//   K-major), dS = P (dP - delta), dQ += dS K on the register-A wgmma with K
//   MN-major. KEYS is 128 at D = 64 and 64 at D = 128, where dQ's 64
//   accumulator registers a thread leave no room for 128-key S and dP.
//   Causal: the block stops at the diagonal tile, query blocks run in
//   reverse order so the heaviest start first; the mask runs on the tiles
//   that cut the diagonal or T.
// - Epilogues: dQ * scale, dK * scale and dV go to bf16 through the
//   warpgroup's own swizzled Q (or K, V) rows in shared memory and out in
//   16-byte vectors; rows past S (or T) are clipped.
// - Launch: the pre-pass, then the dQ kernel on a side stream forked from
//   the caller's and the dK/dV kernel on the caller's, joined after both.
//   Each grid alone (B*H x S/128 blocks, one block per SM) leaves part of
//   its last wave idle; side by side they share the waves.
// Tried on the card and dropped (PERF.md, PR 8): leaving a tile's dK/dV (or
// dQ) products running into the next tile's S and dP (slower at every
// shape), and 128-query tiles in the dK/dV kernel at D = 64 (no gain).
// Later work, not here: a persistent scheduler, fp8, clusters.
//
// Tensor maps: ops/flash_attention.py:tma_plan plans q, k, v and dout at
// BOX rows (MPT's multiquery k/v, expanded over heads with stride 0, drop
// the head axis from the map; dK and dV are then written per head and
// autograd sums over the expand). o, dq, dk and dv keep plain strides.

#include "flash_attn_tma.cuh"

namespace {

constexpr int BLOCK = 128;        // rows a block owns: queries (dQ) or keys (dK/dV), 64 per consumer warpgroup
constexpr int BOX = 64;           // rows of every TMA box and of a streamed Q/dO tile
constexpr int STAGES = 2;         // ring depth
constexpr int THREADS = 384;      // producer warpgroup + two consumer warpgroups
constexpr float LOG2E = 1.4426950408889634f;

// keys per K/V tile of the dQ kernel
template <int D>
struct DqTile {
  static constexpr int KEYS = D == 64 ? 128 : 64;
};

template <int D>
struct DkvSmem {
  static constexpr int SLABS = D / SLAB;
  static constexpr int OWN = SLABS * BLOCK * 128;    // the block's K or V rows
  static constexpr int TILE = SLABS * BOX * 128;     // one streamed Q or dO tile
  static constexpr int K = 0;
  static constexpr int V = K + OWN;
  static constexpr int Q = V + OWN;                  // stage s at Q + s * TILE
  static constexpr int DO = Q + STAGES * TILE;
  static constexpr int LSE = DO + STAGES * TILE;     // fp32 [STAGES][BOX], lse * log2 e of the tile's queries
  static constexpr int DELTA = LSE + STAGES * BOX * 4;
  static constexpr int BAR = DELTA + STAGES * BOX * 4;  // full_kv, full_q[STAGES], full_do[STAGES], empty[STAGES]
  static constexpr int ALLOC = BAR + 8 * (1 + 3 * STAGES) + 1024;  // + slack to align the base to 1024
};

template <int D>
struct DqSmem {
  static constexpr int SLABS = D / SLAB;
  static constexpr int KEYS = DqTile<D>::KEYS;
  static constexpr int OWN = SLABS * BLOCK * 128;    // the block's Q or dO rows
  static constexpr int TILE = SLABS * KEYS * 128;    // one streamed K or V tile
  static constexpr int Q = 0;
  static constexpr int DO = Q + OWN;
  static constexpr int K = DO + OWN;                 // stage s at K + s * TILE
  static constexpr int V = K + STAGES * TILE;
  static constexpr int BAR = V + STAGES * TILE;      // full_own, full_k[STAGES], full_v[STAGES], empty[STAGES]
  static constexpr int ALLOC = BAR + 8 * (1 + 3 * STAGES) + 1024;
};

// the 1024-aligned base of the dynamic shared memory
__device__ __forceinline__ uint32_t aligned_base(unsigned char* raw, unsigned char** aligned) {
  const uint32_t r = smem_u32(raw);
  const uint32_t base = (r + 1023u) & ~1023u;  // the 128-byte swizzle repeats every 1024 bytes
  *aligned = raw + (base - r);
  return base;
}

__device__ __forceinline__ void init_ring(uint32_t bars) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 + 8 * s, 1);
      mbar_init(bars + 8 + 8 * STAGES + 8 * s, 1);
      mbar_init(bars + 8 + 16 * STAGES + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// delta = rowsum(dO * O) and lse2 = lse * log2 e for every query row, into
// [B*H, S_pad] arrays; rows past S get delta 0 and lse2 +inf, so P is 0
// there. D / 8 threads per (b, s, h) row, 16 bytes each, rows in memory
// order (h fastest), so a warp reads 512 contiguous bytes of o and dout.
template <int D>
__global__ void flash_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                                       const float* __restrict__ lse, float* __restrict__ lse2,
                                       float* __restrict__ delta, int H, int S, int S_pad, long long rows,
                                       long long osb, long long oss, long long osh, long long gsb, long long gss,
                                       long long gsh) {
  constexpr int LANES = D / 8;  // threads of a row; a warp holds whole rows
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long r = i / LANES;
  const int c = static_cast<int>(i % LANES) * 8;  // this thread's 8 columns
  const int h = static_cast<int>(r % H);
  const int s = static_cast<int>((r / H) % S_pad);
  const long long b = r / (static_cast<long long>(H) * S_pad);
  float acc = 0.f;
  if (r < rows && s < S) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o + b * osb + s * oss + h * osh + c);
    const uint4 gv = *reinterpret_cast<const uint4*>(dout + b * gsb + s * gss + h * gsh + c);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 a = __bfloat1622float2(o2[k]);
      const float2 g = __bfloat1622float2(g2[k]);
      acc = fmaf(a.x, g.x, fmaf(a.y, g.y, acc));
    }
  }
#pragma unroll
  for (int w = 1; w < LANES; w *= 2) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (r >= rows || c != 0) return;
  const long long at = (b * H + h) * S_pad + s;
  delta[at] = s < S ? acc : 0.f;
  lse2[at] = s < S ? lse[(b * H + h) * S + s] * LOG2E : __int_as_float(0x7f800000);  // +inf
}

// dK and dV: a block owns BLOCK keys of one (b, h) and streams the queries.
template <int D, bool ALIBI>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dmap,
                     MapPos qpos, MapPos kpos, MapPos vpos, MapPos dpos, const float* __restrict__ lse2,
                     const float* __restrict__ delta, const float* __restrict__ slopes, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int S, int T, int S_pad, long long dksb, long long dkss,
                     long long dksh, long long dvsb, long long dvss, long long dvsh, float scale, int causal) {
  using L = DkvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem;
  const uint32_t base = aligned_base(smem_raw, &smem);
  const uint32_t full_kv = base + L::BAR;
  const uint32_t full_q = full_kv + 8, full_do = full_q + 8 * STAGES, empty = full_do + 8 * STAGES;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BLOCK;
  const int q_begin = causal ? k0 : 0;  // causal: earlier queries see none of the block's keys
  const int n_tiles = (S - q_begin + BOX - 1) / BOX;
  init_ring(full_kv);

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_kv, 2 * L::OWN);
      tma_tile<L::SLABS, BLOCK, BOX>(base + L::K, &kmap, kpos, full_kv, k0, h, b);
      tma_tile<L::SLABS, BLOCK, BOX>(base + L::V, &vmap, vpos, full_kv, k0, h, b);
      const float* lrow = lse2 + static_cast<long long>(bh) * S_pad;
      const float* drow = delta + static_cast<long long>(bh) * S_pad;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES, q0 = q_begin + t * BOX;
        mbar_wait(empty + 8 * s, ((t / STAGES) & 1) ^ 1);  // a fresh barrier passes parity 1
        mbar_expect_tx(full_q + 8 * s, L::TILE + BOX * 4);
        tma_tile<L::SLABS, BOX, BOX>(base + L::Q + s * L::TILE, &qmap, qpos, full_q + 8 * s, q0, h, b);
        bulk_copy(base + L::LSE + s * BOX * 4, lrow + q0, BOX * 4, full_q + 8 * s);
        mbar_expect_tx(full_do + 8 * s, L::TILE + BOX * 4);
        tma_tile<L::SLABS, BOX, BOX>(base + L::DO + s * L::TILE, &dmap, dpos, full_do + 8 * s, q0, h, b);
        bulk_copy(base + L::DELTA + s * BOX * 4, drow + q0, BOX * 4, full_do + 8 * s);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup: keys k0 + 64 cw ...
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int first = k0 + 64 * cw;          // the warpgroup's first key
  const int key0 = first + 16 * warp + g;  // this thread's keys (rows): key0 and key0 + 8
  const float scale_log2 = scale * LOG2E;
  // ALiBi: the key is the row, so each of the thread's two rows adds one
  // constant, in raw score units
  const float ab = ALIBI ? slopes[h] / scale : 0.f;
  const float bias0 = ab * static_cast<float>(key0 + 1 - T), bias1 = ab * static_cast<float>(key0 + 9 - T);
  const uint32_t k_rows = base + L::K + cw * 64 * 128, v_rows = base + L::V + cw * 64 * 128;

  float dk_acc[D / 2], dv_acc[D / 2];  // rows key0 (4j, 4j+1) and key0 + 8 (4j+2, 4j+3), cols 8j + 2tq
  float st[32], dpt[32];              // S^T (then P^T) and dP^T, the same layout over the tile's 64 queries
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;

  mbar_wait(full_kv, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const uint32_t parity = (t / STAGES) & 1;
    const int q0 = q_begin + t * BOX;
    const uint32_t q_tile = base + L::Q + s * L::TILE, do_tile = base + L::DO + s * L::TILE;
    mbar_wait(full_q + 8 * s, parity);
    if (causal && q0 + BOX <= first) {  // every query of the tile precedes the warpgroup's keys
      mbar_wait(full_do + 8 * s, parity);
      if (lane == 0) mbar_arrive(empty + 8 * s);
      continue;
    }

    // S^T = K Q^T and dP^T = V dO^T over the head dim, k16 steps of 32 bytes inside each slab
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(st, desc_kmajor(k_rows + (kk / 4) * BLOCK * 128 + (kk % 4) * 32),
               desc_kmajor(q_tile + (kk / 4) * BOX * 128 + (kk % 4) * 32), kk > 0);
    wgmma_commit();
    mbar_wait(full_do + 8 * s, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dpt, desc_kmajor(v_rows + (kk / 4) * BLOCK * 128 + (kk % 4) * 32),
               desc_kmajor(do_tile + (kk / 4) * BOX * 128 + (kk % 4) * 32), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);

    // P^T, the lse indexed by column; padded queries have lse2 = +inf
    const float* lse_s = reinterpret_cast<const float*>(smem + L::LSE + s * BOX * 4);
    const bool diag = causal && q0 < first + 64;  // some query of the tile precedes a key of the warpgroup
    uint32_t pt[16];  // P^T in bf16 pairs; pt[4kk..4kk+3] is the A fragment of queries 16kk..16kk+15
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * tq);
      float p00 = fast_exp2(fmaf(ALIBI ? st[4 * j] + bias0 : st[4 * j], scale_log2, -l.x));
      float p01 = fast_exp2(fmaf(ALIBI ? st[4 * j + 1] + bias0 : st[4 * j + 1], scale_log2, -l.y));
      float p10 = fast_exp2(fmaf(ALIBI ? st[4 * j + 2] + bias1 : st[4 * j + 2], scale_log2, -l.x));
      float p11 = fast_exp2(fmaf(ALIBI ? st[4 * j + 3] + bias1 : st[4 * j + 3], scale_log2, -l.y));
      if (diag) {
        const int col = q0 + 8 * j + 2 * tq;
        if (col < key0) p00 = 0.f;
        if (col + 1 < key0) p01 = 0.f;
        if (col < key0 + 8) p10 = 0.f;
        if (col + 1 < key0 + 8) p11 = 0.f;
      }
      st[4 * j] = p00;
      st[4 * j + 1] = p01;
      st[4 * j + 2] = p10;
      st[4 * j + 3] = p11;
      pt[2 * j] = pack_bf16(p00, p01);
      pt[2 * j + 1] = pack_bf16(p10, p11);
    }

    // dV += P^T dO over the tile's queries (k16 steps of 16 rows, 2048 bytes); it runs while dS^T is formed
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BOX / 16; ++kk) wgmma_rs(dv_acc, pt + 4 * kk, desc_mnmajor(do_tile + kk * 2048, BOX * 128));
    wgmma_commit();
    wgmma_wait<1>();  // dP^T is done; dV may still run
    fence_regs(dpt);

    // dS^T = P^T (dP^T - delta), delta indexed by column
    const float* delta_s = reinterpret_cast<const float*>(smem + L::DELTA + s * BOX * 4);
    uint32_t dst[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d = *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * tq);
      dst[2 * j] = pack_bf16(st[4 * j] * (dpt[4 * j] - d.x), st[4 * j + 1] * (dpt[4 * j + 1] - d.y));
      dst[2 * j + 1] = pack_bf16(st[4 * j + 2] * (dpt[4 * j + 2] - d.x), st[4 * j + 3] * (dpt[4 * j + 3] - d.y));
    }

    // dK += dS^T Q
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BOX / 16; ++kk) wgmma_rs(dk_acc, dst + 4 * kk, desc_mnmajor(q_tile + kk * 2048, BOX * 128));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  // epilogue: dK * scale and dV through the warpgroup's own K and V rows
  store_rows<D>(dk_acc, scale, scale, smem + L::K + cw * 64 * 128, BLOCK * 128, 1 + cw,
                dk + b * dksb + h * dksh + first * dkss, dkss, T - first);
  store_rows<D>(dv_acc, 1.f, 1.f, smem + L::V + cw * 64 * 128, BLOCK * 128, 1 + cw,
                dv + b * dvsb + h * dvsh + first * dvss, dvss, T - first);
}

// dQ: a block owns BLOCK queries of one (b, h) and streams the keys.
template <int D, bool ALIBI>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dmap,
                    MapPos qpos, MapPos kpos, MapPos vpos, MapPos dpos, const float* __restrict__ lse2,
                    const float* __restrict__ delta, const float* __restrict__ slopes, bf16* __restrict__ dq,
                    int H, int S, int T, int S_pad, long long dqsb, long long dqss, long long dqsh, float scale,
                    int causal) {
  using L = DqSmem<D>;
  constexpr int KEYS = L::KEYS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem;
  const uint32_t base = aligned_base(smem_raw, &smem);
  const uint32_t full_own = base + L::BAR;
  const uint32_t full_k = full_own + 8, full_v = full_k + 8 * STAGES, empty = full_v + 8 * STAGES;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BLOCK;  // causal: heaviest first
  const int kv_end = causal ? min(T, q0 + BLOCK) : T;
  const int n_tiles = (kv_end + KEYS - 1) / KEYS;
  init_ring(full_own);

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_own, 2 * L::OWN);
      tma_tile<L::SLABS, BLOCK, BOX>(base + L::Q, &qmap, qpos, full_own, q0, h, b);
      tma_tile<L::SLABS, BLOCK, BOX>(base + L::DO, &dmap, dpos, full_own, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(empty + 8 * s, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(full_k + 8 * s, L::TILE);
        tma_tile<L::SLABS, KEYS, BOX>(base + L::K + s * L::TILE, &kmap, kpos, full_k + 8 * s, t * KEYS, h, b);
        mbar_expect_tx(full_v + 8 * s, L::TILE);
        tma_tile<L::SLABS, KEYS, BOX>(base + L::V + s * L::TILE, &vmap, vpos, full_v + 8 * s, t * KEYS, h, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup: queries q0 + 64 cw ...
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int first = q0 + 64 * cw;          // the warpgroup's first query
  const int row0 = first + 16 * warp + g;  // this thread's queries: row0 and row0 + 8 (< S_pad)
  const float scale_log2 = scale * LOG2E;
  const float ab = ALIBI ? slopes[h] / scale : 0.f;  // ALiBi slope, raw score units
  const long long at = static_cast<long long>(bh) * S_pad + row0;
  const float l0 = lse2[at], l1 = lse2[at + 8], d0 = delta[at], d1 = delta[at + 8];
  const int lim0 = causal ? min(T, row0 + 1) : T;  // keys this thread's rows see
  const int lim1 = causal ? min(T, row0 + 9) : T;
  const uint32_t q_rows = base + L::Q + cw * 64 * 128, do_rows = base + L::DO + cw * 64 * 128;

  float acc[D / 2];                 // dQ: rows row0 (4j, 4j+1) and row0 + 8 (4j+2, 4j+3), cols 8j + 2tq
  float sc[KEYS / 2], dp[KEYS / 2];  // S (then P) and dP, the same layout over the tile's keys
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < KEYS / 2; ++i) sc[i] = dp[i] = 0.f;

  mbar_wait(full_own, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const uint32_t parity = (t / STAGES) & 1;
    const int k0 = t * KEYS;
    const uint32_t k_tile = base + L::K + s * L::TILE, v_tile = base + L::V + s * L::TILE;
    mbar_wait(full_k + 8 * s, parity);
    if (causal && k0 > first + 63) {  // every key of the tile follows the warpgroup's queries
      mbar_wait(full_v + 8 * s, parity);
      if (lane == 0) mbar_arrive(empty + 8 * s);
      continue;
    }

    // S = Q K^T and dP = dO V^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sc, desc_kmajor(q_rows + (kk / 4) * BLOCK * 128 + (kk % 4) * 32),
               desc_kmajor(k_tile + (kk / 4) * KEYS * 128 + (kk % 4) * 32), kk > 0);
    wgmma_commit();
    mbar_wait(full_v + 8 * s, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, desc_kmajor(do_rows + (kk / 4) * BLOCK * 128 + (kk % 4) * 32),
               desc_kmajor(v_tile + (kk / 4) * KEYS * 128 + (kk % 4) * 32), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // P, with the ALiBi bias per column; keys past T or after the query masked
    const bool edge = k0 + KEYS > T || (causal && k0 + KEYS - 1 > first);
    const float c0 = static_cast<float>(k0 + 2 * tq + 1 - T);
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bias = ALIBI ? ab * (c0 + static_cast<float>(8 * j + e)) : 0.f;
        float p0 = fast_exp2(fmaf(ALIBI ? sc[4 * j + e] + bias : sc[4 * j + e], scale_log2, -l0));
        float p1 = fast_exp2(fmaf(ALIBI ? sc[4 * j + 2 + e] + bias : sc[4 * j + 2 + e], scale_log2, -l1));
        if (edge) {
          const int col = k0 + 8 * j + 2 * tq + e;
          if (col >= lim0) p0 = 0.f;
          if (col >= lim1) p1 = 0.f;
        }
        sc[4 * j + e] = p0;
        sc[4 * j + 2 + e] = p1;
      }
    wgmma_wait_all();
    fence_regs(dp);

    // dS = P (dP - delta); ds[4kk..4kk+3] is the A fragment of keys 16kk..16kk+15
    uint32_t ds[KEYS / 4];
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) {
      ds[2 * j] = pack_bf16(sc[4 * j] * (dp[4 * j] - d0), sc[4 * j + 1] * (dp[4 * j + 1] - d0));
      ds[2 * j + 1] = pack_bf16(sc[4 * j + 2] * (dp[4 * j + 2] - d1), sc[4 * j + 3] * (dp[4 * j + 3] - d1));
    }

    // dQ += dS K over the tile's keys, K MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk) wgmma_rs(acc, ds + 4 * kk, desc_mnmajor(k_tile + kk * 2048, KEYS * 128));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  // epilogue: dQ * scale through the warpgroup's own Q rows
  store_rows<D>(acc, scale, scale, smem + L::Q + cw * 64 * 128, BLOCK * 128, 1 + cw,
                dq + b * dqsb + h * dqsh + first * dqss, dqss, S - first);
}

// ------------------------------------------------------------------ host

struct Maps {
  CUtensorMap q, k, v, d;
  MapPos qp, kp, vp, dp;
};

// st: element strides (batch, seq, head) of o, dout, dq, dk, dv
template <int D, bool ALIBI>
cudaError_t launch(const Maps& m, const bf16* o, const bf16* dout, const float* lse, float* rows, const float* slopes,
                   bf16* dq, bf16* dk, bf16* dv, int B, int H, int S, int T, const long long* st, float scale,
                   int causal, cudaStream_t stream) {
  Fork* fork;
  cudaError_t err = device_fork(&fork);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, ALIBI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DqSmem<D>::ALLOC);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D, ALIBI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DkvSmem<D>::ALLOC);
  if (err != cudaSuccess) return err;

  const int S_pad = (S + BLOCK - 1) / BLOCK * BLOCK;
  float* lse2 = rows;
  float* delta = rows + static_cast<long long>(B) * H * S_pad;
  const long long n = static_cast<long long>(B) * S_pad * H;
  flash_bwd_delta_kernel<D><<<static_cast<unsigned>((n * (D / 8) + 255) / 256), 256, 0, stream>>>(
      o, dout, lse, lse2, delta, H, S, S_pad, n, st[0], st[1], st[2], st[3], st[4], st[5]);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = cudaEventRecord(fork->ready, stream)) != cudaSuccess) return err;
  if ((err = cudaStreamWaitEvent(fork->side, fork->ready, 0)) != cudaSuccess) return err;
  flash_bwd_dq_kernel<D, ALIBI><<<dim3(B * H, (S + BLOCK - 1) / BLOCK), THREADS, DqSmem<D>::ALLOC, fork->side>>>(
      m.q, m.k, m.v, m.d, m.qp, m.kp, m.vp, m.dp, lse2, delta, slopes, dq, H, S, T, S_pad, st[6], st[7], st[8],
      scale, causal);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = cudaEventRecord(fork->done, fork->side)) != cudaSuccess) return err;
  flash_bwd_dkv_kernel<D, ALIBI><<<dim3(B * H, (T + BLOCK - 1) / BLOCK), THREADS, DkvSmem<D>::ALLOC, stream>>>(
      m.q, m.k, m.v, m.d, m.qp, m.kp, m.vp, m.dp, lse2, delta, slopes, dk, dv, H, S, T, S_pad, st[9], st[10],
      st[11], st[12], st[13], st[14], scale, causal);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return cudaStreamWaitEvent(stream, fork->done, 0);
}

}  // namespace

// Plain C entry point for ctypes. plans: four tensor-map plans of PLAN_LEN
// values each (q, k, v, dout at BOX rows; ops/flash_attention.py:tma_plan).
// strides: 15 element strides, (batch, seq, head) of o, dout, dq, dk, dv in
// turn; the head dim has stride 1. lse is [B, H, S] fp32 (contiguous);
// rows is fp32 scratch of 2 * B * H * S_pad values, S_pad = S rounded up to
// BLOCK. causal is 0 or 1 (then S == T). slopes: fp32 [H] ALiBi slopes on
// the device, or null for none. Launches the delta pre-pass, the dQ kernel
// and the dK/dV kernel on `stream` (the dQ kernel on a side stream forked
// from it and joined back); returns 0 on success, the cudaError_t
// of the entry-point query or of the first launch that fails, or minus the
// CUresult of a failed tensor-map encode.
extern "C" int supir_flash_attn_bwd_bf16(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                         const void* lse, void* rows, const void* slopes, void* dq, void* dk,
                                         void* dv, int B, int H, int S, int T, int D, int causal,
                                         const long long* plans, const long long* strides, float scale,
                                         void* stream) {
  EncodeTiled fn;
  const cudaError_t found = encode_tiled(&fn);
  if (found != cudaSuccess) return static_cast<int>(found);
  Maps m;
  const void* ptrs[4] = {q, k, v, dout};
  CUtensorMap* maps[4] = {&m.q, &m.k, &m.v, &m.d};
  MapPos* pos[4] = {&m.qp, &m.kp, &m.vp, &m.dp};
  for (int i = 0; i < 4; ++i) {
    const CUresult r = encode(fn, maps[i], pos[i], ptrs[i], plans + i * PLAN_LEN);
    if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  }
  const bf16* ob = static_cast<const bf16*>(o);
  const bf16* gb = static_cast<const bf16*>(dout);
  const float* lb = static_cast<const float*>(lse);
  float* rb = static_cast<float*>(rows);
  const float* sl = static_cast<const float*>(slopes);
  bf16* dqb = static_cast<bf16*>(dq);
  bf16* dkb = static_cast<bf16*>(dk);
  bf16* dvb = static_cast<bf16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 64 && sl) err = launch<64, true>(m, ob, gb, lb, rb, sl, dqb, dkb, dvb, B, H, S, T, strides, scale, causal, s);
  else if (D == 64) err = launch<64, false>(m, ob, gb, lb, rb, sl, dqb, dkb, dvb, B, H, S, T, strides, scale, causal, s);
  else if (D == 128 && sl) err = launch<128, true>(m, ob, gb, lb, rb, sl, dqb, dkb, dvb, B, H, S, T, strides, scale, causal, s);
  else if (D == 128) err = launch<128, false>(m, ob, gb, lb, rb, sl, dqb, dkb, dvb, B, H, S, T, strides, scale, causal, s);
  return static_cast<int>(err);
}
