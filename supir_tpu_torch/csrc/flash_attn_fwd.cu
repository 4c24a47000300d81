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
// code encodes them with cuTensorMapEncodeTiled, fetched at run time
// through cudaGetDriverEntryPoint (no -lcuda link; flash_attn_tma.cuh, with
// the barrier, copy and wgmma helpers the backward shares), and passes
// them as __grid_constant__ kernel parameters.

#include "flash_attn_tma.cuh"

namespace {

constexpr int BM = 128;                  // query rows per block
constexpr int BN = 128;                  // keys per K/V tile
constexpr int SLAB_BYTES = 128 * 128;    // one slab of a 128-row tile
constexpr int STAGES = 2;                // K/V ring depth
constexpr int THREADS = 384;             // producer warpgroup + two consumer warpgroups
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
      tma_tile<L::SLABS, BM, BM>(base + L::Q, &qmap, qpos, full_q, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(empty + 8 * s, ((t / STAGES) & 1) ^ 1);  // a fresh barrier passes parity 1
        mbar_expect_tx(full_k + 8 * s, L::TILE);
        tma_tile<L::SLABS, BN, BN>(base + L::K + s * L::TILE, &kmap, kpos, full_k + 8 * s, t * BN, h, b);
        mbar_expect_tx(full_v + 8 * s, L::TILE);
        tma_tile<L::SLABS, BN, BN>(base + L::V + s * L::TILE, &vmap, vpos, full_v + 8 * s, t * BN, h, b);
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
      wgmma_ss(sc, desc_kmajor(q_rows + off), desc_kmajor(k_tile + off), kk > 0);
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
    for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs(acc, p + 4 * kk, desc_mnmajor(v_tile + kk * 16 * 128, SLAB_BYTES));
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
  store_rows<D>(acc, inv0, inv1, smem + L::Q + cw * 64 * 128, SLAB_BYTES, 1 + cw, o + b * osb + h * osh + first * oss,
                oss, S - first);
  if (WITH_LSE && tq == 0) {
    constexpr float LN2 = 0.6931471805599453f;
    float* lrow = lse + static_cast<long long>(bh) * S;
    if (row0 < S) lrow[row0] = m0 * scale_log2 * LN2 + logf(fmaxf(l0, 1e-30f));
    if (row0 + 8 < S) lrow[row0 + 8] = m1 * scale_log2 * LN2 + logf(fmaxf(l1, 1e-30f));
  }
}

// ------------------------------------------------------------------ host

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
