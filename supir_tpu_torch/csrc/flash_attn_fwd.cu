// K1 and K3: flash-attention forward for Hopper (sm_90a), bf16 in/out,
// optionally causal; K3 also writes the row logsumexp.
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
// k/v [B,T,H,D], read in place through their strides (the innermost dim
// must be contiguous), with fp32 running max, sum and accumulator. Keys past
// T (the ragged last tile) are masked out. With `causal` (the TPU kernels'
// `causal` flag, reached from _flash_primal :350,356), query row i sees keys
// 0..i only: key tiles wholly above the diagonal are skipped, and the tile
// on it is masked per row.
//
// What bounds it: at the main path's shapes ([2,4096,10,64] and
// [2,1024,20,64]) attention is compute-bound (S*T*D multiply-adds against
// S*D loads), so the score and PV products run on the tensor cores through
// nvcuda::wmma bf16 fragments with fp32 accumulation. The softmax between
// them is CUDA-core work on an fp32 score tile in shared memory.
//
// Design: one block of 4 warps per (64-query tile, batch*head). The block
// loops over 64-key tiles of K and V staged in shared memory; that loop
// replaces the TPU's sequential kv grid axis, and nothing is carried between
// blocks. Each warp owns 16 query rows; two lanes share a row (32 columns
// each) for the softmax, so the row max and sum need one shuffle. exp2 with
// the scale folded into the exponent, as on the TPU. The output accumulator
// lives in registers in the same (row, half) layout: each tile's P V product
// goes through the warp's slice of the score buffer and is folded in as
// acc = acc * corr + pv. No wgmma, TMA or cp.async yet: correctness first.
//
// ALiBi (MPT's positional bias, the TPU kernel's `alibi` branch, :197-201,
// with its slopes operand :395-396, :456-458): given fp32 slopes [H], head h
// adds slope_h * (col - (T - 1)) to its scaled scores, T the unpadded key
// length, causal or not; null slopes add nothing. The running max stays in
// raw q.k units, so the bias enters as slope_h / scale * (col - (T - 1)):
// the max, the sum and the lse then all see the biased scores, and the lse
// written is the natural-log logsumexp of the biased scaled scores. The
// offset -(T - 1) cancels in O (it is constant along a row) but not in the
// lse, which the backward reads. Slope index = blockIdx.y % H, as the TPU
// kernel tiles the slopes over the batch (:396). ALIBI is a template flag,
// so the kernels without it are K1's and K3's code unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;           // query rows per block
constexpr int BN = 64;           // key rows per tile
constexpr int WARPS = BM / 16;   // one warp per 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr int PAD_H = 8;         // bf16 row padding: 16 bytes, keeps wmma's 32-byte alignment
constexpr int PAD_F = 4;         // fp32 row padding
constexpr float NEG_INF = -1e30f;

template <int D>
struct Layout {
  static constexpr int LDH = D + PAD_H;                    // Q, K, V rows (bf16)
  static constexpr int LDP = BN + PAD_H;                   // P rows (bf16)
  static constexpr int LDS = (D > BN ? D : BN) + PAD_F;    // scores / PV rows (fp32)
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + sizeof(bf16) * BM * LDH;
  static constexpr size_t V = K + sizeof(bf16) * BN * LDH;
  static constexpr size_t P = V + sizeof(bf16) * BN * LDH;
  static constexpr size_t S = P + sizeof(bf16) * BM * LDP;
  static constexpr size_t BYTES = S + sizeof(float) * BM * LDS;
};

// Copy `rows` rows of D contiguous bf16 (row r at src + r * row_stride) into
// a [64][LDH] shared tile with 16-byte vectors; rows past `valid` are zero.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int valid,
                                          long long row_stride, int tid) {
  constexpr int VEC = 8;
  constexpr int VPR = D / VEC;
  for (int i = tid; i < BN * VPR; i += THREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * Layout<D>::LDH + c) = val;
  }
}

template <int D, bool WITH_LSE, bool ALIBI>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, const float* __restrict__ slopes, int H, int S, int T,
                 long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh,
                 long long osb, long long oss, long long osh,
                 float scale_log2, int causal) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* sk = reinterpret_cast<bf16*>(smem + L::K);
  bf16* sv = reinterpret_cast<bf16*>(smem + L::V);
  bf16* sp = reinterpret_cast<bf16*>(smem + L::P);
  float* ss = reinterpret_cast<float*>(smem + L::S);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * BM;

  const bf16* qp = q + b * qsb + h * qsh + q0 * qss;
  const bf16* kp = k + b * ksb + h * ksh;
  const bf16* vp = v + b * vsb + h * vsh;
  load_tile<D>(sq, qp, min(BM, S - q0), qss, tid);

  // this lane's query row (block-local) and which half of the columns it owns
  const int row = warp * 16 + lane / 2;
  const int half = lane & 1;
  constexpr int HC = BN / 2;   // score columns per lane
  constexpr int OC = D / 2;    // output columns per lane
  float m = NEG_INF;           // running max, raw score units
  float l = 0.f;               // running sum of exp2((s - m) * scale_log2)
  float acc[OC];
#pragma unroll
  for (int j = 0; j < OC; ++j) acc[j] = 0.f;

  float* swarp = ss + warp * 16 * L::LDS;
  bf16* pwarp = sp + warp * 16 * L::LDP;
  // keys this lane's row may see, and the key tiles the block must visit
  const int lim = causal ? min(T, q0 + row + 1) : T;
  const int kv_end = causal ? min(T, q0 + BM) : T;
  // ALiBi slope in raw score units (scale = scale_log2 / log2 e)
  const float ab = ALIBI ? slopes[h] * 1.4426950408889634f / scale_log2 : 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    __syncthreads();  // every warp is done with the previous K/V tile (and Q is stored)
    const int kv_valid = min(BN, T - k0);
    load_tile<D>(sk, kp + k0 * kss, kv_valid, kss, tid);
    load_tile<D>(sv, vp + k0 * vss, kv_valid, vss, tid);
    __syncthreads();

    // scores for the warp's 16 rows: [16, D] x [D, 64]
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[BN / 16];
#pragma unroll
      for (int n = 0; n < BN / 16; ++n) wmma::fill_fragment(sacc[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sq + warp * 16 * L::LDH + kk, L::LDH);
#pragma unroll
        for (int n = 0; n < BN / 16; ++n) {
          // K^T as a column-major [D, 64] operand is K's row-major [64, D] tile
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
          wmma::load_matrix_sync(kb, sk + n * 16 * L::LDH + kk, L::LDH);
          wmma::mma_sync(sacc[n], a, kb, sacc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < BN / 16; ++n)
        wmma::store_matrix_sync(swarp + n * 16, sacc[n], L::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this lane's half row, ALiBi added; keys >= lim
    // are masked. dist0 is this half row's first column less (T - 1).
    const float* srow = ss + row * L::LDS + half * HC;
    const int col0 = k0 + half * HC;
    const float dist0 = (float)(col0 + 1 - T);
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < HC; ++j)
      mx = fmaxf(mx, (col0 + j < lim) ? (ALIBI ? fmaf(ab, dist0 + (float)j, srow[j]) : srow[j]) : NEG_INF);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float corr = exp2f((m - m_new) * scale_log2);
    const float mofs = m_new * scale_log2;
    float psum = 0.f;
    bf16* prow = sp + row * L::LDP + half * HC;
#pragma unroll
    for (int j = 0; j < HC; j += 2) {
      const float b0 = ALIBI ? fmaf(ab, dist0 + (float)j, srow[j]) : srow[j];
      const float b1 = ALIBI ? fmaf(ab, dist0 + (float)(j + 1), srow[j + 1]) : srow[j + 1];
      const float s0 = (col0 + j < lim) ? b0 : NEG_INF;
      const float s1 = (col0 + j + 1 < lim) ? b1 : NEG_INF;
      const float p0 = exp2f(fmaf(s0, scale_log2, -mofs));
      const float p1 = exp2f(fmaf(s1, scale_log2, -mofs));
      psum += p0 + p1;
      *reinterpret_cast<__nv_bfloat162*>(prow + j) = __floats2bfloat162_rn(p0, p1);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // P is written and every lane has read its scores

    // P V for the warp's 16 rows: [16, 64] x [64, D], into the score slice
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[D / 16];
#pragma unroll
      for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(oacc[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < BN; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, pwarp + kk, L::LDP);
#pragma unroll
        for (int n = 0; n < D / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
          wmma::load_matrix_sync(vb, sv + kk * L::LDH + n * 16, L::LDH);
          wmma::mma_sync(oacc[n], a, vb, oacc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < D / 16; ++n)
        wmma::store_matrix_sync(swarp + n * 16, oacc[n], L::LDS, wmma::mem_row_major);
    }
    __syncwarp();
    const float* pvrow = ss + row * L::LDS + half * OC;
#pragma unroll
    for (int j = 0; j < OC; ++j) acc[j] = fmaf(acc[j], corr, pvrow[j]);
  }

  const int qrow = q0 + row;
  if (qrow < S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    bf16* orow = o + b * osb + h * osh + qrow * oss + half * OC;
#pragma unroll
    for (int j = 0; j < OC; j += 8) {
      __nv_bfloat162 packed[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        packed[i] = __floats2bfloat162_rn(acc[j + 2 * i] * inv, acc[j + 2 * i + 1] * inv);
      *reinterpret_cast<uint4*>(orow + j) = *reinterpret_cast<const uint4*>(packed);
    }
    // both lanes of a row hold the same m and l; one writes the row's lse
    if (WITH_LSE && half == 0)
      lse[(long long)blockIdx.y * S + qrow] = m * scale_log2 * 0.6931471805599453f + logf(fmaxf(l, 1e-30f));
  }
}

template <int D, bool WITH_LSE, bool ALIBI>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
                   const float* slopes, int B, int H, int S, int T, const long long* st,
                   float scale_log2, int causal, cudaStream_t stream) {
  const size_t smem = Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, WITH_LSE, ALIBI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BM - 1) / BM, B * H);
  flash_fwd_kernel<D, WITH_LSE, ALIBI><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, lse, slopes, H, S, T, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], scale_log2, causal);
  return cudaGetLastError();
}

template <bool WITH_LSE>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
             const void* slopes, int B, int H, int S, int T, int D, int causal, const long long* st,
             float scale, void* stream) {
  const float scale_log2 = scale * 1.4426950408889634f;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  const float* sl = static_cast<const float*>(slopes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64 && sl) return (int)launch<64, WITH_LSE, true>(qb, kb, vb, ob, lse, sl, B, H, S, T, st, scale_log2, causal, s);
  if (D == 64) return (int)launch<64, WITH_LSE, false>(qb, kb, vb, ob, lse, sl, B, H, S, T, st, scale_log2, causal, s);
  if (D == 128 && sl) return (int)launch<128, WITH_LSE, true>(qb, kb, vb, ob, lse, sl, B, H, S, T, st, scale_log2, causal, s);
  if (D == 128) return (int)launch<128, WITH_LSE, false>(qb, kb, vb, ob, lse, sl, B, H, S, T, st, scale_log2, causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point for ctypes. Strides are in elements, ordered
// (batch, seq, head) for q, k, v, o in turn; the head dim has stride 1.
// causal is 0 or 1 (then S == T). slopes: fp32 [H] ALiBi slopes on the
// device, or null for none. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int supir_flash_attn_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, const void* slopes,
    int B, int H, int S, int T, int D, int causal,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh,
    float scale, void* stream) {
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh};
  return dispatch<false>(q, k, v, o, nullptr, slopes, B, H, S, T, D, causal, st, scale, stream);
}

// K3: the same, and lse [B, H, S] fp32 (contiguous) receives each query
// row's natural-log logsumexp of the scaled (and ALiBi-biased) scores.
extern "C" int supir_flash_attn_fwd_lse_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, const void* slopes,
    int B, int H, int S, int T, int D, int causal,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh,
    float scale, void* stream) {
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh};
  return dispatch<true>(q, k, v, o, static_cast<float*>(lse), slopes, B, H, S, T, D, causal, st, scale, stream);
}
