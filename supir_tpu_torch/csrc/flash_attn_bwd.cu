// K4: flash-attention backward for Hopper (sm_90a), bf16 in/out, optionally causal.
//
// Replaces supir_tpu/ops/flash_attention.py:_bwd_dq_kernel (:499, pallas_call
// :637) and _bwd_dkv_kernel (:539, pallas_call :663), driven by _flash_bwd
// (:592), the backward rule of the flash_attention custom_vjp (:305-325).
//
// What it computes, from the forward's residuals q, k, v [B,S|T,H,D], o and
// lse [B,H,S] (K3's natural-log logsumexp of the scaled scores) and the
// output gradient dO:
//   P  = exp(scale * Q K^T - lse)          recomputed per tile, never stored
//   delta = rowsum(dO * O)                 a pre-pass, as XLA did it (:608)
//   dS = P * (dO V^T - delta)
//   dQ = scale * dS K,  dK = scale * dS^T Q,  dV = P^T dO
// Keys past T, queries past S and, with `causal`, keys after the query are
// masked to P = 0, so padded rows and columns of a tile contribute nothing.
//
// What bounds it: operations. The five [64 x 64 x D] products per tile pair
// (S and dP in both kernels, then dQ, or dK and dV) run on the tensor cores
// through nvcuda::wmma bf16 fragments with fp32 accumulation; the softmax
// gradient between them is CUDA-core work on fp32 tiles in shared memory.
//
// Design: the TPU's split into two kernels, so no block writes what another
// block writes and the result needs no atomics: two runs give the same bits.
//   flash_bwd_dq_kernel: one block of 4 warps per (64-query tile, b*h); it
//     loops over 64-key tiles (the TPU's sequential kv grid axis, :642), each
//     warp owning 16 query rows; dQ accumulates in wmma fragments.
//   flash_bwd_dkv_kernel: one block per (64-key tile, b*h); it loops over
//     64-query tiles (the TPU's sequential q axis, :668), each warp owning 16
//     key rows; it computes S^T = K Q^T and dP^T = V dO^T directly, so dK and
//     dV are row-major products with no transposes, and accumulates both in
//     wmma fragments (at D = 128, 128 accumulator registers a thread).
// With `causal` (S == T) the dQ kernel stops at the diagonal key tile and the
// dK/dV kernel starts at the diagonal query tile. As in K1, two lanes share a
// row of a score tile (32 columns each). No wgmma, TMA or cp.async yet.
//
// ALiBi (the TPU kernels' `alibi` branch of _bwd_scores, :481-497): with fp32
// slopes [H] (null for none), the recomputed scores get the forward's bias
// back, slope_h * (key - (T - 1)) in scaled units, before exp2(... - lse2);
// lse is then K3's lse of the biased scores. In raw q.k units, as the scores
// are kept, the bias is slope_h / scale * (key - (T - 1)). The dQ kernel's
// tile has the key as its column; the dK/dV kernel's tile is transposed, the
// key is its row, so there the bias is one constant per lane. delta and the
// products do not change: the bias has no gradient. ALIBI is a template
// flag, so the kernels without it are K4's code unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;           // rows a block owns (queries for dQ, keys for dK/dV)
constexpr int BN = 64;           // rows of each tile the block loops over
constexpr int WARPS = BM / 16;   // one warp per 16 owned rows
constexpr int THREADS = WARPS * 32;
constexpr int HC = BN / 2;       // score columns per lane
constexpr int PAD_H = 8;         // bf16 row padding: 16 bytes, keeps wmma's 32-byte alignment
constexpr int PAD_F = 4;         // fp32 row padding
constexpr float LOG2E = 1.4426950408889634f;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;

// Element strides (batch, seq, head) of the eight [B, N, H, D] tensors.
struct Strides {
  long long q[3], k[3], v[3], o[3], dout[3], dq[3], dk[3], dv[3];
};

template <int D>
struct Layout {
  static constexpr int LDH = D + PAD_H;                  // [64][D] bf16 tiles
  static constexpr int LDP = BN + PAD_H;                 // [64][64] bf16 P / dS tiles
  static constexpr int LDS = (D > BN ? D : BN) + PAD_F;  // [64][*] fp32 tiles
  static constexpr size_t OWN0 = 0;                                 // Q (dQ) or K (dK/dV)
  static constexpr size_t OWN1 = OWN0 + sizeof(bf16) * BM * LDH;    // dO (dQ) or V (dK/dV)
  static constexpr size_t TILE0 = OWN1 + sizeof(bf16) * BM * LDH;   // K (dQ) or Q (dK/dV)
  static constexpr size_t TILE1 = TILE0 + sizeof(bf16) * BN * LDH;  // V (dQ) or dO (dK/dV)
  static constexpr size_t SC = TILE1 + sizeof(bf16) * BN * LDH;     // fp32 scores, then results
  static constexpr size_t DP = SC + sizeof(float) * BM * LDS;       // fp32 dP
  static constexpr size_t P = DP + sizeof(float) * BM * LDS;        // bf16 P^T (dK/dV)
  static constexpr size_t DS = P + sizeof(bf16) * BM * LDP;         // bf16 dS (dQ) or dS^T (dK/dV)
  static constexpr size_t ROWS = DS + sizeof(bf16) * BM * LDP;      // fp32 lse*log2e and delta of a query tile
  static constexpr size_t BYTES = ROWS + sizeof(float) * 2 * BN;
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

// out[16, 64] (fp32, ld LDS) = A[16, D] (row-major, ld LDH) x B^T, where B is
// a row-major [64, D] tile (ld LDH): the product of 16 rows with 64 rows.
template <int D>
__device__ __forceinline__ void rows_times_rows(float* out, const bf16* a, const bf16* b) {
  using L = Layout<D>;
  Acc acc[BN / 16];
#pragma unroll
  for (int n = 0; n < BN / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk, L::LDH);
#pragma unroll
    for (int n = 0; n < BN / 16; ++n) {
      // B^T as a column-major [D, 64] operand is B's row-major [64, D] tile
      FragBt fb;
      wmma::load_matrix_sync(fb, b + n * 16 * L::LDH + kk, L::LDH);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < BN / 16; ++n)
    wmma::store_matrix_sync(out + n * 16, acc[n], L::LDS, wmma::mem_row_major);
}

// acc[16, D] += A[16, 64] (row-major bf16, ld LDP) x B[64, D] (row-major, ld LDH)
template <int D>
__device__ __forceinline__ void accumulate(Acc* acc, const bf16* a, const bf16* b) {
  using L = Layout<D>;
#pragma unroll
  for (int kk = 0; kk < BN; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk, L::LDP);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      FragB fb;
      wmma::load_matrix_sync(fb, b + kk * L::LDH + n * 16, L::LDH);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// Scale acc[16, D], stage it in the warp's fp32 slice and write its rows
// (this lane's half of row `row`, if row_ok) to dst as bf16.
template <int D>
__device__ __forceinline__ void write_rows(Acc* acc, float scale, float* swarp, const float* srow,
                                           bf16* dst, bool row_ok) {
  using L = Layout<D>;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
#pragma unroll
    for (int i = 0; i < acc[n].num_elements; ++i) acc[n].x[i] *= scale;
    wmma::store_matrix_sync(swarp + n * 16, acc[n], L::LDS, wmma::mem_row_major);
  }
  __syncwarp();
  if (row_ok) {
#pragma unroll
    for (int j = 0; j < D / 2; j += 8) {
      __nv_bfloat162 packed[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) packed[i] = __floats2bfloat162_rn(srow[j + 2 * i], srow[j + 2 * i + 1]);
      *reinterpret_cast<uint4*>(dst + j) = *reinterpret_cast<const uint4*>(packed);
    }
  }
  __syncwarp();
}

// delta[b, h, s] = sum_d dO * O in fp32: one thread per (b, s, h) row.
template <int D>
__global__ void flash_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                                       float* __restrict__ delta, int H, int S, long long rows,
                                       Strides st) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int h = (int)(r % H);
  const int s = (int)((r / H) % S);
  const long long b = r / ((long long)H * S);
  const bf16* op = o + b * st.o[0] + s * st.o[1] + h * st.o[2];
  const bf16* gp = dout + b * st.dout[0] + s * st.dout[1] + h * st.dout[2];
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D; c += 8) {
    const uint4 ov = *reinterpret_cast<const uint4*>(op + c);
    const uint4 gv = *reinterpret_cast<const uint4*>(gp + c);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(o2[i]);
      const float2 g = __bfloat1622float2(g2[i]);
      acc = fmaf(a.x, g.x, fmaf(a.y, g.y, acc));
    }
  }
  delta[(b * H + h) * S + s] = acc;
}

template <int D, bool ALIBI>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const float* __restrict__ slopes, bf16* __restrict__ dq, int H, int S, int T, Strides st,
                    float scale, int causal) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem + L::OWN0);
  bf16* sdo = reinterpret_cast<bf16*>(smem + L::OWN1);
  bf16* sk = reinterpret_cast<bf16*>(smem + L::TILE0);
  bf16* sv = reinterpret_cast<bf16*>(smem + L::TILE1);
  float* ss = reinterpret_cast<float*>(smem + L::SC);
  float* sdp = reinterpret_cast<float*>(smem + L::DP);
  bf16* sds = reinterpret_cast<bf16*>(smem + L::DS);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long long bh = blockIdx.y;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * BM;
  const float scale_log2 = scale * LOG2E;

  load_tile<D>(sq, q + b * st.q[0] + h * st.q[2] + q0 * st.q[1], min(BM, S - q0), st.q[1], tid);
  load_tile<D>(sdo, dout + b * st.dout[0] + h * st.dout[2] + q0 * st.dout[1], min(BM, S - q0),
               st.dout[1], tid);

  // this lane's query row (block-local), its half of the columns, its
  // residuals, and the keys it may see
  const int row = warp * 16 + lane / 2;
  const int half = lane & 1;
  const int qrow = q0 + row;
  const bool row_ok = qrow < S;
  const float lse2 = row_ok ? lse[bh * S + qrow] * LOG2E : 0.f;
  const float dlt = row_ok ? delta[bh * S + qrow] : 0.f;
  const int lim = !row_ok ? 0 : (causal ? min(T, qrow + 1) : T);
  const int kv_end = causal ? min(T, q0 + BM) : T;
  const float ab = ALIBI ? slopes[h] / scale : 0.f;  // ALiBi slope, raw units

  Acc acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
  float* swarp = ss + warp * 16 * L::LDS;
  float* dpwarp = sdp + warp * 16 * L::LDS;
  bf16* dswarp = sds + warp * 16 * L::LDP;
  const bf16* qwarp = sq + warp * 16 * L::LDH;
  const bf16* dowarp = sdo + warp * 16 * L::LDH;

  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    __syncthreads();  // every warp is done with the previous K/V tile (and Q, dO are stored)
    const int kv_valid = min(BN, T - k0);
    load_tile<D>(sk, k + b * st.k[0] + h * st.k[2] + k0 * st.k[1], kv_valid, st.k[1], tid);
    load_tile<D>(sv, v + b * st.v[0] + h * st.v[2] + k0 * st.v[1], kv_valid, st.v[1], tid);
    __syncthreads();

    rows_times_rows<D>(swarp, qwarp, sk);    // S  = Q_w K^T
    rows_times_rows<D>(dpwarp, dowarp, sv);  // dP = dO_w V^T
    __syncwarp();

    // dS = P * (dP - delta) over this lane's half row, keys >= lim masked
    const float* srow = ss + row * L::LDS + half * HC;
    const float* dprow = sdp + row * L::LDS + half * HC;
    bf16* dsrow = sds + row * L::LDP + half * HC;
    const int col0 = k0 + half * HC;
    const float dist0 = (float)(col0 + 1 - T);  // this half row's first key less (T - 1)
#pragma unroll
    for (int j = 0; j < HC; j += 2) {
      const float s0 = ALIBI ? fmaf(ab, dist0 + (float)j, srow[j]) : srow[j];
      const float s1 = ALIBI ? fmaf(ab, dist0 + (float)(j + 1), srow[j + 1]) : srow[j + 1];
      const float p0 = (col0 + j < lim) ? exp2f(fmaf(s0, scale_log2, -lse2)) : 0.f;
      const float p1 = (col0 + j + 1 < lim) ? exp2f(fmaf(s1, scale_log2, -lse2)) : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(dsrow + j) =
          __floats2bfloat162_rn(p0 * (dprow[j] - dlt), p1 * (dprow[j + 1] - dlt));
    }
    __syncwarp();
    accumulate<D>(acc, dswarp, sk);  // dQ += dS K
  }

  write_rows<D>(acc, scale, swarp, ss + row * L::LDS + half * (D / 2),
                dq + b * st.dq[0] + h * st.dq[2] + (long long)qrow * st.dq[1] + half * (D / 2), row_ok);
}

template <int D, bool ALIBI>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const float* __restrict__ slopes, bf16* __restrict__ dk, bf16* __restrict__ dv,
                     int H, int S, int T,
                     Strides st, float scale, int causal) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem + L::OWN0);
  bf16* sv = reinterpret_cast<bf16*>(smem + L::OWN1);
  bf16* sq = reinterpret_cast<bf16*>(smem + L::TILE0);
  bf16* sdo = reinterpret_cast<bf16*>(smem + L::TILE1);
  float* ss = reinterpret_cast<float*>(smem + L::SC);
  float* sdp = reinterpret_cast<float*>(smem + L::DP);
  bf16* sp = reinterpret_cast<bf16*>(smem + L::P);
  bf16* sds = reinterpret_cast<bf16*>(smem + L::DS);
  float* slse = reinterpret_cast<float*>(smem + L::ROWS);
  float* sdelta = slse + BN;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const long long bh = blockIdx.y;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int k0 = blockIdx.x * BM;
  const float scale_log2 = scale * LOG2E;

  load_tile<D>(sk, k + b * st.k[0] + h * st.k[2] + k0 * st.k[1], min(BM, T - k0), st.k[1], tid);
  load_tile<D>(sv, v + b * st.v[0] + h * st.v[2] + k0 * st.v[1], min(BM, T - k0), st.v[1], tid);

  // this lane's key row (block-local) and its half of the query columns
  const int row = warp * 16 + lane / 2;
  const int half = lane & 1;
  const int key = k0 + row;
  const bool row_ok = key < T;
  // ALiBi: the key is this lane's row, so its bias (raw units) is one constant
  const float kbias = ALIBI ? slopes[h] / scale * (float)(key + 1 - T) : 0.f;

  Acc dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }
  float* swarp = ss + warp * 16 * L::LDS;
  float* dpwarp = sdp + warp * 16 * L::LDS;
  bf16* pwarp = sp + warp * 16 * L::LDP;
  bf16* dswarp = sds + warp * 16 * L::LDP;
  const bf16* kwarp = sk + warp * 16 * L::LDH;
  const bf16* vwarp = sv + warp * 16 * L::LDH;

  // causal: query tiles wholly before this key tile see none of its keys
  for (int q0 = causal ? k0 : 0; q0 < S; q0 += BN) {
    __syncthreads();  // every warp is done with the previous Q/dO tile (and K, V are stored)
    const int q_valid = min(BN, S - q0);
    load_tile<D>(sq, q + b * st.q[0] + h * st.q[2] + q0 * st.q[1], q_valid, st.q[1], tid);
    load_tile<D>(sdo, dout + b * st.dout[0] + h * st.dout[2] + q0 * st.dout[1], q_valid,
                 st.dout[1], tid);
    for (int i = tid; i < BN; i += THREADS) {
      const bool ok = i < q_valid;
      slse[i] = ok ? lse[bh * S + q0 + i] * LOG2E : 0.f;
      sdelta[i] = ok ? delta[bh * S + q0 + i] : 0.f;
    }
    __syncthreads();

    rows_times_rows<D>(swarp, kwarp, sq);    // S^T  = K_w Q^T
    rows_times_rows<D>(dpwarp, vwarp, sdo);  // dP^T = V_w dO^T
    __syncwarp();

    // P^T and dS^T over this lane's half row: query i sees key j if i < S
    // and, with causal, j <= i
    const float* srow = ss + row * L::LDS + half * HC;
    const float* dprow = sdp + row * L::LDS + half * HC;
    bf16* prow = sp + row * L::LDP + half * HC;
    bf16* dsrow = sds + row * L::LDP + half * HC;
    const float* lrow = slse + half * HC;
    const float* drow = sdelta + half * HC;
    const int col0 = q0 + half * HC;
#pragma unroll
    for (int j = 0; j < HC; j += 2) {
      const bool ok0 = row_ok && col0 + j < S && (!causal || key <= col0 + j);
      const bool ok1 = row_ok && col0 + j + 1 < S && (!causal || key <= col0 + j + 1);
      const float s0 = ALIBI ? srow[j] + kbias : srow[j];
      const float s1 = ALIBI ? srow[j + 1] + kbias : srow[j + 1];
      const float p0 = ok0 ? exp2f(fmaf(s0, scale_log2, -lrow[j])) : 0.f;
      const float p1 = ok1 ? exp2f(fmaf(s1, scale_log2, -lrow[j + 1])) : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(prow + j) = __floats2bfloat162_rn(p0, p1);
      *reinterpret_cast<__nv_bfloat162*>(dsrow + j) =
          __floats2bfloat162_rn(p0 * (dprow[j] - drow[j]), p1 * (dprow[j + 1] - drow[j + 1]));
    }
    __syncwarp();
    accumulate<D>(dv_acc, pwarp, sdo);  // dV += P^T dO
    accumulate<D>(dk_acc, dswarp, sq);  // dK += dS^T Q
  }

  const float* res_row = ss + row * L::LDS + half * (D / 2);
  const long long dk_off = b * st.dk[0] + h * st.dk[2] + (long long)key * st.dk[1] + half * (D / 2);
  const long long dv_off = b * st.dv[0] + h * st.dv[2] + (long long)key * st.dv[1] + half * (D / 2);
  write_rows<D>(dk_acc, scale, swarp, res_row, dk + dk_off, row_ok);
  write_rows<D>(dv_acc, 1.f, swarp, res_row, dv + dv_off, row_ok);
}

template <int D, bool ALIBI>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
                   const float* lse, float* delta, const float* slopes, bf16* dq, bf16* dk, bf16* dv,
                   int B, int H, int S, int T, const Strides& st, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D, ALIBI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D, ALIBI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;

  const long long rows = (long long)B * S * H;
  const int threads = 256;
  flash_bwd_delta_kernel<D><<<(unsigned)((rows + threads - 1) / threads), threads, 0, stream>>>(
      o, dout, delta, H, S, rows, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D, ALIBI><<<dim3((S + BM - 1) / BM, B * H), THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, slopes, dq, H, S, T, st, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<D, ALIBI><<<dim3((T + BM - 1) / BM, B * H), THREADS, smem, stream>>>(
      q, k, v, dout, lse, delta, slopes, dk, dv, H, S, T, st, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. `strides` holds 24 element strides,
// (batch, seq, head) for q, k, v, o, dout, dq, dk, dv in turn; the head dim
// has stride 1. lse is [B, H, S] fp32 (contiguous); delta is fp32 scratch of
// B*H*S values. causal is 0 or 1 (then S == T). slopes: fp32 [H] ALiBi
// slopes on the device, or null for none. Launches the delta pre-pass,
// the dQ kernel and the dK/dV kernel on `stream`; returns the cudaError_t of
// the first launch that fails (0 on success).
extern "C" int supir_flash_attn_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, const void* slopes, void* dq, void* dk, void* dv,
    int B, int H, int S, int T, int D, int causal, const long long* strides,
    float scale, void* stream) {
  Strides st;
  long long* dst = &st.q[0];
  for (int i = 0; i < 24; ++i) dst[i] = strides[i];
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* ob = static_cast<const bf16*>(o);
  const bf16* gb = static_cast<const bf16*>(dout);
  const float* lb = static_cast<const float*>(lse);
  float* db = static_cast<float*>(delta);
  const float* sl = static_cast<const float*>(slopes);
  bf16* dqb = static_cast<bf16*>(dq);
  bf16* dkb = static_cast<bf16*>(dk);
  bf16* dvb = static_cast<bf16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64 && sl) return (int)launch<64, true>(qb, kb, vb, ob, gb, lb, db, sl, dqb, dkb, dvb, B, H, S, T, st, scale, causal, s);
  if (D == 64) return (int)launch<64, false>(qb, kb, vb, ob, gb, lb, db, sl, dqb, dkb, dvb, B, H, S, T, st, scale, causal, s);
  if (D == 128 && sl) return (int)launch<128, true>(qb, kb, vb, ob, gb, lb, db, sl, dqb, dkb, dvb, B, H, S, T, st, scale, causal, s);
  if (D == 128) return (int)launch<128, false>(qb, kb, vb, ob, gb, lb, db, sl, dqb, dkb, dvb, B, H, S, T, st, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
