// K4 fp32: the flash-attention backward for Hopper (sm_90a) in fp32, on the
// CUDA cores: fp32 q, k, v, o, lse and dO in, fp32 dQ, dK and dV out,
// optionally causal.
//
// It replaces supir_tpu/ops/flash_attention.py:_bwd_dq_kernel (:499,
// pallas_call :637) and _bwd_dkv_kernel (:539, pallas_call :663), driven by
// _flash_bwd (:592), for fp32 inputs: the TPU kernels write their gradients
// in q's dtype, so a trainer whose model computes in fp32 differentiates its
// flash sites in fp32 there. flash_attn_bwd.cu is the bf16 instance (wgmma,
// TMA); this file is its fp32 twin, a first design kept simple and exact.
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
// to fp32 as K3 ALiBi fp32 (flash_attn_fwd_fp32.cu) and the plain version
// round them, so P is the forward's. Both kernels take the score through
// one helper, `scaled_score`. The delta pre-pass needs no bias; the slopes
// get no gradient (static in JAX's custom VJP).
//
// Design: fp32 FMA tiles on the CUDA cores, every product in fp32 (no TF32
// rounding), so the result is the plain version's up to the order of fp32
// sums. Chosen over 3xTF32 on wgmma (flash_attn_fwd_fp32.cu's route)
// because a simple kernel that is right comes first: the fp32 backward runs
// on the fp32 trainers' flash sites only, where it is a small share of a
// step, and the fast design (one pass over key blocks with a fixed-order
// dQ partial sum) is ROADMAP Queue 2 item 3 for both dtypes.
// - The TPU's split into a dQ kernel and a dK/dV kernel is kept: every
//   output element is written by exactly one block, so no atomics and two
//   runs give the same bits. It costs 7 products where the function needs
//   5 (S and dP are computed in both kernels), as K4 bf16 does.
// - Block: 256 threads own a 64-row block (queries in the dQ kernel, keys
//   in the dK/dV kernel) of one (b, h), and stream 64-row tiles of the
//   other side through shared memory. Thread (ty, tx), ty = tid / 16, tx =
//   tid % 16, holds the 4 x 4 scores of rows 4 ty + i and tile columns
//   tx + 16 j, and the outputs of rows 4 ty + i at head-dim columns
//   tx + 16 j (j < D / 16). Shared rows are D + 1 floats apart (BN + 1 for
//   the score tiles), so the 16 columns a warp reads fall in 16 banks.
// - The scores go through shared memory (dS in the dQ kernel, P^T and dS^T
//   in the dK/dV kernel) between the two products of a tile.
// - Shared memory at D = 128: the dQ kernel 146 KB, the dK/dV kernel
//   162 KB; one block an SM.
// What bounds it: operations, 5 x 2 B H S T D flops (fewer when causal).
// At TF32's 495 TFLOP/s with 3xTF32 (three products each) it is the bound
// PERF.md §6 states beside K4 bf16's; on the CUDA cores' fp32 67 TFLOP/s it
// is the bound of this design. Each FMA here reads two shared-memory words
// for every two FMAs in the score loops, so shared memory, not the FMA
// units, paces it.
//
// FAULT (a runtime argument, for the checks only): 1 delta dropped (dS = P
// dP), 2 dK without the scale, 3 the causal diagonal not masked, 4 P read
// with the lse in log2 units.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;         // rows a block owns
constexpr int BN = 64;         // rows of a streamed tile
constexpr int THREADS = 256;
constexpr int RF = 4;          // rows a thread holds (4 ty + i)
constexpr int CF = BN / 16;    // tile columns a thread holds (tx + 16 j)
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, n, h;  // batch, sequence, head, in elements (the head dim has stride 1)
};

template <int D>
struct Smem {
  static constexpr int LD = D + 1;   // floats between rows of a D-wide tile
  static constexpr int LS = BN + 1;  // floats between rows of a score tile
};

// P's exponent, the scaled score less the row's lse: scale s - l, or with
// ALiBi (`alibi`, the head's slope) scale s + slope (col - (T - 1)) - l,
// each step rounded to fp32 as the forward and the plain version round it
__device__ __forceinline__ float scaled_score(float s, float scale, float l, bool alibi, float slope, int col,
                                              int T) {
  if (!alibi) return s * scale - l;
  return __fadd_rn(__fmul_rn(s, scale), __fmul_rn(slope, static_cast<float>(col - (T - 1)))) - l;
}

// rows [row0, row0 + BN) of one (b, h) of x into shared rows of LD floats;
// zeros past n
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ x, const Strides& st, int b, int h,
                                          int row0, int n) {
  const float* base = x + b * st.b + h * st.h;
  for (int e = threadIdx.x; e < BN * D; e += THREADS) {
    const int r = e / D, c = e % D;
    const int row = row0 + r;
    dst[r * Smem<D>::LD + c] = row < n ? base[row * st.n + c] : 0.f;
  }
}

// delta[bh, s] = sum_d dO[b, s, h, d] * O[b, s, h, d], one warp a row, the
// lanes' partial sums combined in a fixed order
__global__ void __launch_bounds__(THREADS)
flash_bwd_fp32_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout, float* __restrict__ delta,
                            int H, int S, int D, Strides so, Strides sd, long long rows) {
  const long long row = static_cast<long long>(blockIdx.x) * (THREADS / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int s = static_cast<int>(row % S), bh = static_cast<int>(row / S);
  const int b = bh / H, h = bh % H;
  const float* orow = o + b * so.b + s * so.n + h * so.h;
  const float* grow = dout + b * sd.b + s * sd.n + h * sd.h;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(orow[c], grow[c], acc);
#pragma unroll
  for (int w = 16; w > 0; w /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) delta[row] = acc;
}

// dQ: a block owns BM queries; K and V tiles of BN keys stream through.
// Per tile: S = Q K^T and dP = dO V^T (4 x 4 a thread), dS = P (dP - delta)
// to shared memory, dQ += dS K.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_fp32_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, const float* __restrict__ slopes,
                         float* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides sd, int H, int S, int T,
                         float scale, int causal, int fault) {
  constexpr int LD = Smem<D>::LD, LS = Smem<D>::LS, DF = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;            // [BM][LD]
  float* gs = qs + BM * LD;    // dO [BM][LD]
  float* ks = gs + BM * LD;    // [BN][LD]
  float* vs = ks + BN * LD;    // [BN][LD]
  float* ds = vs + BN * LD;    // [BM][LS]
  float* ls = ds + BM * LS;    // lse of the block's rows
  float* es = ls + BM;         // delta of the block's rows

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * BM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const bool alibi = slopes != nullptr;
  const float slope = alibi ? slopes[h] : 0.f;
  load_rows<D>(qs, q, sq, b, h, q0, S);
  load_rows<D>(gs, dout, sd, b, h, q0, S);
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    const bool in = q0 + r < S;
    // past S: P = exp(-inf) = 0
    ls[r] = in ? lse[static_cast<long long>(bh) * S + q0 + r] : INFINITY;
    es[r] = in ? delta[static_cast<long long>(bh) * S + q0 + r] : 0.f;
  }
  float acc[RF][DF];
#pragma unroll
  for (int i = 0; i < RF; ++i)
#pragma unroll
    for (int j = 0; j < DF; ++j) acc[i][j] = 0.f;

  const int kv_end = causal && fault != 3 ? min(T, q0 + BM) : T;
  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    __syncthreads();  // the previous tile's K, V and dS are read
    load_rows<D>(ks, k, sk, b, h, k0, T);
    load_rows<D>(vs, v, sv, b, h, k0, T);
    __syncthreads();
    float sc[RF][CF], dp[RF][CF];
#pragma unroll
    for (int i = 0; i < RF; ++i)
#pragma unroll
      for (int j = 0; j < CF; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RF], g[RF], kb[CF], vb[CF];
#pragma unroll
      for (int i = 0; i < RF; ++i) {
        a[i] = qs[(RF * ty + i) * LD + d];
        g[i] = gs[(RF * ty + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < CF; ++j) {
        kb[j] = ks[(tx + 16 * j) * LD + d];
        vb[j] = vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RF; ++i)
#pragma unroll
        for (int j = 0; j < CF; ++j) {
          sc[i][j] = fmaf(a[i], kb[j], sc[i][j]);
          dp[i][j] = fmaf(g[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RF; ++i) {
      const int r = RF * ty + i, row = q0 + r;
      const float l = fault == 4 ? ls[r] * LOG2E : ls[r];
#pragma unroll
      for (int j = 0; j < CF; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool keep = col < T && (!causal || fault == 3 || col <= row);
        const float p = keep ? expf(scaled_score(sc[i][j], scale, l, alibi, slope, col, T)) : 0.f;
        ds[r * LS + tx + 16 * j] = fault == 1 ? p * dp[i][j] : p * (dp[i][j] - es[r]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float a[RF], kb[DF];
#pragma unroll
      for (int i = 0; i < RF; ++i) a[i] = ds[(RF * ty + i) * LS + c];
#pragma unroll
      for (int j = 0; j < DF; ++j) kb[j] = ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RF; ++i)
#pragma unroll
        for (int j = 0; j < DF; ++j) acc[i][j] = fmaf(a[i], kb[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < RF; ++i) {
    const int row = q0 + RF * ty + i;
    if (row >= S) continue;
    float* out = dq + (static_cast<long long>(b) * S + row) * H * D + h * D;
#pragma unroll
    for (int j = 0; j < DF; ++j) out[tx + 16 * j] = acc[i][j] * scale;
  }
}

// dK and dV: a block owns BM keys; Q and dO tiles of BN queries stream
// through. Per tile: S^T = K Q^T and dP^T = V dO^T (4 x 4 a thread), P^T
// and dS^T = P^T (dP^T - delta) to shared memory, dV += P^T dO, dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_fp32_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                          const float* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ delta, const float* __restrict__ slopes,
                          float* __restrict__ dk, float* __restrict__ dv, Strides sq, Strides sk, Strides sv,
                          Strides sd, int H, int S, int T, float scale, int causal, int fault) {
  constexpr int LD = Smem<D>::LD, LS = Smem<D>::LS, DF = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;            // [BM][LD]
  float* vs = ks + BM * LD;    // [BM][LD]
  float* qs = vs + BM * LD;    // [BN][LD]
  float* gs = qs + BN * LD;    // dO [BN][LD]
  float* ps = gs + BN * LD;    // P^T [BM][LS]
  float* ds = ps + BM * LS;    // dS^T [BM][LS]
  float* ls = ds + BM * LS;    // lse of the tile's queries
  float* es = ls + BN;         // delta of the tile's queries

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const bool alibi = slopes != nullptr;
  const float slope = alibi ? slopes[h] : 0.f;
  load_rows<D>(ks, k, sk, b, h, k0, T);
  load_rows<D>(vs, v, sv, b, h, k0, T);
  float dka[RF][DF], dva[RF][DF];
#pragma unroll
  for (int i = 0; i < RF; ++i)
#pragma unroll
    for (int j = 0; j < DF; ++j) dka[i][j] = dva[i][j] = 0.f;

  // causal: the queries before the block's first key see none of its keys
  const int q_first = causal && fault != 3 ? (k0 / BN) * BN : 0;
  for (int q0 = q_first; q0 < S; q0 += BN) {
    __syncthreads();  // the previous tile's Q, dO, P^T and dS^T are read
    load_rows<D>(qs, q, sq, b, h, q0, S);
    load_rows<D>(gs, dout, sd, b, h, q0, S);
    for (int r = threadIdx.x; r < BN; r += THREADS) {
      const bool in = q0 + r < S;
      ls[r] = in ? lse[static_cast<long long>(bh) * S + q0 + r] : INFINITY;
      es[r] = in ? delta[static_cast<long long>(bh) * S + q0 + r] : 0.f;
    }
    __syncthreads();
    float st[RF][CF], dpt[RF][CF];
#pragma unroll
    for (int i = 0; i < RF; ++i)
#pragma unroll
      for (int j = 0; j < CF; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RF], w[RF], qb[CF], gb[CF];
#pragma unroll
      for (int i = 0; i < RF; ++i) {
        a[i] = ks[(RF * ty + i) * LD + d];
        w[i] = vs[(RF * ty + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < CF; ++j) {
        qb[j] = qs[(tx + 16 * j) * LD + d];
        gb[j] = gs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RF; ++i)
#pragma unroll
        for (int j = 0; j < CF; ++j) {
          st[i][j] = fmaf(a[i], qb[j], st[i][j]);
          dpt[i][j] = fmaf(w[i], gb[j], dpt[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RF; ++i) {
      const int r = RF * ty + i, key = k0 + r;
#pragma unroll
      for (int j = 0; j < CF; ++j) {
        const int c = tx + 16 * j, row = q0 + c;
        const float l = fault == 4 ? ls[c] * LOG2E : ls[c];
        const bool keep = key < T && (!causal || fault == 3 || key <= row);
        const float p = keep ? expf(scaled_score(st[i][j], scale, l, alibi, slope, key, T)) : 0.f;
        ps[r * LS + c] = p;
        ds[r * LS + c] = fault == 1 ? p * dpt[i][j] : p * (dpt[i][j] - es[c]);
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < BN; ++c) {
      float pa[RF], da[RF], gb[DF], qb[DF];
#pragma unroll
      for (int i = 0; i < RF; ++i) {
        pa[i] = ps[(RF * ty + i) * LS + c];
        da[i] = ds[(RF * ty + i) * LS + c];
      }
#pragma unroll
      for (int j = 0; j < DF; ++j) {
        gb[j] = gs[c * LD + tx + 16 * j];
        qb[j] = qs[c * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < RF; ++i)
#pragma unroll
        for (int j = 0; j < DF; ++j) {
          dva[i][j] = fmaf(pa[i], gb[j], dva[i][j]);
          dka[i][j] = fmaf(da[i], qb[j], dka[i][j]);
        }
    }
  }
  const float kscale = fault == 2 ? 1.f : scale;
#pragma unroll
  for (int i = 0; i < RF; ++i) {
    const int key = k0 + RF * ty + i;
    if (key >= T) continue;
    const long long at = (static_cast<long long>(b) * T + key) * H * D + h * D;
#pragma unroll
    for (int j = 0; j < DF; ++j) {
      dk[at + tx + 16 * j] = dka[i][j] * kscale;
      dv[at + tx + 16 * j] = dva[i][j];
    }
  }
}

template <int D>
constexpr int dq_smem() {
  return (2 * BM * Smem<D>::LD + 2 * BN * Smem<D>::LD + BM * Smem<D>::LS + 2 * BM) * 4;
}

template <int D>
constexpr int dkv_smem() {
  return (2 * BM * Smem<D>::LD + 2 * BN * Smem<D>::LD + 2 * BM * Smem<D>::LS + 2 * BN) * 4;
}

static_assert(dkv_smem<128>() <= 232448, "one block's shared memory");

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, const float* dout, const float* lse,
                   const float* delta, const float* slopes, float* dq, float* dk, float* dv, const Strides* st, int B,
                   int H, int S, int T, float scale, int causal, int fault, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_fp32_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         dq_smem<D>());
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_fp32_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkv_smem<D>());
  if (err != cudaSuccess) return err;
  flash_bwd_fp32_dq_kernel<D><<<dim3(B * H, (S + BM - 1) / BM), THREADS, dq_smem<D>(), stream>>>(
      q, k, v, dout, lse, delta, slopes, dq, st[0], st[1], st[2], st[4], H, S, T, scale, causal, fault);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_fp32_dkv_kernel<D><<<dim3(B * H, (T + BM - 1) / BM), THREADS, dkv_smem<D>(), stream>>>(
      q, k, v, dout, lse, delta, slopes, dk, dv, st[0], st[1], st[2], st[4], H, S, T, scale, causal, fault);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes: fp32 q, o, dout [B,S,H,D], k, v [B,T,H,D]
// (any strides with a contiguous head dim: `strides` holds batch, sequence
// and head strides in elements of q, k, v, o and dout, 15 values); lse
// [B,H,S] fp32 contiguous; delta scratch of B*H*S floats; slopes: fp32 [H]
// ALiBi slopes on the device, or null for none; dq [B,S,H,D], dk and dv
// [B,T,H,D] fp32 contiguous. causal is 0 or 1 (then S == T); fault 0 is
// the kernel, 1-4 its planted faults. Launches the delta pre-pass, then the
// dQ kernel and the dK/dV kernel on `stream`. Returns 0 or a cudaError_t.
extern "C" int supir_flash_attn_bwd_fp32(const void* q, const void* k, const void* v, const void* o,
                                         const void* dout, const void* lse, void* delta, const void* slopes,
                                         void* dq, void* dk, void* dv, int B, int H, int S, int T, int D, int causal,
                                         const long long* strides, float scale, int fault, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || T <= 0 || (D != 64 && D != 128)) return static_cast<int>(cudaErrorInvalidValue);
  if ((S + BM - 1) / BM > 65535 || (T + BM - 1) / BM > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Strides st[5];
  for (int i = 0; i < 5; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(B) * H * S;
  const float* of = static_cast<const float*>(o);
  const float* gf = static_cast<const float*>(dout);
  float* df = static_cast<float*>(delta);
  flash_bwd_fp32_delta_kernel<<<static_cast<unsigned>((rows + THREADS / 32 - 1) / (THREADS / 32)), THREADS, 0, s>>>(
      of, gf, df, H, S, D, st[3], st[4], rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* lf = static_cast<const float*>(lse);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  const float* sl = static_cast<const float*>(slopes);
  err = D == 64 ? launch<64>(qf, kf, vf, gf, lf, df, sl, dqf, dkf, dvf, st, B, H, S, T, scale, causal, fault, s)
                : launch<128>(qf, kf, vf, gf, lf, df, sl, dqf, dkf, dvf, st, B, H, S, T, scale, causal, fault, s);
  return static_cast<int>(err);
}
