// K5, K6, K7, K10, K11: dequant-fused decode GEMVs for Hopper (sm_90a).
//
// Replace, in supir_tpu/ops/quantize.py:
//   K5  _qmm_fused_kernel  (:260, pallas_call :357, int4_paired_fused_matmul),
//       with its act_int8 branch (:291-297)
//   K6  _qmm_paired_kernel (:116, pallas_call :171, int4_paired_matmul)
//   K7  _qmm_kernel        (:606, pallas_call :674, int8_matmul / int4_matmul)
//   K10 _qmm_w4a8_kernel   (:191, pallas_call :236, int4_w4a8_matmul)
//   K11 _qmm_native_kernel (:555, pallas_call :579, int4_native_matmul)
//
// What they compute: out[b, c] = sum_k x'[b, k] * q[k, c] * scale[c]
// (+ residual[b, c]), fp32 out, for up to 32 rows of activations against
// per-output-channel quantized weights in one of the layouts of
// quant_gemv.cuh (paired, half-split and native int4, int8). x' is bf16 x
// itself, or K5's prologue (PRO): 1 RMSNorm, x' = bf16((x * rsqrt(mean(x^2)
// + eps)) * gamma); 2 SiLU-GLU over x = [a | g], x' = bf16((a * sigmoid(a))
// * g), both in fp32 and rounded to bf16 as the TPU kernel does
// (quantize.py:299-302). K5's optional fp32 residual is the RESIDUAL flag.
// K6 is the paired instance with neither, K7 the half-split and int8
// instances, K11 the native instance (its `qn` stored as column pairs).
//
// W4A8 (w4a8_kernel): paired int4 weights against int8 activations, the
// dot exact in int32 with __dp4a. K10 takes activations that torch has
// already quantized per row (xq int8, xs the row absmax) and applies
// out = (acc * scale) * (xs / 127). K5's act_int8 mode takes bf16 x, runs
// the prologue in fp32 without rounding it, takes each row's absmax in a
// pass over the whole row, quantizes as it stages (round half to even,
// clamp to +-127) and applies out = (acc * (xs / 127)) * scale (+ residual),
// the orders of quantize.py:257 and :297. Each thread reads two packed
// rows (4 k-values) of 8 columns, turns each column's two bytes into four
// signed bytes with a byte permute, two masks and a per-byte subtract, and
// meets them with a word of 4 staged int8 activations in one __dp4a. The
// sum is exact at any cin (|sum| <= 127 * 7 * cin < 2^31 up to cin 2.4M).
//
// What bounds them: bytes. A decode GEMV reads every weight byte once and
// does 2 * rows operations per weight (4 * rows per int4 byte), far below
// the H100's ridge point, so the least time is the weight bytes over 3.35
// TB/s (47 us per 13B layer in int4, 94 us in int8).
//
// Design: each block owns a strip of 32 output columns and one tile of up
// to 8 activation rows (quant_gemv.cuh), so nothing crosses blocks and no
// split-K reduction is needed; 32 columns give cout / 32 blocks (160 at
// cout 5120, 864 at 27648) for the 132 SMs. RMSNorm's row statistics, and
// W4A8's row absmax, come from passes over the rows before the weights
// stream; nothing of the prologue goes to device memory. More than 8 rows
// take further row tiles (grid.y), each streaming the weights again. K11
// reads 4 bytes (8 columns) per load where the others read 8, so a 32-byte
// sector of its rows is shared by two neighbouring blocks. No wgmma, TMA or
// cp.async yet: a simple right kernel first.

#include "quant_gemv.cuh"

using namespace qgemv;

namespace {

template <int MODE, int BT, int PRO, bool RESIDUAL>
__global__ void __launch_bounds__(THREADS)
gemv_kernel(const bf16* __restrict__ x, int ldx, const float* __restrict__ gamma, float eps,
            const uint8_t* __restrict__ w, const float* __restrict__ scale,
            const float* __restrict__ residual, float* __restrict__ out,
            int B, int cin, int cout) {
  __shared__ __align__(16) float xs[Chunk<MODE, BT>::FLOATS];
  __shared__ float red[WARPS * BT * STRIP];
  __shared__ float rstd[BT];

  const int b0 = blockIdx.y * BT;
  const int nb = min(BT, B - b0);                     // rows of this tile
  const bf16* xt = x + (size_t)b0 * ldx;

  if (PRO == PRO_NORM) {
    float ss[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) ss[b] = 0.f;
    for (int k = threadIdx.x; k < cin; k += THREADS)
#pragma unroll
      for (int b = 0; b < BT; ++b)
        if (b < nb) {
          const float v = __bfloat162float(xt[(size_t)b * ldx + k]);
          ss[b] = fmaf(v, v, ss[b]);
        }
    block_sum<BT>(ss, red, rstd);
    if (threadIdx.x < BT) rstd[threadIdx.x] = rsqrtf(rstd[threadIdx.x] / (float)cin + eps);
    // strip_dot's first __syncthreads publishes rstd
  }

  float acc[BT][8];
  if (PRO == PRO_NORM)
    strip_dot<MODE, BT>(ActNorm{xt, ldx, gamma, rstd}, nb, w, cin, cout, blockIdx.x, xs, acc);
  else if (PRO == PRO_SILUGLU)
    strip_dot<MODE, BT>(ActSiluGlu{xt, ldx, cin}, nb, w, cin, cout, blockIdx.x, xs, acc);
  else
    strip_dot<MODE, BT>(ActPlain{xt, ldx}, nb, w, cin, cout, blockIdx.x, xs, acc);
  strip_store<BT, RESIDUAL>(acc, red, nb, b0, blockIdx.x, scale, residual, out, cout);
}

// ---------------------------------------------------------------- W4A8

constexpr int QUNROLL = 4;                   // quads (two packed rows) in flight per thread: 4 x 16 bytes
constexpr int QBATCH = KGROUPS * QUNROLL;    // quads per load batch
constexpr int XQ_WORDS = 8192;               // 32 KB of staged int8 activations, 4 to a word

// the four signed bytes (k = 4q .. 4q+3) of one column from its bytes in
// packed rows 2q (a, low byte lane `sel`) and 2q+1 (b)
__device__ __forceinline__ int quad_weights(uint32_t a, uint32_t b, uint32_t lane) {
  const uint32_t u = __byte_perm(a, b, lane | ((lane + 4u) << 8));   // byte 0 = a's, byte 2 = b's
  const uint32_t v = (u & 0x000F000Fu) | ((u << 4) & 0x0F000F00u);   // nibbles a_lo, a_hi, b_lo, b_hi
  return (int)__vsub4(v ^ 0x08080808u, 0x08080808u);                 // sign-extend each byte
}

// K5's prologue in fp32, without rounding: what act_int8 quantizes
template <int PRO>
__device__ __forceinline__ float prologue_f32(const bf16* xr, int k, int cin, const float* gamma, float rstd) {
  const float v = __bfloat162float(xr[k]);
  if (PRO == PRO_NORM) return (v * rstd) * gamma[k];
  if (PRO == PRO_SILUGLU) return silu_glu(v, __bfloat162float(xr[k + cin]));
  return v;
}

template <int BT, int PRO, bool RESIDUAL, bool QIN>
__global__ void __launch_bounds__(THREADS)
w4a8_kernel(const void* __restrict__ xin, int ldx, const float* __restrict__ xsc,
            const float* __restrict__ gamma, float eps,
            const uint8_t* __restrict__ w, const float* __restrict__ scale,
            const float* __restrict__ residual, float* __restrict__ out,
            int B, int cin, int cout) {
  constexpr int QROWS = (XQ_WORDS / BT) / QBATCH * QBATCH;   // quads per chunk
  static_assert(QROWS >= QBATCH, "a chunk holds at least one load batch");
  __shared__ int xq[BT * QROWS];
  __shared__ int red[WARPS][BT][STRIP];
  __shared__ float fred[WARPS * BT];
  __shared__ float rstd[BT], mul[BT], rowscale[BT];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ct = lane % COL_THREADS;
  const int kg = tid / COL_THREADS;
  const int c0 = blockIdx.x * STRIP + ct * 8;
  const int b0 = blockIdx.y * BT;
  const int nb = min(BT, B - b0);
  const bool col_ok = c0 < cout;
  const int nquads = cin / 4;
  const bf16* x = static_cast<const bf16*>(xin) + (size_t)b0 * ldx;
  const int8_t* xq_in = static_cast<const int8_t*>(xin) + (size_t)b0 * ldx;

  if (QIN) {
    if (tid < BT) rowscale[tid] = tid < nb ? xsc[b0 + tid] * (1.f / 127.f) : 0.f;
  } else {
    if (PRO == PRO_NORM) {
      float ss[BT];
#pragma unroll
      for (int b = 0; b < BT; ++b) ss[b] = 0.f;
      for (int k = tid; k < cin; k += THREADS)
#pragma unroll
        for (int b = 0; b < BT; ++b)
          if (b < nb) {
            const float v = __bfloat162float(x[(size_t)b * ldx + k]);
            ss[b] = fmaf(v, v, ss[b]);
          }
      block_sum<BT>(ss, fred, rstd);
      if (tid < BT) rstd[tid] = rsqrtf(rstd[tid] / (float)cin + eps);
      __syncthreads();
    }
    // each row's absmax of the fp32 prologue output
    float mx[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) mx[b] = 0.f;
    for (int k = tid; k < cin; k += THREADS)
#pragma unroll
      for (int b = 0; b < BT; ++b)
        if (b < nb)
          mx[b] = fmaxf(mx[b], fabsf(prologue_f32<PRO>(x + (size_t)b * ldx, k, cin, gamma,
                                                        PRO == PRO_NORM ? rstd[b] : 0.f)));
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      float m = mx[b];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (lane == 0) fred[warp * BT + b] = m;
    }
    __syncthreads();
    if (tid < BT) {
      float m = 0.f;
#pragma unroll
      for (int wi = 0; wi < WARPS; ++wi) m = fmaxf(m, fred[wi * BT + tid]);
      const float xs = fmaxf(m, 1e-6f);
      mul[tid] = 127.f / xs;
      rowscale[tid] = xs * (1.f / 127.f);
    }
    // the staging loop's first __syncthreads publishes mul and rowscale
  }

  int acc[BT][8];
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[b][j] = 0;

  for (int qc0 = 0; qc0 < nquads; qc0 += QROWS) {
    const int rows = min(QROWS, nquads - qc0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = tid; i < BT * QROWS; i += THREADS) {
      const int b = i / QROWS;
      const int r = i % QROWS;
      int word = 0;
      if (b < nb && r < rows) {
        const int k0 = 4 * (qc0 + r);
        if (QIN) {
          word = *reinterpret_cast<const int*>(xq_in + (size_t)b * ldx + k0);
        } else {
          const bf16* xr = x + (size_t)b * ldx;
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float v = prologue_f32<PRO>(xr, k0 + t, cin, gamma, PRO == PRO_NORM ? rstd[b] : 0.f);
            const int q = max(-127, min(127, __float2int_rn(v * mul[b])));
            word |= (q & 0xFF) << (8 * t);
          }
        }
      }
      xq[i] = word;
    }
    __syncthreads();

    for (int r0 = 0; r0 < rows; r0 += QBATCH) {
      uint2 wa[QUNROLL], wb[QUNROLL];
#pragma unroll
      for (int u = 0; u < QUNROLL; ++u) {
        const int qd = qc0 + r0 + u * KGROUPS + kg;
        wa[u] = wb[u] = make_uint2(0u, 0u);   // decodes to zero weights
        if (col_ok && qd < nquads) {
          const uint8_t* src = w + (size_t)(2 * qd) * cout + c0;
          wa[u] = __ldg(reinterpret_cast<const uint2*>(src));
          wb[u] = __ldg(reinterpret_cast<const uint2*>(src + cout));
        }
      }
#pragma unroll
      for (int u = 0; u < QUNROLL; ++u) {
        const int r = r0 + u * KGROUPS + kg;  // < QROWS: QROWS is a multiple of QBATCH
        int wq[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          wq[j] = quad_weights(j < 4 ? wa[u].x : wa[u].y, j < 4 ? wb[u].x : wb[u].y, j % 4);
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          const int xw = xq[b * QROWS + r];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[b][j] = __dp4a(xw, wq[j], acc[b][j]);
        }
      }
    }
  }

  // sum the 8 k-groups of each warp that share a column thread, exactly
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int v = acc[b][j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[b][j] = v;
    }
  if (lane < COL_THREADS) {
#pragma unroll
    for (int b = 0; b < BT; ++b)
#pragma unroll
      for (int j = 0; j < 8; ++j) red[warp][b][ct * 8 + j] = acc[b][j];
  }
  __syncthreads();

  for (int i = tid; i < BT * STRIP; i += THREADS) {
    const int b = i / STRIP;
    const int col = i % STRIP;
    const int row = b0 + b;
    const int c = blockIdx.x * STRIP + col;
    if (b >= nb || c >= cout) continue;
    int total = 0;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) total += red[wi][b][col];
    float s = (float)total;
    s = QIN ? (s * scale[c]) * rowscale[b] : (s * rowscale[b]) * scale[c];
    if (RESIDUAL) s += residual[(size_t)row * cout + c];
    out[(size_t)row * cout + c] = s;
  }
}

// ---------------------------------------------------------------- launch

struct Args {
  const void* x; int ldx; const float* xs; const float* gamma; float eps;
  const uint8_t* w; const float* scale; const float* residual; float* out;
  int B, cin, cout;
};

template <int MODE, int BT, int PRO, bool RES>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.cout + STRIP - 1) / STRIP, (a.B + BT - 1) / BT);
  gemv_kernel<MODE, BT, PRO, RES><<<grid, THREADS, 0, stream>>>(
      static_cast<const bf16*>(a.x), a.ldx, a.gamma, a.eps, a.w, a.scale, a.residual, a.out,
      a.B, a.cin, a.cout);
  return cudaGetLastError();
}

template <int MODE, int BT>
cudaError_t launch_flags(const Args& a, int pro, cudaStream_t stream) {
  if constexpr (MODE == PAIRED) {
    const bool res = a.residual != nullptr;
    if (pro == PRO_NONE) return res ? launch<MODE, BT, PRO_NONE, true>(a, stream) : launch<MODE, BT, PRO_NONE, false>(a, stream);
    if (pro == PRO_NORM) return res ? launch<MODE, BT, PRO_NORM, true>(a, stream) : launch<MODE, BT, PRO_NORM, false>(a, stream);
    if (pro == PRO_SILUGLU) return res ? launch<MODE, BT, PRO_SILUGLU, true>(a, stream) : launch<MODE, BT, PRO_SILUGLU, false>(a, stream);
    return cudaErrorInvalidValue;
  } else {
    // K7 and K11 have neither prologue nor residual
    if (pro != PRO_NONE || a.residual != nullptr) return cudaErrorInvalidValue;
    return launch<MODE, BT, PRO_NONE, false>(a, stream);
  }
}

template <int MODE>
cudaError_t launch_rows(const Args& a, int pro, cudaStream_t stream) {
  if (a.B <= 1) return launch_flags<MODE, 1>(a, pro, stream);
  if (a.B <= 2) return launch_flags<MODE, 2>(a, pro, stream);
  if (a.B <= 4) return launch_flags<MODE, 4>(a, pro, stream);
  return launch_flags<MODE, 8>(a, pro, stream);
}

template <int BT, int PRO, bool RES, bool QIN>
cudaError_t launch_w4a8(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.cout + STRIP - 1) / STRIP, (a.B + BT - 1) / BT);
  w4a8_kernel<BT, PRO, RES, QIN><<<grid, THREADS, 0, stream>>>(
      a.x, a.ldx, a.xs, a.gamma, a.eps, a.w, a.scale, a.residual, a.out, a.B, a.cin, a.cout);
  return cudaGetLastError();
}

template <int BT>
cudaError_t w4a8_flags(const Args& a, int pro, bool quantized, cudaStream_t stream) {
  const bool res = a.residual != nullptr;
  if (quantized) {
    // K10: no prologue, no residual
    if (pro != PRO_NONE || res) return cudaErrorInvalidValue;
    return launch_w4a8<BT, PRO_NONE, false, true>(a, stream);
  }
  if (pro == PRO_NONE) return res ? launch_w4a8<BT, PRO_NONE, true, false>(a, stream) : launch_w4a8<BT, PRO_NONE, false, false>(a, stream);
  if (pro == PRO_NORM) return res ? launch_w4a8<BT, PRO_NORM, true, false>(a, stream) : launch_w4a8<BT, PRO_NORM, false, false>(a, stream);
  if (pro == PRO_SILUGLU) return res ? launch_w4a8<BT, PRO_SILUGLU, true, false>(a, stream) : launch_w4a8<BT, PRO_SILUGLU, false, false>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points for ctypes; each returns the cudaError_t of its
// launch (0 on success).
//
// supir_qgemv (K5, K6, K7, K11): x is bf16 [B, >= cin] (>= 2 cin with
// SiLU-GLU) with row stride ldx; gamma fp32 [cin] (RMSNorm only); w the
// packed weights (see quant_gemv.cuh), 8-byte aligned; scale fp32 [cout];
// residual fp32 [B, cout] or null; out fp32 [B, cout]. prologue: 0 none,
// 1 RMSNorm, 2 SiLU-GLU (paired only). mode: 0 paired, 1 half-split, 2 int8,
// 3 native.
extern "C" int supir_qgemv(const void* x, int ldx, const void* gamma, float eps, int prologue,
                           const void* w, const void* scale, const void* residual, void* out,
                           int B, int cin, int cout, int mode, void* stream) {
  const Args a{x, ldx, nullptr, static_cast<const float*>(gamma), eps,
               static_cast<const uint8_t*>(w), static_cast<const float*>(scale),
               static_cast<const float*>(residual), static_cast<float*>(out), B, cin, cout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || cin <= 0 || cout <= 0 || cout % 8 || cin % 2) return (int)cudaErrorInvalidValue;
  if (prologue == PRO_NORM && gamma == nullptr) return (int)cudaErrorInvalidValue;
  if (mode == PAIRED) return (int)launch_rows<PAIRED>(a, prologue, s);
  if (mode == HALF_SPLIT) return (int)launch_rows<HALF_SPLIT>(a, prologue, s);
  if (mode == INT8) return (int)launch_rows<INT8>(a, prologue, s);
  if (mode == NATIVE) return (int)launch_rows<NATIVE>(a, prologue, s);
  return (int)cudaErrorInvalidValue;
}

// supir_qgemv_w4a8 (K10, and K5 with act_int8): paired int4 weights w
// uint8 [cin/2, cout]. quantized != 0 (K10): x int8 [B, >= cin], 4-byte
// aligned rows of stride ldx, xs fp32 [B] the rows' absmax scales; no
// prologue, no residual. quantized == 0 (K5 act_int8): x bf16 as for
// supir_qgemv, with its prologue and residual; xs unused. cin % 4 == 0.
extern "C" int supir_qgemv_w4a8(const void* x, int ldx, const void* xs, int quantized, const void* gamma,
                                float eps, int prologue, const void* w, const void* scale,
                                const void* residual, void* out, int B, int cin, int cout, void* stream) {
  const Args a{x, ldx, static_cast<const float*>(xs), static_cast<const float*>(gamma), eps,
               static_cast<const uint8_t*>(w), static_cast<const float*>(scale),
               static_cast<const float*>(residual), static_cast<float*>(out), B, cin, cout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || cin <= 0 || cout <= 0 || cout % 8 || cin % 4) return (int)cudaErrorInvalidValue;
  if (quantized && (xs == nullptr || ldx % 4 || reinterpret_cast<uintptr_t>(x) % 4)) return (int)cudaErrorInvalidValue;
  if (prologue == PRO_NORM && gamma == nullptr) return (int)cudaErrorInvalidValue;
  const bool q = quantized != 0;
  if (B <= 1) return (int)w4a8_flags<1>(a, prologue, q, s);
  if (B <= 2) return (int)w4a8_flags<2>(a, prologue, q, s);
  if (B <= 4) return (int)w4a8_flags<4>(a, prologue, q, s);
  return (int)w4a8_flags<8>(a, prologue, q, s);
}
