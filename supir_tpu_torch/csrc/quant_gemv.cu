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
//
// The kernels' bodies (gemv_kernel, w4a8_kernel) live in quant_gemv.cuh with
// the strip width and K10's split-K count as template parameters; this file
// holds the instances the model paths run (strip 32, no split) and their
// launch. csrc/gemv_sweep.cu instantiates the other geometries for the
// decode-GEMV probes, in a translation unit of its own so that this one,
// the slowest to build, does not grow.

#include "quant_gemv.cuh"

using namespace qgemv;

namespace {

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
      a.x, a.ldx, a.xs, a.gamma, a.eps, a.w, a.scale, a.residual, a.out, a.B, a.cin, a.cout, nullptr, -1);
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
