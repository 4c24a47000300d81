// The decode GEMVs at other launch geometries, the first designs of the
// probes T1c, T2 and T4b (supir_tpu_torch/tools/; all three run on
// csrc/quant_gemv_tc.cu since, and these are kept to time them in turns):
// the bodies of quant_gemv.cuh, instantiated
// at strips of 64, 128 and 256 output columns per block and, for K10's
// W4A8 body, split-K of 2 and 4 as well. And the strip body's paired
// (every prologue, with and without residual) and int8 instances at the
// model paths' strip of 32 (supir_qgemv_strip): the kernel K5, K6 and K7
// int8 ran before quant_gemv_tc.cu, kept so that one run can time the two
// side by side; no model path launches it from here.
//
// Replace the TPU probes' forced block widths:
//   T1c  tools/stream_ceiling.py:162, K7's _qmm_kernel (supir_tpu/ops/
//        quantize.py:606) at bout 512-3840: here K7's half-split instance
//        (the first design, timed in turns with T1c on the tensor-core body)
//   T2   tools/gemv_sweep.py:_w4a8_kernel (:48, pallas_call :69), the W4A8
//        GEMV at _paired_bout's width: here K10's strip body (int8 x, paired
//        int4 w, exact int32 sums) at strip x split-K, in its pre-activation-
//        scale form when the caller passes xs = 127 (127 * (1/127) is 1.0f)
//        (the first design, ops/probes.py:w4a8_preact_strip)
//   T4b  tools/int4_native_probe.py:_native_kernel (:58, pallas_call :72),
//        native int4 at bout 256: here K11's NATIVE instance
// The TPU's bout is the width of a VMEM block that one core walks in order;
// the card's strip is the width one block of 256 threads owns, and it stops
// at 256 (one warp across the strip, 8 bytes a lane). Today's geometry
// (strip 32, no split) stays in quant_gemv.cu.
//
// What bounds them: the weight bytes over the memory rate, as K7/K10/K11.
// A wider strip gives fewer, longer blocks (cout / S: 60 at cout 15360 and
// S 256) whose warps read whole 256-byte rows; split-K multiplies the
// blocks by SPLIT for the projections whose cout leaves SMs idle (o and
// down: 160 blocks at strip 32 for 132 SMs) and adds an int32 atomic per
// output and slice plus one epilogue launch (w4a8_finish). The integer
// partial sums are exact, so their order does not matter.
//
// Activation rows: one tile of 1 row (decode) or of 8 rows (more rows take
// further tiles, as in quant_gemv.cu).

#include "quant_gemv.cuh"

using namespace qgemv;

namespace {

template <int MODE, int BT, int S>
cudaError_t launch_gemv(const void* x, int ldx, const void* w, const void* scale, void* out, int B, int cin,
                        int cout, cudaStream_t stream) {
  const dim3 grid((cout + S - 1) / S, (B + BT - 1) / BT);
  gemv_kernel<MODE, BT, PRO_NONE, false, S><<<grid, THREADS, 0, stream>>>(
      static_cast<const bf16*>(x), ldx, nullptr, 0.f, static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), nullptr, static_cast<float*>(out), B, cin, cout);
  return cudaGetLastError();
}

template <int MODE, int S>
cudaError_t gemv_rows(const void* x, int ldx, const void* w, const void* scale, void* out, int B, int cin,
                      int cout, cudaStream_t stream) {
  if (B <= 1) return launch_gemv<MODE, 1, S>(x, ldx, w, scale, out, B, cin, cout, stream);
  return launch_gemv<MODE, 8, S>(x, ldx, w, scale, out, B, cin, cout, stream);
}

template <int MODE>
cudaError_t gemv_strip(const void* x, int ldx, const void* w, const void* scale, void* out, int B, int cin,
                       int cout, int strip, cudaStream_t stream) {
  if (strip == 64) return gemv_rows<MODE, 64>(x, ldx, w, scale, out, B, cin, cout, stream);
  if (strip == 128) return gemv_rows<MODE, 128>(x, ldx, w, scale, out, B, cin, cout, stream);
  if (strip == 256) return gemv_rows<MODE, 256>(x, ldx, w, scale, out, B, cin, cout, stream);
  return cudaErrorInvalidValue;
}

template <int BT, int S, int SPLIT>
cudaError_t launch_w4a8(const void* xq, int ldx, const void* xs, const void* w, const void* scale, int* acc32,
                        void* out, int B, int cin, int cout, int skip, cudaStream_t stream) {
  const dim3 grid((cout + S - 1) / S, (B + BT - 1) / BT, SPLIT);
  w4a8_kernel<BT, PRO_NONE, false, true, S, SPLIT><<<grid, THREADS, 0, stream>>>(
      xq, ldx, static_cast<const float*>(xs), nullptr, 0.f, static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), nullptr, static_cast<float*>(out), B, cin, cout, acc32, skip);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || SPLIT == 1) return err;
  const int n = B * cout;
  w4a8_finish<<<(n + 255) / 256, 256, 0, stream>>>(acc32, static_cast<const float*>(scale),
                                                   static_cast<const float*>(xs), static_cast<float*>(out), B, cout);
  return cudaGetLastError();
}

template <int S, int SPLIT>
cudaError_t w4a8_rows(const void* xq, int ldx, const void* xs, const void* w, const void* scale, int* acc32,
                      void* out, int B, int cin, int cout, int skip, cudaStream_t stream) {
  if (B <= 1) return launch_w4a8<1, S, SPLIT>(xq, ldx, xs, w, scale, acc32, out, B, cin, cout, skip, stream);
  return launch_w4a8<8, S, SPLIT>(xq, ldx, xs, w, scale, acc32, out, B, cin, cout, skip, stream);
}

template <int S>
cudaError_t w4a8_split(const void* xq, int ldx, const void* xs, const void* w, const void* scale, int* acc32,
                       void* out, int B, int cin, int cout, int split, int skip, cudaStream_t stream) {
  if (split == 1) return w4a8_rows<S, 1>(xq, ldx, xs, w, scale, acc32, out, B, cin, cout, skip, stream);
  if (split == 2) return w4a8_rows<S, 2>(xq, ldx, xs, w, scale, acc32, out, B, cin, cout, skip, stream);
  if (split == 4) return w4a8_rows<S, 4>(xq, ldx, xs, w, scale, acc32, out, B, cin, cout, skip, stream);
  return cudaErrorInvalidValue;
}

template <int MODE, int BT, int PRO, bool RES>
cudaError_t launch_strip(const void* x, int ldx, const float* gamma, float eps, const void* w, const void* scale,
                         const float* residual, void* out, int B, int cin, int cout, cudaStream_t stream) {
  const dim3 grid((cout + STRIP - 1) / STRIP, (B + BT - 1) / BT);
  gemv_kernel<MODE, BT, PRO, RES><<<grid, THREADS, 0, stream>>>(
      static_cast<const bf16*>(x), ldx, gamma, eps, static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), residual, static_cast<float*>(out), B, cin, cout);
  return cudaGetLastError();
}

template <int BT>
cudaError_t strip_flags(const void* x, int ldx, const float* gamma, float eps, int pro, const void* w,
                        const void* scale, const float* res, void* out, int B, int cin, int cout, int mode,
                        cudaStream_t s) {
  if (mode == INT8) {
    if (pro != PRO_NONE || res) return cudaErrorInvalidValue;
    return launch_strip<INT8, BT, PRO_NONE, false>(x, ldx, gamma, eps, w, scale, res, out, B, cin, cout, s);
  }
  if (mode != PAIRED) return cudaErrorInvalidValue;
  if (pro == PRO_NONE)
    return res ? launch_strip<PAIRED, BT, PRO_NONE, true>(x, ldx, gamma, eps, w, scale, res, out, B, cin, cout, s)
               : launch_strip<PAIRED, BT, PRO_NONE, false>(x, ldx, gamma, eps, w, scale, res, out, B, cin, cout, s);
  if (pro == PRO_NORM)
    return res ? launch_strip<PAIRED, BT, PRO_NORM, true>(x, ldx, gamma, eps, w, scale, res, out, B, cin, cout, s)
               : launch_strip<PAIRED, BT, PRO_NORM, false>(x, ldx, gamma, eps, w, scale, res, out, B, cin, cout, s);
  if (pro == PRO_SILUGLU)
    return res ? launch_strip<PAIRED, BT, PRO_SILUGLU, true>(x, ldx, gamma, eps, w, scale, res, out, B, cin, cout, s)
               : launch_strip<PAIRED, BT, PRO_SILUGLU, false>(x, ldx, gamma, eps, w, scale, res, out, B, cin, cout,
                                                              s);
  return cudaErrorInvalidValue;
}

}  // namespace

// supir_qgemv_strip: the strip body's paired (mode 0) and int8 (mode 2)
// GEMV at strip 32, with the arguments of quant_gemv.cu's supir_qgemv;
// tiles of 1 row, or 8 rows (more rows take further tiles). Returns the
// launch's cudaError_t.
extern "C" int supir_qgemv_strip(const void* x, int ldx, const void* gamma, float eps, int prologue, const void* w,
                                 const void* scale, const void* residual, void* out, int B, int cin, int cout,
                                 int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || cin <= 0 || cout <= 0 || cout % 8 || cin % 2) return (int)cudaErrorInvalidValue;
  if (prologue == PRO_NORM && gamma == nullptr) return (int)cudaErrorInvalidValue;
  const float* gm = static_cast<const float*>(gamma);
  const float* res = static_cast<const float*>(residual);
  if (B <= 1) return (int)strip_flags<1>(x, ldx, gm, eps, prologue, w, scale, res, out, B, cin, cout, mode, s);
  return (int)strip_flags<8>(x, ldx, gm, eps, prologue, w, scale, res, out, B, cin, cout, mode, s);
}

// supir_qgemv_geo: K7's half-split int4 (mode 1) or K11's native int4
// (mode 3) GEMV at a strip of 64, 128 or 256 columns; x bf16 [B, >= cin]
// with row stride ldx, w 8-byte aligned, scale fp32 [cout], out fp32
// [B, cout]. No prologue, no residual. Returns the launch's cudaError_t.
extern "C" int supir_qgemv_geo(const void* x, int ldx, const void* w, const void* scale, void* out, int B,
                               int cin, int cout, int mode, int strip, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || cin <= 0 || cout <= 0 || cout % 8 || cin % 2) return (int)cudaErrorInvalidValue;
  if (mode == HALF_SPLIT) return (int)gemv_strip<HALF_SPLIT>(x, ldx, w, scale, out, B, cin, cout, strip, s);
  if (mode == NATIVE) return (int)gemv_strip<NATIVE>(x, ldx, w, scale, out, B, cin, cout, strip, s);
  return (int)cudaErrorInvalidValue;
}

// supir_qgemv_w4a8_geo: K10's W4A8 GEMV at a strip of 32-256 columns and a
// split-K of 1, 2 or 4 (not strip 32 with split 1: that is quant_gemv.cu's).
// xq int8 [B, >= cin], 4-byte aligned rows of stride ldx; xs fp32 [B] the
// rows' absmax; w paired uint8 [cin/2, cout]; acc32 int32 [B, cout], zeroed
// by the caller, when split > 1 (else unused); skip: a slice to leave out
// (planted fault), -1 for none. cin % 4 == 0.
extern "C" int supir_qgemv_w4a8_geo(const void* xq, int ldx, const void* xs, const void* w, const void* scale,
                                    void* acc32, void* out, int B, int cin, int cout, int strip, int split,
                                    int skip, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || cin <= 0 || cout <= 0 || cout % 8 || cin % 4 || ldx % 4) return (int)cudaErrorInvalidValue;
  if (split > 1 && acc32 == nullptr) return (int)cudaErrorInvalidValue;
  int* acc = static_cast<int*>(acc32);
  if (strip == 32 && split > 1) return (int)w4a8_split<32>(xq, ldx, xs, w, scale, acc, out, B, cin, cout, split, skip, s);
  if (strip == 64) return (int)w4a8_split<64>(xq, ldx, xs, w, scale, acc, out, B, cin, cout, split, skip, s);
  if (strip == 128) return (int)w4a8_split<128>(xq, ldx, xs, w, scale, acc, out, B, cin, cout, split, skip, s);
  if (strip == 256) return (int)w4a8_split<256>(xq, ldx, xs, w, scale, acc, out, B, cin, cout, split, skip, s);
  return (int)cudaErrorInvalidValue;
}
