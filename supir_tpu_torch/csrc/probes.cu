// T4a, the native int4 cast, for Hopper (sm_90a): its counterpart is the
// Pallas kernel of the TPU probe tools/int4_native_probe.py;
// supir_tpu_torch/tools/int4_native_probe.py runs it.
//
//   T4a native cast: column-pair-packed int4 u8 [r, c/2] -> bf16 [r, c] x 2
//       (byte (k, j) = column 2j low | 2j+1 high), through quant_gemv.cuh's
//       nib2_bf16 and one packed multiply. Replaces tools/int4_native_probe.py:
//       stage2_mosaic's k (:46, pallas_call :50), the int4 -> bf16 cast of a
//       [128, 128] block.
// (T1a and T1b run on the GEMV body's ring, csrc/colsum_tc.cu; T1c, T2, T3b
// and T4b on csrc/quant_gemv_tc.cu; T3a on the body's own decodes,
// csrc/nibble_order.cu.)
//
// What bounds it: bytes. The cast writes 4 bytes per byte read; at the
// probe's [128, 128] it is one launch.
//
// FAULT instances exist for planted faults only: 1 swaps the two nibbles of
// a byte, 2 leaves them unsigned.

#include "quant_gemv.cuh"

using namespace qgemv;

namespace {

template <int FAULT>
__global__ void native_cast_kernel(const uint8_t* __restrict__ q, size_t n, __nv_bfloat162* __restrict__ out) {
  const __nv_bfloat162 two = __floats2bfloat162_rn(2.f, 2.f);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (size_t)gridDim.x * blockDim.x) {
    uint32_t b = q[i];
    if (FAULT == 1) b = ((b >> 4) | (b << 4)) & 0xFFu;
    __nv_bfloat162 v;
    if (FAULT == 2)
      v = __floats2bfloat162_rn((float)(b & 0xFu), (float)(b >> 4));
    else
      v = nib2_bf16(b);
    out[i] = __hmul2(v, two);
  }
}

int grid_for(size_t n) {
  const size_t blocks = (n + 255) / 256;
  return (int)(blocks < 4096 ? blocks : 4096);
}

}  // namespace

// supir_native_cast (T4a): q uint8 [n] column-pair-packed int4 -> out bf16
// [2n], 4-byte aligned: out[2i] = 2 * low nibble, out[2i+1] = 2 * high.
extern "C" int supir_native_cast(const void* q, long long n, int fault, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || reinterpret_cast<uintptr_t>(out) % 4) return (int)cudaErrorInvalidValue;
  const int blocks = grid_for((size_t)n);
  const uint8_t* qq = static_cast<const uint8_t*>(q);
  __nv_bfloat162* o = static_cast<__nv_bfloat162*>(out);
  if (fault == 0) native_cast_kernel<0><<<blocks, 256, 0, s>>>(qq, (size_t)n, o);
  else if (fault == 1) native_cast_kernel<1><<<blocks, 256, 0, s>>>(qq, (size_t)n, o);
  else if (fault == 2) native_cast_kernel<2><<<blocks, 256, 0, s>>>(qq, (size_t)n, o);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
