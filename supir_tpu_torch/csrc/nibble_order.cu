// T3a, the nibble-order check, and T4a, the native int4 cast, for Hopper
// (sm_90a): packed int4 bytes read back through the int4 decodes that the
// tensor-core decode GEMV (quant_gemv_tc.cu) compiles, from the one
// definition both include (tc_decode.cuh).
//
// T3a replaces tools/bitcast_probe.py:order_kernel (:33, pallas_call :46),
// which reads the order pltpu.bitcast gives: quantize_int4_paired's bytes.
//
// What it computes: u8 q [r, c] -> fp32 [2r, c], row 2i the low nibble of
// byte row i and row 2i + 1 the high one, sign-extended (8 -> -8): the order
// the packer writes. Every byte is decoded as the body's lanes decode it:
//   paired (decode 0): a thread takes one 4-byte word (4 columns of packed
//       row i), as a paired or half-split lane reads it, and turns each
//       byte into a bf16x2 by nib2 (a permute, a lop3, an hsub2); both
//       halves are exact, so the fp32 store changes nothing.
//   w4a8 (decode 1): a thread takes the words of packed rows 2p and 2p + 1
//       at the same 4 columns, as a W4A8 lane reads a row pair, and quad16
//       makes the A registers of its 4 columns: s8 bytes of value 16 n in
//       the k order 4p, 4p + 2, 4p + 1, 4p + 3 (k = output row). Each byte
//       is shifted back by 4 as an s8 and put back in row order (the body
//       stages x in that order instead).
// Either decode must give the plain unpack on every byte.
//
// T4a replaces tools/int4_native_probe.py:stage2_mosaic's k (:46,
// pallas_call :50), the int4 -> bf16 cast of a [128, 128] block, doubled:
// column-pair-packed int4 u8 [r, c/2] (byte (k, j) = column 2j low | 2j+1
// high, quantize_int4_native's layout) -> bf16 [r, c] x 2. A thread takes
// one 4-byte word (4 column pairs, as a native lane of the body reads its
// weight stage) and turns each byte into a bf16x2 by nib2, the decode K11's
// MODE_NATIVE runs (a permute, a lop3, an hsub2; exact for every nibble),
// then doubles it with one packed multiply (exact).
//
// What bounds them: one launch. T3a's input is u8 [2, 128] (all 256 byte
// values), 256 bytes in and 1 KB out; T4a's [128, 64], 8 KB in and 32 KB
// out: nanoseconds of memory traffic, so their time is the launch;
// supir_empty_launch, an empty kernel, measures that floor on the same
// stream.
//
// Planted faults (checks only): 1 the nibbles swapped (nib2's or quad16's
// permute selector mirrored: tc_decode.cuh's SWAP), 2 the sign not restored
// (nib2: the lop3's ^ 8 dropped, SIGNED false; w4a8: the bytes read back
// unsigned), 3 (T3a's w4a8) the k order left permuted.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_decode.cuh"

namespace {

constexpr int DECODE_PAIRED = 0, DECODE_W4A8 = 1;
constexpr int FAULT_SWAP = 1, FAULT_UNSIGNED = 2, FAULT_K_ORDER = 3;

// one thread per word: packed row e / cw, columns 4 (e % cw) .. + 3
template <int FAULT>
__global__ void order_paired_kernel(const uint32_t* __restrict__ q, int r, int cw, float* __restrict__ out) {
  const size_t n = (size_t)r * cw, c = 4 * (size_t)cw;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n; e += (size_t)gridDim.x * blockDim.x) {
    const size_t row = e / cw, j = e % cw;
    const uint32_t w = q[e], w4 = w >> 4;
    float lo[4], hi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t v = tcdec::nib2<FAULT != FAULT_UNSIGNED, FAULT == FAULT_SWAP>(w, w4, i);
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
      lo[i] = f.x;
      hi[i] = f.y;
    }
    float4* dst = reinterpret_cast<float4*>(out + 2 * row * c + 4 * j);
    dst[0] = make_float4(lo[0], lo[1], lo[2], lo[3]);
    dst[c / 4] = make_float4(hi[0], hi[1], hi[2], hi[3]);
  }
}

// one thread per word pair: packed rows 2p, 2p + 1 (zeros past r), columns
// 4 (e % cw) .. + 3; output rows 4p .. 4p + 3 (those below 2r)
template <int FAULT>
__global__ void order_w4a8_kernel(const uint32_t* __restrict__ q, int r, int cw, float* __restrict__ out) {
  const int pairs = (r + 1) / 2;
  const size_t n = (size_t)pairs * cw, c = 4 * (size_t)cw;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n; e += (size_t)gridDim.x * blockDim.x) {
    const int p = (int)(e / cw);
    const size_t j = e % cw;
    const uint32_t wa = q[(size_t)(2 * p) * cw + j];
    const uint32_t wb = 2 * p + 1 < r ? q[(size_t)(2 * p + 1) * cw + j] : 0u;
    uint32_t reg[4];                                  // columns 4j .. 4j + 3
    tcdec::quad16<FAULT == FAULT_SWAP>(reg[0], reg[1], wa, wb, 0);
    tcdec::quad16<FAULT == FAULT_SWAP>(reg[2], reg[3], wa, wb, 1);
    float v[4][4];                                    // [byte][column]
#pragma unroll
    for (int col = 0; col < 4; ++col)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint32_t byte = (reg[col] >> (8 * b)) & 0xFFu;
        v[b][col] = FAULT == FAULT_UNSIGNED ? (float)(byte >> 4) : (float)((int)(int8_t)byte >> 4);
      }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      // byte b holds k 4p, 4p + 2, 4p + 1, 4p + 3
      const int row = 4 * p + (FAULT == FAULT_K_ORDER ? b : (b == 1 ? 2 : (b == 2 ? 1 : b)));
      if (row < 2 * r)
        *reinterpret_cast<float4*>(out + row * c + 4 * j) = make_float4(v[b][0], v[b][1], v[b][2], v[b][3]);
    }
  }
}

// T4a: one thread per 4-byte word of q (n bytes; a last partial word read
// and written byte by byte); out word i = bf16x2 of byte i, doubled
template <bool SIGNED, bool SWAP>
__global__ void native_cast_kernel(const uint8_t* __restrict__ q, size_t n, uint32_t* __restrict__ out) {
  const __nv_bfloat162 two = __floats2bfloat162_rn(2.f, 2.f);
  const size_t words = (n + 3) / 4;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < words; e += (size_t)gridDim.x * blockDim.x) {
    const size_t i0 = 4 * e;
    const bool whole = i0 + 4 <= n;
    uint32_t w = 0;
    if (whole)
      w = reinterpret_cast<const uint32_t*>(q)[e];
    else
      for (size_t b = 0; i0 + b < n; ++b) w |= (uint32_t)q[i0 + b] << (8 * b);
    const uint32_t w4 = w >> 4;
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t pair = tcdec::nib2<SIGNED, SWAP>(w, w4, i);
      const __nv_bfloat162 x = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&pair), two);
      r[i] = *reinterpret_cast<const uint32_t*>(&x);
    }
    if (whole)
      reinterpret_cast<uint4*>(out)[e] = make_uint4(r[0], r[1], r[2], r[3]);
    else
      for (size_t b = 0; i0 + b < n; ++b) out[i0 + b] = r[b];
  }
}

__global__ void empty_kernel() {}

int grid_for(size_t n) {
  const size_t blocks = (n + 255) / 256;
  return (int)(blocks < 4096 ? blocks : 4096);
}

template <int FAULT>
cudaError_t launch(const uint32_t* q, int r, int cw, int decode, float* out, cudaStream_t s) {
  if (decode == DECODE_PAIRED)
    order_paired_kernel<FAULT><<<grid_for((size_t)r * cw), 256, 0, s>>>(q, r, cw, out);
  else
    order_w4a8_kernel<FAULT><<<grid_for((size_t)((r + 1) / 2) * cw), 256, 0, s>>>(q, r, cw, out);
  return cudaGetLastError();
}

}  // namespace

// supir_unpack_nibbles (T3a): q uint8 [r, c], 4-byte aligned, c % 4 == 0 ->
// out fp32 [2r, c], 16-byte aligned; decode 0 paired (nib2), 1 W4A8
// (quad16); fault 0 none, 1 nibbles swapped, 2 sign not restored, 3 (W4A8
// only) k order left permuted. Returns the launch's cudaError_t.
extern "C" int supir_unpack_nibbles(const void* q, int r, int c, int decode, int fault, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r <= 0 || c <= 0 || c % 4 || reinterpret_cast<uintptr_t>(q) % 4 || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  if (decode != DECODE_PAIRED && decode != DECODE_W4A8) return (int)cudaErrorInvalidValue;
  const uint32_t* qq = static_cast<const uint32_t*>(q);
  float* o = static_cast<float*>(out);
  const int cw = c / 4;
  if (fault == 0) return (int)launch<0>(qq, r, cw, decode, o, s);
  if (fault == FAULT_SWAP) return (int)launch<FAULT_SWAP>(qq, r, cw, decode, o, s);
  if (fault == FAULT_UNSIGNED) return (int)launch<FAULT_UNSIGNED>(qq, r, cw, decode, o, s);
  if (fault == FAULT_K_ORDER && decode == DECODE_W4A8) return (int)launch<FAULT_K_ORDER>(qq, r, cw, decode, o, s);
  return (int)cudaErrorInvalidValue;
}

// supir_native_cast (T4a): q uint8 [n] column-pair-packed int4, 4-byte
// aligned -> out bf16 [2n], 16-byte aligned: out[2i] = 2 * low nibble of
// byte i, out[2i+1] = 2 * high; fault 0 none, 1 nibbles swapped, 2 sign not
// restored. Returns the launch's cudaError_t.
extern "C" int supir_native_cast(const void* q, long long n, int fault, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || reinterpret_cast<uintptr_t>(q) % 4 || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  const int blocks = grid_for(((size_t)n + 3) / 4);
  const uint8_t* qq = static_cast<const uint8_t*>(q);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (fault == 0) native_cast_kernel<true, false><<<blocks, 256, 0, s>>>(qq, (size_t)n, o);
  else if (fault == FAULT_SWAP) native_cast_kernel<true, true><<<blocks, 256, 0, s>>>(qq, (size_t)n, o);
  else if (fault == FAULT_UNSIGNED) native_cast_kernel<false, false><<<blocks, 256, 0, s>>>(qq, (size_t)n, o);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// supir_empty_launch: one empty kernel of one warp on `stream`, the launch
// floor T3a's and T4a's times are read against. Returns the launch's cudaError_t.
extern "C" int supir_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
