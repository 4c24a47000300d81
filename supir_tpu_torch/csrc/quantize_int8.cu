// K8: per-output-channel absmax int8 quantization for Hopper (sm_90a).
//
// Replaces supir_tpu/ops/quantize.py:_quant_kernel (:21, pallas_call :49,
// quantize_int8 :39): for w [cin, cout] fp32,
//   scale[c] = max_k |w[k, c]| * float(1 / 127)   (as XLA computes the JAX
//              function's absmax / 127 off the TPU)
//   q[k, c]  = clip(floor(w[k, c] / max(scale[c], 1e-12) + u), -127, 127)
// with u ~ U[0, 1) (stochastic rounding, as the TPU kernel draws it from its
// PRNG), or q = clip(round_half_even(w / scale)) when `stochastic` is 0, as
// the JAX function does off the TPU (:43-48). u is (r >> 8) * 2^-24 for a
// 32-bit Philox4x32-10 output r (curand) keyed by the seed, with element e
// taking word e % 4 of counter e / 4: nothing random is read from memory,
// and the same seed gives the same bytes.
//
// What bounds it: bytes. It reads w twice (once for the column maxima, once
// to quantize) and writes one byte per weight; a few flops per element.
//
// Design: the TPU kernel held the whole matrix in VMEM and reduced it in
// one step. Here `colmax_kernel` gives each thread one column and a slab of
// rows (coalesced along cout), and merges slabs with atomicMax on the
// maxima's bit patterns (non-negative floats order as unsigned integers, so
// the result does not depend on the order). `quant_kernel` then quantizes
// four elements per thread from one Philox draw.

#include <cuda_runtime.h>
#include <curand_kernel.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_SLAB = 64;

__global__ void __launch_bounds__(THREADS)
colmax_kernel(const float* __restrict__ w, int cin, int cout, unsigned int* __restrict__ amax) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= cout) return;
  const int r0 = blockIdx.y * ROWS_PER_SLAB;
  const int r1 = min(cin, r0 + ROWS_PER_SLAB);
  float m = 0.f;
  for (int r = r0; r < r1; ++r) m = fmaxf(m, fabsf(w[(size_t)r * cout + c]));
  atomicMax(amax + c, __float_as_uint(m));
}

__global__ void __launch_bounds__(THREADS)
quant_kernel(const float* __restrict__ w, long long n, int cout,
             const unsigned int* __restrict__ amax, unsigned long long seed, int stochastic,
             int8_t* __restrict__ q, float* __restrict__ scale_out) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long e0 = 4 * t;
  if (e0 >= n) return;
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (stochastic) {
    curandStatePhilox4_32_10_t st;
    curand_init(seed, (unsigned long long)t, 0ull, &st);
    r = curand4(&st);
  }
  const unsigned int words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long e = e0 + i;
    if (e >= n) break;
    const int c = (int)(e % cout);
    const float s = __uint_as_float(amax[c]) * (1.0f / 127.0f);
    const float scaled = w[e] / fmaxf(s, 1e-12f);
    float v;
    if (stochastic) {
      const float u = (float)(words[i] >> 8) * (1.0f / 16777216.0f);
      v = floorf(scaled + u);
    } else {
      v = rintf(scaled);
    }
    v = fminf(fmaxf(v, -127.f), 127.f);
    q[e] = (int8_t)(int)v;
    if (e < cout) scale_out[e] = s;
  }
}

}  // namespace

// Plain C entry point for ctypes. amax is a zeroed uint32 [cout] scratch,
// q int8 [cin, cout], scale fp32 [cout]. Returns the cudaError_t of the
// launches (0 on success).
extern "C" int supir_quantize_int8(const void* w, int cin, int cout, void* amax,
                                   unsigned long long seed, int stochastic,
                                   void* q, void* scale, void* stream) {
  if (cin <= 0 || cout <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  unsigned int* am = static_cast<unsigned int*>(amax);
  const dim3 g1((cout + THREADS - 1) / THREADS, (cin + ROWS_PER_SLAB - 1) / ROWS_PER_SLAB);
  colmax_kernel<<<g1, THREADS, 0, s>>>(wf, cin, cout, am);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)cin * cout;
  const long long threads = (n + 3) / 4;
  const unsigned int blocks = (unsigned int)((threads + THREADS - 1) / THREADS);
  quant_kernel<<<blocks, THREADS, 0, s>>>(wf, n, cout, am, seed, stochastic,
                                          static_cast<int8_t*>(q), static_cast<float*>(scale));
  return (int)cudaGetLastError();
}
