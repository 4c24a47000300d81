// K5, K6, K7: dequant-fused decode GEMVs for Hopper (sm_90a).
//
// Replace, in supir_tpu/ops/quantize.py:
//   K5 _qmm_fused_kernel  (:260, pallas_call :357, int4_paired_fused_matmul)
//   K6 _qmm_paired_kernel (:116, pallas_call :171, int4_paired_matmul)
//   K7 _qmm_kernel        (:606, pallas_call :674, int8_matmul / int4_matmul)
//
// What they compute: out[b, c] = sum_k x'[b, k] * q[k, c] * scale[c]
// (+ residual[b, c]), fp32 out, for up to 32 rows of bf16 activations against
// per-output-channel quantized weights. Three weight layouts (MODE):
//   0 paired int4     uint8 [cin/2, cout], byte i = row 2i (low nibble) | row 2i+1 (high)
//   1 half-split int4 uint8 [cin/2, cout], byte i = row i (low) | row i + cin/2 (high)
//   2 int8            int8 [cin, cout]
// Nibbles are 4-bit two's complement in [-7, 7]. x' is x itself, or K5's
// prologue (PRO): 1 RMSNorm, x' = bf16((x * rsqrt(mean(x^2) + eps)) * gamma);
// 2 SiLU-GLU over x = [a | g], x' = bf16((a * sigmoid(a)) * g), both in fp32
// and rounded to bf16 as the TPU kernel does (quantize.py:299-302). K5's
// optional fp32 residual is the RESIDUAL flag. K6 is the paired instance
// with neither, K7 the half-split and int8 instances.
//
// What bounds it: bytes. A decode GEMV reads every weight byte once and does
// 2 * rows flops per weight (4 * rows per int4 byte), far below the H100's
// ridge point, so the least time is the weight bytes over 3.35 TB/s (47 us
// per 13B layer in paired int4, 94 us in int8).
//
// Design: each block owns a strip of 32 output columns and one tile of up
// to 8 activation rows, and streams its weights down the whole contraction,
// so nothing crosses blocks and no split-K reduction is needed; 32 columns
// give cout / 32 blocks (160 at cout 5120, 864 at 27648) for the 132 SMs. In
// a block of 256 threads, 4 column threads x 8 bytes cover the strip's 32
// bytes of one weight row (one 32-byte sector) and 64 k-groups walk the rows
// with stride 64, eight 8-byte loads in flight per thread. The activation
// rows the weights meet are staged in shared memory in chunks of weight
// rows, as fp32 values, with the prologue applied once per block as they are
// staged (RMSNorm's row statistics come from one pass over the rows first):
// nothing of the prologue goes to device memory. Nibbles become floats by the
// exponent trick ((n & 0xF) ^ 0x4B000008) - (2^23 + 8): no integer-to-float
// conversions, which run at a quarter of the FMA rate. Each thread keeps
// fp32 accumulators for its tile's rows x 8 columns; the 64 k-groups are
// summed by warp shuffles and one pass through shared memory in a fixed
// order, and scale and residual are applied once. More than 8 rows take
// further row tiles (grid.y), each streaming the weights again. No wgmma,
// TMA or cp.async yet: a simple right kernel first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;
constexpr int COL_THREADS = 4;                    // x 8 bytes = 32 columns
constexpr int STRIP = COL_THREADS * 8;            // output columns per block
constexpr int KGROUPS = THREADS / COL_THREADS;    // 64
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 8;                         // weight loads in flight per thread
constexpr int BATCH = KGROUPS * UNROLL;           // weight rows per load batch
constexpr int XS_FLOATS = 8192;                   // 32 KB of staged activations

enum { PAIRED = 0, HALF_SPLIT = 1, INT8 = 2 };
enum { PRO_NONE = 0, PRO_NORM = 1, PRO_SILUGLU = 2 };

// signed nibble (low 4 bits of n) -> float, by the exponent trick
__device__ __forceinline__ float nib(uint32_t n) {
  return __int_as_float((n & 0xFu) ^ 0x4B000008u) - 8388616.0f;
}

// signed byte (low 8 bits of n) -> float
__device__ __forceinline__ float sbyte(uint32_t n) {
  return __int_as_float((n & 0xFFu) ^ 0x4B000080u) - 8388736.0f;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int MODE, int BT, int PRO, bool RESIDUAL>
__global__ void __launch_bounds__(THREADS)
gemv_kernel(const bf16* __restrict__ x, int ldx, const float* __restrict__ gamma, float eps,
            const uint8_t* __restrict__ w, const float* __restrict__ scale,
            const float* __restrict__ residual, float* __restrict__ out,
            int B, int cin, int cout) {
  constexpr int VALS = MODE == INT8 ? 1 : 2;          // activation values per weight row
  constexpr int ROWS = (XS_FLOATS / (BT * VALS)) / BATCH * BATCH;  // weight rows per chunk
  static_assert(ROWS >= BATCH, "a chunk holds at least one load batch");
  __shared__ __align__(16) float xs[BT * ROWS * VALS];
  __shared__ float red[WARPS][BT][STRIP];
  __shared__ float rstd[BT];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ct = lane % COL_THREADS;
  const int kg = tid / COL_THREADS;
  const int c0 = blockIdx.x * STRIP + ct * 8;
  const int b0 = blockIdx.y * BT;
  const int nb = min(BT, B - b0);                     // rows of this tile
  const bool col_ok = c0 < cout;
  const int nrows = MODE == INT8 ? cin : cin / 2;     // weight rows
  const int half = cin / 2;

  if (PRO == PRO_NORM) {
    float ss[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) ss[b] = 0.f;
    for (int k = tid; k < cin; k += THREADS)
#pragma unroll
      for (int b = 0; b < BT; ++b)
        if (b < nb) {
          const float v = __bfloat162float(x[(size_t)(b0 + b) * ldx + k]);
          ss[b] = fmaf(v, v, ss[b]);
        }
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      float v = ss[b];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) red[warp][b][0] = v;
    }
    __syncthreads();
    if (tid < BT) {
      float t = 0.f;
#pragma unroll
      for (int wi = 0; wi < WARPS; ++wi) t += red[wi][tid][0];
      rstd[tid] = rsqrtf(t / (float)cin + eps);
    }
    // the staging loop's first __syncthreads publishes rstd
  }

  float acc[BT][8];
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[b][j] = 0.f;

  for (int pc0 = 0; pc0 < nrows; pc0 += ROWS) {
    const int rows = min(ROWS, nrows - pc0);
    __syncthreads();  // every thread is done with the previous chunk
    // stage x' for weight rows [pc0, pc0 + rows); rows and activation rows
    // past the end stage zeros, so the weight loop needs no bounds on them
    for (int i = tid; i < BT * ROWS * VALS; i += THREADS) {
      const int b = i / (ROWS * VALS);
      const int r = (i / VALS) % ROWS;
      const int v = i % VALS;
      float val = 0.f;
      if (b < nb && r < rows) {
        const int p = pc0 + r;
        const int k = MODE == PAIRED ? 2 * p + v : (MODE == HALF_SPLIT ? p + v * half : p);
        const bf16* xr = x + (size_t)(b0 + b) * ldx;
        val = __bfloat162float(xr[k]);
        if (PRO == PRO_NORM) {
          val = round_bf16((val * rstd[b]) * gamma[k]);
        } else if (PRO == PRO_SILUGLU) {
          const float g = __bfloat162float(xr[k + cin]);
          val = round_bf16((val * (1.f / (1.f + expf(-val)))) * g);
        }
      }
      xs[i] = val;
    }
    __syncthreads();

    for (int r0 = 0; r0 < rows; r0 += BATCH) {
      uint2 wv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int p = pc0 + r0 + u * KGROUPS + kg;
        wv[u] = make_uint2(0u, 0u);   // decodes to zero weights
        if (col_ok && p < nrows)
          wv[u] = __ldg(reinterpret_cast<const uint2*>(w + (size_t)p * cout + c0));
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int r = r0 + u * KGROUPS + kg;  // < ROWS: ROWS is a multiple of BATCH
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          if (MODE == INT8) {
            const float x0 = xs[b * ROWS + r];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const uint32_t word = j < 4 ? wv[u].x : wv[u].y;
              acc[b][j] = fmaf(x0, sbyte(word >> (8 * (j % 4))), acc[b][j]);
            }
          } else {
            const float2 xx = reinterpret_cast<const float2*>(xs)[b * ROWS + r];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const uint32_t byte = (j < 4 ? wv[u].x : wv[u].y) >> (8 * (j % 4));
              acc[b][j] = fmaf(xx.x, nib(byte), acc[b][j]);
              acc[b][j] = fmaf(xx.y, nib(byte >> 4), acc[b][j]);
            }
          }
        }
      }
    }
  }

  // sum the 8 k-groups of each warp that share a column thread
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = acc[b][j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[b][j] = v;
    }
  __syncthreads();  // red's use for the RMSNorm statistics is over
  if (lane < COL_THREADS) {
#pragma unroll
    for (int b = 0; b < BT; ++b)
#pragma unroll
      for (int j = 0; j < 8; ++j) red[warp][b][ct * 8 + j] = acc[b][j];
  }
  __syncthreads();

  // then the warps, in a fixed order; scale and residual once
  for (int i = tid; i < BT * STRIP; i += THREADS) {
    const int b = i / STRIP;
    const int col = i % STRIP;
    const int row = b0 + b;
    const int c = blockIdx.x * STRIP + col;
    if (b >= nb || c >= cout) continue;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) s += red[wi][b][col];
    s *= scale[c];
    if (RESIDUAL) s += residual[(size_t)row * cout + c];
    out[(size_t)row * cout + c] = s;
  }
}

struct Args {
  const bf16* x; int ldx; const float* gamma; float eps;
  const uint8_t* w; const float* scale; const float* residual; float* out;
  int B, cin, cout;
};

template <int MODE, int BT, int PRO, bool RES>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.cout + STRIP - 1) / STRIP, (a.B + BT - 1) / BT);
  gemv_kernel<MODE, BT, PRO, RES><<<grid, THREADS, 0, stream>>>(
      a.x, a.ldx, a.gamma, a.eps, a.w, a.scale, a.residual, a.out, a.B, a.cin, a.cout);
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
    // K7 has neither prologue nor residual
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

}  // namespace

// Plain C entry point for ctypes; returns the cudaError_t of the launch (0 on
// success). x is bf16 [B, >= cin] (>= 2 cin with SiLU-GLU) with row stride
// ldx; gamma fp32 [cin] (RMSNorm only); w the packed weights (see MODE
// above), 8-byte aligned; scale fp32 [cout]; residual fp32 [B, cout] or null;
// out fp32 [B, cout]. prologue: 0 none, 1 RMSNorm, 2 SiLU-GLU (paired only).
extern "C" int supir_qgemv(const void* x, int ldx, const void* gamma, float eps, int prologue,
                           const void* w, const void* scale, const void* residual, void* out,
                           int B, int cin, int cout, int mode, void* stream) {
  const Args a{static_cast<const bf16*>(x), ldx, static_cast<const float*>(gamma), eps,
               static_cast<const uint8_t*>(w), static_cast<const float*>(scale),
               static_cast<const float*>(residual), static_cast<float*>(out), B, cin, cout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || cin <= 0 || cout <= 0 || cout % 8 || cin % 2) return (int)cudaErrorInvalidValue;
  if (prologue == PRO_NORM && gamma == nullptr) return (int)cudaErrorInvalidValue;
  if (mode == PAIRED) return (int)launch_rows<PAIRED>(a, prologue, s);
  if (mode == HALF_SPLIT) return (int)launch_rows<HALF_SPLIT>(a, prologue, s);
  if (mode == INT8) return (int)launch_rows<INT8>(a, prologue, s);
  return (int)cudaErrorInvalidValue;
}
