// The decode GEMVs' common body: one block computes one strip of 32 output
// columns for a tile of up to 8 activation rows, streaming the strip's
// weights down the whole contraction. quant_gemv.cu (K5, K6, K7, K11) runs
// one strip per block; quant_pair.cu (K9) runs many strips per block in a
// persistent, cooperative launch. Both keep the arithmetic of this file.
//
// Layout of a block of 256 threads: 4 column threads x 8 columns cover the
// strip, 64 k-groups walk the weight rows with stride 64, eight loads in
// flight per thread. The activation rows the weights meet are staged in
// shared memory in chunks of weight rows, as fp32 values, through an
// activation functor that applies the caller's prologue once per block as
// they are staged. Nibbles become floats by the exponent trick
// ((n & 0xF) ^ 0x4B000008) - (2^23 + 8): no integer-to-float conversions,
// which run at a quarter of the FMA rate. The 64 k-groups are summed by warp
// shuffles and one pass through shared memory in a fixed order, so a result
// does not depend on scheduling.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qgemv {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int COL_THREADS = 4;                    // x 8 columns = the strip
constexpr int STRIP = COL_THREADS * 8;            // output columns per strip
constexpr int KGROUPS = THREADS / COL_THREADS;    // 64
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 8;                         // weight loads in flight per thread
constexpr int BATCH = KGROUPS * UNROLL;           // weight rows per load batch
constexpr int XS_FLOATS = 8192;                   // 32 KB of staged activations

// Weight layouts. Nibbles are 4-bit two's complement in [-7, 7].
//   PAIRED     uint8 [cin/2, cout], byte i = row 2i (low nibble) | row 2i+1 (high)
//   HALF_SPLIT uint8 [cin/2, cout], byte i = row i (low) | row i + cin/2 (high)
//   INT8       int8 [cin, cout]
//   NATIVE     uint8 [cin, cout/2], byte (k, j) = column 2j (low) | column 2j+1 (high):
//              a dense row-major s4 buffer, one byte feeding two outputs of one row
enum { PAIRED = 0, HALF_SPLIT = 1, INT8 = 2, NATIVE = 3 };
enum { PRO_NONE = 0, PRO_NORM = 1, PRO_SILUGLU = 2 };

template <int MODE> struct Layout {
  static constexpr int VALS = (MODE == PAIRED || MODE == HALF_SPLIT) ? 2 : 1;  // activation values per weight row
};

template <int MODE, int BT> struct Chunk {
  // weight rows staged per chunk: as many as XS_FLOATS holds, in load batches
  static constexpr int ROWS = (XS_FLOATS / (BT * Layout<MODE>::VALS)) / BATCH * BATCH;
  static constexpr int FLOATS = BT * ROWS * Layout<MODE>::VALS;
  static_assert(ROWS >= BATCH, "a chunk holds at least one load batch");
};

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

__device__ __forceinline__ float silu_glu(float a, float g) {
  return (a * (1.f / (1.f + expf(-a)))) * g;
}

// Activation functors: the value x'[b, k] that meets weight row k, for row b
// of the tile (b < the tile's rows), in fp32.
struct ActPlain {      // x itself, bf16
  const bf16* x; int ldx;
  __device__ float operator()(int b, int k) const { return __bfloat162float(x[(size_t)b * ldx + k]); }
};
struct ActNorm {       // bf16((x * rstd) * gamma): RMSNorm of bf16 x
  const bf16* x; int ldx; const float* gamma; const float* rstd;
  __device__ float operator()(int b, int k) const {
    return round_bf16((__bfloat162float(x[(size_t)b * ldx + k]) * rstd[b]) * gamma[k]);
  }
};
struct ActSiluGlu {    // bf16(silu(a) * g) over x = [a | g]
  const bf16* x; int ldx; int cin;
  __device__ float operator()(int b, int k) const {
    const bf16* xr = x + (size_t)b * ldx;
    return round_bf16(silu_glu(__bfloat162float(xr[k]), __bfloat162float(xr[k + cin])));
  }
};

// Sum v[b] over the block's threads into out[b] (b < BT), through
// red[WARPS * BT]. Every thread must call it; out is published by the
// caller's next __syncthreads.
template <int BT>
__device__ __forceinline__ void block_sum(float (&v)[BT], float* red, float* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    float s = v[b];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) red[warp * BT + b] = s;
  }
  __syncthreads();
  if (threadIdx.x < BT) {
    float t = 0.f;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) t += red[wi * BT + threadIdx.x];
    out[threadIdx.x] = t;
  }
}

// acc[b][j] = sum over the weight rows of x'[b, k] * w[k, strip * 32 + 8 ct + j]
// for the nb rows of the tile (act(b, k) gives x'); rows past nb are zero.
// xs is the block's staging area of Chunk<MODE, BT>::FLOATS floats.
template <int MODE, int BT, class Act>
__device__ __forceinline__ void strip_dot(const Act& act, int nb, const uint8_t* __restrict__ w,
                                          int cin, int cout, int strip, float* xs, float (&acc)[BT][8]) {
  constexpr int VALS = Layout<MODE>::VALS;
  constexpr int ROWS = Chunk<MODE, BT>::ROWS;
  const int tid = threadIdx.x;
  const int ct = (tid % 32) % COL_THREADS;
  const int kg = tid / COL_THREADS;
  const int c0 = strip * STRIP + ct * 8;
  const bool col_ok = c0 < cout;
  const int nrows = VALS == 1 ? cin : cin / 2;         // weight rows
  const int half = cin / 2;
  // bytes per weight row, and this thread's byte offset in it
  const size_t row_bytes = MODE == NATIVE ? (size_t)cout / 2 : (size_t)cout;
  const int col_byte = MODE == NATIVE ? c0 / 2 : c0;

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
        val = act(b, k);
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
        if (col_ok && p < nrows) {
          const uint8_t* src = w + (size_t)p * row_bytes + col_byte;
          if (MODE == NATIVE)
            wv[u].x = __ldg(reinterpret_cast<const uint32_t*>(src));   // 8 columns in 4 bytes
          else
            wv[u] = __ldg(reinterpret_cast<const uint2*>(src));
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int r = r0 + u * KGROUPS + kg;  // < ROWS: ROWS is a multiple of BATCH
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          if (MODE == NATIVE) {
            const float x0 = xs[b * ROWS + r];
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[b][j] = fmaf(x0, nib(wv[u].x >> (4 * j)), acc[b][j]);
          } else if (MODE == INT8) {
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
}

// Sum acc over the block's k-groups and write rows [b0, b0 + nb) of the
// strip: out = sum * scale (+ residual), fp32. red holds WARPS * BT * STRIP
// floats; its earlier uses must be over when the block enters.
template <int BT, bool RESIDUAL>
__device__ __forceinline__ void strip_store(float (&acc)[BT][8], float* red, int nb, int b0, int strip,
                                            const float* __restrict__ scale, const float* residual,
                                            float* out, int cout) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ct = lane % COL_THREADS;
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
  __syncthreads();
  if (lane < COL_THREADS) {
#pragma unroll
    for (int b = 0; b < BT; ++b)
#pragma unroll
      for (int j = 0; j < 8; ++j) red[(warp * BT + b) * STRIP + ct * 8 + j] = acc[b][j];
  }
  __syncthreads();

  // then the warps, in a fixed order; scale and residual once
  for (int i = tid; i < BT * STRIP; i += THREADS) {
    const int b = i / STRIP;
    const int col = i % STRIP;
    const int row = b0 + b;
    const int c = strip * STRIP + col;
    if (b >= nb || c >= cout) continue;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) s += red[(wi * BT + b) * STRIP + col];
    s *= scale[c];
    if (RESIDUAL) s += residual[(size_t)row * cout + c];
    out[(size_t)row * cout + c] = s;
  }
}

}  // namespace qgemv
