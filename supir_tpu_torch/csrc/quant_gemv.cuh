// The decode GEMVs' common body: one block computes one strip of output
// columns (32 by default) for a tile of up to 8 activation rows, streaming
// the strip's weights down the whole contraction. quant_gemv.cu (K5, K6,
// K7, K10, K11) runs one strip per block; quant_pair.cu (K9) runs many
// strips per block in a persistent, cooperative launch; gemv_sweep.cu
// instantiates the same kernels at other strip widths (and K10's with
// split-K) for the decode-GEMV probes' first designs. All keep the
// arithmetic of this file.
//
// Layout of a block of 256 threads at the default strip: 4 column threads x
// 8 columns cover the strip, 64 k-groups walk the weight rows with stride
// 64, eight loads in flight per thread. A strip of S columns (a power of two
// from 32 to 256, the template parameter S) has S / 8 column threads and
// 256 / (S / 8) k-groups: at 256 one warp spans the strip and the 8 warps
// are the k-groups. The activation rows the weights meet are staged in
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
constexpr int STRIP = 32;                         // output columns per block on the model paths
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 8;                         // weight loads in flight per thread
constexpr int XS_FLOATS = 8192;                   // 32 KB of staged activations

// The geometry of a strip of S output columns.
template <int S> struct Geo {
  static_assert(S >= 32 && S <= 256 && (S & (S - 1)) == 0, "a strip is 32, 64, 128 or 256 columns");
  static constexpr int COLS = S / 8;                 // column threads
  static constexpr int KG = THREADS / COLS;          // k-groups
  static constexpr int BATCH = KG * UNROLL;          // weight rows per load batch
};

// strip_store's reduction buffer: the k-group sums of RB rows of the tile at
// a time, RB as many as WARPS * 8 * STRIP values hold (the whole tile at the
// default strip, so its single pass is unchanged)
template <int BT, int S> struct Red {
  static constexpr int ROWS = BT * S <= 8 * STRIP ? BT : (8 * STRIP) / S;
  static constexpr int FLOATS = WARPS * ROWS * S;
};

// Weight layouts. Nibbles are 4-bit two's complement in [-7, 7].
//   PAIRED     uint8 [cin/2, cout], byte i = row 2i (low nibble) | row 2i+1 (high)
//   HALF_SPLIT uint8 [cin/2, cout], byte i = row i (low) | row i + cin/2 (high)
//   INT8       int8 [cin, cout]
//   NATIVE     uint8 [cin, cout/2], byte (k, j) = column 2j (low) | column 2j+1 (high):
//              a dense row-major s4 buffer, one byte feeding two outputs of one row
enum { PAIRED = 0, HALF_SPLIT = 1, INT8 = 2, NATIVE = 3 };
enum { PRO_NONE = 0, PRO_NORM = 1, PRO_SILUGLU = 2 };

template <int MODE> struct Layout {
  static constexpr bool PAIR = MODE == PAIRED;                              // byte i = rows 2i, 2i+1
  static constexpr int VALS = (PAIR || MODE == HALF_SPLIT) ? 2 : 1;          // activation values per weight row
};

template <int MODE, int BT, int S = STRIP> struct Chunk {
  // weight rows staged per chunk: as many as XS_FLOATS holds, in load batches
  static constexpr int ROWS = (XS_FLOATS / (BT * Layout<MODE>::VALS)) / Geo<S>::BATCH * Geo<S>::BATCH;
  static constexpr int FLOATS = BT * ROWS * Layout<MODE>::VALS;
  static_assert(ROWS >= Geo<S>::BATCH, "a chunk holds at least one load batch");
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

// acc[b][j] = sum over the weight rows of x'[b, k] * w[k, strip * S + 8 ct + j]
// for the nb rows of the tile (act(b, k) gives x'); rows past nb are zero.
// xs is the block's staging area of Chunk<MODE, BT, S>::FLOATS floats.
template <int MODE, int BT, int S = STRIP, class Act>
__device__ __forceinline__ void strip_dot(const Act& act, int nb, const uint8_t* __restrict__ w,
                                          int cin, int cout, int strip, float* xs, float (&acc)[BT][8]) {
  constexpr int VALS = Layout<MODE>::VALS;
  constexpr int ROWS = Chunk<MODE, BT, S>::ROWS;
  constexpr int COLS = Geo<S>::COLS, KG = Geo<S>::KG, BATCH = Geo<S>::BATCH;
  const int tid = threadIdx.x;
  const int ct = (tid % 32) % COLS;
  const int kg = tid / COLS;
  const int c0 = strip * S + ct * 8;
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
        const int k = Layout<MODE>::PAIR ? 2 * p + v : (MODE == HALF_SPLIT ? p + v * half : p);
        val = act(b, k);
      }
      xs[i] = val;
    }
    __syncthreads();

    for (int r0 = 0; r0 < rows; r0 += BATCH) {
      uint2 wv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int p = pc0 + r0 + u * KG + kg;
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
        const int r = r0 + u * KG + kg;  // < ROWS: ROWS is a multiple of the load batch
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
// strip: out = sum * scale (+ residual), fp32. red holds
// Red<BT, S>::FLOATS floats; its earlier uses must be over when the block
// enters. Wide strips pass through red in groups of rows.
template <int BT, bool RESIDUAL, int S = STRIP>
__device__ __forceinline__ void strip_store(float (&acc)[BT][8], float* red, int nb, int b0, int strip,
                                            const float* __restrict__ scale, const float* residual,
                                            float* out, int cout) {
  constexpr int COLS = Geo<S>::COLS, RB = Red<BT, S>::ROWS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ct = lane % COLS;
  // sum the k-groups of each warp that share a column thread
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = acc[b][j];
#pragma unroll
      for (int o = COLS; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      acc[b][j] = v;
    }
#pragma unroll
  for (int g0 = 0; g0 < BT; g0 += RB) {
    __syncthreads();
    if (lane < COLS) {
#pragma unroll
      for (int b = 0; b < RB; ++b)
#pragma unroll
        for (int j = 0; j < 8; ++j) red[(warp * RB + b) * S + ct * 8 + j] = acc[g0 + b][j];
    }
    __syncthreads();

    // then the warps, in a fixed order; scale and residual once
    for (int i = tid; i < RB * S; i += THREADS) {
      const int b = g0 + i / S;
      const int col = i % S;
      const int row = b0 + b;
      const int c = strip * S + col;
      if (b >= nb || c >= cout) continue;
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < WARPS; ++wi) s += red[(wi * RB + (b - g0)) * S + col];
      s *= scale[c];
      if (RESIDUAL) s += residual[(size_t)row * cout + c];
      out[(size_t)row * cout + c] = s;
    }
  }
}

// K5, K6, K7, K11 (and T3b's single-cast GEMV): one strip of S columns and
// one tile of BT activation rows per block; grid (ceil(cout / S), ceil(B / BT))
template <int MODE, int BT, int PRO, bool RESIDUAL, int S = STRIP>
__global__ void __launch_bounds__(THREADS)
gemv_kernel(const bf16* __restrict__ x, int ldx, const float* __restrict__ gamma, float eps,
            const uint8_t* __restrict__ w, const float* __restrict__ scale,
            const float* __restrict__ residual, float* __restrict__ out,
            int B, int cin, int cout) {
  __shared__ __align__(16) float xs[Chunk<MODE, BT, S>::FLOATS];
  __shared__ float red[Red<BT, S>::FLOATS];
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
    strip_dot<MODE, BT, S>(ActNorm{xt, ldx, gamma, rstd}, nb, w, cin, cout, blockIdx.x, xs, acc);
  else if (PRO == PRO_SILUGLU)
    strip_dot<MODE, BT, S>(ActSiluGlu{xt, ldx, cin}, nb, w, cin, cout, blockIdx.x, xs, acc);
  else
    strip_dot<MODE, BT, S>(ActPlain{xt, ldx}, nb, w, cin, cout, blockIdx.x, xs, acc);
  strip_store<BT, RESIDUAL, S>(acc, red, nb, b0, blockIdx.x, scale, residual, out, cout);
}

// ---------------------------------------------------------------- W4A8

constexpr int QUNROLL = 4;                   // quads (two packed rows) in flight per thread: 4 x 16 bytes
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

// K10 and K5's act_int8 mode (the tensor-core body's W4A8 layout takes the
// model paths' calls; this body the ones it refuses, the strip and split-K
// probes, and comparisons): one strip of S columns, one tile of BT rows and
// one of SPLIT slices of the contraction per block; grid (ceil(cout / S),
// ceil(B / BT), SPLIT). With SPLIT > 1 (K10's form only, QIN) each block adds
// its exact int32 sums into acc32 [B, cout] with atomics, in any order, and
// w4a8_finish applies the scales; `skip` names a slice that adds nothing (a
// planted fault; -1 for none).
template <int BT, int PRO, bool RESIDUAL, bool QIN, int S = STRIP, int SPLIT = 1>
__global__ void __launch_bounds__(THREADS)
w4a8_kernel(const void* __restrict__ xin, int ldx, const float* __restrict__ xsc,
            const float* __restrict__ gamma, float eps,
            const uint8_t* __restrict__ w, const float* __restrict__ scale,
            const float* __restrict__ residual, float* __restrict__ out,
            int B, int cin, int cout, int* __restrict__ acc32, int skip) {
  static_assert(SPLIT == 1 || (QIN && PRO == PRO_NONE && !RESIDUAL), "split-K is K10's form only");
  constexpr int COLS = Geo<S>::COLS, KG = Geo<S>::KG, RB = Red<BT, S>::ROWS;
  constexpr int QBATCH = KG * QUNROLL;                       // quads per load batch
  constexpr int QROWS = (XQ_WORDS / BT) / QBATCH * QBATCH;   // quads per chunk
  static_assert(QROWS >= QBATCH, "a chunk holds at least one load batch");
  __shared__ int xq[BT * QROWS];
  __shared__ int red[Red<BT, S>::FLOATS];
  __shared__ float fred[WARPS * BT];
  __shared__ float rstd[BT], mul[BT], rowscale[BT];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ct = lane % COLS;
  const int kg = tid / COLS;
  const int c0 = blockIdx.x * S + ct * 8;
  const int b0 = blockIdx.y * BT;
  const int nb = min(BT, B - b0);
  const bool col_ok = c0 < cout;
  const int nquads = cin / 4;
  // this block's slice of the quads (all of them without split-K)
  const int per = (nquads + SPLIT - 1) / SPLIT;
  const int q_begin = SPLIT == 1 ? 0 : (int)blockIdx.z * per;
  const int q_end = SPLIT == 1 ? nquads : min(nquads, q_begin + per);
  if (SPLIT > 1 && (int)blockIdx.z == skip) return;
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

  for (int qc0 = q_begin; qc0 < q_end; qc0 += QROWS) {
    const int rows = min(QROWS, q_end - qc0);
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
        const int qd = qc0 + r0 + u * KG + kg;
        wa[u] = wb[u] = make_uint2(0u, 0u);   // decodes to zero weights
        if (col_ok && qd < q_end) {
          const uint8_t* src = w + (size_t)(2 * qd) * cout + c0;
          wa[u] = __ldg(reinterpret_cast<const uint2*>(src));
          wb[u] = __ldg(reinterpret_cast<const uint2*>(src + cout));
        }
      }
#pragma unroll
      for (int u = 0; u < QUNROLL; ++u) {
        const int r = r0 + u * KG + kg;  // < QROWS: QROWS is a multiple of QBATCH
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

  // sum the k-groups of each warp that share a column thread, exactly
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int v = acc[b][j];
#pragma unroll
      for (int o = COLS; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      acc[b][j] = v;
    }
#pragma unroll
  for (int g0 = 0; g0 < BT; g0 += RB) {
    if (g0 > 0) __syncthreads();   // the previous group's reads of red are over
    if (lane < COLS) {
#pragma unroll
      for (int b = 0; b < RB; ++b)
#pragma unroll
        for (int j = 0; j < 8; ++j) red[(warp * RB + b) * S + ct * 8 + j] = acc[g0 + b][j];
    }
    __syncthreads();

    for (int i = tid; i < RB * S; i += THREADS) {
      const int b = g0 + i / S;
      const int col = i % S;
      const int row = b0 + b;
      const int c = blockIdx.x * S + col;
      if (b >= nb || c >= cout) continue;
      int total = 0;
#pragma unroll
      for (int wi = 0; wi < WARPS; ++wi) total += red[(wi * RB + (b - g0)) * S + col];
      if (SPLIT > 1) {
        atomicAdd(acc32 + (size_t)row * cout + c, total);
        continue;
      }
      // each multiply and the add rounded on its own (no fma), as the plain
      // versions and the tensor-core body's W4A8 layout round them
      float s = (float)total;
      s = QIN ? __fmul_rn(__fmul_rn(s, scale[c]), rowscale[b]) : __fmul_rn(__fmul_rn(s, rowscale[b]), scale[c]);
      if (RESIDUAL) s = __fadd_rn(s, residual[(size_t)row * cout + c]);
      out[(size_t)row * cout + c] = s;
    }
  }
}

// split-K's epilogue: out = (acc32 * scale) * (xs / 127), K10's order
__global__ void w4a8_finish(const int* __restrict__ acc32, const float* __restrict__ scale,
                            const float* __restrict__ xsc, float* __restrict__ out, int B, int cout) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * cout) return;
  const int row = i / cout, c = i % cout;
  out[i] = ((float)acc32[i] * scale[c]) * (xsc[row] * (1.f / 127.f));
}

}  // namespace qgemv
