// K5, K6, K7 (int8 and half-split int4), K9, K10, K5's act_int8 mode and
// K11 on the tensor cores: the decode GEMV for Hopper (sm_90a) with a TMA
// weight stream, mma.sync and k-slice tiles that all blocks walk together.
// One body, five layouts (template MODE); K9 runs the paired layout twice in
// one launch (qpair_tc_kernel, below).
//
// Replaces, in supir_tpu/ops/quantize.py:
//   K5  _qmm_fused_kernel  (:260, pallas_call :357, int4_paired_fused_matmul):
//       RMSNorm or SiLU-GLU prologue, paired int4 weights, fp32 scale,
//       optional fp32 residual
//   K6  _qmm_paired_kernel (:116, pallas_call :171, int4_paired_matmul): the
//       same without prologue or residual
//   K7  _qmm_kernel        (:606, pallas_call :674, int8_matmul and
//       int4_matmul): int8 or half-split int4 weights, bf16 x, fp32
//       accumulation, x scale
//   K11 _qmm_native_kernel (:555, pallas_call :579, int4_native_matmul): s4
//       weights, stored here as column pairs, uint8 [cin, cout/2]
//   K10 _qmm_w4a8_kernel   (:191, pallas_call :236, int4_w4a8_matmul): int8
//       x with per-row scales xs (absmax, quantized before the launch) against
//       paired int4 weights, exact int32 sums, fp32 out
//   K5 act_int8, the act_int8 branch of _qmm_fused_kernel (:291-297,
//       pallas_call :357): K5's prologue in fp32, each row's absmax, int8
//       quantization in the kernel, K10's integer dot, the residual
//   K9  _qmm_pair_kernel   (:398, pallas_call :502, int4_paired_fused_pair):
//       two chained paired GEMVs, the second's RMSNorm over the first's
//       output, in one cooperative launch
// for 1-32 activation rows (W4A8 1-16 a launch). The calls this body does
// not take (a weight row stride that is not a multiple of 16 bytes,
// unaligned pointers: ops/gemv_plan.py:tc_eligible, tc_pair_eligible) keep
// the strip body of quant_gemv.cuh (K9's in quant_pair.cu), and so do K10's
// other strips and split-K (gemv_sweep.cu, T2's first design). The probes
// T1c, T2, T3b and T4b launch this body's instances at a k-slices override
// (ops/probes.py); T2 is W4A8 with every row scale 127, so that the row
// factor xs / 127 is exactly 1.0f.
//
// The int4 decodes (nib2_sel, nib2, quad16) live in tc_decode.cuh, which the
// nibble-order check T3a (nibble_order.cu) compiles too.
//
// How each layout meets the A fragments (lane g = lane / 4, t = lane % 4;
// rows g and g + 8 of fragment F are columns 4g + 2F and 4g + 2F + 1):
// - paired (MODE_PAIRED): byte = k 2p (low nibble) and 2p + 1 of one
//   column: one bf16x2 register of A by a byte permute, a lop3 and an
//   hsub2 (nib2). The lane reads rows 2t and 2t + 1 of each 8-row step, a
//   word of 4 columns each; they stand for the k pairs t and t + 4.
// - half-split (MODE_HALF): byte p = k p (low) and k p + cin/2 (high): the
//   paired layout with the contraction permuted, so the A path is the
//   paired one unchanged, the pair standing for (p, p + cin/2). Only x' is
//   staged otherwise: the word of packed row p holds (x[p], x[p + cin/2]),
//   two 16-byte loads a step.
// - int8 (MODE_INT8): a byte becomes an exact float by the exponent trick,
//   two of them a bf16x2 by a permute of their high halves; rows 2t, 2t+1,
//   2t+8, 2t+9 of each 16-row step, natural k order.
// - native (MODE_NATIVE): byte (k, j) = column 2j (low) and 2j + 1 (high):
//   byte F of the lane's 2 bytes in a row is exactly rows g and g + 8 of
//   fragment F. The lane reads the int8 layout's rows, 2 bytes each, from a
//   box of 128 rows x 64 bytes (the 128-column strip; TMA's 64-byte
//   swizzle); one permute joins rows 2t and 2t + 1, and nib2's permute,
//   lop3 and hsub2 on the low nibbles give one A register, on the high
//   nibbles (the word >> 4) the next.
// - W4A8 (MODE_W4A8): the paired bytes against int8 x on mma.sync
//   m16n8k32 s8 x s8 -> s32, a step of 32 k (16 packed rows); the box, ring,
//   tiles and combine are the paired layout's. The lane reads packed rows 2t,
//   2t + 1, 2t + 8, 2t + 9 of the step (the int8 layout's rows): a pair of
//   rows holds k 4t .. 4t + 3 of its 4 columns. A byte permute joins a
//   column's bytes of the two rows; the high nibbles masked in place and the
//   low ones shifted up and masked are s8 bytes of value 16 n, exact, with no
//   sign extension (quad16); a register's bytes hold k 4t, 4t + 2, 4t + 1,
//   4t + 3, and x is staged in that order. The sums are 16 times the dot
//   (below 2^31 at every 13B cin), shifted back at the store.
//
// What it computes: out[b, c] = (sum_k x'[b, k] q[k, c]) * scale[c]
// (+ residual[b, c]), fp32, x' = x or K5's prologue (RMSNorm: bf16((x *
// rsqrt(mean(x^2) + eps)) * gamma); SiLU-GLU over [a | g]: bf16(silu(a) *
// g)), in fp32 and rounded to bf16 as the TPU kernel does. W4A8: the int32
// dot of xq (K10's, or K5's prologue output in fp32 quantized per row,
// round(x' * 127 / absmax) clamped to +-127) with q, then K10's (acc *
// scale[c]) * (xs / 127), or K5's (acc * (xs / 127)) * scale[c] (+ residual),
// each multiply and the add rounded on its own.
//
// What bounds it: bytes. Every weight byte is read once (47.5 us per 13B
// layer in int4, 94.8 us in int8 at 3.35 TB/s). Even 32 padded rows need
// about 0.4 PFLOP/s of bf16 products at that rate, which mma.sync covers;
// an fp32 FMA per weight and row would not (the strip body of
// quant_gemv.cuh spends about 4 ALU operations a weight at one row and
// grows 4.3x at 8 rows). What the design does about it:
// - The weight stream is asynchronous. One producer warp issues TMA copies
//   (a box of 128 bytes x 64 packed rows or 128 int8 rows, or 64 bytes x
//   128 native rows: 8, 16 or 8 KB) into a ring of 16 or 8 stages (128 KB)
//   with full and empty mbarriers; the
//   first stages are requested at block entry, before the prologue. At the
//   loaded latency of device memory (3-4 us on the H100) a block needs
//   about that much in flight. The tensor map is encoded once per weight
//   (supir_qgemv_tc_map) and cached by the caller.
// - The blocks read whole rows together. A 128-column strip is 128 bytes
//   of each weight row; blocks that each stream their own strip from its
//   own k read scattered 128-byte pieces, and device memory serves them at
//   about 2 TB/s. So each strip's k range is cut into slices, and block b
//   takes the (strip, slice) tiles b, b + G, ... in slice-major order: at
//   any moment all blocks read one or two slices of every strip, whole
//   rows, which streams at 2.5-2.9 TB/s. The slice count is the most even
//   split of the tiles over the grid, traded against the partial sums.
// - The products run on the tensor cores: mma.sync m16n8k16, bf16 in, fp32
//   accumulate. The dequantized weights are the A operand (16 output
//   columns x 16 k in registers), x' the B operand (16 k x 8 rows per
//   n-tile), so 1-32 rows stream the weights once; each layout's decode is
//   above.
// - The shared-memory reads meet no bank twice: each lane reads 4-byte
//   words (native: 2 bytes) of the TMA-swizzled stage from rows chosen so
//   that a warp's distinct words fall in distinct banks (ops/gemv_plan.py
//   says which); the staged x' is ordered so that a lane's two B registers
//   are one 8-byte load.
// - A strip cut into slices is summed from their partials in slice order,
//   so two runs give the same bits: a signal warp counts each finished tile
//   but a last slice's in on the strip's counter (behind one gpu-scope
//   fence for all the tiles finished since its last one, so no consumer
//   waits for its partials to reach device scope), and the block that took
//   the last slice, in the final round by the slice-major order, waits at
//   its end for the count and sums. No atomic adds a value to an output.
//   Scale, residual and the store happen once per output.
// - K5's prologue overlaps the stream: while the first stages are in flight
//   each block takes the RMSNorm statistics of its rows (from L2) and then
//   stages x' only for the chunks its tiles need, at most a 56 KB window
//   at a time (all of cin at one or two rows). K5's act_int8 mode takes each
//   row's absmax of the fp32 prologue output there too, one more pass over
//   x, and quantizes as it stages.
//
// Block: 8 consumer warps (4 groups of 32 output columns of the 128-column
// strip; the two warps of a group take the first and the second half of
// every chunk's 16-k steps, into 4, 2 or 1 independent accumulator sets by
// the row count), one producer warp and one signal warp, 320 threads, one
// block per SM.

#include <string.h>

#include <type_traits>

#include "flash_attn_tma.cuh"
#include "quant_gemv.cuh"
#include "tc_decode.cuh"

namespace {

using tcdec::nib2;
using tcdec::nib2_sel;
using tcdec::quad16;

using qgemv::PRO_NONE;
using qgemv::PRO_NORM;
using qgemv::PRO_SILUGLU;

constexpr int TC_GROUPS = 4;                          // 32-column groups of the strip
constexpr int TC_EARLY_STAGES = 4;                    // stages requested before x' is staged
constexpr int TC_RED_FLOATS = 4096;                   // the parts' sums: (PARTS - 1) x 4 groups x 32 lanes x <= 32

// The consumer warps of an instance: each group's chunk steps are cut into
// PARTS, so 4 x PARTS consumer warps, plus the producer and the signal
// warp. (Three or four parts at one row measured no faster: the products
// are paced by the weight stream as much as by their own latency.)
template <int NT> struct TcWarps {
  static constexpr int PARTS = 2;
  // independent accumulator sets per warp, one per step of a part (mod
  // SETS): an mma.sync's result takes ~100 cycles on this card, so a chain
  // of dependent products per chunk would hold each warp
  static constexpr int SETS = NT == 1 ? 4 : (NT == 2 ? 2 : 1);
  static constexpr int CONSUMERS = TC_GROUPS * PARTS;
  static constexpr int THREADS = 32 * (CONSUMERS + 2);
};
constexpr int TC_STRIP = 128;                         // output columns per strip (one box row)
constexpr int TC_MAX_ROWS = 32;
constexpr int MODE_PAIRED = 0, MODE_HALF = 1, MODE_INT8 = 2, MODE_NATIVE = 3, MODE_W4A8 = 4;   // ops/quantize.py:_MODES
constexpr int TC_RING_BYTES = 128 * 1024;
constexpr int FAULT_DROP_SHARE = 1, FAULT_COMBINE_TWICE = 2, FAULT_X_ORDER = 3, FAULT_ROW_SCALE = 4;
constexpr int FAULT_STALE_SMALL = 5;                 // K9: phase 2 does not wait for phase 1's strips
constexpr int FAULT_ONE_STRIP = 6;                   // K9: phase 2's statistics from strip 0's squares alone
constexpr int CONSUMER_BAR = 1;                       // named barrier of the consumer threads

// ops/gemv_plan.py:PLAN_FIELDS, in that order
struct TcPlan {
  int rows, cin, cout, wrows, strips, chunks, slices, tiles, grid, wch, xrs, smem, nt, stages, box_rows, wcols;
};

template <int MODE> struct TcMode {
  // weight rows per chunk
  static constexpr int BOX_ROWS = MODE == MODE_PAIRED || MODE == MODE_HALF || MODE == MODE_W4A8 ? 64 : 128;
  static constexpr int BOX_BYTES = MODE == MODE_NATIVE ? 64 : 128;  // a strip's bytes of a row; the swizzle's span
  static constexpr int STAGE_BYTES = BOX_ROWS * BOX_BYTES;
  static constexpr int STEPS = MODE == MODE_W4A8 ? 4 : 8;           // steps of a chunk: 16 k, W4A8's 32 k
  static constexpr int STEP_BYTES = STAGE_BYTES / STEPS;            // a step's rows
  static constexpr int XWORDS = MODE == MODE_W4A8 ? 32 : 64;        // staged words of a chunk's row: 4 int8 or 2 bf16 each
  static constexpr int STAGES = TC_RING_BYTES / STAGE_BYTES;
  static constexpr int RING = STAGES * STAGE_BYTES;
  using Acc = std::conditional_t<MODE == MODE_W4A8, int, float>;    // the accumulators, partials and combine
};

// accumulator sets: TcWarps' SETS, at most a part's steps of a chunk
template <int MODE, int NT> struct TcSets {
  static constexpr int STEPS = TcMode<MODE>::STEPS / TcWarps<NT>::PARTS;
  static constexpr int SETS = TcWarps<NT>::SETS < STEPS ? TcWarps<NT>::SETS : STEPS;
};

template <int CONSUMERS>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(CONSUMER_BAR), "n"(32 * CONSUMERS) : "memory");
}

// counter += 1 at gpu scope (no value comes back); the fence before it
// releases the partials this block wrote
__device__ __forceinline__ void fence_gpu() { asm volatile("fence.acq_rel.gpu;\n" ::: "memory"); }
__device__ __forceinline__ void count_in(int* counter) {
  asm volatile("red.relaxed.gpu.global.add.s32 [%0], 1;\n" ::"l"(counter) : "memory");
}

__device__ __forceinline__ void store_release_cta(int* p, int v) {
  asm volatile("st.release.cta.shared.s32 [%0], %1;\n" ::"r"(smem_u32(p)), "r"(v) : "memory");
}

__device__ __forceinline__ int load_acquire_cta(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.s32 %0, [%1];\n" : "=r"(v) : "r"(smem_u32(p)) : "memory");
  return v;
}

__device__ __forceinline__ int load_acquire(const int* counter) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(counter) : "memory");
  return v;
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  // not volatile: the products may be scheduled among the loads and decodes of other steps
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// signed byte i of wx (= w ^ 0x80808080) as an exact float
__device__ __forceinline__ float sbyte_f(uint32_t wx, int i) {
  return __uint_as_float(__byte_perm(wx, 0x4B000000u, i | 0x7440)) - 8388736.0f;   // 2^23 + 128
}

// (lo, hi) exact small integers as a bf16x2: their floats' high halves
__device__ __forceinline__ uint32_t pack_hi(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// ops/gemv_plan.py:x_word_k: the values (of a step's 16, step_values) of
// staged word pos (the paired rows' order and the word interleave cancel:
// natural k order; half-split: packed row pos's two halves); FAULT_X_ORDER
// drops the interleave, and stages the half-split step in natural order
template <int MODE>
__device__ __forceinline__ int2 x_word_k(int pos, int fault) {
  if (MODE == MODE_HALF) return fault == FAULT_X_ORDER ? make_int2(2 * pos, 2 * pos + 1) : make_int2(pos, pos + 8);
  const int pair = fault == FAULT_X_ORDER ? pos : (pos >> 1) + 4 * (pos & 1);
  const int r = MODE == MODE_PAIRED ? (pair < 4 ? 2 * pair : 2 * (pair - 4) + 1) : pair;
  return make_int2(2 * r, 2 * r + 1);
}

// W4A8 (ops/gemv_plan.py:x_word_k): the staged word of k quad q of a 32-k
// step, so that a lane's quads t and t + 4 are one 8-byte load;
// FAULT_X_ORDER drops the interleave
__device__ __forceinline__ int x_quad_word(int q, int fault) {
  return fault == FAULT_X_ORDER ? q : (q & 3) * 2 + (q >> 2);
}

// x'[k] for one row at the 16 k of one step (k0..k0+15), in fp32 rounded
// to bf16 as the TPU kernel rounds it; k past cin gives 0. gm: gamma at
// those k (RMSNorm only). FAST (W4A8's act_int8 mode, which takes SiLU-GLU
// twice, for the absmax and as it stages): the sigmoid by __expf and an
// approximate division, about 1e-6 relative, far inside the 1e-2 bound.
template <bool FAST = false>
__device__ __forceinline__ void step_values(float (&v)[16], const qgemv::bf16* xr, int k0, int cin, int pro,
                                            const float (&gm)[16], float rstd) {
  float a[16], gt[16];
  if (k0 + 16 <= cin) {
    const uint4 u0 = *reinterpret_cast<const uint4*>(xr + k0), u1 = *reinterpret_cast<const uint4*>(xr + k0 + 8);
    const uint32_t w[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      a[2 * i] = f.x;
      a[2 * i + 1] = f.y;
    }
    if (pro == PRO_SILUGLU) {
      const uint4 g0 = *reinterpret_cast<const uint4*>(xr + cin + k0);
      const uint4 g1 = *reinterpret_cast<const uint4*>(xr + cin + k0 + 8);
      const uint32_t h[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&h[i]));
        gt[2 * i] = f.x;
        gt[2 * i + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const bool in = k0 + i < cin;
      a[i] = in ? __bfloat162float(xr[k0 + i]) : 0.f;
      gt[i] = in && pro == PRO_SILUGLU ? __bfloat162float(xr[cin + k0 + i]) : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    float y = a[i];
    if (pro == PRO_NORM) y = (y * rstd) * gm[i];
    else if (pro == PRO_SILUGLU) y = FAST ? __fdividef(y, 1.f + __expf(-y)) * gt[i] : qgemv::silu_glu(y, gt[i]);
    v[i] = k0 + i < cin ? y : 0.f;
  }
}

// MODE_HALF: the 16 values of the step of packed rows p0..p0+7, x[p0 ..
// p0+7] then x[h + p0 .. h + p0+7] (h = cin / 2, ops/gemv_plan.py:
// step_values); h % 8 == 0, so a step is whole or past the edge (zeros)
__device__ __forceinline__ void half_step_values(float (&v)[16], const qgemv::bf16* xr, int p0, int h) {
  if (p0 + 8 <= h) {
    const uint4 lo = *reinterpret_cast<const uint4*>(xr + p0), hi = *reinterpret_cast<const uint4*>(xr + h + p0);
    const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = 0.f;
  }
}

// four fp32 values (k order) quantized at m = 127 / xs as K5's act_int8 mode
// and the strip body round them, clamped to +-127, as int8 bytes
__device__ __forceinline__ uint32_t quant_quad(const float* v, float m) {
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) word |= (uint32_t)(max(-127, min(127, __float2int_rn(v[i] * m))) & 0xFF) << (8 * i);
  return word;
}

// gamma at k0 .. k0 + 15 (zeros past cin) for RMSNorm, else zeros
__device__ __forceinline__ void gamma16(float (&gm)[16], const float* gamma, int k0, int cin, int pro) {
#pragma unroll
  for (int i = 0; i < 16; ++i) gm[i] = 0.f;
  if (pro == PRO_NORM) {
    if (k0 + 16 <= cin) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 f = *reinterpret_cast<const float4*>(gamma + k0 + 4 * q);
        gm[4 * q] = f.x, gm[4 * q + 1] = f.y, gm[4 * q + 2] = f.z, gm[4 * q + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) gm[i] = k0 + i < cin ? gamma[k0 + i] : 0.f;
    }
  }
}

// the 8 staged words of one step from its 16 values
template <int MODE, int FAULT>
__device__ __forceinline__ void step_words(uint32_t (&out)[8], const float (&v)[16]) {
#pragma unroll
  for (int pos = 0; pos < 8; ++pos) {
    const int2 k = x_word_k<MODE>(pos, FAULT);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[k.x], v[k.y]);
    out[pos] = *reinterpret_cast<const uint32_t*>(&b);
  }
}

// Stage x' for chunks [ja, jb) of row-major bf16 x into the window (rows
// xrs words apart, 8 words a 16-k step), by the consumer threads: one
// step per thread at a time, gamma read once for all rows, 16-byte loads
// and stores.
template <int MODE, int CONSUMERS>
__device__ void stage_x(uint32_t* xw, const TcPlan& p, const qgemv::bf16* x, int ldx, int pro,
                        const float* gamma, const float* rstd, int ja, int jb, int fault) {
  const int steps = (jb - ja) * 8;                   // 128 k a chunk, 16 k a step
#pragma unroll 2
  for (int st = threadIdx.x; st < steps; st += 32 * CONSUMERS) {
    const int k0 = (ja * 8 + st) * 16;                 // half-split: packed rows (ja * 8 + st) * 8 ..
    float gm[16];
    gamma16(gm, gamma, k0, p.cin, pro);
#pragma unroll 2
    for (int n = 0; n < p.rows; ++n) {
      float v[16];
      if (MODE == MODE_HALF) half_step_values(v, x + (size_t)n * ldx, k0 / 2, p.cin / 2);
      else step_values(v, x + (size_t)n * ldx, k0, p.cin, pro, gm, pro == PRO_NORM ? rstd[n] : 0.f);
      uint32_t w[8];
      if (fault == FAULT_X_ORDER) step_words<MODE, FAULT_X_ORDER>(w, v);
      else step_words<MODE, 0>(w, v);
      uint4* dst = reinterpret_cast<uint4*>(xw + n * p.xrs + st * 8);
      dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
      dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
    }
  }
}

// W4A8: stage int8 x for chunks [ja, jb) into the window (rows xrs words
// apart, 8 words a 32-k step), one (row, 16-k half step) item per thread at
// a time, dealt half-major so that the rows' loads are in flight together
// (the half's 4 quads are words 2i + h of the step): K10's int8 x (8-byte
// aligned rows), or K5's act_int8 prologue in fp32 quantized at mul[n] =
// 127 / xs of its row. Each quad's bytes go in the A registers' order (k
// 4q, 4q + 2, 4q + 1, 4q + 3). Halves, not 32-k steps, so that no more than
// 16 values are live beside the accumulators.
template <int CONSUMERS>
__device__ void stage_xq(uint32_t* xw, const TcPlan& p, const void* x, int ldx, bool quantized, int pro,
                         const float* gamma, const float* rstd, const float* mul, int ja, int jb, int fault) {
  const int halves = (jb - ja) * 8;                  // 128 k a chunk, 16 k a half step
  // item hs * rows + n, walked by increments: 32 CONSUMERS = dh rows + dn
  const int dh = 32 * CONSUMERS / p.rows, dn = 32 * CONSUMERS % p.rows;
  int n = threadIdx.x % p.rows, hs = threadIdx.x / p.rows;
#pragma unroll 1
  for (; hs < halves; hs += dh, n += dn) {
    if (n >= p.rows) n -= p.rows, ++hs;
    if (hs >= halves) break;
    const int k0 = (ja * 8 + hs) * 16, h = hs & 1;
    uint32_t quads[4];                                // k0 + 4i .. k0 + 4i + 3, natural order
    if (quantized) {
      const int8_t* xr = static_cast<const int8_t*>(x) + (size_t)n * ldx + k0;
      if (k0 + 16 <= p.cin) {
        const uint2 a = *reinterpret_cast<const uint2*>(xr), b = *reinterpret_cast<const uint2*>(xr + 8);
        quads[0] = a.x, quads[1] = a.y, quads[2] = b.x, quads[3] = b.y;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) quads[i] = 0u;
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (k0 + i < p.cin) quads[i >> 2] |= (uint32_t)(uint8_t)xr[i] << (8 * (i & 3));
      }
    } else {
      float gm[16], v[16];
      gamma16(gm, gamma, k0, p.cin, pro);
      step_values<true>(v, static_cast<const qgemv::bf16*>(x) + (size_t)n * ldx, k0, p.cin, pro, gm,
                        pro == PRO_NORM ? rstd[n] : 0.f);
#pragma unroll
      for (int i = 0; i < 4; ++i) quads[i] = quant_quad(v + 4 * i, mul[n]);
    }
    uint32_t* dst = xw + n * p.xrs + (hs >> 1) * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[x_quad_word(4 * h + i, fault)] = __byte_perm(quads[i], 0u, 0x3120);
  }
}

// W4A8's store: the sums were taken at 16 n, so acc16 >> 4 is the exact
// integer dot; then K10's (acc * scale) * (xs / 127) or K5's (acc * (xs /
// 127)) * scale (+ residual), each multiply and the add rounded on its own
// (no contraction into an fma), as the plain versions and the strip body
// round them. rs = xs / 127 of the row; FAULT_ROW_SCALE applies it twice.
__device__ __forceinline__ float w4a8_out(int acc16, float sc, float rs, bool k10, const float* residual, size_t i,
                                          int fault) {
  const float a = (float)(acc16 >> 4);
  if (fault == FAULT_ROW_SCALE) rs = __fmul_rn(rs, rs);
  float s = k10 ? __fmul_rn(__fmul_rn(a, sc), rs) : __fmul_rn(__fmul_rn(a, rs), sc);
  if (residual) s = __fadd_rn(s, residual[i]);
  return s;
}

// One chunk (a ring stage) of the warp's 32 columns (group): its part of
// the chunk's 8 steps of 16 k (steps [4 part, 4 part + 4)), or W4A8's 4 of
// 32 k (steps [2 part, 2 part + 2)). aoff: the byte offsets of the lane's
// words in a step's rows (stage_offsets); xlane: the lane's first x' word;
// live: bit nt set when the lane's row 8 nt + g exists.
// acc[set][nt][frag][4]: rows 8 nt + 2t (+1), columns 32 group + 4g + 2 frag
// (+1); the part's step i adds into set i % SETS.
// Plain loads (not asm), so that the compiler may issue later steps' loads
// and decodes while earlier products run; the full barrier's wait (a
// memory clobber) keeps them behind the stage's arrival.
template <int MODE, int NT>
__device__ __forceinline__ void chunk_products(typename TcMode<MODE>::Acc (&acc)[TcSets<MODE, NT>::SETS][NT][2][4],
                                               const unsigned char* stage, const uint32_t* xlane, int xrs,
                                               unsigned live, const int (&aoff)[4], int part) {
  constexpr int PART_STEPS = TcSets<MODE, NT>::STEPS;
  constexpr int STEP_BYTES = TcMode<MODE>::STEP_BYTES;
#pragma unroll
  for (int i = 0; i < PART_STEPS; ++i) {
    const int step = PART_STEPS * part + i;           // this warp's part of the chunk's steps
    const unsigned char* rows = stage + step * STEP_BYTES;
    // B: this lane's rows 8 nt + g, words 2t, 2t + 1 of the step (k pairs t, t + 4)
    uint2 bx[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      bx[nt] = (live >> nt) & 1 ? *reinterpret_cast<const uint2*>(xlane + 8 * nt * xrs + 8 * step) : make_uint2(0u, 0u);
    uint32_t a[2][4];
    if (MODE == MODE_W4A8) {
      // rows 2t, 2t + 1 (k 4t .. 4t + 3) and 2t + 8, 2t + 9 (k 16 + 4t ..) of
      // the 32-k step: byte f of a word is column 4g + f
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(rows + aoff[0]);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(rows + aoff[1]);
      const uint32_t w2 = *reinterpret_cast<const uint32_t*>(rows + aoff[2]);
      const uint32_t w3 = *reinterpret_cast<const uint32_t*>(rows + aoff[3]);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        quad16(a[f][0], a[f][1], w0, w1, f);
        quad16(a[f][2], a[f][3], w2, w3, f);
      }
    } else if (MODE == MODE_PAIRED || MODE == MODE_HALF) {
      // rows 2t and 2t + 1 of the step: k pairs t and t + 4 (half-split: the
      // pairs (p, p + cin/2) of packed rows p)
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(rows + aoff[0]);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(rows + aoff[1]);
      const uint32_t w0s = w0 >> 4, w1s = w1 >> 4;
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        a[f][0] = nib2(w0, w0s, 2 * f);
        a[f][1] = nib2(w0, w0s, 2 * f + 1);
        a[f][2] = nib2(w1, w1s, 2 * f);
        a[f][3] = nib2(w1, w1s, 2 * f + 1);
      }
    } else if (MODE == MODE_NATIVE) {
      // rows 2t | 2t + 1 and 2t + 8 | 2t + 9 of the step, 2 bytes each
      // (columns 4g .. 4g + 3): byte f of a row holds column 4g + 2f in its
      // low nibble and 4g + 2f + 1 in its high one, rows g and g + 8 of
      // fragment f; a register takes one column at k 2t, 2t + 1 (or + 8)
      const uint32_t lo = __byte_perm(*reinterpret_cast<const uint16_t*>(rows + aoff[0]),
                                      *reinterpret_cast<const uint16_t*>(rows + aoff[1]), 0x5410);
      const uint32_t hi = __byte_perm(*reinterpret_cast<const uint16_t*>(rows + aoff[2]),
                                      *reinterpret_cast<const uint16_t*>(rows + aoff[3]), 0x5410);
      const uint32_t lo4 = lo >> 4, hi4 = hi >> 4;
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        a[f][0] = nib2_sel(lo, lo4, f | ((2 + f) << 8));          // low nibbles: column 4g + 2f
        a[f][1] = nib2_sel(lo, lo4, (4 + f) | ((6 + f) << 8));    // high nibbles: column 4g + 2f + 1
        a[f][2] = nib2_sel(hi, hi4, f | ((2 + f) << 8));
        a[f][3] = nib2_sel(hi, hi4, (4 + f) | ((6 + f) << 8));
      }
    } else {
      uint32_t wx[4];
#pragma unroll
      for (int l = 0; l < 4; ++l)   // rows 2t, 2t+1, 2t+8, 2t+9 of the step
        wx[l] = *reinterpret_cast<const uint32_t*>(rows + aoff[l]) ^ 0x80808080u;
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        a[f][0] = pack_hi(sbyte_f(wx[0], 2 * f), sbyte_f(wx[1], 2 * f));
        a[f][1] = pack_hi(sbyte_f(wx[0], 2 * f + 1), sbyte_f(wx[1], 2 * f + 1));
        a[f][2] = pack_hi(sbyte_f(wx[2], 2 * f), sbyte_f(wx[3], 2 * f));
        a[f][3] = pack_hi(sbyte_f(wx[2], 2 * f + 1), sbyte_f(wx[3], 2 * f + 1));
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        if constexpr (MODE == MODE_W4A8)
          mma_s8(acc[i % TcSets<MODE, NT>::SETS][nt][f], a[f][0], a[f][1], a[f][2], a[f][3], bx[nt].x, bx[nt].y);
        else
          mma_bf16(acc[i % TcSets<MODE, NT>::SETS][nt][f], a[f][0], a[f][1], a[f][2], a[f][3], bx[nt].x, bx[nt].y);
      }
  }
}

// The byte offsets, inside a step's rows of a TMA-swizzled stage, of the
// pieces lane (g, t) of column group `group` reads: rows 2t, 2t + 1
// (paired, half-split) or 2t, 2t + 1, 2t + 8, 2t + 9 (int8, native, W4A8),
// columns 32 group + 4g .. + 3: a word of a 128-byte row (16-byte chunk c
// of row r at c ^ (r % 8)), or native bytes 16 group + 2g, + 1 of a
// 64-byte row (chunk c at c ^ (r / 2 % 4)). A step is 8 or 16 rows, so
// neither depends on the step.
template <int MODE>
__device__ __forceinline__ void stage_offsets(int (&aoff)[4], int group, int g, int t) {
  const int chunk0 = 2 * group + (g >> 2), within = 4 * (g & 3);
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const int r = MODE == MODE_PAIRED || MODE == MODE_HALF ? 2 * t + (l & 1) : 2 * t + (l & 1) + 8 * (l >> 1);
    if (MODE == MODE_NATIVE) aoff[l] = r * 64 + ((group ^ ((r >> 1) & 3)) << 4) + 2 * g;
    else aoff[l] = r * TC_STRIP + ((chunk0 ^ (r & 7)) << 4) + within;
  }
}

template <int MODE, int NT>
__global__ void __launch_bounds__(TcWarps<NT>::THREADS, 1)
qgemv_tc_kernel(const __grid_constant__ CUtensorMap wmap, const TcPlan p, const qgemv::bf16* __restrict__ x,
                int ldx, const float* __restrict__ gamma, float eps, int pro, const float* __restrict__ scale,
                const float* __restrict__ residual, float* __restrict__ out, float* __restrict__ part_sums,
                int* __restrict__ counters, int fault, const float* __restrict__ xsc) {
  using M = TcMode<MODE>;
  using Acc = typename M::Acc;
  constexpr int CONSUMERS = TcWarps<NT>::CONSUMERS, PARTS = TcWarps<NT>::PARTS;
  // stages requested before x' is staged: W4A8's staging is int8 (K10) or
  // follows K5's longer act_int8 statistics, so its weights start deeper
  constexpr int EARLY = MODE == MODE_W4A8 ? 12 : TC_EARLY_STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;       // the 128-byte swizzle repeats every 1024 bytes
  unsigned char* smem = smem_raw + (base - raw);
  // ring | x' window | the step halves' sums | rstd (W4A8: and each row's
  // 127 / xs and xs / 127) | barriers (ops/gemv_plan.py:tc_plan's smem)
  uint32_t* xw = reinterpret_cast<uint32_t*>(smem + M::RING);
  float* red = reinterpret_cast<float*>(smem + M::RING + ((4 * p.rows * p.xrs + 15) & ~15));
  float* rstd = red + TC_RED_FLOATS;
  float* mul = rstd + TC_MAX_ROWS;                   // W4A8 only
  float* rowsc = mul + TC_MAX_ROWS;
  // the consumers' finished tiles
  int* tiles_done = reinterpret_cast<int*>(rstd + TC_MAX_ROWS * (MODE == MODE_W4A8 ? 3 : 1));
  const uint32_t full = smem_u32(tiles_done + 4);     // full[STAGES], then empty[STAGES], then go
  const uint32_t empty = full + 8 * M::STAGES;
  const uint32_t go = empty + 8 * M::STAGES;          // x' is staged: the producer may fill the ring

  const int blk = blockIdx.x, G = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    *tiles_done = 0;
    for (int s = 0; s < M::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);           // one arrival per consumer warp
    }
    mbar_init(go, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS) {
    // producer: one thread keeps the ring full, from block entry on, over
    // the block's tiles b, b + G, ... (strip t % strips, slice t / strips)
    if (lane == 0) {
      int n = 0;
      for (int t = blk; t < p.tiles; t += G) {
        const int s = t % p.strips, sl = t / p.strips;
        for (int j = sl * p.chunks / p.slices; j < (sl + 1) * p.chunks / p.slices; ++j, ++n) {
          // a few stages at entry, the rest once x' is staged: the activation
          // loads of the prologue would otherwise queue behind every block's
          // whole ring of weight copies
          if (n == EARLY) mbar_wait(go, 0);
          const int st = n % M::STAGES;
          mbar_wait(empty + 8 * st, ((n / M::STAGES) & 1) ^ 1);   // a fresh barrier passes parity 1
          mbar_expect_tx(full + 8 * st, M::STAGE_BYTES);
          tma_load_2d(base + st * M::STAGE_BYTES, &wmap, full + 8 * st, s * M::BOX_BYTES, j * M::BOX_ROWS);
        }
      }
    }
    return;
  }
  if (warp == CONSUMERS + 1) {
    // signal warp: counts each finished tile but a last slice's in on its
    // strip's counter, a few at a time behind one gpu-scope fence, so that
    // no consumer waits for the partials to reach device scope
    if (lane == 0 && p.slices > 1) {
      const int mine = (p.tiles - 1 - blk) / G + 1;
      for (int sent = 0; sent < mine;) {
        int done;
        while ((done = load_acquire_cta(tiles_done)) == sent) {
        }
        fence_gpu();
        for (; sent < done; ++sent) {
          const int t = blk + sent * G;
          if (t / p.strips < p.slices - 1) count_in(counters + t % p.strips);
        }
      }
    }
    return;
  }

  const int tid = threadIdx.x;
  const int g = lane >> 2, t4 = lane & 3;
  const int group = warp % TC_GROUPS, part = warp / TC_GROUPS;

  // RMSNorm statistics of every row, over all of cin, while the first
  // stages stream in
  if (pro == PRO_NORM) {
    for (int n = 0; n < p.rows; ++n) {
      const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)n * ldx);
      float ss = 0.f;
#pragma unroll 4
      for (int k8 = tid; k8 < p.cin / 8; k8 += 32 * CONSUMERS) {   // cin % 8 == 0 (tc_eligible)
        const uint4 u = xr[k8];
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
          ss = fmaf(v.x, v.x, fmaf(v.y, v.y, ss));
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      if (lane == 0) red[n * CONSUMERS + warp] = ss;
    }
    consumer_sync<CONSUMERS>();
    if (tid < p.rows) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < CONSUMERS; ++w) s += red[tid * CONSUMERS + w];
      rstd[tid] = rsqrtf(s / (float)p.cin + eps);
    }
    consumer_sync<CONSUMERS>();
  }
  if constexpr (MODE == MODE_W4A8) {
    if (xsc != nullptr) {
      if (tid < p.rows) rowsc[tid] = xsc[tid] * (1.f / 127.f);   // K10: the row scales come with int8 x
    } else {
      // K5's act_int8 mode: each row's absmax of the fp32 prologue output,
      // computed as stage_xq computes the values it quantizes
      for (int n = 0; n < p.rows; ++n) {
        const qgemv::bf16* xr = x + (size_t)n * ldx;
        float m = 0.f;
        for (int k0 = 16 * tid; k0 < p.cin; k0 += 16 * 32 * CONSUMERS) {
          float gm[16], v[16];
          gamma16(gm, gamma, k0, p.cin, pro);
          step_values<true>(v, xr, k0, p.cin, pro, gm, pro == PRO_NORM ? rstd[n] : 0.f);
#pragma unroll
          for (int i = 0; i < 16; ++i) m = fmaxf(m, fabsf(v[i]));
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        if (lane == 0) red[n * CONSUMERS + warp] = m;
      }
      consumer_sync<CONSUMERS>();
      if (tid < p.rows) {
        float m = 0.f;
#pragma unroll
        for (int w = 0; w < CONSUMERS; ++w) m = fmaxf(m, red[tid * CONSUMERS + w]);
        const float xs = fmaxf(m, 1e-6f);
        mul[tid] = 127.f / xs;
        rowsc[tid] = xs * (1.f / 127.f);
      }
    }
    // the first staging's consumer_sync publishes them
  }

  const uint32_t* xlane = xw + g * p.xrs + 2 * t4;   // this lane's first x' word
  int aoff[4];
  stage_offsets<MODE>(aoff, group, g, t4);
  unsigned live = 0;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) live |= (8 * nt + g < p.rows ? 1u : 0u) << nt;
  int xa = 0, xb = 0;                                // staged chunks [xa, xb)
  int n = 0;                                         // ring position
  int ti = 0;
  for (int t = blk; t < p.tiles; t += G) {
    const int s = t % p.strips, sl = t / p.strips;
    constexpr int SETS = TcSets<MODE, NT>::SETS;
    Acc sets[SETS][NT][2][4];
#pragma unroll
    for (int q = 0; q < SETS; ++q)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int r = 0; r < 4; ++r) sets[q][nt][f][r] = 0;
    for (int j = sl * p.chunks / p.slices; j < (sl + 1) * p.chunks / p.slices; ++j, ++n) {
      if (j < xa || j >= xb) {
        // the blocks move forward through k: stage from here on
        xa = j;
        xb = min(p.chunks, j + p.wch);
        // W4A8: only this tile's slice, since K5's act_int8 staging computes
        // the prologue and quantizes (a window past the slice read 2-3x the
        // chunks a block needs at the o and down projections)
        if (MODE == MODE_W4A8) xb = min(xb, (sl + 1) * p.chunks / p.slices);
        consumer_sync<CONSUMERS>();                             // every warp is done with the old window
        if constexpr (MODE == MODE_W4A8)
          stage_xq<CONSUMERS>(xw, p, x, ldx, xsc != nullptr, pro, gamma, rstd, mul, xa, xb, fault);
        else
          stage_x<MODE, CONSUMERS>(xw, p, x, ldx, pro, gamma, rstd, xa, xb, fault);
        consumer_sync<CONSUMERS>();
        if (n == 0 && tid == 0) mbar_arrive(go);
      }
      const int st = n % M::STAGES;
      mbar_wait(full + 8 * st, (n / M::STAGES) & 1);
      if (!(fault == FAULT_DROP_SHARE && blk == 0))
        chunk_products<MODE, NT>(sets, smem + st * M::STAGE_BYTES, xlane + M::XWORDS * (j - xa), p.xrs, live, aoff,
                                 part);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }

    // the tile's end: each warp's sets are summed in set order, then the
    // other parts' sums join part 0's, in part order; part 0 stores a
    // one-slice strip or leaves the slice's partial
    Acc acc[NT][2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          Acc v = sets[0][nt][f][r];
#pragma unroll
          for (int q = 1; q < SETS; ++q) v += sets[q][nt][f][r];
          acc[nt][f][r] = v;
        }
    // element i of part q at mine[128 (i (PARTS-1) + q-1)]
    Acc* mine = reinterpret_cast<Acc*>(red) + group * 32 + lane;
    if (part > 0) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            mine[128 * (((nt * 2 + f) * 4 + r) * (PARTS - 1) + part - 1)] = acc[nt][f][r];
    }
    consumer_sync<CONSUMERS>();
    if (part == 0) {
      Acc* dst = reinterpret_cast<Acc*>(part_sums) + (size_t)t * p.rows * TC_STRIP;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = 8 * nt + 2 * t4 + (r & 1);
            const int col = 32 * group + 4 * g + 2 * f + (r >> 1);
            const int c = s * TC_STRIP + col;
            Acc v = acc[nt][f][r];
#pragma unroll
            for (int q = 1; q < PARTS; ++q) v += mine[128 * (((nt * 2 + f) * 4 + r) * (PARTS - 1) + q - 1)];
            if (row < p.rows) {
              if (p.slices > 1) {
                dst[row * TC_STRIP + col] = v;
              } else if (c < p.cout) {
                if constexpr (MODE == MODE_W4A8)
                  out[(size_t)row * p.cout + c] = w4a8_out(v, scale[c], rowsc[row], xsc != nullptr, residual,
                                                           (size_t)row * p.cout + c, fault);
                else
                  out[(size_t)row * p.cout + c] = residual ? v * scale[c] + residual[(size_t)row * p.cout + c]
                                                           : v * scale[c];
              }
            }
          }
    }
    consumer_sync<CONSUMERS>();                                 // red is free; the partial is written
    ++ti;
    if (tid == 0) store_release_cta(tiles_done, ti);  // the signal warp counts the tile in
  }
  if (p.slices == 1) return;

  // The strips whose last slice this block took (its final round's tiles):
  // wait until their other slices are counted in, then sum the partials in
  // slice order. No block waits for one that has not started: every tile
  // is counted in as it ends, and the waits come only after this block's
  // own tiles.
  for (int t = blk; t < p.tiles; t += G) {
    if (t / p.strips != p.slices - 1) continue;
    const int s = t % p.strips;
    if (tid == 0)
      while (load_acquire(counters + s) < p.slices - 1) {
      }
    consumer_sync<CONSUMERS>();
    for (int e = tid; e < p.rows * TC_STRIP; e += 32 * CONSUMERS) {
      const int row = e / TC_STRIP, col = e % TC_STRIP;
      const int c = s * TC_STRIP + col;
      if (c >= p.cout) continue;
      Acc v = 0;
#pragma unroll 8
      for (int q = 0; q < p.slices; ++q)
        v += __ldcg(reinterpret_cast<const Acc*>(part_sums) + ((size_t)(q * p.strips + s) * p.rows + row) * TC_STRIP +
                    col);
      if (fault == FAULT_COMBINE_TWICE) v += v;
      if constexpr (MODE == MODE_W4A8) {
        out[(size_t)row * p.cout + c] = w4a8_out(v, scale[c], rowsc[row], xsc != nullptr, residual,
                                                 (size_t)row * p.cout + c, fault);
      } else {
        v *= scale[c];
        if (residual) v += residual[(size_t)row * p.cout + c];
        out[(size_t)row * p.cout + c] = v;
      }
    }
    if (tid == 0) counters[s] = 0;                   // ready for the next launch
  }
}

// ------------------------------------------------------------ K9: the pair
//
// small = glue(x) W1 s1 + residual (glue: none or SiLU-GLU), then big =
// bf16((small * rstd) * gamma) W2 s2, rstd = rsqrt(mean(small^2) + eps) per
// row, in one launch (supir_tpu/ops/quantize.py:_qmm_pair_kernel :398,
// pallas_call :502). Two paired plans over one grid (ops/gemv_plan.py:
// tc_pair_plan): each block walks its phase-1 tiles, then its phase-2
// tiles, through one ring, and the producer issues W2's first boxes right
// after its last W1 box: W2 does not depend on `small`, so the weight stream
// runs on through the phase boundary while the consumers finish phase 1.
// Only the consumers wait, and only before staging phase 2's x': a phase-1
// strip is final when its tile's block stores it (one slice) or its
// last-slice owner has combined it; that block writes the strip's per-row
// sum of squares (strip_ssq) and counts it in on a device counter (a
// release). Every block then waits (an acquire) until all phase-1 strips are
// counted in, which needs every block resident: the launch is cooperative
// and is refused, never split in two, when the grid does not fit. The
// strips' sums are added in a fixed order, so every block takes the same
// rstd without an atomic on a value, and x' is staged from `small` in fp32
// (read through L2: other blocks wrote it in this launch) and rounded to
// bf16 once, the TPU kernel's precision. Both phases' partial sums share
// the scratch: a block writes phase-2 partials only after the wait, so
// after every phase-1 combine has read its own. The last block through
// zeroes the phase counter; every launch leaves the counters zero.

// sum of squares of columns [s * 128, s * 128 + 128) of `small`'s rows
// (those below ncols), by the consumer threads after a consumer_sync that
// orders the strip's stores: each warp's 32 columns of one row by the
// butterfly, the strip's four warps in order, into ssq[s * rows + row]
template <int CONSUMERS>
__device__ __forceinline__ void strip_ssq(const float* small, int rows, int cout, int ncols, int s, float* red,
                                          float* ssq) {
  const int tid = threadIdx.x, lane = tid % 32;
  for (int e0 = 0; e0 < rows * TC_STRIP; e0 += 32 * CONSUMERS) {
    const int e = e0 + tid;                          // whole warps are in or out: rows * 128 % 32 == 0
    if (e < rows * TC_STRIP) {
      const int c = s * TC_STRIP + e % TC_STRIP;
      float q = 0.f;
      if (c < ncols) {
        const float v = __ldcg(small + (size_t)(e / TC_STRIP) * cout + c);
        q = v * v;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
      if (lane == 0) red[e / 32] = q;                // red[4 row + warp of the strip]
    }
  }
  consumer_sync<CONSUMERS>();
  if (tid < rows) ssq[s * rows + tid] = ((red[4 * tid] + red[4 * tid + 1]) + red[4 * tid + 2]) + red[4 * tid + 3];
  consumer_sync<CONSUMERS>();                        // red is free again
}

// Stage phase 2's x' = bf16((small * rstd) * gamma) for chunks [ja, jb):
// small fp32 [rows, cin] (cin = cout1, a multiple of 16: a step is whole or
// past the edge), read through L2
template <int CONSUMERS>
__device__ void stage_small(uint32_t* xw, const TcPlan& p, const float* small, const float* gamma, const float* rstd,
                            int ja, int jb, int fault) {
  const int steps = (jb - ja) * 8;
#pragma unroll 2
  for (int st = threadIdx.x; st < steps; st += 32 * CONSUMERS) {
    const int k0 = (ja * 8 + st) * 16;
    float gm[16];
    gamma16(gm, gamma, k0, p.cin, PRO_NORM);
#pragma unroll 2
    for (int n = 0; n < p.rows; ++n) {
      float v[16];
      if (k0 < p.cin) {
        const float4* sr = reinterpret_cast<const float4*>(small + (size_t)n * p.cin + k0);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 f = __ldcg(sr + q);
          v[4 * q] = f.x, v[4 * q + 1] = f.y, v[4 * q + 2] = f.z, v[4 * q + 3] = f.w;
        }
#pragma unroll
        for (int i = 0; i < 16; ++i) v[i] = (v[i] * rstd[n]) * gm[i];
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) v[i] = 0.f;
      }
      uint32_t w[8];
      if (fault == FAULT_X_ORDER) step_words<MODE_PAIRED, FAULT_X_ORDER>(w, v);
      else step_words<MODE_PAIRED, 0>(w, v);
      uint4* dst = reinterpret_cast<uint4*>(xw + n * p.xrs + st * 8);
      dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
      dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
    }
  }
}

struct PairArgs {
  const qgemv::bf16* x; int ldx; int pro1;           // phase 1's prologue: PRO_NONE or PRO_SILUGLU
  const float* scale1; const float* residual; float* small;
  const float* small_in;                             // what phase 2 reads: small (a stale buffer under FAULT_STALE_SMALL)
  const float* gamma; float eps; int norm_cols;
  const float* scale2; float* big;
  float* part; int* counters; float* ssq; int fault;
};

// the producer's boxes of one phase: the block's tiles of plan p, from
// ring position n on; in phase 1 the first EARLY stages go out at entry,
// the rest once x' is staged
template <int PHASE>
__device__ __forceinline__ void pair_produce(const TcPlan& p, const CUtensorMap* map, int& n, uint32_t base,
                                             uint32_t full, uint32_t empty, uint32_t go) {
  using M = TcMode<MODE_PAIRED>;
  for (int t = blockIdx.x; t < p.tiles; t += p.grid) {
    const int s = t % p.strips, sl = t / p.strips;
    for (int j = sl * p.chunks / p.slices; j < (sl + 1) * p.chunks / p.slices; ++j, ++n) {
      if (PHASE == 0 && n == TC_EARLY_STAGES) mbar_wait(go, 0);
      const int st = n % M::STAGES;
      mbar_wait(empty + 8 * st, ((n / M::STAGES) & 1) ^ 1);
      mbar_expect_tx(full + 8 * st, M::STAGE_BYTES);
      tma_load_2d(base + st * M::STAGE_BYTES, map, full + 8 * st, s * M::BOX_BYTES, j * M::BOX_ROWS);
    }
  }
}

// The consumers' tiles of one phase (qgemv_tc_kernel's tile loop on the
// paired layout): phase 1 stages glue(x), phase 2 x' from small; a tile of
// a one-slice strip stores its outputs (phase 1: + residual, then its
// strip's sums of squares), else leaves its partial. Returns the phase-1
// strips this block made final.
template <int NT, int PHASE>
__device__ __forceinline__ int pair_tiles(const TcPlan& p, const PairArgs& a, unsigned char* smem, uint32_t* xw,
                                          float* red, const float* rstd, int* tiles_done, uint32_t full,
                                          uint32_t empty, uint32_t go, const int (&aoff)[4], unsigned live, int& n,
                                          int& ti) {
  using M = TcMode<MODE_PAIRED>;
  constexpr int CONSUMERS = TcWarps<NT>::CONSUMERS, PARTS = TcWarps<NT>::PARTS, SETS = TcSets<MODE_PAIRED, NT>::SETS;
  const int blk = blockIdx.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3, group = warp % TC_GROUPS, part = warp / TC_GROUPS;
  const uint32_t* xlane = xw + g * p.xrs + 2 * t4;
  int made = 0, xa = 0, xb = 0;
  for (int t = blk; t < p.tiles; t += p.grid) {
    const int s = t % p.strips, sl = t / p.strips;
    float sets[SETS][NT][2][4];
#pragma unroll
    for (int q = 0; q < SETS; ++q)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int r = 0; r < 4; ++r) sets[q][nt][f][r] = 0.f;
    for (int j = sl * p.chunks / p.slices; j < (sl + 1) * p.chunks / p.slices; ++j, ++n) {
      if (j < xa || j >= xb) {
        xa = j;
        xb = min(p.chunks, j + p.wch);
        consumer_sync<CONSUMERS>();
        if (PHASE == 0)
          stage_x<MODE_PAIRED, CONSUMERS>(xw, p, a.x, a.ldx, a.pro1, nullptr, nullptr, xa, xb, a.fault);
        else
          stage_small<CONSUMERS>(xw, p, a.small_in, a.gamma, rstd, xa, xb, a.fault);
        consumer_sync<CONSUMERS>();
        if (PHASE == 0 && n == 0 && tid == 0) mbar_arrive(go);
      }
      const int st = n % M::STAGES;
      mbar_wait(full + 8 * st, (n / M::STAGES) & 1);
      if (!(a.fault == FAULT_DROP_SHARE && blk == 0))
        chunk_products<MODE_PAIRED, NT>(sets, smem + st * M::STAGE_BYTES, xlane + M::XWORDS * (j - xa), p.xrs, live,
                                        aoff, part);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }
    float acc[NT][2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float v = sets[0][nt][f][r];
#pragma unroll
          for (int q = 1; q < SETS; ++q) v += sets[q][nt][f][r];
          acc[nt][f][r] = v;
        }
    float* mine = red + group * 32 + lane;
    if (part > 0) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int r = 0; r < 4; ++r) mine[128 * (((nt * 2 + f) * 4 + r) * (PARTS - 1) + part - 1)] = acc[nt][f][r];
    }
    consumer_sync<CONSUMERS>();
    if (part == 0) {
      float* dst = a.part + (size_t)t * p.rows * TC_STRIP;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = 8 * nt + 2 * t4 + (r & 1);
            const int col = 32 * group + 4 * g + 2 * f + (r >> 1);
            const int c = s * TC_STRIP + col;
            float v = acc[nt][f][r];
#pragma unroll
            for (int q = 1; q < PARTS; ++q) v += mine[128 * (((nt * 2 + f) * 4 + r) * (PARTS - 1) + q - 1)];
            if (row < p.rows) {
              if (p.slices > 1) dst[row * TC_STRIP + col] = v;
              else if (c < p.cout) {
                const size_t i = (size_t)row * p.cout + c;
                if (PHASE == 0) a.small[i] = v * a.scale1[c] + a.residual[i];
                else a.big[i] = v * a.scale2[c];
              }
            }
          }
    }
    consumer_sync<CONSUMERS>();                                 // red is free; the partial is written
    if (PHASE == 0 && p.slices == 1) {
      strip_ssq<CONSUMERS>(a.small, p.rows, p.cout, a.norm_cols, s, red, a.ssq);
      ++made;
    }
    ++ti;
    if (tid == 0) store_release_cta(tiles_done, ti);            // the signal warp counts the tile in
  }
  return made;
}

// The strips of one phase whose last slice this block took: wait until the
// other slices are counted in, sum the partials in slice order, apply the
// epilogue (phase 1: * scale1 + residual, then the strip's sums of squares;
// phase 2: * scale2). Returns the phase-1 strips it made final.
template <int CONSUMERS, int PHASE>
__device__ __forceinline__ int pair_combine(const TcPlan& p, const PairArgs& a, int* counters, float* red) {
  const int tid = threadIdx.x;
  int made = 0;
  if (p.slices == 1) return 0;
  for (int t = blockIdx.x; t < p.tiles; t += p.grid) {
    if (t / p.strips != p.slices - 1) continue;
    const int s = t % p.strips;
    if (tid == 0)
      while (load_acquire(counters + s) < p.slices - 1) {
      }
    consumer_sync<CONSUMERS>();
    for (int e = tid; e < p.rows * TC_STRIP; e += 32 * CONSUMERS) {
      const int row = e / TC_STRIP, col = e % TC_STRIP;
      const int c = s * TC_STRIP + col;
      if (c >= p.cout) continue;
      float v = 0.f;
#pragma unroll 8
      for (int q = 0; q < p.slices; ++q)
        v += __ldcg(a.part + ((size_t)(q * p.strips + s) * p.rows + row) * TC_STRIP + col);
      const size_t i = (size_t)row * p.cout + c;
      if (PHASE == 0) {
        if (a.fault == FAULT_COMBINE_TWICE) v += v;
        a.small[i] = v * a.scale1[c] + a.residual[i];
      } else {
        a.big[i] = v * a.scale2[c];
      }
    }
    if (tid == 0) counters[s] = 0;                   // ready for the next launch
    if (PHASE == 0) {
      consumer_sync<CONSUMERS>();                    // the strip's stores, before its sums of squares
      strip_ssq<CONSUMERS>(a.small, p.rows, p.cout, a.norm_cols, s, red, a.ssq);
      ++made;
    }
  }
  return made;
}

__device__ __forceinline__ void count_add(int* counter, int v) {
  asm volatile("red.relaxed.gpu.global.add.s32 [%0], %1;\n" ::"l"(counter), "r"(v) : "memory");
}

__device__ __forceinline__ int atomic_add_acq_rel(int* counter, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n" : "=r"(old) : "l"(counter), "r"(v) : "memory");
  return old;
}

template <int NT>
__global__ void __launch_bounds__(TcWarps<NT>::THREADS, 1)
qpair_tc_kernel(const __grid_constant__ CUtensorMap map1, const __grid_constant__ CUtensorMap map2, const TcPlan p1,
                const TcPlan p2, const PairArgs a) {
  using M = TcMode<MODE_PAIRED>;
  constexpr int CONSUMERS = TcWarps<NT>::CONSUMERS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  // ring | x' window (the larger phase's) | the step halves' sums | rstd |
  // finished tiles | barriers (ops/gemv_plan.py:tc_pair_plan's smem)
  uint32_t* xw = reinterpret_cast<uint32_t*>(smem + M::RING);
  float* red = reinterpret_cast<float*>(smem + M::RING + ((4 * p1.rows * max(p1.xrs, p2.xrs) + 15) & ~15));
  float* rstd = red + TC_RED_FLOATS;
  int* tiles_done = reinterpret_cast<int*>(rstd + TC_MAX_ROWS);
  const uint32_t full = smem_u32(tiles_done + 4);
  const uint32_t empty = full + 8 * M::STAGES;
  const uint32_t go = empty + 8 * M::STAGES;
  int* counters1 = a.counters;
  int* counters2 = a.counters + p1.strips;
  int* done1 = counters2 + p2.strips;                // phase-1 strips counted in
  int* through = done1 + 1;                          // blocks at their end

  const int blk = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    *tiles_done = 0;
    for (int s = 0; s < M::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    mbar_init(go, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS) {
    // producer: phase 1's boxes, then phase 2's, without a pause between
    if (lane == 0) {
      int n = 0;
      pair_produce<0>(p1, &map1, n, base, full, empty, go);
      pair_produce<1>(p2, &map2, n, base, full, empty, go);
    }
    return;
  }
  if (warp == CONSUMERS + 1) {
    // signal warp: counts each finished tile but a last slice's in on its
    // phase's strip counter, as qgemv_tc_kernel's
    if (lane == 0 && (p1.slices > 1 || p2.slices > 1)) {
      const int mine1 = blk < p1.grid ? (p1.tiles - 1 - blk) / p1.grid + 1 : 0;
      const int mine = mine1 + (blk < p2.grid ? (p2.tiles - 1 - blk) / p2.grid + 1 : 0);
      for (int sent = 0; sent < mine;) {
        int done;
        while ((done = load_acquire_cta(tiles_done)) == sent) {
        }
        fence_gpu();
        for (; sent < done; ++sent) {
          if (sent < mine1) {
            const int t = blk + sent * p1.grid;
            if (t / p1.strips < p1.slices - 1) count_in(counters1 + t % p1.strips);
          } else {
            const int t = blk + (sent - mine1) * p2.grid;
            if (t / p2.strips < p2.slices - 1) count_in(counters2 + t % p2.strips);
          }
        }
      }
    }
    return;
  }

  const int tid = threadIdx.x;
  int aoff[4];
  stage_offsets<MODE_PAIRED>(aoff, warp % TC_GROUPS, lane >> 2, lane & 3);
  unsigned live = 0;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) live |= (8 * nt + (lane >> 2) < p1.rows ? 1u : 0u) << nt;
  int n = 0, ti = 0;

  int made = pair_tiles<NT, 0>(p1, a, smem, xw, red, rstd, tiles_done, full, empty, go, aoff, live, n, ti);
  made += pair_combine<CONSUMERS, 0>(p1, a, counters1, red);
  // release the strips this block made final (their stores and sums of
  // squares, ordered before by the consumer_sync at strip_ssq's end)
  if (tid == 0 && made > 0) {
    fence_gpu();
    count_add(done1, made);
  }
  if (a.fault != FAULT_STALE_SMALL && tid == 0)
    while (load_acquire(done1) < p1.strips) {
    }
  consumer_sync<CONSUMERS>();
  // rstd of each row: warp w takes rows w, w + CONSUMERS, ...; lane l sums
  // strips l, l + 32, ... in order, the butterfly sums the lanes: the same
  // bits in every block
  const int stats_strips = a.fault == FAULT_ONE_STRIP ? 1 : p1.strips;
  for (int row = warp; row < p1.rows; row += CONSUMERS) {
    float ss = 0.f;
    for (int k = lane; k < stats_strips; k += 32) ss += __ldcg(a.ssq + k * p1.rows + row);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) rstd[row] = rsqrtf(ss / (float)a.norm_cols + a.eps);
  }
  // (the first phase-2 staging's consumer_sync publishes rstd)
  pair_tiles<NT, 1>(p2, a, smem, xw, red, rstd, tiles_done, full, empty, go, aoff, live, n, ti);
  pair_combine<CONSUMERS, 1>(p2, a, counters2, red);
  // the last block through zeroes the phase counter for the next launch:
  // every block has passed its wait, and the acq_rel chain orders every
  // count before the reset
  consumer_sync<CONSUMERS>();
  if (tid == 0 && atomic_add_acq_rel(through, 1) == (int)gridDim.x - 1) {
    *done1 = 0;
    *through = 0;
  }
}

// ------------------------------------------------------------------ host

template <int MODE, int NT>
cudaError_t launch(const CUtensorMap& map, const TcPlan& p, const void* x, int ldx, const float* xs,
                   const float* gamma, float eps, int pro, const float* scale, const float* residual, float* out,
                   float* part, int* counters, int fault, cudaStream_t stream) {
  static int attr_bytes = 0;                         // the shared memory this instance may take so far
  if (p.smem > attr_bytes) {
    const cudaError_t err = cudaFuncSetAttribute(qgemv_tc_kernel<MODE, NT>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    attr_bytes = p.smem;
  }
  qgemv_tc_kernel<MODE, NT><<<p.grid, TcWarps<NT>::THREADS, p.smem, stream>>>(
      map, p, static_cast<const qgemv::bf16*>(x), ldx, gamma, eps, pro, scale, residual, out, part, counters, fault,
      xs);
  return cudaGetLastError();
}

// W4A8 has no 4-tile instance (17-32 rows): it sat at the register cap of a
// 320-thread block (168) and spilled 16 bytes under one ptxas (CUDA 12.9),
// so a call of more than 16 rows is two launches (ops/gemv_plan.py:
// TC_W4A8_ROWS)
template <int MODE>
cudaError_t launch_nt(const CUtensorMap& map, const TcPlan& p, const void* x, int ldx, const float* xs,
                      const float* gamma, float eps, int pro, const float* scale, const float* residual, float* out,
                      float* part, int* counters, int fault, cudaStream_t s) {
  if (p.nt == 1)
    return launch<MODE, 1>(map, p, x, ldx, xs, gamma, eps, pro, scale, residual, out, part, counters, fault, s);
  if (p.nt == 2)
    return launch<MODE, 2>(map, p, x, ldx, xs, gamma, eps, pro, scale, residual, out, part, counters, fault, s);
  if constexpr (MODE != MODE_W4A8) {
    if (p.nt == 4)
      return launch<MODE, 4>(map, p, x, ldx, xs, gamma, eps, pro, scale, residual, out, part, counters, fault, s);
  }
  return cudaErrorInvalidValue;
}

// K9: one cooperative launch (cudaLaunchKernelExC with the cooperative
// attribute, which stream capture records as a cooperative graph node), so
// that the launch is refused rather than run when the grid cannot be
// resident at once
template <int NT>
cudaError_t launch_pair(const CUtensorMap& m1, const CUtensorMap& m2, const TcPlan& p1, const TcPlan& p2, int grid,
                        int smem, const PairArgs& a, cudaStream_t stream) {
  static int attr_bytes = 0;
  if (smem > attr_bytes) {
    const cudaError_t err = cudaFuncSetAttribute(qpair_tc_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 smem);
    if (err != cudaSuccess) return err;
    attr_bytes = smem;
  }
  cudaLaunchAttribute coop[1];
  coop[0].id = cudaLaunchAttributeCooperative;
  coop[0].val.cooperative = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(grid);
  config.blockDim = dim3(TcWarps<NT>::THREADS);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = coop;
  config.numAttrs = 1;
  void* args[] = {const_cast<CUtensorMap*>(&m1), const_cast<CUtensorMap*>(&m2), const_cast<TcPlan*>(&p1),
                  const_cast<TcPlan*>(&p2), const_cast<PairArgs*>(&a)};
  const cudaError_t err = cudaLaunchKernelExC(&config, reinterpret_cast<const void*>(qpair_tc_kernel<NT>), args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Encodes the weight's tensor map into map_out (128 bytes, CUtensorMap):
// uint8 [rows, cols] row-major (cols bytes a row, a multiple of 16; base
// 16-byte aligned), box box_cols bytes x box_rows rows, the 64- or 128-byte
// swizzle (swizzle_bytes, at least box_cols), zeros past the edges. Returns
// 0, a cudaError_t from the entry-point query, or minus the CUresult of a
// failed encode.
extern "C" int supir_qgemv_tc_map(const void* w, long long rows, long long cols, int box_rows, int box_cols,
                                  int swizzle_bytes, void* map_out) {
  if ((swizzle_bytes != 64 && swizzle_bytes != 128) || box_cols <= 0 || box_cols > swizzle_bytes)
    return (int)cudaErrorInvalidValue;
  EncodeTiled fn;
  const cudaError_t found = encode_tiled(&fn);
  if (found != cudaSuccess) return static_cast<int>(found);
  alignas(64) CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  memcpy(map_out, &map, sizeof(map));
  return 0;
}

// supir_qgemv_tc (K5, K6, K7, K10, K11): map from supir_qgemv_tc_map for
// the weights (paired uint8 [cin/2, cout], mode 0 and W4A8's mode 4;
// half-split uint8 [cin/2, cout], mode 1, cin % 16 == 0; int8 [cin, cout],
// mode 2; native uint8 [cin, cout/2], mode 3, cout % 32 == 0); plan:
// ops/gemv_plan.py:PLAN_FIELDS; x bf16 [rows, >= cin] (>= 2 cin with
// SiLU-GLU), row stride ldx, 16-byte aligned rows, or in mode 4 with xs
// (K10) int8 [rows, >= cin], 8-byte aligned rows; xs fp32 [rows], the rows'
// absmax scales (mode 4 only; null for K5's act_int8 mode, which quantizes
// x itself); gamma fp32 [cin] (RMSNorm only); prologue 0 none, 1 RMSNorm, 2
// SiLU-GLU (prologue and residual: paired and K5's act_int8 only); scale
// fp32 [cout]; residual fp32 [rows, cout] or null; out fp32 [rows, cout];
// part fp32 [grid, 2, 32, 128] scratch; counters int32 [strips], zero, and
// zero again when the launch ends. fault: a planted fault (0 for none).
// Returns the launch's cudaError_t.
extern "C" int supir_qgemv_tc(const void* map, const int* plan, int mode, const void* x, int ldx, const void* xs,
                              const void* gamma, float eps, int prologue, const void* scale, const void* residual,
                              void* out, void* part, void* counters, int fault, void* stream) {
  alignas(64) CUtensorMap m;
  memcpy(&m, map, sizeof(m));
  TcPlan p;
  memcpy(&p, plan, sizeof(p));
  if (p.rows <= 0 || p.rows > TC_MAX_ROWS || p.grid <= 0 || p.cout % 16 || p.cin % 8 || ldx % 8 || p.wcols % 16 ||
      p.wcols != (mode == MODE_NATIVE ? p.cout / 2 : p.cout))
    return (int)cudaErrorInvalidValue;
  if (prologue == PRO_NORM && gamma == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gm = static_cast<const float*>(gamma);
  const float* sc = static_cast<const float*>(scale);
  const float* rs = static_cast<const float*>(residual);
  float* o = static_cast<float*>(out);
  float* pt = static_cast<float*>(part);
  int* ct = static_cast<int*>(counters);
  const float* xsc = static_cast<const float*>(xs);
  if (mode == MODE_W4A8 && p.box_rows == TcMode<MODE_W4A8>::BOX_ROWS) {
    if (xsc != nullptr && (prologue != PRO_NONE || residual != nullptr)) return (int)cudaErrorInvalidValue;   // K10
    return (int)launch_nt<MODE_W4A8>(m, p, x, ldx, xsc, gm, eps, prologue, sc, rs, o, pt, ct, fault, s);
  }
  if (xsc != nullptr) return (int)cudaErrorInvalidValue;        // row scales are W4A8's
  if (mode == MODE_PAIRED && p.box_rows == TcMode<MODE_PAIRED>::BOX_ROWS)
    return (int)launch_nt<MODE_PAIRED>(m, p, x, ldx, nullptr, gm, eps, prologue, sc, rs, o, pt, ct, fault, s);
  if (prologue != PRO_NONE || residual != nullptr) return (int)cudaErrorInvalidValue;   // K7 and K11 take neither
  if (mode == MODE_HALF && p.cin % 16 == 0 && p.box_rows == TcMode<MODE_HALF>::BOX_ROWS)
    return (int)launch_nt<MODE_HALF>(m, p, x, ldx, nullptr, gm, eps, prologue, sc, rs, o, pt, ct, fault, s);
  if (mode == MODE_INT8 && p.box_rows == TcMode<MODE_INT8>::BOX_ROWS)
    return (int)launch_nt<MODE_INT8>(m, p, x, ldx, nullptr, gm, eps, prologue, sc, rs, o, pt, ct, fault, s);
  if (mode == MODE_NATIVE && p.box_rows == TcMode<MODE_NATIVE>::BOX_ROWS)
    return (int)launch_nt<MODE_NATIVE>(m, p, x, ldx, nullptr, gm, eps, prologue, sc, rs, o, pt, ct, fault, s);
  return (int)cudaErrorInvalidValue;
}

// supir_qpair_tc (K9): maps from supir_qgemv_tc_map for w1 (paired uint8
// [cin1/2, cout1]) and w2 (paired uint8 [cout1/2, cout2]); plan:
// ops/gemv_plan.py:PairPlan.packed (both plans' PLAN_FIELDS, then grid and
// smem); x bf16 [rows, >= cin1] (>= 2 cin1 with siluglu1), row stride ldx,
// 16-byte aligned rows; scale1 fp32 [cout1], residual fp32 [rows, cout1],
// small fp32 [rows, cout1] out; small_in: small, or for FAULT_STALE_SMALL a
// buffer phase 2 reads instead; gamma fp32 [cout1], 16-byte aligned; 0 <
// norm_cols <= cout1 (cout1 but for planted faults); scale2 fp32 [cout2];
// big fp32 [rows, cout2] out; part: the partial-sum scratch; counters int32
// [strips1 + strips2 + 2], zero, and zero again when the launch ends; ssq
// fp32 [strips1 x rows] scratch. Returns the launch's cudaError_t
// (cudaErrorCooperativeLaunchTooLarge when the grid cannot be resident).
extern "C" int supir_qpair_tc(const void* map1, const void* map2, const int* plan, const void* x, int ldx,
                              int siluglu1, const void* scale1, const void* residual, void* small,
                              const void* small_in, const void* gamma, float eps, int norm_cols, const void* scale2,
                              void* big, void* part, void* counters, void* ssq, int fault, void* stream) {
  alignas(64) CUtensorMap m1, m2;
  memcpy(&m1, map1, sizeof(m1));
  memcpy(&m2, map2, sizeof(m2));
  TcPlan p1, p2;
  memcpy(&p1, plan, sizeof(p1));
  memcpy(&p2, plan + sizeof(TcPlan) / sizeof(int), sizeof(p2));
  const int grid = plan[2 * sizeof(TcPlan) / sizeof(int)], smem = plan[2 * sizeof(TcPlan) / sizeof(int) + 1];
  if (p1.rows <= 0 || p1.rows > TC_MAX_ROWS || p2.rows != p1.rows || p2.cin != p1.cout || p1.cout % 16 ||
      p2.cout % 16 || p1.cin % 8 || ldx % 8 || p1.wcols != p1.cout || p2.wcols != p2.cout ||
      p1.box_rows != TcMode<MODE_PAIRED>::BOX_ROWS || p2.box_rows != TcMode<MODE_PAIRED>::BOX_ROWS ||
      grid < p1.grid || grid < p2.grid || norm_cols <= 0 || norm_cols > p1.cout)
    return (int)cudaErrorInvalidValue;
  if (residual == nullptr || gamma == nullptr || small_in == nullptr) return (int)cudaErrorInvalidValue;
  const PairArgs a{static_cast<const qgemv::bf16*>(x), ldx, siluglu1 ? PRO_SILUGLU : PRO_NONE,
                   static_cast<const float*>(scale1), static_cast<const float*>(residual), static_cast<float*>(small),
                   static_cast<const float*>(small_in), static_cast<const float*>(gamma), eps, norm_cols,
                   static_cast<const float*>(scale2), static_cast<float*>(big), static_cast<float*>(part),
                   static_cast<int*>(counters), static_cast<float*>(ssq), fault};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p1.nt == 1) return (int)launch_pair<1>(m1, m2, p1, p2, grid, smem, a, s);
  if (p1.nt == 2) return (int)launch_pair<2>(m1, m2, p1, p2, grid, smem, a, s);
  if (p1.nt == 4) return (int)launch_pair<4>(m1, m2, p1, p2, grid, smem, a, s);
  return (int)cudaErrorInvalidValue;
}
