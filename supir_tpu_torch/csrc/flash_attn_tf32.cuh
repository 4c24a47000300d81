// 3xTF32 on Hopper's tensor cores: the operand split and the TF32 wgmma
// products that the fp32 flash sources share. flash_attn_fwd_fp32.cu (K1,
// K3 and K3 ALiBi fp32) and flash_attn_bwd_fp32.cu (K4 and K4 ALiBi fp32)
// each include it into their own translation unit, after
// flash_attn_tma.cuh.
//
// The split. The tensor cores take fp32 operands only as TF32 (10 mantissa
// bits: they do not read an fp32 word's low 13 mantissa bits). Each operand
// x is split into hi = x rounded to TF32 (its bits + 0x1000, the low 13
// cleared: nearest, ties away from zero) and lo = x - hi (exact in fp32),
// and lo too is handed over with its low 13 bits cleared, so what the
// tensor cores read is defined whatever they do with those bits
// (ops/flash_attention.py:tf32_split, tf32_operand). A product is lo_a hi_b
// + hi_a lo_b + hi_a hi_b, the small terms first, into one fp32
// accumulator; lo_a lo_b (~2^-22 of it) is dropped.
//
// The fragment permutation. A product's accumulator gives lane (g, t) of a
// warp the columns 2t and 2t + 1 of every 8-column group (rows g and
// g + 8); the TF32 A operand from registers wants k-indices t and t + 4 of
// every k8 step. So a B operand whose k-index runs over those columns (V^T
// in the forward, K^T, Q^T and dO^T in the backward) holds in slot p of
// each 8-column group the column VT_KEY[p] = 2 (p % 4) + p / 4: a lane's
// value of column 2t meets slot t, that of 2t + 1 slot t + 4, and the
// accumulator goes to the A fragment without an exchange (`a_fragment`).
// TF32 wgmma reads K-major operands only (the transpose bits exist for
// 16-bit types alone), so those B operands are written transposed, in that
// order, by the producer that splits them.

#pragma once

#include "flash_attn_tma.cuh"

namespace {

constexpr int FP32_SLAB = 32;                // fp32 columns per 128-byte swizzle slab (one TMA box)
constexpr uint32_t TF32_HALF = 0x1000u;      // half a TF32 ulp, in the fp32 bits
constexpr uint32_t TF32_KEEP = 0xFFFFE000u;  // the bits of an fp32 word a TF32 operand keeps
// slot p of each 8-column group of a transposed B row holds column VT_KEY[p]
constexpr int VT_KEY[8] = {0, 2, 4, 6, 1, 3, 5, 7};

constexpr bool vt_key_is_the_rule() {
  for (int p = 0; p < 8; ++p)
    if (VT_KEY[p] != 2 * (p & 3) + (p >> 2)) return false;
  return true;
}
static_assert(vt_key_is_the_rule(), "the split pass writes transposed operands by 2 (p % 4) + p / 4");

// the TF32 pair of x as the tensor cores read it: hi = x rounded to TF32,
// lo = x - hi with its low 13 bits cleared
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + TF32_HALF) & TF32_KEEP;
  lo = __float_as_uint(x - __uint_as_float(hi)) & TF32_KEEP;
}

__device__ __forceinline__ void tf32_split4(const float4& x, uint4& hi, uint4& lo) {
  tf32_split(x.x, hi.x, lo.x);
  tf32_split(x.y, hi.y, lo.y);
  tf32_split(x.z, hi.z, lo.z);
  tf32_split(x.w, hi.w, lo.w);
}

// An accumulator's eight-column group j (rows g, g + 8 at columns 8j + 2t,
// + 1: acc[4j .. 4j + 3]) split into the TF32 A fragments of k8 step j:
// k-index t is column 2t, t + 4 column 2t + 1 (VT_KEY).
template <int N>
__device__ __forceinline__ void a_fragment(const float (&acc)[N], uint32_t (&hi)[N], uint32_t (&lo)[N]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    tf32_split(acc[4 * j], hi[4 * j], lo[4 * j]);
    tf32_split(acc[4 * j + 2], hi[4 * j + 1], lo[4 * j + 1]);
    tf32_split(acc[4 * j + 1], hi[4 * j + 2], lo[4 * j + 2]);
    tf32_split(acc[4 * j + 3], hi[4 * j + 3], lo[4 * j + 3]);
  }
}

// the producer warpgroup's own barrier (id 1; 0 is __syncthreads)
__device__ __forceinline__ void producer_sync() { asm volatile("bar.sync 1, 128;\n" ::: "memory"); }

// this thread's shared-memory accesses, ordered against the async proxy
// (wgmma, TMA)
__device__ __forceinline__ void fence_to_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// keeps A-fragment registers live (and unmoved) up to this point: an
// asynchronous product reads them until its wait returns
template <int N>
__device__ __forceinline__ void keep_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// S (+)= A B^T over one k8 step at TF32, A and B K-major in shared memory
// (128-byte swizzle); N = 32 or 64 by the accumulator's size; scale_d 0
// overwrites S.
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (+)= A B^T over one k8 step at TF32, A from registers (four TF32 words
// a thread: rows g and g + 8 at k-indices t and t + 4, g = lane / 4, t =
// lane % 4), B K-major in shared memory; N = 32, 64 or 128 by the
// accumulator's size; scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16], const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64], const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

}  // namespace
