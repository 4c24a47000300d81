// The int4 decodes of the tensor-core decode GEMV (quant_gemv_tc.cu), in one
// place: the body compiles them into every layout that takes nibbles, and
// the nibble-order check (nibble_order.cu, T3a) reads quantize_int4_paired's
// bytes back through these same definitions. ops/gemv_plan.py:byte_perm,
// nib2_sel, nib2 and quad16 walk the same bit operations in torch.
//
// Each reads the 4-byte words a lane takes from the weight stage (4 columns
// of one packed row), as the body's lanes read them:
//   nib2_sel / nib2  two nibbles of a word as a bf16x2 (paired, half-split
//                    and native layouts): a byte permute, one lop3 and one
//                    hsub2, exact for every nibble
//   quad16           W4A8: the words of two packed rows as the s8 A
//                    registers of two columns, each nibble the byte 16 n,
//                    bytes in the k order 4t, 4t + 2, 4t + 1, 4t + 3
// The template flags exist for the check's planted faults only; the body
// compiles the defaults.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tcdec {

// two nibbles as a bf16x2: the low nibbles of bytes 0 and 2 of
// __byte_perm(w, w4, sel) (w4 = w >> 4: byte i + 4 of the pair is byte i's
// high nibble), the first in the low half; the exponent trick by that
// permute, one lop3 ((r & 0x000F000F) ^ 0x43084308: each nibble's sign bit
// flipped under the exponent of 128) and one hsub2 of 136. SIGNED false
// drops the lop3's ^ 8 (planted fault: the sign not restored, n - 8)
template <bool SIGNED = true>
__device__ __forceinline__ uint32_t nib2_sel(uint32_t w, uint32_t w4, int sel) {
  const uint32_t r = __byte_perm(w, w4, sel);
  uint32_t bits;                                                        // bf16 128 + (n ^ 8)
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n"
      : "=r"(bits)
      : "r"(r), "r"(0x000F000Fu), "r"(SIGNED ? 0x43084308u : 0x43004300u));
  const uint32_t k136 = 0x43084308u;
  const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&bits),
                                   *reinterpret_cast<const __nv_bfloat162*>(&k136));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the two nibbles of byte i of w, low nibble in the low half (a paired or
// half-split byte: one column's k pair); SWAP mirrors the permute's
// selector (planted fault: the high nibble in the low half)
template <bool SIGNED = true, bool SWAP = false>
__device__ __forceinline__ uint32_t nib2(uint32_t w, uint32_t w4, int i) {
  return nib2_sel<SIGNED>(w, w4, SWAP ? (4 + i) | (i << 8) : i | ((4 + i) << 8));   // byte 0: b_i, byte 2: b_i >> 4
}

// W4A8: the A registers of columns 4g + 2f (lo) and 4g + 2f + 1 (hi) at k
// 4t .. 4t + 3 from the lane's words of packed rows 2t (wa) and 2t + 1 (wb)
// (or 2t + 8, 2t + 9): one permute joins the columns' bytes of both rows,
// the high nibbles masked in place and the low ones shifted up and masked
// are s8 bytes of value 16 n, and two permutes sort them per column, bytes
// in the k order 4t, 4t + 2, 4t + 1, 4t + 3. SWAP mirrors the sorting
// permutes' selectors (planted fault: each k pair's nibbles exchanged)
template <bool SWAP = false>
__device__ __forceinline__ void quad16(uint32_t& lo, uint32_t& hi, uint32_t wa, uint32_t wb, int f) {
  const uint32_t u = __byte_perm(wa, wb, (2 * f) | ((4 + 2 * f) << 4) | ((2 * f + 1) << 8) | ((5 + 2 * f) << 12));
  const uint32_t h = u & 0xF0F0F0F0u;            // k 4t + 1 (row 2t), 4t + 3 (row 2t + 1) of both columns
  const uint32_t l = (u << 4) & 0xF0F0F0F0u;     // k 4t, 4t + 2
  lo = __byte_perm(l, h, SWAP ? 0x1054 : 0x5410);
  hi = __byte_perm(l, h, SWAP ? 0x3276 : 0x7632);
}

}  // namespace tcdec
