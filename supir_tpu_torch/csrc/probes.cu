// The decode-GEMV probes' own kernels (T3a, T4a, and the first designs of
// T1a, T1b and T3b) for Hopper (sm_90a). Their counterparts are the Pallas
// kernels of the TPU probes in tools/; supir_tpu_torch/tools/ runs them.
//
//   T1a/T1b column sum (the first design: T1a and T1b run on the GEMV
//       body's ring, csrc/colsum_tc.cu, and this one is kept to time them in
//       turns): u8 q [rows, cout] -> fp32 [1, cout], the column sums
//       of the bytes read as unsigned. Replaces tools/stream_ceiling.py:
//       sum_kernel (:48, pallas_call :78; 1-D grid of output strips) and the
//       closure sum2d_kernel (:99, pallas_call :110; 2-D grid that also
//       splits the rows). The TPU's sum_kernel zeroes its output only at
//       grid step 0, so every output block past the first accumulates onto
//       memory it never initialised; this kernel computes the column sum the
//       probe meant.
//   T3a nibble unpack: u8 [r, c] -> fp32 [2r, c], row 2i the low nibble of
//       byte row i and row 2i+1 the high one, sign-extended (8 -> -8), by
//       quant_gemv.cuh's nib, the very conversion the GEMVs use. Replaces
//       tools/bitcast_probe.py:order_kernel (:33, pallas_call :46), which
//       reads the order pltpu.bitcast gives.
//   T3b single-cast GEMV: bf16 x [<= 8 rows, cin] x paired int4 [cin/2, cout]
//       -> fp32 [B, cout] * scale, each byte turned into a bf16 pair by one
//       packed subtract (quant_gemv.cuh's nib2_bf16, the PAIRED_BF16 layout)
//       and accumulated in fp32. Replaces tools/bitcast_probe.py:
//       gemv_kernel_bitcast (:63, pallas_call :111: one s4 -> bf16 cast).
//   T4a native cast: column-pair-packed int4 u8 [r, c/2] -> bf16 [r, c] x 2
//       (byte (k, j) = column 2j low | 2j+1 high), through nib2_bf16 and one
//       packed multiply. Replaces tools/int4_native_probe.py:stage2_mosaic's
//       k (:46, pallas_call :50), the int4 -> bf16 cast of a [128, 128] block.
// (T2 is K10's strip body at other geometries, csrc/gemv_sweep.cu; T1c,
// T3b and T4b run on csrc/quant_gemv_tc.cu.)
//
// What bounds them: bytes. The column sum reads each byte once and adds it
// (one integer op per byte, ~1.3 with the packing below), far under the
// card's integer rate, so its least time is the bytes over 3.35 TB/s (11.7
// us for 39.3 MB). The unpack and the cast write 8 and 4 bytes per byte
// read; at the probes' [8, 128] and [128, 128] each is one launch. The GEMV
// is bound as K6.
//
// Design of the column sum: a block owns a strip of `strip` columns
// (16-byte column groups, one per thread) and a block of `brow` rows; the
// threads left over when the strip has fewer groups than 256 take further
// row lanes. Each thread keeps 8 loads of 16 bytes in flight and adds the
// bytes two to a 32-bit word (bytes 0 and 2, 1 and 3 in 16-bit lanes),
// flushing the lanes every 256 rows before they could carry (256 x 255 <
// 2^16). Row lanes meet in shared memory. The 1-D grid (one row block)
// stores its sums; the 2-D grid's row blocks add theirs into the output,
// which the caller zeroes, by fp32 atomics: every partial and every running
// total is an integer below 2^24 (2560 x 255 = 652,800), so the fp32 sums
// are exact in any order. That cross-block combine is where the TPU's
// sequential grid, which carried the sum in its output block from step to
// step, does not carry over.
//
// FAULT instances exist for planted faults only: column sum 1 reads the
// bytes as int8, 2 drops the last row block; unpack and cast 1 swap the two
// nibbles of a byte, 2 leave them unsigned.

#include "quant_gemv.cuh"

using namespace qgemv;

namespace {

constexpr int CS_THREADS = 256;
constexpr int CS_UNROLL = 8;   // 16-byte loads in flight per thread

__device__ __forceinline__ void add_bytes(uint32_t w, uint32_t& lo, uint32_t& hi) {
  lo += w & 0x00FF00FFu;          // bytes 0 and 2
  hi += (w >> 8) & 0x00FF00FFu;   // bytes 1 and 3
}

template <bool ATOMIC, int FAULT>
__global__ void __launch_bounds__(CS_THREADS)
colsum_kernel(const uint8_t* __restrict__ q, int rows, int cout, int strip, int brow, float* __restrict__ out) {
  __shared__ int red[CS_THREADS * 16];
  if (FAULT == 2 && gridDim.y > 1 && blockIdx.y == gridDim.y - 1) return;
  const int tid = threadIdx.x;
  const int groups = strip / 16;                     // 16-byte column groups of the strip
  const int gp = min(groups, CS_THREADS);            // groups per pass
  const int lanes = CS_THREADS / gp;                 // row lanes
  const int lr = tid / gp, cgl = tid % gp;
  const int r_begin = blockIdx.y * brow;
  const int r_end = min(rows, r_begin + brow);

  for (int g0 = 0; g0 < groups; g0 += gp) {
    const int cg = g0 + cgl;
    const int col = blockIdx.x * strip + cg * 16;
    const bool ok = lr < lanes && cg < groups && col < cout;
    int acc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = 0;
    if (ok) {
      const uint8_t* base = q + col;
      int r = r_begin + lr;
      while (r < r_end) {
        uint32_t lo[4] = {0u, 0u, 0u, 0u}, hi[4] = {0u, 0u, 0u, 0u};
        // at most 256 rows into the 16-bit lanes
        for (int n = 0; n < 256 / CS_UNROLL && r < r_end; ++n, r += CS_UNROLL * lanes) {
          uint4 v[CS_UNROLL];
#pragma unroll
          for (int u = 0; u < CS_UNROLL; ++u) {
            const int rr = r + u * lanes;
            v[u] = rr < r_end ? __ldg(reinterpret_cast<const uint4*>(base + (size_t)rr * cout))
                              : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
          for (int u = 0; u < CS_UNROLL; ++u) {
            if (FAULT == 1) {
              const uint32_t ws[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
              for (int j = 0; j < 16; ++j) acc[j] += (int)(int8_t)(ws[j / 4] >> (8 * (j % 4)));
            } else {
              add_bytes(v[u].x, lo[0], hi[0]);
              add_bytes(v[u].y, lo[1], hi[1]);
              add_bytes(v[u].z, lo[2], hi[2]);
              add_bytes(v[u].w, lo[3], hi[3]);
            }
          }
        }
#pragma unroll
        for (int wd = 0; wd < 4; ++wd) {
          acc[4 * wd + 0] += (int)(lo[wd] & 0xFFFFu);
          acc[4 * wd + 1] += (int)(hi[wd] & 0xFFFFu);
          acc[4 * wd + 2] += (int)(lo[wd] >> 16);
          acc[4 * wd + 3] += (int)(hi[wd] >> 16);
        }
      }
    }
    // the row lanes meet in shared memory (integer sums: any order is exact)
    if (lanes > 1) {
      __syncthreads();   // the previous pass's reads are over
#pragma unroll
      for (int j = 0; j < 16; ++j) red[tid * 16 + j] = acc[j];
      __syncthreads();
      if (lr == 0) {
        for (int l = 1; l < lanes; ++l)
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[j] += red[(l * gp + cgl) * 16 + j];
      }
    }
    if (ok && lr == 0) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (ATOMIC) atomicAdd(out + col + j, (float)acc[j]);
        else out[col + j] = (float)acc[j];
      }
    }
  }
}

template <int FAULT>
__device__ __forceinline__ float nib_fault(uint32_t n) {
  return FAULT == 2 ? (float)(n & 0xFu) : nib(n);
}

template <int FAULT>
__global__ void unpack_kernel(const uint8_t* __restrict__ q, int r, int c, float* __restrict__ out) {
  const size_t n = (size_t)r * c;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (size_t)gridDim.x * blockDim.x) {
    const uint32_t b = q[i];
    const size_t row = i / c, col = i % c;
    const uint32_t lo = FAULT == 1 ? b >> 4 : b, hi = FAULT == 1 ? b : b >> 4;
    out[(2 * row) * c + col] = nib_fault<FAULT>(lo);
    out[(2 * row + 1) * c + col] = nib_fault<FAULT>(hi);
  }
}

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

template <int BT, int S>
cudaError_t launch_single_cast(const void* x, int ldx, const void* w, const void* scale, void* out, int B,
                               int cin, int cout, cudaStream_t stream) {
  const dim3 grid((cout + S - 1) / S, (B + BT - 1) / BT);
  gemv_kernel<PAIRED_BF16, BT, PRO_NONE, false, S><<<grid, THREADS, 0, stream>>>(
      static_cast<const bf16*>(x), ldx, nullptr, 0.f, static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), nullptr, static_cast<float*>(out), B, cin, cout);
  return cudaGetLastError();
}

template <int S>
cudaError_t single_cast_rows(const void* x, int ldx, const void* w, const void* scale, void* out, int B,
                             int cin, int cout, cudaStream_t stream) {
  if (B <= 1) return launch_single_cast<1, S>(x, ldx, w, scale, out, B, cin, cout, stream);
  return launch_single_cast<8, S>(x, ldx, w, scale, out, B, cin, cout, stream);
}

int grid_for(size_t n) {
  const size_t blocks = (n + 255) / 256;
  return (int)(blocks < 4096 ? blocks : 4096);
}

}  // namespace

// supir_colsum (T1a, T1b): q uint8 [rows, cout], 16-byte aligned, cout and
// strip multiples of 16; out fp32 [cout]. two_d 0: one row block, the sums
// stored. two_d 1: row blocks of brow rows, the sums added by fp32 atomics
// into out, which must hold zeros. rows * 255 < 2^24. fault: 0 none, 1
// bytes read as int8, 2 last row block dropped (two_d only).
extern "C" int supir_colsum(const void* q, int rows, int cout, int strip, int brow, int two_d, int fault,
                            void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || cout <= 0 || cout % 16 || strip <= 0 || strip % 16 || rows > (1 << 24) / 255)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(q) % 16) return (int)cudaErrorInvalidValue;
  if (!two_d) brow = rows;
  if (brow <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((cout + strip - 1) / strip, (rows + brow - 1) / brow);
  const uint8_t* qq = static_cast<const uint8_t*>(q);
  float* o = static_cast<float*>(out);
  if (!two_d && fault == 0) colsum_kernel<false, 0><<<grid, CS_THREADS, 0, s>>>(qq, rows, cout, strip, brow, o);
  else if (!two_d && fault == 1) colsum_kernel<false, 1><<<grid, CS_THREADS, 0, s>>>(qq, rows, cout, strip, brow, o);
  else if (two_d && fault == 0) colsum_kernel<true, 0><<<grid, CS_THREADS, 0, s>>>(qq, rows, cout, strip, brow, o);
  else if (two_d && fault == 1) colsum_kernel<true, 1><<<grid, CS_THREADS, 0, s>>>(qq, rows, cout, strip, brow, o);
  else if (two_d && fault == 2) colsum_kernel<true, 2><<<grid, CS_THREADS, 0, s>>>(qq, rows, cout, strip, brow, o);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// supir_unpack_nibbles (T3a): q uint8 [r, c] -> out fp32 [2r, c].
extern "C" int supir_unpack_nibbles(const void* q, int r, int c, int fault, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = grid_for((size_t)r * c);
  const uint8_t* qq = static_cast<const uint8_t*>(q);
  float* o = static_cast<float*>(out);
  if (fault == 0) unpack_kernel<0><<<blocks, 256, 0, s>>>(qq, r, c, o);
  else if (fault == 1) unpack_kernel<1><<<blocks, 256, 0, s>>>(qq, r, c, o);
  else if (fault == 2) unpack_kernel<2><<<blocks, 256, 0, s>>>(qq, r, c, o);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

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

// supir_gemv_single_cast (T3b): x bf16 [B, >= cin] with row stride ldx, w
// paired uint8 [cin/2, cout] 8-byte aligned, scale fp32 [cout], out fp32
// [B, cout]; strip 32, 64, 128 or 256.
extern "C" int supir_gemv_single_cast(const void* x, int ldx, const void* w, const void* scale, void* out,
                                      int B, int cin, int cout, int strip, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || cin <= 0 || cout <= 0 || cout % 8 || cin % 2) return (int)cudaErrorInvalidValue;
  if (strip == 32) return (int)single_cast_rows<32>(x, ldx, w, scale, out, B, cin, cout, s);
  if (strip == 64) return (int)single_cast_rows<64>(x, ldx, w, scale, out, B, cin, cout, s);
  if (strip == 128) return (int)single_cast_rows<128>(x, ldx, w, scale, out, B, cin, cout, s);
  if (strip == 256) return (int)single_cast_rows<256>(x, ldx, w, scale, out, B, cin, cout, s);
  return (int)cudaErrorInvalidValue;
}
