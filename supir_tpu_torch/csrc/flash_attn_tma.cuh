// The Hopper machinery the flash-attention sources build on: mbarriers,
// TMA tile copies, wgmma shared-memory descriptors and products, and the
// host-side encode of the tensor maps that ops/flash_attention.py:tma_plan
// lays out. flash_attn_fwd.cu (K1, K3), flash_attn_fwd_fp32.cu (K1 fp32)
// and flash_attn_bwd.cu (K4) each include it into their own translation
// unit; quantize_int8.cu (K8) takes its mbarrier and tensor-map helpers.
//
// Shared-memory tiles: a tile of R rows and D head-dim columns (bf16) is
// D / 64 slabs of R rows x 128 bytes, written by TMA in the 128-byte swizzle
// that wgmma reads (16-byte chunk c of row r at ((c ^ (r & 7)) * 16)). A
// tile's base is 1024-byte aligned, the swizzle's period. An fp32 tile
// (flash_attn_fwd_fp32.cu) is the same with 32 columns a slab.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int SLAB = 64;                 // head-dim columns per 128-byte swizzle slab
constexpr int PLAN_LEN = 15;             // see tma_plan: rank, dims[4], strides[3], box[4], positions[3]

// where the seq, head and batch coordinates go in a tensor map (1..3), -1
// for an axis dropped from it
struct MapPos {
  int rank, seq, head, batch;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ int map_coord(const MapPos& p, int i, int row, int h, int b) {
  return (p.seq == i ? row : 0) + (p.head == i ? h : 0) + (p.batch == i ? b : 0);
}

// one tile of ROWS rows (all its slabs, COLS columns each) from `map` at
// sequence row `row` of (batch b, head h) into shared memory at dst, in
// boxes of BOX rows (the map's box); completes on `bar`. Rows past the map's
// extent arrive as zeros.
template <int SLABS, int ROWS, int BOX, int COLS = SLAB>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, const MapPos& p, uint32_t bar,
                                         int row, int h, int b) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
#pragma unroll
  for (int r = 0; r < ROWS; r += BOX) {
    const int c1 = map_coord(p, 1, row + r, h, b), c2 = map_coord(p, 2, row + r, h, b);
    const int c3 = map_coord(p, 3, row + r, h, b);
#pragma unroll
    for (int s = 0; s < SLABS; ++s) {
      const uint32_t to = dst + s * ROWS * 128 + r * 128;
      const int c0 = s * COLS;
      if (p.rank == 2)
        asm volatile(
            "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
            ::"r"(to), "l"(m), "r"(bar), "r"(c0), "r"(c1) : "memory");
      else if (p.rank == 3)
        asm volatile(
            "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
            "[%2];\n" ::"r"(to), "l"(m), "r"(bar), "r"(c0), "r"(c1), "r"(c2) : "memory");
      else
        asm volatile(
            "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
            "[%2];\n" ::"r"(to), "l"(m), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
    }
  }
}

// a 1-D copy of `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from global to shared memory; completes on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1): start
// address, leading and stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand (rows of 128 bytes, the reduction dim contiguous): 8-row
// groups 1024 bytes apart; the leading offset is unused under the swizzle.
// A k16 step advances the address by 32 bytes inside a slab.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) { return smem_desc(addr, 16, 1024); }

// MN-major operand (the reduction dim along the rows, N = the head dim
// contiguous; read through the transpose bit): 8-row groups 1024 bytes apart
// along K, 64-column slabs `slab_bytes` apart along N. A k16 step advances
// the address by 16 rows (2048 bytes).
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr, uint32_t slab_bytes) {
  return smem_desc(addr, slab_bytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

// waits until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }

// keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (+)= A B^T over one k16 step, A and B K-major in shared memory
// (128-byte swizzle); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D += A B over one k16 step, A (four bf16x2 registers a thread, the
// accumulator layout of a k16 column block) from registers, B MN-major in
// shared memory (transpose-B bit, 128-byte swizzle); N = 64 or 128 by the
// accumulator's size.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Writes a warpgroup's 64-row accumulator (rows r0 times mul0, rows r0 + 8
// times mul1, as bf16) into its
// rows of a swizzled shared tile (`rows`: the tile's first slab at the
// warpgroup's first row, slabs `slab_bytes` apart), then, once the
// warpgroup's 128 threads have written (named barrier `bar`), stores the
// rows below `valid` to `out` (row r at out + r * row_stride) in 16-byte
// vectors. The accumulator's rows are 16 * warp + g and + 8 (g = lane / 4),
// its columns 8 j + 2 (lane % 4) and + 1.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], float mul0, float mul1, unsigned char* rows,
                                           int slab_bytes, int bar, bf16* out, long long row_stride, int valid) {
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int r0 = 16 * warp + g;  // r0 and r0 + 8 share r0 % 8, the swizzle's row phase
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    unsigned char* chunk = rows + (j / 8) * slab_bytes + (((j % 8) ^ (r0 & 7)) * 16) + tq * 4;
    *reinterpret_cast<uint32_t*>(chunk + r0 * 128) = pack_bf16(acc[4 * j] * mul0, acc[4 * j + 1] * mul0);
    *reinterpret_cast<uint32_t*>(chunk + (r0 + 8) * 128) = pack_bf16(acc[4 * j + 2] * mul1, acc[4 * j + 3] * mul1);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");  // the warpgroup's rows are written
  for (int i = tid; i < 64 * (D / 8); i += 128) {
    const int r = i / (D / 8), c = i % (D / 8);
    if (r < valid)
      *reinterpret_cast<uint4*>(out + r * row_stride + c * 8) = *reinterpret_cast<const uint4*>(
          rows + (c / 8) * slab_bytes + r * 128 + (((c % 8) ^ (r & 7)) * 16));
  }
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded
cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (!cached) {
    void* entry = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &entry, 12000, cudaEnableDefault,
                                                       &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &entry, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || !entry) return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiled>(entry);
  }
  *fn = cached;
  return cudaSuccess;
}

// The backward sources (flash_attn_bwd.cu, flash_attn_bwd_fp32.cu) run
// their dQ kernel on a second stream beside the dK/dV kernel: both read only
// the inputs and the pre-pass's scratch, and each alone leaves part of its
// last wave of blocks idle. One side stream and two events per device,
// made at first use; the caller's stream forks after the pre-pass and joins
// after both kernels, which CUDA-graph capture records as the same fork
// and join.
struct Fork {
  cudaStream_t side;
  cudaEvent_t ready, done;
};

cudaError_t device_fork(Fork** out) {
  constexpr int MAX_DEVICES = 64;
  static Fork forks[MAX_DEVICES];
  static bool made[MAX_DEVICES];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  Fork& f = forks[dev];
  if (!made[dev]) {
    if ((err = cudaStreamCreateWithFlags(&f.side, cudaStreamNonBlocking)) != cudaSuccess) return err;
    if ((err = cudaEventCreateWithFlags(&f.ready, cudaEventDisableTiming)) != cudaSuccess) return err;
    if ((err = cudaEventCreateWithFlags(&f.done, cudaEventDisableTiming)) != cudaSuccess) return err;
    made[dev] = true;
  }
  *out = &f;
  return cudaSuccess;
}

// A plan of PLAN_LEN values (ops/flash_attention.py:tma_plan): rank, dims
// innermost-first (4), byte strides of dims 1.. (3), box (4), and the map
// positions of the seq, head and batch coordinates (3), of elements of
// `type`. Returns the CUresult of the encode.
CUresult encode(EncodeTiled fn, CUtensorMap* map, MapPos* pos, const void* ptr, const long long* plan,
                CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const int rank = static_cast<int>(plan[0]);
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    dims[i] = static_cast<cuuint64_t>(plan[1 + i]);
    box[i] = static_cast<cuuint32_t>(plan[8 + i]);
    if (i) strides[i - 1] = static_cast<cuuint64_t>(plan[4 + i]);
  }
  *pos = MapPos{rank, static_cast<int>(plan[12]), static_cast<int>(plan[13]), static_cast<int>(plan[14])};
  return fn(map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(ptr), dims,
            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace
