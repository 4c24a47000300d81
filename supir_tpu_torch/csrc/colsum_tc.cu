// T1a/T1b, the column sum, on the tensor-core GEMV body's weight stream for
// Hopper (sm_90a): its tile plan, TMA ring and slice-order combine, with a
// byte sum in place of the decode and the products, so that the ring's own
// streaming rate is measured.
//
// Replaces tools/stream_ceiling.py:sum_kernel (:48, pallas_call :78; a 1-D
// grid of column blocks) and the closure sum2d_kernel (:99, pallas_call
// :110; a 2-D grid that also splits the rows): u8 q [rows, cout] -> fp32
// [1, cout], the exact column sums of the bytes read as unsigned. The
// first design (csrc/probes.cu:colsum_kernel, one block per strip x row
// block, fp32 atomics) stays as the comparator.
//
// What bounds it: bytes. Each byte is read once and added once (about 1.5
// integer operations a byte), far under the card's integer rate, so its
// least time is the bytes over 3.35 TB/s (11.7 us for 39.3 MB).
//
// What the design does about it: it streams q exactly as
// csrc/quant_gemv_tc.cu streams K6's paired weight at one activation row.
// - Plan (ops/gemv_plan.py:tc_plan("paired", 1, 2 rows, cout, sms,
//   slices)): 128-column strips, 64-row chunks, each strip's chunks cut
//   into k-slices; tile t = (strip t % strips, slice t / strips) goes to
//   block t mod G in slice-major order, one block per SM.
// - Ring: one producer thread issues 128-byte x 64-row TMA boxes (the
//   128-byte swizzle) into 16 stages of 8 KB with full and empty mbarriers,
//   in the order of qgemv_tc_kernel's producer. There is no x' to stage,
//   so it does not wait on a `go` barrier: the whole ring is requested at
//   block entry.
// - Consumers: 8 warps. Warp w takes rows w, w + 8, ..., w + 56 of each
//   stage; lane l holds columns 4l .. 4l + 3 of the strip, the 4-byte word
//   of logical 16-byte chunk l / 4. Under the swizzle, chunk c of row r
//   sits at chunk c ^ (r & 7), and r & 7 == w for every row of warp w: the
//   lane's word is at r * 128 + ((l / 4) ^ w) * 16 + (l % 4) * 4, one
//   offset for all its rows. A warp's load covers one whole 128-byte row,
//   32 distinct words in 32 banks: no bank is met twice. Each word is added
//   two bytes to a 32-bit register (bytes 0 and 2, 1 and 3 in 16-bit
//   lanes), which are flushed into int32 sums every RING_FLUSH_CHUNKS
//   chunks (16 x 8 rows x 255 < 2^16) and at the tile's end.
// - Tile end: the 8 warps' sums meet in shared memory and are added in
//   warp order (integers: exact in any order).
// - Combine: as the body. A strip of one slice is stored by its tile's
//   block. Otherwise each tile leaves an int32 partial in the device's
//   partial-sum scratch, a signal warp counts each finished tile but a last
//   slice's in on the strip's counter (one gpu-scope fence for the tiles
//   finished since its last count), and the block that took the strip's
//   last slice waits for the count and sums the partials in slice order.
//   No atomic adds a value to the output, and two runs give the same bits.
//   Each output is converted to fp32 once (every sum is below 2^24, so
//   exactly) and stored once.
//
// Block: 8 consumer warps, one producer warp and one signal warp, 320
// threads, 128 KB of ring, one block per SM.
//
// FAULT instances exist for planted faults only: 1 the bytes read as int8,
// 2 the combine leaves slice 0's partial out, 3 the combine runs twice.

#include <string.h>

#include "flash_attn_tma.cuh"

namespace {

constexpr int RING_STRIP = 128;                                // columns per strip: one box row
constexpr int RING_BOX_ROWS = 64;                              // rows per chunk: one box, one stage
constexpr int RING_STAGE_BYTES = RING_STRIP * RING_BOX_ROWS;   // 8 KB
constexpr int RING_STAGES = 16;                                // 128 KB of ring, as the body's paired layout
constexpr int RING_CONSUMERS = 8;
constexpr int RING_THREADS = 32 * (RING_CONSUMERS + 2);
constexpr int RING_FLUSH_CHUNKS = 16;                          // ops/probes.py:RING_FLUSH_CHUNKS
constexpr int CONSUMER_BAR = 1;
constexpr int FAULT_SIGNED = 1, FAULT_DROP_SLICE = 2, FAULT_COMBINE_TWICE = 3;
// ring | the warps' sums, int [8][128] | finished tiles (16 bytes) | full[16], empty[16] | alignment slack
constexpr int RING_SMEM = RING_STAGES * RING_STAGE_BYTES + RING_CONSUMERS * RING_STRIP * 4 + 16 +
                          16 * RING_STAGES + 1024;

// the synchronisation of csrc/quant_gemv_tc.cu, whose model instances keep
// their own copies
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(CONSUMER_BAR), "n"(32 * RING_CONSUMERS) : "memory");
}

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

__device__ __forceinline__ void add_bytes(uint32_t w, uint32_t& lo, uint32_t& hi) {
  lo += w & 0x00FF00FFu;          // bytes 0 and 2
  hi += (w >> 8) & 0x00FF00FFu;   // bytes 1 and 3
}

template <int FAULT>
__global__ void __launch_bounds__(RING_THREADS, 1)
colsum_ring_kernel(const __grid_constant__ CUtensorMap qmap, int strips, int chunks, int slices,
                   int* __restrict__ part, int* __restrict__ counters, float* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;       // the 128-byte swizzle repeats every 1024 bytes
  unsigned char* smem = smem_raw + (base - raw);
  int* red = reinterpret_cast<int*>(smem + RING_STAGES * RING_STAGE_BYTES);
  int* tiles_done = red + RING_CONSUMERS * RING_STRIP;
  const uint32_t full = smem_u32(tiles_done + 4);     // full[STAGES], then empty[STAGES]
  const uint32_t empty = full + 8 * RING_STAGES;
  const int tiles = strips * slices;
  const int blk = blockIdx.x, G = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    *tiles_done = 0;
    for (int s = 0; s < RING_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, RING_CONSUMERS);       // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == RING_CONSUMERS) {
    // producer: one thread keeps the ring full over the block's tiles b,
    // b + G, ... (strip t % strips, slice t / strips)
    if (lane == 0) {
      int n = 0;
      for (int t = blk; t < tiles; t += G) {
        const int s = t % strips, sl = t / strips;
        for (int j = sl * chunks / slices; j < (sl + 1) * chunks / slices; ++j, ++n) {
          const int st = n % RING_STAGES;
          mbar_wait(empty + 8 * st, ((n / RING_STAGES) & 1) ^ 1);   // a fresh barrier passes parity 1
          mbar_expect_tx(full + 8 * st, RING_STAGE_BYTES);
          tma_load_2d(base + st * RING_STAGE_BYTES, &qmap, full + 8 * st, s * RING_STRIP, j * RING_BOX_ROWS);
        }
      }
    }
    return;
  }
  if (warp == RING_CONSUMERS + 1) {
    // signal warp: counts each finished tile but a last slice's in on its
    // strip's counter, a few at a time behind one gpu-scope fence
    if (lane == 0 && slices > 1) {
      const int mine = (tiles - 1 - blk) / G + 1;
      for (int sent = 0; sent < mine;) {
        int done;
        while ((done = load_acquire_cta(tiles_done)) == sent) {
        }
        fence_gpu();
        for (; sent < done; ++sent) {
          const int t = blk + sent * G;
          if (t / strips < slices - 1) count_in(counters + t % strips);
        }
      }
    }
    return;
  }

  const int tid = threadIdx.x;
  // this lane's word of row `warp` of a stage; row warp + 8i is i KB further
  const int lane_off = warp * RING_STRIP + (((lane >> 2) ^ warp) << 4) + 4 * (lane & 3);
  int n = 0, ti = 0;
  for (int t = blk; t < tiles; t += G) {
    const int s = t % strips, sl = t / strips;
    const int j0 = sl * chunks / slices, j1 = (sl + 1) * chunks / slices;
    int acc[4] = {0, 0, 0, 0};                        // columns 4l .. 4l + 3
    uint32_t lo = 0u, hi = 0u;
    for (int j = j0; j < j1; ++j, ++n) {
      const int st = n % RING_STAGES;
      mbar_wait(full + 8 * st, (n / RING_STAGES) & 1);
      const uint32_t* w = reinterpret_cast<const uint32_t*>(smem + st * RING_STAGE_BYTES + lane_off);
      uint32_t v[RING_BOX_ROWS / RING_CONSUMERS];
#pragma unroll
      for (int i = 0; i < RING_BOX_ROWS / RING_CONSUMERS; ++i) v[i] = w[i * 256];   // 8 rows = 1024 bytes
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);
#pragma unroll
      for (int i = 0; i < RING_BOX_ROWS / RING_CONSUMERS; ++i) {
        if (FAULT == FAULT_SIGNED) {
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[b] += (int)(int8_t)(v[i] >> (8 * b));
        } else {
          add_bytes(v[i], lo, hi);
        }
      }
      if ((j - j0) % RING_FLUSH_CHUNKS == RING_FLUSH_CHUNKS - 1 || j == j1 - 1) {
        acc[0] += (int)(lo & 0xFFFFu);
        acc[1] += (int)(hi & 0xFFFFu);
        acc[2] += (int)(lo >> 16);
        acc[3] += (int)(hi >> 16);
        lo = hi = 0u;
      }
    }

    // the tile's end: the warps' sums meet in shared memory, added in warp
    // order; a one-slice strip is stored, else the slice's partial left
    reinterpret_cast<int4*>(red)[warp * 32 + lane] = make_int4(acc[0], acc[1], acc[2], acc[3]);
    consumer_sync();
    if (tid < RING_STRIP) {
      int v = 0;
#pragma unroll
      for (int w = 0; w < RING_CONSUMERS; ++w) v += red[w * RING_STRIP + tid];
      if (slices > 1) part[(size_t)t * RING_STRIP + tid] = v;
      else out[s * RING_STRIP + tid] = (float)v;
    }
    consumer_sync();                                  // red is free; the partial is written
    ++ti;
    if (tid == 0) store_release_cta(tiles_done, ti);  // the signal warp counts the tile in
  }
  if (slices == 1) return;

  // The strips whose last slice this block took (its final round's tiles):
  // wait until their other slices are counted in, then sum the partials in
  // slice order. Every tile is counted in as it ends, and the waits come
  // only after this block's own tiles.
  for (int t = blk; t < tiles; t += G) {
    if (t / strips != slices - 1) continue;
    const int s = t % strips;
    if (tid == 0)
      while (load_acquire(counters + s) < slices - 1) {
      }
    consumer_sync();
    if (tid < RING_STRIP) {
      int v = 0;
      for (int q = FAULT == FAULT_DROP_SLICE ? 1 : 0; q < slices; ++q)
        v += __ldcg(part + (size_t)(q * strips + s) * RING_STRIP + tid);
      if (FAULT == FAULT_COMBINE_TWICE) v += v;
      out[s * RING_STRIP + tid] = (float)v;
    }
    if (tid == 0) counters[s] = 0;                   // ready for the next launch
  }
}

template <int FAULT>
cudaError_t launch(const CUtensorMap& map, int strips, int chunks, int slices, int grid, int* part, int* counters,
                   float* out, cudaStream_t stream) {
  static bool attr = false;                          // the shared memory this instance may take
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(colsum_ring_kernel<FAULT>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, RING_SMEM);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  colsum_ring_kernel<FAULT><<<grid, RING_THREADS, RING_SMEM, stream>>>(map, strips, chunks, slices, part, counters,
                                                                        out);
  return cudaGetLastError();
}

}  // namespace

// supir_colsum_ring (T1a, T1b): q uint8 [rows, cout], 16-byte aligned, rows
// a multiple of 64, cout of 128, rows * 255 < 2^24; slices: k-slices per
// strip, 1 .. rows / 64; grid: blocks, 1 .. strips * slices (one per SM:
// ops/gemv_plan.py:tc_plan); part: int32 scratch of strips * slices * 128
// when slices > 1; counters int32 [cout / 128], zero, and zero again when
// the launch ends; out fp32 [cout]. fault: 0 none, 1 bytes read as int8, 2
// slice 0's partial left out of the combine, 3 the combine run twice.
// Returns 0, a cudaError_t, or minus the CUresult of a failed map encode.
extern "C" int supir_colsum_ring(const void* q, int rows, int cout, int slices, int grid, int fault, void* part,
                                 void* counters, void* out, void* stream) {
  if (rows <= 0 || rows % RING_BOX_ROWS || cout <= 0 || cout % RING_STRIP || rows > ((1 << 24) - 1) / 255 ||
      reinterpret_cast<uintptr_t>(q) % 16 || fault < 0 || fault > FAULT_COMBINE_TWICE)
    return (int)cudaErrorInvalidValue;
  const int strips = cout / RING_STRIP, chunks = rows / RING_BOX_ROWS;
  if (slices < 1 || slices > chunks || grid < 1 || grid > strips * slices) return (int)cudaErrorInvalidValue;
  EncodeTiled fn;
  const cudaError_t found = encode_tiled(&fn);
  if (found != cudaSuccess) return static_cast<int>(found);
  alignas(64) CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cout), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cout)};
  const cuuint32_t box[2] = {RING_STRIP, RING_BOX_ROWS};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(q), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* pt = static_cast<int*>(part);
  int* ct = static_cast<int*>(counters);
  float* o = static_cast<float*>(out);
  if (fault == 0) return (int)launch<0>(map, strips, chunks, slices, grid, pt, ct, o, s);
  if (fault == FAULT_SIGNED) return (int)launch<FAULT_SIGNED>(map, strips, chunks, slices, grid, pt, ct, o, s);
  if (fault == FAULT_DROP_SLICE) return (int)launch<FAULT_DROP_SLICE>(map, strips, chunks, slices, grid, pt, ct, o, s);
  return (int)launch<FAULT_COMBINE_TWICE>(map, strips, chunks, slices, grid, pt, ct, o, s);
}
