// K9: two chained paired-int4 decode GEMVs in one cooperative launch, for
// Hopper (sm_90a).
//
// Replaces, in supir_tpu/ops/quantize.py, _qmm_pair_kernel (:398,
// pallas_call :502, int4_paired_fused_pair :461):
//   small = glue(x) @ deq(qp1) * sc1 + residual          (glue: none or SiLU-GLU)
//   big   = RMSNorm(small, gamma) @ deq(qp2) * sc2
// both fp32 out, for up to 32 activation rows. The captioner's decode runs
// two such pairs per layer: o_proj (+ residual) -> post-attention norm ->
// gate-up, and SiLU-GLU + down_proj (+ residual) -> the next layer's input
// norm -> its qkv.
//
// What changes on the GPU: the TPU grid runs its steps in order on one
// core, so its phase 2 reads the phase-1 scratch in VMEM. Here blocks run
// at once, and phase 2 needs all of `small` for its RMSNorm statistics
// before any of its dot. So the kernel is one cooperative launch
// (cudaLaunchKernelExC with cudaLaunchAttributeCooperative, the form that
// CUDA graphs can hold) of as many blocks as can be resident at
// once (the occupancy API's blocks per SM x SMs): the blocks loop over
// phase 1's strips of 32 columns (the body of quant_gemv.cuh, each writing
// its part of `small` to device memory, where it stays in L2), wait at
// cooperative_groups' grid barrier, then every block takes the row
// statistics of the whole of `small` and loops over phase 2's strips. A
// grid barrier over more blocks than are resident would never be passed;
// the launch refuses such a grid rather than spin, and the wrapper raises.
// There is no fallback to two launches.
//
// Precision: phase 2 follows the TPU kernel: the RMSNorm reads `small` in
// fp32 and rounds its output to bf16 before the dot. The plain version
// follows the JAX fallback, which rounds `small` to x's dtype (bf16 on the
// card) before the RMSNorm; the two agree in fp32 on the CPU and differ on
// the card by that rounding, well within the GEMV bound (rel-L2 1e-2).
//
// What bounds it: bytes, as the other decode GEMVs: the two weight
// matrices once each (25.0 us for o + gate-up, 22.3 us for down + qkv at
// 13B shapes, over 3.35 TB/s). The barrier costs a few microseconds, and
// the second GEMV's first loads cannot start under the first's tail.
// `small` makes one round trip through L2.

#include <cooperative_groups.h>

#include "quant_gemv.cuh"

namespace cg = cooperative_groups;
using namespace qgemv;

namespace {

constexpr int MAX_ROWS = 32;

struct PairArgs {
  const bf16* x; int ldx; int siluglu1;
  const uint8_t* w1; const float* s1; const float* residual;
  const float* gamma; const uint8_t* w2; const float* s2;
  float* small; float* big;
  int B, cin1, cout1, cout2; float eps; int norm_cols;
};

// bf16((small * rstd) * gamma), `small` written earlier in this launch: read
// through L2 (__ldcg), never through the non-coherent read-only path
struct ActNormSmall {
  const float* small; int ld; const float* gamma; const float* rstd;
  __device__ float operator()(int b, int k) const {
    return round_bf16((__ldcg(small + (size_t)b * ld + k) * rstd[b]) * gamma[k]);
  }
};

template <int BT>
__global__ void __launch_bounds__(THREADS) pair_kernel(PairArgs a) {
  __shared__ __align__(16) float xs[Chunk<PAIRED, BT>::FLOATS];
  __shared__ float red[WARPS * BT * STRIP];
  __shared__ float rstd[MAX_ROWS];
  cg::grid_group grid = cg::this_grid();

  const int tiles = (a.B + BT - 1) / BT;
  const int n1 = (a.cout1 + STRIP - 1) / STRIP;
  const int n2 = (a.cout2 + STRIP - 1) / STRIP;

  // phase 1: small = glue(x) @ W1 * s1 + residual, strip by strip
  for (int item = blockIdx.x; item < n1 * tiles; item += gridDim.x) {
    const int strip = item % n1, b0 = (item / n1) * BT, nb = min(BT, a.B - b0);
    const bf16* xt = a.x + (size_t)b0 * a.ldx;
    float acc[BT][8];
    if (a.siluglu1)
      strip_dot<PAIRED, BT>(ActSiluGlu{xt, a.ldx, a.cin1}, nb, a.w1, a.cin1, a.cout1, strip, xs, acc);
    else
      strip_dot<PAIRED, BT>(ActPlain{xt, a.ldx}, nb, a.w1, a.cin1, a.cout1, strip, xs, acc);
    strip_store<BT, true>(acc, red, nb, b0, strip, a.s1, a.residual, a.small, a.cout1);
  }

  grid.sync();  // all of small is written, and visible to every block

  // every block: rstd of each row from the mean square of its first
  // norm_cols columns (all cout1 of them; fewer only as a planted fault)
  for (int t0 = 0; t0 < a.B; t0 += BT) {
    float ss[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) ss[b] = 0.f;
    for (int k = threadIdx.x; k < a.norm_cols; k += THREADS)
#pragma unroll
      for (int b = 0; b < BT; ++b)
        if (t0 + b < a.B) {
          const float v = __ldcg(a.small + (size_t)(t0 + b) * a.cout1 + k);
          ss[b] = fmaf(v, v, ss[b]);
        }
    block_sum<BT>(ss, red, rstd + t0);
    if (threadIdx.x < BT) rstd[t0 + threadIdx.x] = rsqrtf(rstd[t0 + threadIdx.x] / (float)a.norm_cols + a.eps);
    __syncthreads();  // red is free again; rstd is published
  }

  // phase 2: big = bf16(RMSNorm(small) * gamma) @ W2 * s2, strip by strip
  for (int item = blockIdx.x; item < n2 * tiles; item += gridDim.x) {
    const int strip = item % n2, b0 = (item / n2) * BT, nb = min(BT, a.B - b0);
    float acc[BT][8];
    strip_dot<PAIRED, BT>(ActNormSmall{a.small + (size_t)b0 * a.cout1, a.cout1, a.gamma, rstd + b0}, nb, a.w2,
                          a.cout1, a.cout2, strip, xs, acc);
    strip_store<BT, false>(acc, red, nb, b0, strip, a.s2, nullptr, a.big, a.cout2);
  }
}

constexpr int MAX_DEVICES = 64;

// the resident blocks of pair_kernel<BT> on the current device, queried once
// per device (a launch inside CUDA-graph capture then makes no query)
template <int BT>
cudaError_t grid_blocks(int* blocks) {
  static int known[MAX_DEVICES] = {};
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && known[dev] > 0) {
    *blocks = known[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pair_kernel<BT>, THREADS, 0);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorCooperativeLaunchTooLarge;
  *blocks = per_sm * sms;
  if (err == cudaSuccess && dev < MAX_DEVICES) known[dev] = *blocks;
  return err;
}

template <int BT>
cudaError_t launch(PairArgs a, cudaStream_t stream) {
  int resident = 0;
  cudaError_t err = grid_blocks<BT>(&resident);
  if (err != cudaSuccess) return err;
  const int tiles = (a.B + BT - 1) / BT;
  const int items = max((a.cout1 + STRIP - 1) / STRIP, (a.cout2 + STRIP - 1) / STRIP) * tiles;
  // a cooperative launch through the launch-attribute API, which stream
  // capture records as a cooperative graph node
  cudaLaunchAttribute coop[1];
  coop[0].id = cudaLaunchAttributeCooperative;
  coop[0].val.cooperative = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(min(resident, items));
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  config.attrs = coop;
  config.numAttrs = 1;
  void* args[] = {&a};
  err = cudaLaunchKernelExC(&config, reinterpret_cast<const void*>(pair_kernel<BT>), args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes; each returns a cudaError_t (0 on
// success).
//
// supir_qpair: x bf16 [B, >= cin1] (>= 2 cin1 with siluglu1) of row stride
// ldx; w1 paired uint8 [cin1/2, cout1], s1 fp32 [cout1], residual fp32
// [B, cout1]; gamma fp32 [cout1], w2 paired uint8 [cout1/2, cout2], s2 fp32
// [cout2]; small fp32 [B, cout1] and big fp32 [B, cout2] out. B <= 32;
// 0 < norm_cols <= cout1 (cout1 but for planted-fault checks).
extern "C" int supir_qpair(const void* x, int ldx, int siluglu1, const void* w1, const void* s1,
                           const void* residual, const void* gamma, const void* w2, const void* s2,
                           void* small, void* big, int B, int cin1, int cout1, int cout2, float eps,
                           int norm_cols, void* stream) {
  const PairArgs a{static_cast<const bf16*>(x), ldx, siluglu1,
                   static_cast<const uint8_t*>(w1), static_cast<const float*>(s1),
                   static_cast<const float*>(residual), static_cast<const float*>(gamma),
                   static_cast<const uint8_t*>(w2), static_cast<const float*>(s2),
                   static_cast<float*>(small), static_cast<float*>(big), B, cin1, cout1, cout2, eps, norm_cols};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > MAX_ROWS || cin1 <= 0 || cin1 % 2 || cout1 <= 0 || cout1 % 8 || cout2 <= 0 || cout2 % 8)
    return (int)cudaErrorInvalidValue;
  if (norm_cols <= 0 || norm_cols > cout1 || residual == nullptr || gamma == nullptr)
    return (int)cudaErrorInvalidValue;
  if (B <= 1) return (int)launch<1>(a, s);
  if (B <= 2) return (int)launch<2>(a, s);
  if (B <= 4) return (int)launch<4>(a, s);
  return (int)launch<8>(a, s);
}

// supir_qpair_grid: the blocks K9 launches at most for B rows on the current
// device (resident blocks per SM x SMs), or an error if the device cannot
// launch cooperatively.
extern "C" int supir_qpair_grid(int B, int* blocks) {
  if (B <= 1) return (int)grid_blocks<1>(blocks);
  if (B <= 2) return (int)grid_blocks<2>(blocks);
  if (B <= 4) return (int)grid_blocks<4>(blocks);
  return (int)grid_blocks<8>(blocks);
}
