// K1 fp32: the flash-attention forward for Hopper (sm_90a) in fp32, on the
// CUDA cores: fp32 q, k, v and output, fp32 running max, sum and
// accumulator, optionally causal.
//
// It replaces supir_tpu/ops/flash_attention.py:_attn_kernel_packed (:35) and
// _attn_kernel_packed_single (:123), launched from _flash_primal (:363), for
// fp32 inputs: the TPU kernels run in the inputs' dtype
// (out_shape=jax.ShapeDtypeStruct(qb.shape, q.dtype), :373), so an engine
// with fp32 parameters (--full_params, --diff_dtype fp32) attends in fp32
// there. flash_attn_fwd.cu is the bf16 instance (wgmma, TMA); this file is
// its fp32 twin. The TPU's 128-lane head packing and its single-block
// variant are TPU layout and have no counterpart here.
//
// What it computes: O = softmax(Q K^T / sqrt(D)) V over q [B,S,H,D] and
// k/v [B,T,H,D], D 64 or 128, each read in place through its own strides
// (views of one packed qkv, k/v expanded over heads with stride 0). Keys
// past T (the ragged last tile) are masked; rows past S are read as zeros
// and never stored. With `causal` (S == T) query i sees keys 0..i: key
// tiles wholly above the diagonal are never loaded, the diagonal tile is
// masked per element. Each row's running max m is kept in raw q.k units and
// P = exp2((s - m) * scale * log2 e), as the TPU kernel computes it (:84-86).
//
// Why the CUDA cores: wgmma takes no fp32 operand, and TF32 (10 mantissa
// bits) would lower what --full_params promises, so every product here is
// an fp32 FMA. What bounds it: operations, 4 B H S T D flops against the
// card's 67 TFLOP/s fp32 peak outside the tensor cores ([2,4096,10,64]:
// 85.9 GFLOP, 1.28 ms); the bytes (q, k, v, out once: 84 MB, 0.025 ms) are
// far below. The design feeds the FMA pipes from shared memory with 16-byte
// loads and keeps S, P's row statistics and O in registers:
// - Block: 64 query rows of one (batch, head), 256 threads as 16 x 16;
//   thread (ty, tx) owns rows 4 ty .. 4 ty + 3 and, of each 64-key tile,
//   score columns 4 tx .. 4 tx + 3, and of O the columns 64 g + 4 tx .. + 3
//   (g < D / 64): a 4 x 4 score micro-tile and a 4 x 4 (D 64) or 4 x 8
//   (D 128) accumulator.
// - Shared memory (fp32): Q and each K tile transposed, [D][68] (the 4
//   floats of padding keep 16-byte rows and spread the transposing stores
//   over the banks), so a step of S = Q K^T reads one float4 of 4 rows of Q
//   and one of 4 keys for 16 FMAs; V [64][D] as stored; P transposed
//   [64][68], so a step of O += P V reads one float4 of P and D / 64 of V
//   for 16 D / 64 FMAs. D = 64: 68.6 KB (three blocks an SM); D = 128:
//   119.8 KB (one).
// - Global loads: 16-byte vectors, two neighbouring lanes on one 32-byte
//   sector of a row, a warp on 16 rows; rows past S or T load zeros.
// - Softmax: a row's 64 scores lie on the 16 lanes of one half-warp, so its
//   max and sum take four xor-shuffles each. When the max rises the
//   accumulator and the sum are rescaled by exp2((m_old - m_new) c). A row
//   whose max is still -inf subtracts 0, so no NaN arises.
// - Epilogue: O / max(l, 1e-30) (the TPU kernel's norm, :114-116) in
//   16-byte stores, rows past S clipped.
// - Grid: B*H x ceil(S/64), query blocks in reverse order when causal (the
//   heaviest first).
// Later work, not here: a 3xTF32 tensor-core design (hi/lo split operands,
// three products, fp32-grade accuracy), cp.async double buffering, larger
// micro-tiles.
//
// FAULT instantiations exist for planted faults only (checks): 1 the
// accumulator is not rescaled when the max rises, 2 the ragged last key tile
// is not masked, 3 the causal diagonal tile is not masked.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;         // query rows per block
constexpr int BN = 64;         // keys per K/V tile
constexpr int THREADS = 256;   // 16 x 16
constexpr int LDT = BM + 4;    // row stride of the transposed tiles (Q, K, P), floats
static_assert(BM == BN, "the causal diagonal is one tile: tile qb of block qb");

template <int D>
struct Smem {
  static constexpr int QT = 0;               // Q^T [D][LDT]
  static constexpr int KT = QT + D * LDT;    // K^T [D][LDT]
  static constexpr int V = KT + D * LDT;     // V [BN][D]
  static constexpr int PT = V + BN * D;      // P^T [BN][LDT]
  static constexpr int BYTES = (PT + BN * LDT) * 4;
};

// rows first .. first + 63 of one (b, h) of a [*, n, *, D] operand (`base`
// at (b, 0, h), row stride `ss`) into t[d * LDT + row], zeros past n. Two
// neighbouring lanes read the two 16-byte halves of a 32-byte sector, so a
// warp reads 16 rows and its transposing stores hit 32 distinct banks.
template <int D>
__device__ __forceinline__ void load_transposed(const float* __restrict__ base, long long ss, int first, int n,
                                                float* __restrict__ t) {
  for (int e = threadIdx.x; e < BM * D / 4; e += THREADS) {
    const int row = (e >> 1) & (BM - 1), d4 = 2 * (e >> 7) + (e & 1);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (first + row < n) x = __ldg(reinterpret_cast<const float4*>(base + (first + row) * ss) + d4);
    float* col = t + 4 * d4 * LDT + row;
    col[0] = x.x;
    col[LDT] = x.y;
    col[2 * LDT] = x.z;
    col[3 * LDT] = x.w;
  }
}

// rows first .. first + 63 as stored, [BN][D], zeros past n
template <int D>
__device__ __forceinline__ void load_rows(const float* __restrict__ base, long long ss, int first, int n,
                                          float* __restrict__ t) {
  for (int e = threadIdx.x; e < BN * D / 4; e += THREADS) {
    const int row = e / (D / 4), d4 = e % (D / 4);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (first + row < n) x = __ldg(reinterpret_cast<const float4*>(base + (first + row) * ss) + d4);
    reinterpret_cast<float4*>(t + row * D)[d4] = x;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D, int FAULT>
__global__ void __launch_bounds__(THREADS)
flash_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                      float* __restrict__ o, int H, int S, int T, long long qsb, long long qss, long long qsh,
                      long long ksb, long long kss, long long ksh, long long vsb, long long vss, long long vsh,
                      long long osb, long long oss, long long osh, float scale_log2, int causal) {
  constexpr int G = D / 64;  // 4-column groups of O a thread owns
  using L = Smem<D>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qt = smem + L::QT;
  float* kt = smem + L::KT;
  float* vs = smem + L::V;
  float* pt = smem + L::PT;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int qb = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int first = qb * BM;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* kbase = k + b * ksb + h * ksh;
  const float* vbase = v + b * vsb + h * vsh;

  load_transposed<D>(q + b * qsb + h * qsh, qss, first, S, qt);

  float acc[4][4 * G];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = (T + BN - 1) / BN;
  const int tiles = causal ? min(n_tiles, qb + 1) : n_tiles;  // causal: tile qb holds the diagonal
  for (int j = 0; j < tiles; ++j) {
    const int kfirst = j * BN;
    __syncthreads();  // the previous tile's products are done with K, V and P
    load_transposed<D>(kbase, kss, kfirst, T, kt);
    load_rows<D>(vbase, vss, kfirst, T, vs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * LDT + 4 * ty);
      const float4 kk = *reinterpret_cast<const float4*>(kt + d * LDT + 4 * tx);
      const float ar[4] = {a.x, a.y, a.z, a.w}, kr[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(ar[i], kr[c], s[i][c]);
    }

    const bool ragged = FAULT != 2 && kfirst + BN > T;
    const bool diagonal = FAULT != 3 && causal && j == qb;
    if (ragged || diagonal) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = kfirst + 4 * tx + c, row = first + 4 * ty + i;
          if ((ragged && col >= T) || (diagonal && col > row)) s[i][c] = -INFINITY;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mx = half_warp_max(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
      const float m_new = fmaxf(m[i], mx);
      const float sub = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet: every p is 0
      const float corr = exp2f((m[i] - sub) * scale_log2);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = exp2f((s[i][c] - sub) * scale_log2);
        sum += s[i][c];
      }
      l[i] = l[i] * corr + half_warp_sum(sum);
      if (FAULT != 1) {
#pragma unroll
        for (int c = 0; c < 4 * G; ++c) acc[i][c] *= corr;
      }
      m[i] = m_new;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(pt + (4 * tx + c) * LDT + 4 * ty) = make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();

#pragma unroll 4
    for (int key = 0; key < BN; ++key) {
      const float4 p = *reinterpret_cast<const float4*>(pt + key * LDT + 4 * ty);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 vv = *reinterpret_cast<const float4*>(vs + key * D + 64 * g + 4 * tx);
        const float vr[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][4 * g + c] = fmaf(pr[i], vr[c], acc[i][4 * g + c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = first + 4 * ty + i;
    if (row >= S) continue;
    const float norm = fmaxf(l[i], 1e-30f);
    float* dst = o + b * osb + row * oss + h * osh;
#pragma unroll
    for (int g = 0; g < G; ++g)
      reinterpret_cast<float4*>(dst + 64 * g)[tx] =
          make_float4(acc[i][4 * g] / norm, acc[i][4 * g + 1] / norm, acc[i][4 * g + 2] / norm,
                      acc[i][4 * g + 3] / norm);
  }
}

template <int D, int FAULT>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, int B, int H, int S, int T,
                   const long long* st, float scale_log2, int causal, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(flash_fwd_fp32_kernel<D, FAULT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + BM - 1) / BM);
  flash_fwd_fp32_kernel<D, FAULT><<<grid, THREADS, Smem<D>::BYTES, stream>>>(
      q, k, v, o, H, S, T, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale_log2, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(const float* q, const float* k, const float* v, float* o, int B, int H, int S, int T,
                     const long long* st, float scale_log2, int causal, int fault, cudaStream_t s) {
  switch (fault) {
    case 0: return launch<D, 0>(q, k, v, o, B, H, S, T, st, scale_log2, causal, s);
    case 1: return launch<D, 1>(q, k, v, o, B, H, S, T, st, scale_log2, causal, s);
    case 2: return launch<D, 2>(q, k, v, o, B, H, S, T, st, scale_log2, causal, s);
    case 3: return launch<D, 3>(q, k, v, o, B, H, S, T, st, scale_log2, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes: fp32 q [B,S,H,D], k/v [B,T,H,D] and o
// [B,S,H,D], each 16-byte aligned with its head dim contiguous; strides:
// 12 values in elements, (batch, seq, head) of q, k, v and o, each a
// multiple of 4 (a stride may be 0). causal is 0 or 1 (then S == T). fault
// 0 is the kernel, 1-3 its planted faults. Returns 0 or a cudaError_t.
extern "C" int supir_flash_attn_fwd_fp32(const void* q, const void* k, const void* v, void* o, int B, int H, int S,
                                         int T, int D, int causal, const long long* strides, float scale, int fault,
                                         void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || T <= 0 || (S + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * 1.4426950408889634f;
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k), *vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return (int)dispatch<64>(qf, kf, vf, of, B, H, S, T, strides, scale_log2, causal, fault, s);
  if (D == 128) return (int)dispatch<128>(qf, kf, vf, of, B, H, S, T, strides, scale_log2, causal, fault, s);
  return (int)cudaErrorInvalidValue;
}
