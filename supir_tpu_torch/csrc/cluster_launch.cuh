// Launching a kernel in thread-block clusters of `ranks` CTAs along x, for
// the cluster reductions (group_norm.cu, K2; quantize_int8.cu, K8): the
// kernel's attributes set once per device (the largest dynamic shared
// memory a CTA may use on the H100, and cluster sizes past the portable 8),
// and cudaOccupancyMaxActiveClusters asked once per device, kernel, cluster
// size, block and shared memory, so that a geometry the card cannot place
// is refused instead of launched.

#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int CLUSTER_SMEM_MAX = 232448;  // shared memory one CTA may use on the H100 (227 KB)

struct PlacedClusters {
  const void* kernel;
  int device, ranks, threads, smem, clusters;
};
PlacedClusters g_placed[64];
int g_nplaced = 0;
std::mutex g_placed_lock;

inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int ranks, int grid_y, int threads, int smem,
                                         cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ranks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ranks, grid_y, 1);
  config.blockDim = dim3(threads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

// How many clusters of this geometry the current device holds at once,
// into *clusters (0: it cannot be placed).
template <typename... Args>
cudaError_t placed_clusters(void (*kernel)(Args...), int ranks, int threads, int smem, int* clusters) {
  const void* key = reinterpret_cast<const void*>(kernel);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(g_placed_lock);
  for (int i = 0; i < g_nplaced; ++i) {
    const PlacedClusters& p = g_placed[i];
    if (p.kernel == key && p.device == device && p.ranks == ranks && p.threads == threads && p.smem == smem) {
      *clusters = p.clusters;
      return cudaSuccess;
    }
  }
  // the attributes apply to the current device only, with the same values
  // for every geometry, so a geometry cached on this device stays launchable
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CLUSTER_SMEM_MAX);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = cluster_config(&attr, ranks, 1, threads, smem, nullptr);
  err = cudaOccupancyMaxActiveClusters(clusters, kernel, &config);
  if (err == cudaSuccess && g_nplaced < 64)
    g_placed[g_nplaced++] = PlacedClusters{key, device, ranks, threads, smem, *clusters};
  return err;
}

// Launches grid (ranks, grid_y) in clusters of `ranks`; with clusters_out
// it only reports placed_clusters there. Returns 0, a cudaError_t, or -1
// when the cluster cannot be placed. `grid_y` 0 takes as many clusters as
// the card places at once (a persistent grid), at most max_y.
template <typename... Args, typename... Actual>
int cluster_launch(void (*kernel)(Args...), int ranks, int grid_y, int max_y, int threads, int smem,
                   cudaStream_t stream, int* clusters_out, Actual&&... args) {
  if (smem > CLUSTER_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int clusters = 0;
  cudaError_t err = placed_clusters(kernel, ranks, threads, smem, &clusters);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters_out) {
    *clusters_out = clusters;
    return 0;
  }
  if (clusters < 1) return -1;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config =
      cluster_config(&attr, ranks, grid_y > 0 ? grid_y : (clusters < max_y ? clusters : max_y), threads, smem, stream);
  err = cudaLaunchKernelEx(&config, kernel, static_cast<Actual&&>(args)...);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace
