// Thread-block cluster machinery shared by the whole-volume (whole3d.cu)
// and whole-image (whole2d.cu) cluster kernels, sm_90a: the box walk that
// spreads a block's entries over its threads, and the launch of a grid of
// clusters with the card's own answer on whether it co-schedules them.
#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <set>
#include <tuple>

namespace passes {

constexpr int kMaxCluster = 16;  // 8 is portable; 9-16 need the non-portable opt-in

// Walks the entries (a, b, k) of an (unbounded, nb, nk) box, k fastest,
// one entry per thread and step of blockDim.x: the thread's start and the
// block's stride are split into (a, b, k) once, then each step adds them
// with carries — no division per entry.
struct Walk {
  int a, b, k, da, db, dk, nb, nk;
  __device__ Walk(int nb_, int nk_) : nb(nb_), nk(nk_) {
    split(threadIdx.x, &a, &b, &k);
    split(blockDim.x, &da, &db, &dk);
  }
  __device__ void split(int v, int* x, int* y, int* z) const {
    *z = v % nk;
    v /= nk;
    *y = v % nb;
    *x = v / nb;
  }
  __device__ void next() {
    k += dk;
    b += db;
    a += da;
    if (k >= nk) {
      k -= nk;
      ++b;
    }
    if (b >= nb) {
      b -= nb;
      ++a;
    }
  }
};

// A cluster launch's attributes are set when a launch or a query first
// needs them on a device (the dynamic shared memory of the largest share
// so far; the non-portable cluster sizes where c > 8), and each (c, bytes)
// is asked once of cudaOccupancyMaxActiveClusters: `clusters` is how many
// such clusters the card co-schedules, 0 where it cannot run one.
template <class K>
cudaError_t cluster_room(K kernel, int device, int nc, const cudaLaunchConfig_t& cfg,
                         int* clusters) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> allowed;
  static std::set<std::pair<const void*, int>> non_portable;
  static std::map<std::tuple<const void*, int, int, size_t>, int> rooms;
  const std::lock_guard<std::mutex> lock(mu);
  const void* k = reinterpret_cast<const void*>(kernel);
  const size_t bytes = cfg.dynamicSmemBytes;
  const auto room = rooms.find(std::make_tuple(k, device, nc, bytes));
  if (room != rooms.end()) {
    *clusters = room->second;
    return cudaSuccess;
  }
  cudaError_t e = cudaSuccess;
  const auto key = std::make_pair(k, device);
  const auto it = allowed.find(key);
  if (it == allowed.end() || it->second < bytes) {
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(bytes))) != cudaSuccess)
      return e;
    allowed[key] = bytes;
  }
  if (nc > 8 && !non_portable.count(key)) {
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
        cudaSuccess)
      return e;
    non_portable.insert(key);
  }
  if ((e = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg)) != cudaSuccess) return e;
  rooms[std::make_tuple(k, device, nc, bytes)] = *clusters;
  return cudaSuccess;
}

// The launch of `blocks` blocks of `threads` in clusters of nc, each
// block holding a share of `bytes` (attr is the configuration's one
// attribute).
inline void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, unsigned blocks,
                           int nc, int threads, size_t bytes, cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = nc;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = {};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(threads);
  cfg->dynamicSmemBytes = bytes;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// Launches `kernel` over `blocks` blocks in clusters of nc.  A
// configuration the card cannot co-schedule is refused with its error
// code, never run another way, and leaves no error behind for the next
// launch.
template <class K, class... Args>
cudaError_t launch_clusters(K kernel, int device, unsigned blocks, int nc, int threads,
                            size_t bytes, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cluster_config(&cfg, &attr, blocks, nc, threads, bytes, stream);
  int room = 0;
  cudaError_t e = cluster_room(kernel, device, nc, cfg, &room);
  if (e == cudaSuccess && room < 1) e = cudaErrorInvalidConfiguration;
  if (e == cudaSuccess) e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e == cudaSuccess) return cudaGetLastError();
  cudaGetLastError();
  return e;
}

// How many clusters of nc blocks of `threads`, each block holding a share
// of `bytes`, the card co-schedules for both of a direction pair's
// kernels (the smaller), into *clusters; 0 where it cannot run one.  A
// refusal leaves no error behind.
template <class KF, class KI>
cudaError_t cluster_room_pair(KF fwd, KI inv, int device, int nc, int threads, int bytes,
                              int* clusters) {
  *clusters = 0;
  if (nc < 1 || nc > kMaxCluster || bytes < 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cluster_config(&cfg, &attr, nc, nc, threads, bytes, nullptr);
  int f = 0, i = 0;
  if ((e = cluster_room(fwd, device, nc, cfg, &f)) == cudaSuccess)
    e = cluster_room(inv, device, nc, cfg, &i);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  *clusters = f < i ? f : i;
  return cudaSuccess;
}

}  // namespace passes
