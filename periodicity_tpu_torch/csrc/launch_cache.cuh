// How many blocks of a kernel fit on the card at once, queried once per
// (kernel, device, dynamic shared memory) and cached for the life of the
// process. The runtime's occupancy query, the SM count and the opt-in
// shared-memory attribute cost host time on every launch that asks for
// them, and none of their answers changes between launches.
#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

namespace launch_cache {

// Sets *blocks to the resident blocks of `fn` on the current device (its
// SM count times the blocks per SM at `threads` threads and `smem` bytes of
// dynamic shared memory, at least one per SM). A query not seen before
// first raises the kernel's dynamic shared-memory limit to `max_smem` when
// that is above the default 48 KB.
inline cudaError_t resident_blocks(const void* fn, int threads, size_t smem, size_t max_smem,
                                   int* blocks) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, size_t>, int> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(fn, dev, smem);
  auto it = cache.find(key);
  if (it == cache.end()) {
    if (max_smem > 48 * 1024) {
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(max_smem));
      if (err != cudaSuccess) return err;
    }
    int sms = 0;
    int per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
    if (err != cudaSuccess) return err;
    it = cache.emplace(key, (per_sm > 0 ? per_sm : 1) * sms).first;
  }
  *blocks = it->second;
  return cudaSuccess;
}

}  // namespace launch_cache
