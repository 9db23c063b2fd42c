// The opt-in to more than 48 KB of dynamic shared memory, set once per
// device and kernel rather than on every launch.  The attribute holds for
// the device's context, so a launcher keeps one SmemOptIn per kernel (a
// function-local static) and asks it for the bytes of each launch: the
// attribute is raised only when a launch needs more than any before it on
// that device, and the host pays one atomic load otherwise.
#pragma once

#include <atomic>
#include <mutex>

#include <cuda_runtime.h>

namespace repro {

struct SmemOptIn {
  static constexpr int kMaxDevices = 64;
  std::atomic<int> granted[kMaxDevices] = {};
  std::mutex raise;

  template <typename Kernel>
  cudaError_t need(Kernel* kernel, int bytes) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (bytes <= granted[dev].load(std::memory_order_acquire)) return cudaSuccess;
    std::lock_guard<std::mutex> lock(raise);
    if (bytes <= granted[dev].load(std::memory_order_relaxed)) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) granted[dev].store(bytes, std::memory_order_release);
    return err;
  }
};

}  // namespace repro
