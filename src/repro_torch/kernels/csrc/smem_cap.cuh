// A kernel's dynamic shared-memory cap, raised once per device.
//
// cudaFuncAttributeMaxDynamicSharedMemorySize is a property of the kernel
// (one value per device, shared by every thread of the process), and it is
// only a cap: a launch may ask for any size up to it.  Setting it to the
// launch's own size before each launch races when two host threads launch
// the same instance at different sizes (one thread lowers the cap between
// the other's set and its launch).  So it is set once per device to the
// largest size the device allows a block, and never lowered; a cluster
// kernel also gets non-portable cluster sizes allowed.  Two threads that
// both see a device unset both write the same values, which is harmless.

#pragma once

#include <atomic>
#include <cuda_runtime.h>

namespace smemcap {

constexpr int kDevices = 16;

// `done` is one static of the caller's per kernel instance.
template <typename Kern>
cudaError_t raise(Kern kern, bool cluster,
                  std::atomic<bool> (&done)[kDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && done[dev].load(std::memory_order_acquire)) {
    return cudaSuccess;
  }
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attrs = {};
  err = cudaFuncGetAttributes(&attrs, kern);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      optin - static_cast<int>(attrs.sharedSizeBytes));
  if (err == cudaSuccess && cluster) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err == cudaSuccess && dev < kDevices) {
    done[dev].store(true, std::memory_order_release);
  }
  return err;
}

}  // namespace smemcap
