// What a launcher asks of the runtime once per kernel and device, not once
// per launch: the permission to use the card's full shared memory in a block
// and the number of SMs.  A launcher keeps one `DeviceOnce` per kernel
// instance (a function-local static) and calls `prepare_kernel` before its
// launch; after the first call on a device this is one `cudaGetDevice`, a
// read of thread-local state, so a launch makes no call to the runtime but
// its own and can be captured into a CUDA graph.
#pragma once

#include <cuda_runtime.h>

namespace launch_once {

constexpr int MAX_DEVICES = 64;

struct DeviceOnce {
  bool done[MAX_DEVICES] = {};
  int sms[MAX_DEVICES] = {};
};

// Allows `kernel` any dynamic shared memory size up to the device's opt-in
// limit (what a launch then takes is its own argument) and, with `carveout`,
// prefers shared memory over L1.  Writes the device's SM count to `sms`
// where one is given.
template <typename Kernel>
inline cudaError_t prepare_kernel(Kernel kernel, DeviceOnce& once,
                                  bool carveout, int* sms = nullptr) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!once.done[dev]) {
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&once.sms[dev],
                               cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e != cudaSuccess) return e;
    if (carveout) {
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
      if (e != cudaSuccess) return e;
    }
    once.done[dev] = true;
  }
  if (sms != nullptr) *sms = once.sms[dev];
  return cudaSuccess;
}

}  // namespace launch_once
