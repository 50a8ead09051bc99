// The host half of a launch that names its device: the caller's current
// device is set to it for the launch and restored after it, with
// cudaSetDevice only where the two differ (cheaper than a device context
// around the call on the Python side).

#pragma once

#include <cuda_runtime.h>

namespace {

struct DeviceGuard {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  }
  ~DeviceGuard() {
    int now = -1;
    if (prev >= 0 && cudaGetDevice(&now) == cudaSuccess && now != prev)
      cudaSetDevice(prev);
  }
};

}  // namespace
