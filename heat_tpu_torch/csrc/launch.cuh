// Shared by every C entry point of the library: the device guard.
//
// An entry point is given the index of the device its tensors lie on and
// the raw handle of PyTorch's current stream of that device. The guard
// makes that device current for the launch and restores the caller's
// afterwards, touching the runtime's device only where the two differ:
// cudaGetDevice reads a thread-local value, so a launch on the current
// device (the usual case) pays next to nothing for it.
// Neither call is a stream operation: both are legal while the stream is
// being captured into a CUDA graph.

#pragma once

#include <cuda_runtime.h>

namespace heat {

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    error_ = cudaGetDevice(&previous_);
    if (error_ == cudaSuccess && previous_ != device) {
      error_ = cudaSetDevice(device);
      switched_ = error_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched_) cudaSetDevice(previous_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;

  // cudaSuccess (0), or why the device could not be made current.
  int error() const { return static_cast<int>(error_); }

 private:
  int previous_ = -1;
  bool switched_ = false;
  cudaError_t error_ = cudaSuccess;
};

}  // namespace heat
