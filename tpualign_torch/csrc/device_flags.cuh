// One-time launch setup kept per device.
//
// cudaFuncSetAttribute (a kernel's dynamic shared-memory limit) applies to
// the current device only. A launcher that set it once per process would
// launch on a second card without it, and a launch there that needs more
// than 48 KB of dynamic shared memory would fail. So each launcher keeps a
// flag per device, indexed by the device its entry point has just made
// current with cudaSetDevice.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include <memory>

namespace devflags {
// Internal linkage: every kernel library compiles its own copy, and no
// static of a launch template is shared with another library loaded in the
// same process (GCC would make it a GNU-unique symbol).
namespace {

// One T per device, sized by cudaGetDeviceCount when it is first built.
template <typename T>
class PerDevice {
 public:
  explicit PerDevice(T init) {
    int n = 0;
    if (cudaGetDeviceCount(&n) != cudaSuccess || n < 0) n = 0;
    count_ = n;
    slots_.reset(new T[(size_t)(n > 0 ? n : 1)]);
    for (int i = 0; i < n; ++i) slots_[i] = init;
  }
  // The current device's slot; nullptr when the device cannot be read.
  T* current() {
    int dev = -1;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= count_) return nullptr;
    return &slots_[dev];
  }

 private:
  int count_ = 0;
  std::unique_ptr<T[]> slots_;
};

// Sets `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device, once per device (`done` is the launcher's static flag set).
template <typename Kernel>
cudaError_t smem_limit_once(PerDevice<bool>& done, Kernel* kernel, size_t bytes) {
  bool* flag = done.current();
  if (flag == nullptr) return cudaErrorInvalidDevice;
  if (*flag) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *flag = true;
  return err;
}

}  // namespace
}  // namespace devflags
