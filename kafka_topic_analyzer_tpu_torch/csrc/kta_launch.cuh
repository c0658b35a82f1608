// The shared prelude of the port's CUDA entries: the checks every entry
// makes before its launch and the error text _build.Kernel reads after a
// failed one.  An entry returns 0, kWrongDevice or a cudaError_t code.
// _build.library_path hashes this file with each source.

#pragma once

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDevices = 64;
// The tensors' device is not the current one (_build.WRONG_DEVICE).
constexpr int kWrongDevice = -1;

// Reads the current device into `dev`; returns 0 when it is the tensors'
// `device` and below kMaxDevices, else the code the entry returns.
inline int check_device(int64_t device, int* dev) {
  const cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  if (*dev != device) return kWrongDevice;
  if (*dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  return 0;
}

// Reads device `dev`'s streaming-multiprocessor count into `sms`, queried
// once per device; returns 0 or a CUDA error code.
inline int sm_count(int dev, int* sms) {
  static std::atomic<int> cached[kMaxDevices];  // 0 = not yet
  int n = cached[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    const cudaError_t err =
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    cached[dev].store(n, std::memory_order_relaxed);
  }
  *sms = n;
  return 0;
}

}  // namespace

extern "C" const char* kta_cuda_error_string(int code) {
  if (code == kWrongDevice) return "the tensors are not on the current device";
  return cudaGetErrorString((cudaError_t)code);
}
