// The device a launch runs on, shared by every library's C entry point.
//
// The CUDA runtime launches a kernel, raises a kernel's shared-memory limit
// and reads an occupancy on the calling thread's current device, and that
// need not be the device of the tensors a wrapper was handed: a worker
// thread starts on device 0, and so does a process that never set its own.
// A stream of another device then fails the launch. So each extern "C"
// entry point takes its tensors' device index and runs its body through
// guard::on_device, which makes that device current for the call and
// restores the thread's own device on every return path. The index also
// picks the library's per-device state (attributes raised, occupancy read).
//
// The way back makes a device current again only where the process has
// made that device's primary context, as PyTorch's own device guard does
// (c10::cuda::MaybeSetDevice): since CUDA 12, cudaSetDevice creates the
// context of a device that has none, which would take memory on a card the
// process never used (a rank on cuda:3 whose fresh thread starts on device
// 0). cuDevicePrimaryCtxGetState is looked up in libcuda, which the runtime
// has already loaded; where it cannot be found, the thread's device is
// always restored.
#pragma once

#include <cuda_runtime.h>
#include <dlfcn.h>

namespace guard {

constexpr int kMaxDevices = 64;  // per-device state is kept for indices below this

using PrimaryCtxState = int (*)(int device, unsigned int* flags, int* active);

inline PrimaryCtxState primary_ctx_state() {
  static const PrimaryCtxState fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    return lib ? (PrimaryCtxState)dlsym(lib, "cuDevicePrimaryCtxGetState") : nullptr;
  }();
  return fn;
}

// Whether making ``device`` current again is free of side effects: its
// primary context exists (or libcuda cannot be asked).
inline bool has_primary_context(int device) {
  const PrimaryCtxState state = primary_ctx_state();
  if (state == nullptr) return true;
  unsigned int flags = 0;
  int active = 0;
  return state(device, &flags, &active) != 0 || active != 0;
}

// fn() with ``device`` current on the calling thread; returns fn's result
// (0 or a cudaError_t), else the first error of switching the device.
template <typename Fn>
int on_device(int device, Fn&& fn) {
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev == device) return fn();
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int out = fn();
  if (has_primary_context(prev)) {
    err = cudaSetDevice(prev);
    if (out == 0 && err != cudaSuccess) return (int)err;
  }
  return out;
}

}  // namespace guard
