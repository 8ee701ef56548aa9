// A kernel's function attributes (dynamic shared memory, carveout) are
// per-device state: a process that launches on several cards sets them
// once on each card, not once per process.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace sbt {

constexpr int kMaxDevices = 64;

// Runs ``set`` once for the current device and returns what it returned,
// then and on every later call on that device.
template <typename Set>
inline cudaError_t once_per_device(std::once_flag (&flags)[kMaxDevices],
                                   cudaError_t (&results)[kMaxDevices],
                                   Set set) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(flags[dev], [&] { results[dev] = set(); });
  return results[dev];
}

}  // namespace sbt
