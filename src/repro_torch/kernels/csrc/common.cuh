// Shared definitions for the port's hand-written Hopper kernels.
//
// Every entry point has a plain C interface (loaded with ctypes by
// kernels/build.py), launches on the stream it is given, allocates
// nothing, and returns the cudaError_t of the launch (0 on success).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

// Grid sizes are passed as 32-bit ints; callers check the bound.
static inline __host__ __device__ int repro_ceil_div(int64_t a, int64_t b) {
  return (int)((a + b - 1) / b);
}
