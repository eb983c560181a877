// What the one-thread-a-lane kernels (shade.cuh, hit.cuh) share: the host
// stand-ins that let their lane logic compile with g++ for the CPU tests
// (tests/shade_host/, tests/hit_host/), and the helpers that follow
// PyTorch's CUDA arithmetic.

#pragma once

#include <math.h>
#include <stdint.h>

#ifndef __CUDACC__
#include <cstring>
#define __device__
#define __forceinline__ inline
inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}
template <class T> inline T __ldg(const T *p) { return *p; }
#endif

namespace lane {

// torch.clamp(v, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// an int64 through the read-only path
__device__ __forceinline__ int64_t ld64(const int64_t *p) {
  return (int64_t)__ldg(reinterpret_cast<const long long *>(p));
}

}  // namespace lane
