// Host emulation of the few CUDA features csrc/walk.cuh uses, for the CPU
// tests (tests/test_torch_walk.py): a warp is 32 std::threads that meet at
// a barrier in every warp-collective call, so a collective that some lanes
// of a warp skip hangs here as it would on the card.
#pragma once
#define WALK_HOST_EMULATION
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#define __device__
#define __forceinline__ inline
#define __global__
#define __launch_bounds__(...)
struct float4 { float x, y, z, w; };
struct int2 { int x, y; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline int2 make_int2(int a, int b) { return {a, b}; }
template <class T> inline T __ldg(const T *p) { return *p; }
struct uint3_ { unsigned x, y, z; };
inline thread_local uint3_ threadIdx;
struct Warp {
  std::barrier<> bar{32};
  unsigned votes[32];
  unsigned long long vals[32];
};
inline thread_local Warp *cur_warp;
inline unsigned __ballot_sync(unsigned, int pred) {
  Warp *w = cur_warp;
  const int l = threadIdx.x & 31;
  w->votes[l] = pred ? 1u : 0u;
  w->bar.arrive_and_wait();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= w->votes[i] << i;
  w->bar.arrive_and_wait();
  return r;
}
template <class T> inline T shfl_impl(T v, int src) {
  Warp *w = cur_warp;
  const int l = threadIdx.x & 31;
  unsigned long long u = 0;
  std::memcpy(&u, &v, sizeof(T));
  w->vals[l] = u;
  w->bar.arrive_and_wait();
  unsigned long long r = w->vals[src];
  w->bar.arrive_and_wait();
  T out;
  std::memcpy(&out, &r, sizeof(T));
  return out;
}
inline int __shfl_sync(unsigned, int v, int src) { return shfl_impl(v, src); }
inline unsigned long long __shfl_down_sync(unsigned, unsigned long long v, int off) {
  const int l = threadIdx.x & 31;
  return shfl_impl(v, l + off < 32 ? l + off : l);
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int atomicAdd(int *p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline unsigned long long atomicAdd(unsigned long long *p, unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
using std::isnan;
using std::min;
