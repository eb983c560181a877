// Host emulation of the few CUDA features csrc/walk.cuh and
// csrc/tristream.cuh use, for the CPU tests (tests/test_torch_walk.py,
// tests/test_torch_tristream.py): a warp is 32 std::threads that meet at a
// barrier in every warp-collective call, so a collective that some lanes of
// a warp skip hangs here as it would on the card; a block's threads meet at
// its own barrier in __syncthreads.
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
inline thread_local uint3_ blockIdx;
struct Block {
  explicit Block(int threads) : bar(threads) {}
  std::barrier<> bar;
};
inline thread_local Block *cur_block;
inline void __syncthreads() { cur_block->bar.arrive_and_wait(); }
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
inline bool __any_sync(unsigned mask, int pred) { return __ballot_sync(mask, pred) != 0; }
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
inline unsigned atomicOr(unsigned *p, unsigned v) {
  return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned __ldca(const unsigned *p) { return __atomic_load_n(p, __ATOMIC_RELAXED); }
inline unsigned long long atomicMin(unsigned long long *p, unsigned long long v) {
  unsigned long long old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (v < old && !__atomic_compare_exchange_n(p, &old, v, false, __ATOMIC_SEQ_CST,
                                                 __ATOMIC_SEQ_CST)) {
  }
  return old;
}
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
using std::isnan;
using std::min;
