// shade_hit / shade_next: the shading of one bounce of the Advanced
// Pathtracer, in two launches around next-event estimation.
//
// These kernels replace no TPU kernel: on the TPU, XLA fuses the bounce's
// shading into the frame program.  Between them, nee_sample (nee.cu) and the
// occlusion walk run next-event estimation.  On the H100 the port ran it as ~540
// PyTorch ops a bounce: 4,295 of a bench frame's 9,299 launches and 64 of
// its 156 device ms (PERF.md, section 5), each op a launch the host issues
// at 15-20 us and an (N,) pass over the lanes, with (N, 16) row gathers of
// the material table.  Here each lane is one thread that reads its state,
// its hit and two material rows, and writes its new state:
//  - shade_hit runs after the closest-hit walk: the sky, orientation and
//    the stack's materials, Beer's law, emission and its MIS weight,
//    Fresnel, the REFLECTANCE and fuzz draws, the reflect and refract
//    branches with the stack's push and pop, the diffuse BRDF;
//  - shade_next runs after the shadow walk: the light and environment
//    contributions from nee_sample's scratch and the walk's prim, the
//    INDIRECT_LIGHTING draw, the hemisphere, the branches' merge and Russian
//    roulette.
// The lane logic and its arithmetic are in shade.cuh.
//
// Layout: the state is SoA, float32 Vec3 components and int64 RNG state,
// stack and stack index, updated in place (the integrator clones the
// caller's rays and sampler once a frame), so every read and write is
// coalesced; the material, light and environment rows come from the small
// tables through the read-only cache.  A lane that is not alive reads its
// alive flag and writes its branch code and NEE flag (3 bytes); nothing of
// it changes.  Between the two launches a scratch holds the oriented
// normal, the BRDF, the branch code and the specular ray and tint.
//
// What bounds them on an H100: memory bytes.  A live lane of shade_hit
// reads ~135 bytes (alive 1, direction 12, throughput 12, total 12, flag 1,
// RNG state 8, hit id 8, material id 8, normal 12, point 12, t 4, stack
// index 8, two stack entries 16, first-bounce base 4-8; the material rows
// come from cache) and writes ~110 (throughput, total, normal 12 each, RNG
// state 8, the branch's scratch 12-36, codes 2, stack 0-16); shade_next
// reads ~95 (alive 1, code 1, RNG 8, throughput 12, normal 12, BRDF or
// ray 12-36, NEE's flags bytes, walk prims and terms 0-59, point 12) and writes
// ~70 (throughput 12, total 0-12, origin 12, direction 12, normal 12, RNG
// 8, flags 2).  So a bounce moves ~410 bytes a live lane and 4-5 a dead
// one: at 2,073,600 lanes all alive, 0.85 GB or 0.25 ms at 3.35 TB/s; a
// bench frame (8 bounces, 16.9% of its lane-bounces alive) ~0.5 ms in all.
// The rays count of shade_hit and the facing counts of shade_next are block
// counts added with atomics; the last block to finish adds them to stats
// and zeroes the counters, so nothing waits on the host.

#include <cuda_runtime.h>

#include "shade.cuh"

namespace {

constexpr int THREADS = 256;

// true in one thread of the grid's last block to finish, after every
// block's counts are in counters[0..1]; counters[2] counts the blocks
__device__ __forceinline__ bool last_block(unsigned long long *counters,
                                           int c0, int c1) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    if (c0) atomicAdd(&counters[0], (unsigned long long)c0);
    if (c1) atomicAdd(&counters[1], (unsigned long long)c1);
    __threadfence();
    last = atomicAdd(&counters[2], 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (!(last && threadIdx.x == 0)) return false;
  __threadfence();
  return true;
}

__global__ void __launch_bounds__(THREADS) shade_hit_kernel(shade::Args a) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const bool live = i < a.n && shade::shade_hit_lane(a, i);
  const int rays = __syncthreads_count(live);
  if (!last_block(a.counters, rays, 0)) return;
  const unsigned long long total = atomicExch(&a.counters[0], 0ull);
  atomicExch(&a.counters[2], 0ull);
  // stats + [alive.sum(), node_visits, tri_tests], as float32
  a.stats[0] = a.stats[0] + (float)(long long)total;
  a.stats[1] = a.stats[1] + (float)*a.node_visits;
  a.stats[2] = a.stats[2] + (float)*a.tri_tests;
}

__global__ void __launch_bounds__(THREADS) shade_next_kernel(shade::Args a) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  int cnt[2] = {0, 0};
  if (i < a.n) shade::shade_next_lane(a, i, cnt);
  const int facing = __syncthreads_count(cnt[0]);
  const int facing_e = __syncthreads_count(cnt[1]);
  if (!last_block(a.counters, facing, facing_e)) return;
  const unsigned long long f0 = atomicExch(&a.counters[0], 0ull);
  const unsigned long long f1 = atomicExch(&a.counters[1], 0ull);
  atomicExch(&a.counters[2], 0ull);
  // stats + [facing.sum(), 0, 0], then the same for the environment
  if (a.nee) {
    a.stats[0] = a.stats[0] + (float)(long long)f0;
    a.stats[1] = a.stats[1] + 0.0f;
    a.stats[2] = a.stats[2] + 0.0f;
  }
  if (a.env_nee) {
    a.stats[0] = a.stats[0] + (float)(long long)f1;
    a.stats[1] = a.stats[1] + 0.0f;
    a.stats[2] = a.stats[2] + 0.0f;
  }
}

int launch(void (*kernel)(shade::Args), const shade::Args *a, void *stream) {
  if (a->n <= 0) return (int)cudaSuccess;
  const int64_t blocks = (a->n + THREADS - 1) / THREADS;
  kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      *a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int shade_args_size() { return (int)sizeof(shade::Args); }

extern "C" int shade_hit_launch(const shade::Args *a, void *stream) {
  return launch(shade_hit_kernel, a, stream);
}

extern "C" int shade_next_launch(const shade::Args *a, void *stream) {
  return launch(shade_next_kernel, a, stream);
}
