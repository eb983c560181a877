// tristream_closest: dense closest hit of N rays against a stream of T
// triangles ((T, 10) rows [a.xyz, e1.xyz, e2.xyz, id]).
//
// Replaces the TPU kernel buas_pathtracer_tpu/ops/pallas_tristream.py
// _kernel (:35), which sweeps 1024-ray blocks against 64-triangle blocks
// with the ray block's best hit carried across the sequential grid.  Here
// blocks run in no order, so the sweep is cut the other way: a grid of
// (ray tiles) x (stream splits) blocks, each testing THREADS x RAYS rays
// against one contiguous range of the stream, merged exactly through one
// 64-bit atomicMin key per ray, then a finish kernel per ray.  The per-pair
// test, the cull, the merge and what bounds the kernel: tristream.cuh.
//
// One launch call = a memset of the keys, the stream kernel and the finish
// kernel, all on the caller's stream.

#include "tristream.cuh"

namespace {

__global__ void __launch_bounds__(tri::THREADS)
tristream_closest(tri::Args a) {
  __shared__ __align__(16) float stage[tri::TILE * tri::STAGE_W];
  tri::stream_block(a, stage, blockIdx.x, blockIdx.y);
}

__global__ void __launch_bounds__(tri::FINISH_THREADS)
tristream_finish(tri::Args a) {
  const int i = blockIdx.x * tri::FINISH_THREADS + threadIdx.x;
  if (i < a.n) tri::finish(a, i);
}

}  // namespace

extern "C" int tristream_closest_launch(const void *tris, int n_tris, int n,
                                        const void *ox, const void *oy,
                                        const void *oz, const void *dx,
                                        const void *dy, const void *dz,
                                        void *keys, int splits, void *t_out,
                                        void *id_out, void *u_out,
                                        void *v_out, void *stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (splits < 1 || splits > 65535) return (int)cudaErrorInvalidValue;
  const tri::Args a{(const float *)tris, n_tris, n, splits,
                    (const float *)ox, (const float *)oy, (const float *)oz,
                    (const float *)dx, (const float *)dy, (const float *)dz,
                    (unsigned long long *)keys, (float *)t_out, (int *)id_out,
                    (float *)u_out, (float *)v_out};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(keys, 0xff, sizeof(unsigned long long) * n,
                                   s);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((n + tri::BLOCK_RAYS - 1) / tri::BLOCK_RAYS, splits);
  tristream_closest<<<grid, tri::THREADS, 0, s>>>(a);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  tristream_finish<<<(n + tri::FINISH_THREADS - 1) / tri::FINISH_THREADS,
                     tri::FINISH_THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// stream blocks resident at once on the current card (SM count x the
// occupancy query), cached per device; 0 on an error
extern "C" int tristream_blocks() {
  constexpr int MAX_DEVICES = 64;
  static int cached[MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev >= 0 && dev < MAX_DEVICES && cached[dev] != 0) return cached[dev];
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, tristream_closest, tri::THREADS, 0) != cudaSuccess)
    return 0;
  if (dev >= 0 && dev < MAX_DEVICES) cached[dev] = sms * per_sm;
  return sms * per_sm;
}
