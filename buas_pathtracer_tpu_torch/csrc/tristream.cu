// tristream_closest: dense closest hit of N rays against a stream of T
// triangles ((T, 10) rows [a.xyz, e1.xyz, e2.xyz, id]), one thread per ray.
//
// Replaces the TPU kernel buas_pathtracer_tpu/ops/pallas_tristream.py
// _kernel (:35), which sweeps 1024-ray blocks against 64-triangle blocks
// with the ray block's best hit carried across the sequential grid.  Here a
// block of THREADS rays walks the whole stream: each tile of TILE triangles
// is staged once in shared memory by the whole block, then every thread
// tests every staged triangle (all threads read the same word: a broadcast).
//
// Semantics, shared operation for operation with the plain PyTorch version
// (ops/tristream.py intersect_tristream_plain) and the Pallas body:
// Moller-Trumbore with det outside +-TRI_EPS, u, w in range, tt >= TRI_EPS,
// accepted on tt < best_t (strict: the first triangle in stream order wins
// a tie), and only for rows with id >= 0 (padding).  A miss returns
// t = 3e38, id -1, u = v = 0.  Build with -fmad=false.
//
// What bounds it on an H100: arithmetic.  One ray-triangle test is 46 fp32
// operations (the division counted as one): cross products 9 + 9, det 5,
// reciprocal 1, tvec 3, u 6, w 6, u + w 1, t 6; comparisons are not
// counted.  N x T x 46 over 67 TFLOP/s is the bound.  A later PR could
// give each thread several rays so a staged triangle is reused from
// registers, or map the dot products onto warp-level matrix operations;
// the shared-memory broadcast already keeps device memory out of the way.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 256;  // triangles staged per tile
constexpr int TRI_W = 10;
constexpr float TRI_EPS = 1e-9f;
constexpr float BIG_T = 3.0e38f;

__global__ void __launch_bounds__(THREADS)
tristream_kernel(const float *__restrict__ tris, int n_tris, int n,
                 const float *__restrict__ ox, const float *__restrict__ oy,
                 const float *__restrict__ oz, const float *__restrict__ dx,
                 const float *__restrict__ dy, const float *__restrict__ dz,
                 float *__restrict__ t_out, int *__restrict__ id_out,
                 float *__restrict__ u_out, float *__restrict__ v_out) {
  __shared__ float s_tri[TILE * TRI_W];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const float o_x = live ? ox[i] : 0.0f, o_y = live ? oy[i] : 0.0f,
              o_z = live ? oz[i] : 0.0f;
  const float d_x = live ? dx[i] : 0.0f, d_y = live ? dy[i] : 0.0f,
              d_z = live ? dz[i] : 0.0f;
  float best_t = BIG_T, best_u = 0.0f, best_v = 0.0f;
  int best_id = -1;
  for (int base = 0; base < n_tris; base += TILE) {
    const int m = min(TILE, n_tris - base);
    const float *src = tris + (size_t)base * TRI_W;
    for (int j = threadIdx.x; j < m * TRI_W; j += THREADS) s_tri[j] = src[j];
    __syncthreads();
    for (int k = 0; k < m; ++k) {
      const float *q = s_tri + TRI_W * k;
      const float ax = q[0], ay = q[1], az = q[2];
      const float e1x = q[3], e1y = q[4], e1z = q[5];
      const float e2x = q[6], e2y = q[7], e2z = q[8];
      const float tid = q[9];
      const float px = d_y * e2z - d_z * e2y;
      const float py = d_z * e2x - d_x * e2z;
      const float pz = d_x * e2y - d_y * e2x;
      const float det = e1x * px + e1y * py + e1z * pz;
      bool ok = (det <= -TRI_EPS) || (det >= TRI_EPS);
      const float inv_det = 1.0f / (ok ? det : 1.0f);
      const float tx = o_x - ax, ty = o_y - ay, tz = o_z - az;
      const float u = (tx * px + ty * py + tz * pz) * inv_det;
      ok = ok && (u >= 0.0f) && (u <= 1.0f);
      const float qx = ty * e1z - tz * e1y;
      const float qy = tz * e1x - tx * e1z;
      const float qz = tx * e1y - ty * e1x;
      const float w = (d_x * qx + d_y * qy + d_z * qz) * inv_det;
      ok = ok && (w >= 0.0f) && (u + w <= 1.0f);
      const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
      ok = ok && (tt >= TRI_EPS) && (tt < best_t) && (tid >= 0.0f);
      if (ok) {
        best_t = tt;
        best_id = (int)tid;
        best_u = u;
        best_v = w;
      }
    }
    __syncthreads();
  }
  if (live) {
    t_out[i] = best_t;
    id_out[i] = best_id;
    u_out[i] = best_u;
    v_out[i] = best_v;
  }
}

}  // namespace

extern "C" int tristream_closest_launch(const void *tris, int n_tris, int n,
                                        const void *ox, const void *oy,
                                        const void *oz, const void *dx,
                                        const void *dy, const void *dz,
                                        void *t_out, void *id_out,
                                        void *u_out, void *v_out,
                                        void *stream) {
  if (n <= 0) return (int)cudaSuccess;
  const dim3 grid((n + THREADS - 1) / THREADS);
  tristream_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      (const float *)tris, n_tris, n, (const float *)ox, (const float *)oy,
      (const float *)oz, (const float *)dx, (const float *)dy,
      (const float *)dz, (float *)t_out, (int *)id_out, (float *)u_out,
      (float *)v_out);
  return (int)cudaGetLastError();
}
