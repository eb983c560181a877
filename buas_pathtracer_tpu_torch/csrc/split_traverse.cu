// split_traverse<OCCLUSION>: closest-hit / any-hit walk of the split tables
// of big scenes (ops/wide_bvh.py split_for_dma), one thread per ray.
//
// Replaces the TPU kernels buas_pathtracer_tpu/ops/pallas_packet.py
// _kernel_v7 (:616, the grouped walk _kernel_v5 with DMA=True) and
// _kernel_v4 (:1216, block-lockstep walk with a 16-slot leaf-DMA ring).
// Both compute one function: the walk of wide_traverse over a RESIDENT table
// of internal and analytic-prim rows (64 floats) and a LEAF table of merged
// triangle leaves (128 floats, up to 12 triangles).  On the TPU the split
// keeps the internal tree in VMEM and streams leaf rows from HBM through an
// explicit DMA ring; on Hopper the hardware caches do that job, and the
// lockstep / grouped split is a Mosaic schedule, so one kernel serves both.
//
// Links: a stack entry is a signed link; >= 0 is a resident row, -(l+1) is
// leaf row l.  An internal resident row holds its 8 child links in lanes
// 50..57 and its child kinds packed 2 bits each in lane 58, all exact float
// values decoded with (int).  Lane 1 (the unified child_base) is not read.
//
// Semantics, shared operation for operation with the plain PyTorch version
// (ops/packet.py split_traverse_plain) and with the Pallas bodies
// _child_keys (:265), _tri_updates (:346) and _prim_updates (:387):
//   * lanes with t0 < 0 pass through: t = t0, prim = tri = -1, bv = bw = 0;
//     a ray with a NaN component hits nothing (as in wide_traverse.cu);
//   * EMPTY children (dropped padding rows and merged-away leaf slots) are
//     skipped by their kind before the slab test: their link 0 is the
//     root's, so reaching one would restart the walk;
//   * a child is entered when tn < tf, tf > 0, tn < t and its key
//     max(tn, 0) < BIG_T (1e30), all strict;
//   * hit children are pushed farthest first (sorted by (key, slot)), so the
//     nearest pops first; a popped entry whose key >= t is skipped;
//   * triangles: Moller-Trumbore with TRI_EPS, accepted on t >= t_new (the
//     later of two equal-t triangles wins), for k < count, in a leaf whose
//     owning prim (lane 3) != the ray's ignored prim; tri id = lane 2 + k;
//   * analytic prims: sphere / box through the inline inverse transform;
//   * occlusion mode stops at the first accepted hit.
// Build with -fmad=false so the arithmetic rounds like the unfused PyTorch
// ops of the plain version.
//
// Stats: per ray, rows read (resident and leaf pops that pass the key test)
// and triangle slots tested (the count of every leaf whose prim is not
// ignored), summed per warp and added into two int64 counters.  This is NOT
// the TPU kernels' union-of-block counting and is never compared with it.
//
// What bounds it on an H100: on the stress scene the two tables (7.8 MB
// resident + 34.8 MB leaf) fit the 50 MB L2 where the unified table (62.6
// MB) does not, so each step is a chain of dependent L2 loads plus warp
// divergence; a leaf pop reads lanes 0-3 and the 36-lane groups that hold
// its count triangles (lanes 8 .. 115 for a full row).  Measured on the
// stress waves (PERF.md) it is nonetheless slower than wide_traverse on the
// unified table: a merged leaf is entered whenever any member's box is hit
// and then tests all its triangles, and the unified table's EMPTY rows are
// never read, so its touched footprint is far below its size.  A later PR
// should test merged leaves per member box (or stop merging), sort waves by
// origin and direction before the walk, keep the top of the resident tree
// in shared memory, and refill lanes of persistent warps as rays finish.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WIDE = 8;
constexpr int ROW_W = 64;
constexpr int LEAF_ROW_W = 128;
constexpr int KIND_INTERNAL = 0;
constexpr int KIND_PRIM = 2;
constexpr int KIND_EMPTY = 3;
constexpr int PRIM_SPHERE = 2;
constexpr float BIG_T = 1e30f;
constexpr float TRI_EPS = 1e-9f;
constexpr float EPSILON = 0.001f;
constexpr float INV_DIR_EPS = 1e-18f;
constexpr int STACK = 128;  // >= depth * (WIDE - 1) + 1, checked by the wrapper
constexpr int THREADS = 128;

__device__ __forceinline__ float safe_inv(float c) {
  float s = c >= 0.0f ? 1.0f : -1.0f;
  return s / fmaxf(fabsf(c), INV_DIR_EPS);
}

// row lanes [4*first, 4*(first+n)) into f[0 .. 4n)
template <int N>
__device__ __forceinline__ void load_row(const float4 *r4, int first,
                                         float *f) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float4 q = __ldg(r4 + first + i);
    f[4 * i + 0] = q.x;
    f[4 * i + 1] = q.y;
    f[4 * i + 2] = q.z;
    f[4 * i + 3] = q.w;
  }
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <bool OCC>
__global__ void __launch_bounds__(THREADS)
split_traverse_kernel(const float *__restrict__ res,
                      const float *__restrict__ leaf, int n,
                      const float *__restrict__ ox,
                      const float *__restrict__ oy,
                      const float *__restrict__ oz,
                      const float *__restrict__ dx,
                      const float *__restrict__ dy,
                      const float *__restrict__ dz,
                      const float *__restrict__ t0,
                      const int *__restrict__ ign, float *__restrict__ t_out,
                      int *__restrict__ prim_out, int *__restrict__ tri_out,
                      float *__restrict__ bv_out, float *__restrict__ bw_out,
                      unsigned long long *__restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long visits = 0, tests = 0;
  if (i < n) {
    const float t_in = t0[i];
    float t = t_in, bv = 0.0f, bw = 0.0f;
    int prim = -1, tri = -1;
    const float o_x = ox[i], o_y = oy[i], o_z = oz[i];
    const float d_x = dx[i], d_y = dy[i], d_z = dz[i];
    const bool nan_ray = isnan(o_x) || isnan(o_y) || isnan(o_z) ||
                         isnan(d_x) || isnan(d_y) || isnan(d_z);
    if (t_in >= 0.0f && !nan_ray) {
      const int ignored = ign[i];
      const float id_x = safe_inv(d_x), id_y = safe_inv(d_y),
                  id_z = safe_inv(d_z);
      const float4 *res4 = reinterpret_cast<const float4 *>(res);

      int stk_link[STACK];
      float stk_key[STACK];
      int sp = 1;
      stk_link[0] = 0;  // root: resident row 0
      stk_key[0] = 0.0f;
      while (sp > 0) {
        --sp;
        const int link = stk_link[sp];
        if (stk_key[sp] >= t) continue;  // entered after a nearer hit
        ++visits;
        if (link < 0) {
          // ---- merged triangle leaf: lanes 0-3, then 9 per triangle ----
          const float *lr = leaf + (size_t)(-link - 1) * LEAF_ROW_W;
          const float4 head = __ldg(reinterpret_cast<const float4 *>(lr));
          const int count = (int)head.y;
          const int tri_base = (int)head.z;
          const int inst = (int)head.w;
          if (inst == ignored) continue;
          tests += (unsigned long long)count;
          bool any = false;
          // triangles in groups of 4: lanes 8 + 36g .. 43 + 36g are nine
          // aligned float4 loads; only the groups that hold one of the
          // count triangles are read
          const float4 *l4 = reinterpret_cast<const float4 *>(lr) + 2;
          for (int g = 0; 4 * g < count; ++g) {
            float f[36];
            load_row<9>(l4, 9 * g, f);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const int k = 4 * g + kk;
              const float *q = f + 9 * kk;
              const float ax = q[0], ay = q[1], az = q[2];
              const float e1x = q[3], e1y = q[4], e1z = q[5];
              const float e2x = q[6], e2y = q[7], e2z = q[8];
              const float pvx = d_y * e2z - d_z * e2y;
              const float pvy = d_z * e2x - d_x * e2z;
              const float pvz = d_x * e2y - d_y * e2x;
              const float det = e1x * pvx + e1y * pvy + e1z * pvz;
              bool ok = (det <= -TRI_EPS) || (det >= TRI_EPS);
              const float inv_det = 1.0f / (ok ? det : 1.0f);
              const float tvx = o_x - ax, tvy = o_y - ay, tvz = o_z - az;
              const float v = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
              ok = ok && (v >= 0.0f) && (v <= 1.0f);
              const float qvx = tvy * e1z - tvz * e1y;
              const float qvy = tvz * e1x - tvx * e1z;
              const float qvz = tvx * e1y - tvy * e1x;
              const float w = (d_x * qvx + d_y * qvy + d_z * qvz) * inv_det;
              ok = ok && (w >= 0.0f) && (v + w <= 1.0f);
              const float t_new =
                  (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
              ok = ok && (t_new >= TRI_EPS) && (t >= t_new) && (k < count);
              if (ok) {
                t = t_new;
                prim = inst;
                tri = tri_base + k;
                bv = v;
                bw = w;
                any = true;
              }
            }
          }
          if (OCC && any) break;
          continue;
        }
        const float4 *r4 = res4 + (size_t)link * (ROW_W / 4);
        const float4 head = __ldg(r4);
        const int kind = (int)head.x;
        if (kind == KIND_INTERNAL) {
          float f[60];  // lanes 0..59: boxes 2..49, links 50..57, kinds 58
          load_row<15>(r4, 0, f);
          const int kinds = (int)f[58];
          float key[WIDE];
          int lnk[WIDE];
          int slot[WIDE];
          int n_hit = 0;
#pragma unroll
          for (int c = 0; c < WIDE; ++c) {
            bool h = false;
            float k = 0.0f;
            if (((kinds >> (2 * c)) & 3) != KIND_EMPTY) {
              const int s = 2 + 6 * c;
              const float t1x = (f[s + 0] - o_x) * id_x;
              const float t2x = (f[s + 3] - o_x) * id_x;
              const float t1y = (f[s + 1] - o_y) * id_y;
              const float t2y = (f[s + 4] - o_y) * id_y;
              const float t1z = (f[s + 2] - o_z) * id_z;
              const float t2z = (f[s + 5] - o_z) * id_z;
              const float tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                                     fminf(t1z, t2z));
              const float tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                                     fmaxf(t1z, t2z));
              k = fmaxf(tn, 0.0f);
              h = (tn < tf) && (tf > 0.0f) && (tn < t) && (k < BIG_T);
            }
            key[c] = h ? k : __int_as_float(0x7f800000);  // +inf
            lnk[c] = (int)f[50 + c];
            slot[c] = c;
            n_hit += h ? 1 : 0;
          }
          // sort (key, slot) ascending, links riding along: odd-even
          // transposition, unrolled so everything stays in registers
#pragma unroll
          for (int pass = 0; pass < WIDE; ++pass) {
#pragma unroll
            for (int j = pass & 1; j + 1 < WIDE; j += 2) {
              const bool sw = key[j] > key[j + 1] ||
                              (key[j] == key[j + 1] && slot[j] > slot[j + 1]);
              const float ka = sw ? key[j + 1] : key[j];
              const float kb = sw ? key[j] : key[j + 1];
              const int sa = sw ? slot[j + 1] : slot[j];
              const int sb = sw ? slot[j] : slot[j + 1];
              const int la = sw ? lnk[j + 1] : lnk[j];
              const int lb = sw ? lnk[j] : lnk[j + 1];
              key[j] = ka;
              key[j + 1] = kb;
              slot[j] = sa;
              slot[j + 1] = sb;
              lnk[j] = la;
              lnk[j + 1] = lb;
            }
          }
          // push farthest first: sorted entry j lands at sp + n_hit-1-j
#pragma unroll
          for (int j = 0; j < WIDE; ++j) {
            if (j < n_hit) {
              const int at = sp + n_hit - 1 - j;
              stk_link[at] = lnk[j];
              stk_key[at] = key[j];
            }
          }
          sp += n_hit;
        } else if (kind == KIND_PRIM) {
          float f[20];  // lanes 0..19
          load_row<5>(r4, 0, f);
          const int prim_id = (int)f[1];
          const int ptype = (int)f[2];
          const float *m = f + 4;
          const float so_x = m[0] * o_x + m[1] * o_y + m[2] * o_z + m[3];
          const float so_y = m[4] * o_x + m[5] * o_y + m[6] * o_z + m[7];
          const float so_z = m[8] * o_x + m[9] * o_y + m[10] * o_z + m[11];
          const float sd_x = m[0] * d_x + m[1] * d_y + m[2] * d_z;
          const float sd_y = m[4] * d_x + m[5] * d_y + m[6] * d_z;
          const float sd_z = m[8] * d_x + m[9] * d_y + m[10] * d_z;
          bool hit;
          float t_new;
          if (ptype == PRIM_SPHERE) {
            const float r = f[16];
            const float a = sd_x * sd_x + sd_y * sd_y + sd_z * sd_z;
            const float b = sd_x * so_x + sd_y * so_y + sd_z * so_z;
            const float c = (so_x * so_x + so_y * so_y + so_z * so_z) - r * r;
            const float discr = b * b - a * c;
            const float root = sqrtf(fmaxf(discr, 0.0f));
            const float inv_a = 1.0f / fmaxf(a, 1e-30f);
            const float tn = (-b - root) * inv_a;
            const float tf = (-b + root) * inv_a;
            t_new = tn >= 0.0f ? tn : tf;
            hit = (discr >= 0.0f) && (t_new >= EPSILON) && (t > t_new);
          } else {
            const float ix = safe_inv(sd_x), iy = safe_inv(sd_y),
                        iz = safe_inv(sd_z);
            const float nx = ix * so_x, ny = iy * so_y, nz = iz * so_z;
            const float kx = fabsf(ix) * f[17], ky = fabsf(iy) * f[18],
                        kz = fabsf(iz) * f[19];
            const float tn = fmaxf(fmaxf(-nx - kx, -ny - ky), -nz - kz);
            const float tf = fminf(fminf(-nx + kx, -ny + ky), -nz + kz);
            t_new = tn >= 0.0f ? tn : tf;
            hit = (tn < tf) && (t > t_new) && (t_new >= EPSILON);
          }
          if (hit && prim_id != ignored) {
            t = t_new;
            prim = prim_id;
            tri = -1;
            if (OCC) break;
          }
        }
      }
    }
    t_out[i] = t;
    prim_out[i] = prim;
    tri_out[i] = tri;
    bv_out[i] = bv;
    bw_out[i] = bw;
  }
  visits = warp_sum(visits);
  tests = warp_sum(tests);
  if ((threadIdx.x & 31) == 0 && (visits | tests)) {
    atomicAdd(stats + 0, visits);
    atomicAdd(stats + 1, tests);
  }
}

}  // namespace

extern "C" int split_traverse_launch(
    const void *res, const void *leaf, int n, const void *ox, const void *oy,
    const void *oz, const void *dx, const void *dy, const void *dz,
    const void *t0, const void *ign, int occlusion, void *t_out,
    void *prim_out, void *tri_out, void *bv_out, void *bw_out, void *stats,
    void *stream) {
  if (n <= 0) return (int)cudaSuccess;
  const dim3 grid((n + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ST_ARGS                                                              \
  (const float *)res, (const float *)leaf, n, (const float *)ox,             \
      (const float *)oy, (const float *)oz, (const float *)dx,               \
      (const float *)dy, (const float *)dz, (const float *)t0,               \
      (const int *)ign, (float *)t_out, (int *)prim_out, (int *)tri_out,     \
      (float *)bv_out, (float *)bw_out, (unsigned long long *)stats
  if (occlusion)
    split_traverse_kernel<true><<<grid, THREADS, 0, s>>>(ST_ARGS);
  else
    split_traverse_kernel<false><<<grid, THREADS, 0, s>>>(ST_ARGS);
#undef ST_ARGS
  return (int)cudaGetLastError();
}

extern "C" int split_traverse_max_stack() { return STACK; }
