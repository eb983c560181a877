// walk.cuh: the per-ray walk of the 8-wide row BVH, shared by
// wide_traverse.cu (the unified row table) and split_traverse.cu (the split
// resident / leaf tables of big scenes).  Both files instantiate `run` with
// their table accessor and keep their own C entry points.
//
// Replaces, through those two files, the TPU kernels of
// buas_pathtracer_tpu/ops/pallas_packet.py: _kernel_v2 (:406), _kernel_v5
// (:639) and the v1 _kernel (:71) on the unified table; _kernel_v7 (:616)
// and _kernel_v4 (:1216) on the split tables.  Their block-lockstep, grouped
// and leaf-DMA forms are Mosaic schedules of one function; this core is the
// Hopper schedule of the same function.
//
// Semantics, shared operation for operation with the plain PyTorch walks
// (ops/packet.py _Walk) and with the Pallas bodies _child_keys (:265),
// _tri_updates (:346) and _prim_updates (:387).  Each ray's sequence of pops
// is the plain walk's, so t, prim, tri, bv, bw and the stats are equal:
//   * rays with t0 < 0, or with a NaN component, are resolved when they are
//     fetched: t = t0, prim = tri = -1, bv = bw = 0, no row read;
//   * a child is entered when tn < tf, tf > 0, tn < t and its key
//     max(tn, 0) < BIG_T (1e30); EMPTY children (kind 3: padding and
//     merged-away slots, whose point boxes miss every slab anyway) are
//     skipped before the slab test;
//   * hit children are pushed farthest first, sorted by (key, slot), so the
//     nearest pops first and equal keys keep slot order (-0 counts as +0);
//     a popped entry whose key >= t is dropped without a read;
//   * triangles: Moller-Trumbore with TRI_EPS, in slot order, accepted on
//     t >= t_new (the later of two equal-t triangles wins), for k < count,
//     in a leaf whose owning prim (lane 3) != the ray's ignored prim;
//   * analytic prims: sphere / box through the inline inverse transform;
//   * occlusion mode stops at the first accepted hit.
// Built with -fmad=false so the arithmetic rounds like the unfused PyTorch
// ops of the plain version.
//
// Stats: per ray, rows read (pops that pass the key test) and triangle
// slots tested (min(count, leaf slots) of every leaf whose prim is not
// ignored), summed per warp into two int64 counters.  Separately, when
// `steps` is given, each warp adds its loop iterations that read a row, so
// rows read / (32 x steps) is the achieved lane utilisation.  Neither is
// the TPU kernels' union-of-block counting, and neither is compared with it.
//
// What bounds the walk on an H100: each step is a dependent chain, a stack
// pop, then one 256-byte (or 512-byte leaf) row gathered from L2 at an
// address no other lane shares, then the row's arithmetic, then the pushes.
// Nothing is reused across lanes, so the card's time goes to latency and to
// lanes that have nothing to do: a warp that launches one thread per ray
// runs as long as its longest ray, and after the first bounce most rays of
// a wave are dead (t0 < 0) or short.  What the design does about it:
//   * persistent warps: about as many blocks as fit on the card (SM count x
//     the occupancy query); a lane whose ray is done, or that has none,
//     takes the next ray index from a per-launch counter (one warp-
//     aggregated atomicAdd per refill, so rays stay roughly in tile order)
//     once REFILL lanes of the warp are idle; dead rays are resolved at
//     fetch and never hold a lane through a walk;
//   * steps grouped by kind: each warp step runs the kind, internal or
//     leaf / prim, that most of the warp's pending lanes want; the other
//     lanes wait with their popped entry, so no ray reorders its own visits
//     (internal steps first, or every lane its own kind, measured slower);
//   * the child kinds travel with each stack entry, so a warp knows the kind
//     of every lane's next row before reading it, and the 8 (key, slot) pairs
//     sort as 64-bit integers through a 19-comparator network;
//   * registers: ~90 a thread and no spills at the compiler's choice of five
//     blocks per SM (nvcc -Xptxas -v; chip_smoke.py prints them);
//     wide_traverse.cu asks for six (80 registers, a few bytes spilled).
// The stack (capacity STACK = 128, checked by ops/packet.py) is a local
// array whose top entries stay in L1.  Measured and dropped (PERF.md, the
// walks' step table): the stack's top positions in shared memory, laid out
// [position][thread] (0-2.6% slower on five of the six waves: the local
// top already sits in L1, and the split adds a branch per access), and a
// prefetch of the nearest child's row (neutral).
// What it does not use of Hopper: tensor cores, wgmma and TMA have no role in
// a per-ray tree walk (no matrix, no tile that two lanes share); the warp-
// level fetch, L1 and the L2 that holds the tables are the tools that apply.

#pragma once

#ifndef WALK_HOST_EMULATION
#include <cuda_runtime.h>
#endif
#include <stdint.h>

namespace walk {

constexpr int WIDE = 8;
constexpr int ROW_W = 64;
constexpr int LEAF_ROW_W = 128;
constexpr int WIDE_LEAF = 6;
constexpr int DMA_LEAF_K = 12;
constexpr int KIND_INTERNAL = 0;
constexpr int KIND_TRIS = 1;
constexpr int KIND_PRIM = 2;
constexpr int KIND_EMPTY = 3;
constexpr int PRIM_SPHERE = 2;
constexpr float BIG_T = 1e30f;
constexpr float TRI_EPS = 1e-9f;
constexpr float EPSILON = 0.001f;
constexpr float INV_DIR_EPS = 1e-18f;
constexpr int STACK = 128;  // >= depth * (WIDE - 1) + 1, checked by the wrapper
constexpr int THREADS = 128;
// a warp fetches rays once this many of its lanes are idle (8-24 measured
// within 5% of each other, 1 and 32 slower)
constexpr int REFILL = 16;
// a link rides in the low 29 bits of a sort key: |link| < 2^28 rows,
// checked by the wrapper
constexpr int LINK_BITS = 29;
constexpr unsigned LINK_MASK = (1u << LINK_BITS) - 1u;
constexpr unsigned FULL = 0xffffffffu;

// ---- the two tables ------------------------------------------------------

// Unified row table: one 64-float row per node; an internal row's children
// are rows child_base + 0..7 (lane 1) and their kinds are lanes 50..57.
struct Unified {
  static constexpr int LEAF_K = WIDE_LEAF;  // triangles per leaf row
  static constexpr int LEAF_F4 = ROW_W / 4;  // leaf row width in float4
  const float4 *rows;
  __device__ __forceinline__ const float4 *node(int link) const {
    return rows + (size_t)link * (ROW_W / 4);
  }
  __device__ __forceinline__ const float4 *leaf(int link) const {
    return node(link);
  }
  // q: float4 0..14 of an internal row
  __device__ __forceinline__ void children(const float4 *q, int *link,
                                           int &kinds) const {
    const int base = (int)q[0].y;
    const float k[WIDE] = {q[12].z, q[12].w, q[13].x, q[13].y,
                           q[13].z, q[13].w, q[14].x, q[14].y};
    kinds = 0;
#pragma unroll
    for (int c = 0; c < WIDE; ++c) {
      link[c] = base + c;
      kinds |= (int)k[c] << (2 * c);
    }
  }
};

// Split tables (ops/wide_bvh.py split_for_dma): resident internal and prim
// rows of 64 floats, merged triangle leaves of 128 floats.  A link >= 0 is
// a resident row, -(l+1) leaf row l; an internal row holds its 8 child
// links in lanes 50..57 and their kinds, 2 bits each, in lane 58.
struct Split {
  static constexpr int LEAF_K = DMA_LEAF_K;
  static constexpr int LEAF_F4 = LEAF_ROW_W / 4;
  const float4 *res;
  const float4 *leaves;
  __device__ __forceinline__ const float4 *node(int link) const {
    return res + (size_t)link * (ROW_W / 4);
  }
  __device__ __forceinline__ const float4 *leaf(int link) const {
    return leaves + (size_t)(-link - 1) * (LEAF_ROW_W / 4);
  }
  __device__ __forceinline__ void children(const float4 *q, int *link,
                                           int &kinds) const {
    link[0] = (int)q[12].z;
    link[1] = (int)q[12].w;
    link[2] = (int)q[13].x;
    link[3] = (int)q[13].y;
    link[4] = (int)q[13].z;
    link[5] = (int)q[13].w;
    link[6] = (int)q[14].x;
    link[7] = (int)q[14].y;
    kinds = (int)q[14].z;
  }
};

// ---- the launch's arguments ----------------------------------------------

struct Args {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *t0;
  const int *ign;
  int n;
  float *t_out;
  int *prim_out, *tri_out;
  float *bv_out, *bw_out;
  unsigned long long *stats;  // [rows read, triangle tests]
  int *next;                  // the ray counter, zeroed by the wrapper
  unsigned long long *steps;  // warp steps that read a row, or null
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
  int ign;
};

struct Best {
  float t, bv, bw;
  int prim, tri;
};

// ---- arithmetic ----------------------------------------------------------

__device__ __forceinline__ float safe_inv(float c) {
  float s = c >= 0.0f ? 1.0f : -1.0f;
  return s / fmaxf(fabsf(c), INV_DIR_EPS);
}

// lane l of a row held as float4 q[]; l is a constant once unrolled
__device__ __forceinline__ float lane(const float4 *q, int l) {
  const float4 v = q[l >> 2];
  switch (l & 3) {
    case 0: return v.x;
    case 1: return v.y;
    case 2: return v.z;
    default: return v.w;
  }
}

__device__ __forceinline__ void cex(unsigned long long &a,
                                    unsigned long long &b) {
  const unsigned long long lo = a < b ? a : b;
  const unsigned long long hi = a < b ? b : a;
  a = lo;
  b = hi;
}

// ascending sort of 8 keys: the 19-comparator network
__device__ __forceinline__ void sort8(unsigned long long *e) {
  cex(e[0], e[2]); cex(e[1], e[3]); cex(e[4], e[6]); cex(e[5], e[7]);
  cex(e[0], e[4]); cex(e[1], e[5]); cex(e[2], e[6]); cex(e[3], e[7]);
  cex(e[0], e[1]); cex(e[2], e[3]); cex(e[4], e[5]); cex(e[6], e[7]);
  cex(e[2], e[4]); cex(e[3], e[5]);
  cex(e[1], e[4]); cex(e[3], e[6]);
  cex(e[1], e[2]); cex(e[3], e[4]); cex(e[5], e[6]);
}

// Slab tests of the 8 children of internal row `link`.  e[c] is
// (key bits << 32 | slot << 29 | link) for a hit child, all ones for a miss;
// the key is non-negative, so the 64-bit order is the (key, slot) order.
// Returns the number of hits; `kinds` gets the row's packed child kinds.
template <class Tab>
__device__ __forceinline__ int child_keys(const Tab &tab, int link,
                                          const Ray &r, float t,
                                          unsigned long long *e, int &kinds) {
  const float4 *r4 = tab.node(link);
  float4 q[15];  // lanes 0..59: head, 8 boxes, child links / kinds
#pragma unroll
  for (int i = 0; i < 15; ++i) q[i] = __ldg(r4 + i);
  int lnk[WIDE];
  tab.children(q, lnk, kinds);
  int n_hit = 0;
#pragma unroll
  for (int c = 0; c < WIDE; ++c) {
    e[c] = ~0ull;
    if (((kinds >> (2 * c)) & 3) == KIND_EMPTY) continue;
    const int s = 2 + 6 * c;
    const float t1x = (lane(q, s + 0) - r.ox) * r.ix;
    const float t2x = (lane(q, s + 3) - r.ox) * r.ix;
    const float t1y = (lane(q, s + 1) - r.oy) * r.iy;
    const float t2y = (lane(q, s + 4) - r.oy) * r.iy;
    const float t1z = (lane(q, s + 2) - r.oz) * r.iz;
    const float t2z = (lane(q, s + 5) - r.oz) * r.iz;
    const float tn = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                           fminf(t1z, t2z));
    const float tf = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                           fmaxf(t1z, t2z));
    const float k = fmaxf(tn, 0.0f);
    if ((tn < tf) && (tf > 0.0f) && (tn < t) && (k < BIG_T)) {
      // clearing the sign bit maps -0 to +0, which compare equal as floats
      const unsigned kb = __float_as_uint(k) & 0x7fffffffu;
      e[c] = ((unsigned long long)kb << 32) |
             ((unsigned long long)c << LINK_BITS) |
             ((unsigned)lnk[c] & LINK_MASK);
      ++n_hit;
    }
  }
  return n_hit;
}

// Moller-Trumbore of triangle k (9 floats a, e1, e2 at q) against the best
// hit so far
__device__ __forceinline__ bool tri_test(const float *q, int k, int count,
                                         int tri_base, int inst, const Ray &r,
                                         Best &b) {
  const float ax = q[0], ay = q[1], az = q[2];
  const float e1x = q[3], e1y = q[4], e1z = q[5];
  const float e2x = q[6], e2y = q[7], e2z = q[8];
  const float pvx = r.dy * e2z - r.dz * e2y;
  const float pvy = r.dz * e2x - r.dx * e2z;
  const float pvz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  bool ok = (det <= -TRI_EPS) || (det >= TRI_EPS);
  const float inv_det = 1.0f / (ok ? det : 1.0f);
  const float tvx = r.ox - ax, tvy = r.oy - ay, tvz = r.oz - az;
  const float v = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  ok = ok && (v >= 0.0f) && (v <= 1.0f);
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float w = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv_det;
  ok = ok && (w >= 0.0f) && (v + w <= 1.0f);
  const float t_new = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  ok = ok && (t_new >= TRI_EPS) && (b.t >= t_new) && (k < count);
  if (ok) {
    b.t = t_new;
    b.prim = inst;
    b.tri = tri_base + k;
    b.bv = v;
    b.bw = w;
  }
  return ok;
}

// A triangle leaf: lanes 0-3 (kind, count, tri_base, prim), then triangle k
// at lanes 8 + 9k, read as float4 groups of four triangles (nine float4,
// clipped to the row), only the groups that hold one of the count
// triangles.  Returns whether a triangle was accepted.
template <class Tab>
__device__ __forceinline__ bool leaf_step(const Tab &tab, int link,
                                          const Ray &r, Best &b,
                                          unsigned long long &tests) {
  const float4 *l4 = tab.leaf(link);
  const float4 head = __ldg(l4);
  const int count = (int)head.y;
  const int tri_base = (int)head.z;
  const int inst = (int)head.w;
  if (inst == r.ign) return false;
  tests += (unsigned long long)min(count, Tab::LEAF_K);
  bool any = false;
#pragma unroll
  for (int g = 0; 4 * g < Tab::LEAF_K; ++g) {
    if (4 * g >= count) break;
    float f[36];
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const int at = 2 + 9 * g + i;
      const float4 v = at < Tab::LEAF_F4 ? __ldg(l4 + at)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
      f[4 * i + 0] = v.x;
      f[4 * i + 1] = v.y;
      f[4 * i + 2] = v.z;
      f[4 * i + 3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = 4 * g + kk;
      if (k < Tab::LEAF_K)
        any = tri_test(f + 9 * kk, k, count, tri_base, inst, r, b) || any;
    }
  }
  return any;
}

// An analytic prim row: lanes 1 id, 2 type, 4..15 inverse transform,
// 16 sphere radius, 17..19 box half extents.  Returns whether it was hit.
template <class Tab>
__device__ __forceinline__ bool prim_step(const Tab &tab, int link,
                                          const Ray &r, Best &b) {
  const float4 *r4 = tab.node(link);
  float f[20];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float4 v = __ldg(r4 + i);
    f[4 * i + 0] = v.x;
    f[4 * i + 1] = v.y;
    f[4 * i + 2] = v.z;
    f[4 * i + 3] = v.w;
  }
  const int prim_id = (int)f[1];
  const int ptype = (int)f[2];
  const float *m = f + 4;
  const float so_x = m[0] * r.ox + m[1] * r.oy + m[2] * r.oz + m[3];
  const float so_y = m[4] * r.ox + m[5] * r.oy + m[6] * r.oz + m[7];
  const float so_z = m[8] * r.ox + m[9] * r.oy + m[10] * r.oz + m[11];
  const float sd_x = m[0] * r.dx + m[1] * r.dy + m[2] * r.dz;
  const float sd_y = m[4] * r.dx + m[5] * r.dy + m[6] * r.dz;
  const float sd_z = m[8] * r.dx + m[9] * r.dy + m[10] * r.dz;
  bool hit;
  float t_new;
  if (ptype == PRIM_SPHERE) {
    const float rad = f[16];
    const float a = sd_x * sd_x + sd_y * sd_y + sd_z * sd_z;
    const float bb = sd_x * so_x + sd_y * so_y + sd_z * so_z;
    const float c = (so_x * so_x + so_y * so_y + so_z * so_z) - rad * rad;
    const float discr = bb * bb - a * c;
    const float root = sqrtf(fmaxf(discr, 0.0f));
    const float inv_a = 1.0f / fmaxf(a, 1e-30f);
    const float tn = (-bb - root) * inv_a;
    const float tf = (-bb + root) * inv_a;
    t_new = tn >= 0.0f ? tn : tf;
    hit = (discr >= 0.0f) && (t_new >= EPSILON) && (b.t > t_new);
  } else {
    const float ix = safe_inv(sd_x), iy = safe_inv(sd_y), iz = safe_inv(sd_z);
    const float nx = ix * so_x, ny = iy * so_y, nz = iz * so_z;
    const float kx = fabsf(ix) * f[17], ky = fabsf(iy) * f[18],
                kz = fabsf(iz) * f[19];
    const float tn = fmaxf(fmaxf(-nx - kx, -ny - ky), -nz - kz);
    const float tf = fminf(fminf(-nx + kx, -ny + ky), -nz + kz);
    t_new = tn >= 0.0f ? tn : tf;
    hit = (tn < tf) && (b.t > t_new) && (t_new >= EPSILON);
  }
  if (hit && prim_id != r.ign) {
    b.t = t_new;
    b.prim = prim_id;
    b.tri = -1;
    return true;
  }
  return false;
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(FULL, v, off);
  return v;
}

// ---- the persistent walk -------------------------------------------------

// Every warp-collective call below is reached by all 32 lanes with a full
// mask: the loop's exits and the refill loop's condition are warp-uniform.
template <class Tab, bool OCC>
__device__ __forceinline__ void run(const Tab &tab, const Args &a) {
  const int lane_id = threadIdx.x & 31;
  const unsigned below = (1u << lane_id) - 1u;
  int2 stk[STACK];  // entries (link * 4 + kind, key bits)
  const int root_kind = (int)__ldg(tab.node(0)).x;
  Ray r = {};
  Best b = {0.0f, 0.0f, 0.0f, -1, -1};
  int ray = -1;  // this lane's ray index, -1: idle
  int sp = 0;
  int link = 0, kind = 0;  // the popped entry, when pending
  bool pending = false, exhausted = false;
  unsigned long long visits = 0, tests = 0, steps = 0;
  for (;;) {
    // ---- refill: idle lanes take the next ray indices ----
    unsigned idle = __ballot_sync(FULL, ray < 0);
    while (!exhausted && __popc(idle) >= REFILL) {
      const int want = __popc(idle);
      int base = 0;
      if (lane_id == 0) base = atomicAdd(a.next, want);
      base = __shfl_sync(FULL, base, 0);
      if (ray < 0) {
        const int i = base + __popc(idle & below);
        if (i < a.n) {
          const float t_in = a.t0[i];
          bool live = t_in >= 0.0f;
          if (live) {
            r.ox = a.ox[i]; r.oy = a.oy[i]; r.oz = a.oz[i];
            r.dx = a.dx[i]; r.dy = a.dy[i]; r.dz = a.dz[i];
            // fminf/fmaxf drop a NaN operand where torch.minimum/maximum
            // keep it; a NaN ray hits nothing, so it skips the walk
            live = !(isnan(r.ox) || isnan(r.oy) || isnan(r.oz) ||
                     isnan(r.dx) || isnan(r.dy) || isnan(r.dz));
          }
          if (live) {
            ray = i;
            r.ign = a.ign[i];
            r.ix = safe_inv(r.dx);
            r.iy = safe_inv(r.dy);
            r.iz = safe_inv(r.dz);
            b = Best{t_in, 0.0f, 0.0f, -1, -1};
            stk[0] = make_int2(root_kind, 0);  // root: link 0, key 0
            sp = 1;
          } else {
            a.t_out[i] = t_in;
            a.prim_out[i] = -1;
            a.tri_out[i] = -1;
            a.bv_out[i] = 0.0f;
            a.bw_out[i] = 0.0f;
          }
        }
      }
      exhausted = base + want >= a.n;
      idle = __ballot_sync(FULL, ray < 0);
    }
    if (idle == FULL) break;  // the counter is spent and every lane is idle

    // ---- pop: entries entered before a nearer hit are dropped ----
    if (ray >= 0 && !pending) {
      while (sp > 0) {
        const int2 e = stk[--sp];
        if (__int_as_float(e.y) < b.t) {
          link = e.x >> 2;
          kind = e.x & 3;
          pending = true;
          break;
        }
      }
      if (!pending) {  // the walk is done
        a.t_out[ray] = b.t;
        a.prim_out[ray] = b.prim;
        a.tri_out[ray] = b.tri;
        a.bv_out[ray] = b.bv;
        a.bw_out[ray] = b.bw;
        ray = -1;
      }
    }
    const unsigned inner = __ballot_sync(FULL, pending && kind == KIND_INTERNAL);
    const unsigned want = __ballot_sync(FULL, pending);
    if (want == 0) continue;
    ++steps;
    // the kind most pending lanes want steps; the others wait
    const bool run_inner = 2 * __popc(inner) >= __popc(want);

    // ---- an internal step: sorted pushes, nearest on top ----
    if (run_inner && pending && kind == KIND_INTERNAL) {
      pending = false;
      ++visits;
      unsigned long long e[WIDE];
      int kinds;
      const int n_hit = child_keys(tab, link, r, b.t, e, kinds);
      sort8(e);
#pragma unroll
      for (int j = 0; j < WIDE; ++j) {
        if (j < n_hit) {
          const unsigned lo = (unsigned)e[j];
          const int slot = (int)(lo >> LINK_BITS);
          const int l = (int)(lo << (32 - LINK_BITS)) >> (32 - LINK_BITS);
          const int k = (kinds >> (2 * slot)) & 3;
          stk[sp + n_hit - 1 - j] =
              make_int2(l * 4 + k, (int)(unsigned)(e[j] >> 32));
        }
      }
      sp += n_hit;
    }

    // ---- a leaf or prim step ----
    if (!run_inner && pending && kind != KIND_INTERNAL) {
      pending = false;
      ++visits;
      bool hit = false;
      if (kind == KIND_TRIS)
        hit = leaf_step(tab, link, r, b, tests);
      else if (kind == KIND_PRIM)
        hit = prim_step(tab, link, r, b);
      if (OCC && hit) sp = 0;  // any-hit: the walk ends
    }
  }
  visits = warp_sum(visits);
  tests = warp_sum(tests);
  if (lane_id == 0) {
    if (visits | tests) {
      atomicAdd(a.stats + 0, visits);
      atomicAdd(a.stats + 1, tests);
    }
    if (a.steps != nullptr && steps) atomicAdd(a.steps, steps);
  }
}

#ifndef WALK_HOST_EMULATION
// Blocks of THREADS that fit on the card at once: SM count x the occupancy
// query for `kernel`; 0 on an error.
template <class K>
int resident_blocks(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                    0) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

template <class Tab>
int launch(void (*kernel)(Tab, Args), const Tab &tab, const Args &a,
           int blocks, void *stream) {
  if (a.n <= 0) return (int)cudaSuccess;
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(tab, a);
  return (int)cudaGetLastError();
}
#endif

inline Args make_args(int n, const void *ox, const void *oy, const void *oz,
                      const void *dx, const void *dy, const void *dz,
                      const void *t0, const void *ign, void *t_out,
                      void *prim_out, void *tri_out, void *bv_out,
                      void *bw_out, void *stats, void *next, void *steps) {
  Args a;
  a.ox = (const float *)ox;
  a.oy = (const float *)oy;
  a.oz = (const float *)oz;
  a.dx = (const float *)dx;
  a.dy = (const float *)dy;
  a.dz = (const float *)dz;
  a.t0 = (const float *)t0;
  a.ign = (const int *)ign;
  a.n = n;
  a.t_out = (float *)t_out;
  a.prim_out = (int *)prim_out;
  a.tri_out = (int *)tri_out;
  a.bv_out = (float *)bv_out;
  a.bw_out = (float *)bw_out;
  a.stats = (unsigned long long *)stats;
  a.next = (int *)next;
  a.steps = (unsigned long long *)steps;
  return a;
}

}  // namespace walk
