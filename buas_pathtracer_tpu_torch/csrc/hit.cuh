// The hit record of one lane of a closest-hit query, which csrc/hit.cu
// launches after the walk: the hit id, material id and triangle, the hit
// point and the deferred normal (reference intersection.cpp:526-591).  The
// plain version is ops/hit_kernel.py hit_record_plain; each line here is one
// of its PyTorch ops, in its order and in its float32 arithmetic as the
// card's PyTorch runs it (shade.cuh's rules): no fused multiply-add (the
// library is built with -fmad=false), IEEE division, a Python scalar rounded
// to float32, clamp propagating NaN, torch.sign as (0 < v) - (v < 0), and
// normalize-or-zero's rsqrt as rsqrtf, PyTorch's CUDA rsqrt.
//
// Where the plain version computes every candidate normal for every lane
// from rows clamped to row 0 and selects, a lane here reads the one row its
// hit needs: a mesh hit its wtri_nrm16 row, an analytic hit its prim_nrm16
// row, a plane win its plane's normal; a miss or a dead lane reads none and
// its normal is (0, 0, 0) (the plain version's is row 0's, which no caller
// reads: Hit.n is defined where hit_id >= 0).  Every other field equals the
// plain version's on every lane.
//
// The header compiles with g++ as well (no __CUDACC__; lane.cuh), so the CPU
// tests can run its logic against the plain version (tests/hit_host/).

#pragma once

#include "lane.cuh"

namespace hit {

using lane::clamp_min;
using lane::ld64;

constexpr int ROW = 16;  // prim_nrm16 and wtri_nrm16 row width
// models/scene.py prim_nrm16 rows: [inverse12 (row-major 3x4) | box_r3 |
// type]
constexpr int PRIM_BOX_R = 12;
constexpr int PRIM_TYPE = 15;
// wtri_nrm16 rows: [na3 | nb3 | nc3 | ng3 | has_n | 0 0 0], world space
constexpr int TRI_NA = 0;
constexpr int TRI_NB = 3;
constexpr int TRI_NC = 6;
constexpr int TRI_NG = 9;
constexpr int TRI_HAS_N = 12;
constexpr int64_t PRIM_SPHERE = 2;  // models/scene.py PRIM_SPHERE

constexpr float BOX_R_MIN = (float)1e-30;  // clamp(box_r, min=1e-30)
constexpr float NOZ_MIN = (float)1e-24;    // core/vec.py noz
constexpr float HALF = (float)0.5;         // the has_n test

// Everything the kernel reads and writes, by value: pointers and 64-bit
// integers only, in the order of ops/hit_kernel.py's HitArgs.
struct Args {
  int64_t n, n_prims;
  // the rays, as the walk read them
  const float *o[3], *d[3];
  // the walk's outputs, as it wrote them, and the plane pass's winner
  const float *t, *bv, *bw;
  const int32_t *prim, *tri;
  const int64_t *plane_idx;
  // scene tables
  const float *prim_nrm16, *wtri_nrm16, *plane_n[3];
  const int64_t *prim_mat, *plane_mat;
  // the record
  int64_t *hit_id, *mat_id, *hit_tri;
  float *p[3], *nrm[3];
};

// one 64-byte row, as four 16-byte loads through the read-only path
__device__ __forceinline__ void load_row(const float *tab, int64_t r,
                                         float v[ROW]) {
#ifdef __CUDACC__
  const float4 *q = reinterpret_cast<const float4 *>(tab + r * ROW);
#pragma unroll
  for (int k = 0; k < ROW / 4; ++k) {
    const float4 x = __ldg(q + k);
    v[4 * k] = x.x;
    v[4 * k + 1] = x.y;
    v[4 * k + 2] = x.z;
    v[4 * k + 3] = x.w;
  }
#else
  std::memcpy(v, tab + r * ROW, sizeof(float) * ROW);
#endif
}

__device__ __forceinline__ float sign(float v) {
  return (float)((0.0f < v) - (v < 0.0f));
}

// core/vec.py noz: normalize, or zero when |v|^2 is not above 1e-24 or not
// finite
__device__ __forceinline__ void noz(float v[3]) {
  const float lsq = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  const bool ok = lsq > NOZ_MIN && isfinite(lsq);
  const float inv = rsqrtf(ok ? lsq : 1.0f);
  for (int c = 0; c < 3; ++c) v[c] = ok ? v[c] * inv : 0.0f;
}

// a mesh hit: the smooth normal from the barycentrics where the triangle
// has vertex normals, else the geometric one
__device__ __forceinline__ void mesh_normal(const Args &a, int64_t tri,
                                            float bv, float bw, float n[3]) {
  float r[ROW];
  load_row(a.wtri_nrm16, tri, r);
  const float bu = (1.0f - bv) - bw;
  float s[3];
  for (int c = 0; c < 3; ++c)
    s[c] = (r[TRI_NA + c] * bu + r[TRI_NB + c] * bv) + r[TRI_NC + c] * bw;
  noz(s);
  const bool smooth = r[TRI_HAS_N] > HALF;
  for (int c = 0; c < 3; ++c) n[c] = smooth ? s[c] : r[TRI_NG + c];
}

// a sphere or box hit: the object-space normal (the hit point, or the sign
// of the largest |component| of the hit point over the half extents),
// back to world space by the inverse's transpose
__device__ __forceinline__ void analytic_normal(const Args &a, int64_t prim,
                                                const float o[3],
                                                const float d[3], float t,
                                                float n[3]) {
  float m[ROW];
  load_row(a.prim_nrm16, prim, m);
  float os[3], rel[3];
  for (int k = 0; k < 3; ++k) {
    const float *mk = m + 4 * k;
    const float po = ((mk[0] * o[0] + mk[1] * o[1]) + mk[2] * o[2]) + mk[3];
    const float vd = (mk[0] * d[0] + mk[1] * d[1]) + mk[2] * d[2];
    os[k] = po + vd * t;
    rel[k] = os[k] / clamp_min(m[PRIM_BOX_R + k], BOX_R_MIN);
  }
  const float ax = fabsf(rel[0]), ay = fabsf(rel[1]), az = fabsf(rel[2]);
  const bool x_big = ax >= ay && ax >= az;
  const bool y_big = !x_big && ay >= az;
  const float box[3] = {x_big ? sign(rel[0]) : 0.0f,
                        y_big ? sign(rel[1]) : 0.0f,
                        x_big || y_big ? 0.0f : sign(rel[2])};
  const bool sphere = (int64_t)m[PRIM_TYPE] == PRIM_SPHERE;
  const float *v = sphere ? os : box;
  for (int c = 0; c < 3; ++c)
    n[c] = (m[c] * v[0] + m[4 + c] * v[1]) + m[8 + c] * v[2];
  noz(n);
}

__device__ __forceinline__ void record_lane(const Args &a, int64_t i) {
  const float t = a.t[i];
  float o[3], d[3];
  for (int c = 0; c < 3; ++c) {
    o[c] = a.o[c][i];
    d[c] = a.d[c][i];
    a.p[c][i] = o[c] + d[c] * t;
  }
  const int64_t prim = a.prim[i];
  int64_t hit_id = -1, mat = 0, tri = -1;
  float n[3] = {0.0f, 0.0f, 0.0f};
  if (prim >= 0) {
    hit_id = prim;
    mat = ld64(a.prim_mat + prim);
    tri = a.tri[i];
    if (tri >= 0)
      mesh_normal(a, tri, a.bv[i], a.bw[i], n);
    else
      analytic_normal(a, prim, o, d, t, n);
  } else {
    const int64_t pl = a.plane_idx[i];
    if (pl >= 0) {
      hit_id = a.n_prims + pl;
      mat = ld64(a.plane_mat + pl);
      for (int c = 0; c < 3; ++c) n[c] = __ldg(a.plane_n[c] + pl);
    }
  }
  a.hit_id[i] = hit_id;
  a.mat_id[i] = mat;
  a.hit_tri[i] = tri;
  for (int c = 0; c < 3; ++c) a.nrm[c][i] = n[c];
}

}  // namespace hit
