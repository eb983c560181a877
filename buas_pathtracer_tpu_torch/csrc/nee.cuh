// Next-event estimation of one lane of one bounce of the Advanced
// Pathtracer, which csrc/nee.cu launches between shade_hit and the shadow
// walk: the light sample, the environment sample and their shadow queries
// with the plane pass.  The plain version is integrators/advanced.py
// _nee_plain (with integrators/common.py's light pick and light sample,
// ops/envmap.py sample_env_alias and ops/traverse.py _intersect_planes);
// each line here is one of its PyTorch ops, in its order and with the
// arithmetic conventions of shade.cuh.  Its draws keep its order:
// LIGHT_SELECTION, DIRECT_LIGHTING, then ENV_LIGHTING.
//
// A lane alive at the bounce draws whether NEE serves it or not, as the
// plain version does; a dead lane draws nothing.  A wave lane the samples
// do not serve (a dead lane, or one NEE does not serve) gets t0 = -1 and
// its flags byte alone: the walk reads nothing else of a ray with t0 < 0.
//
// The header compiles with g++ as well (tests/shade_host/).

#pragma once

#include "shade.cuh"

namespace shade {

constexpr float PICK_EPS_F = (float)1e-3;  // pick_random_light_slot's
constexpr float HASH_U_F = (float)7193.17;  // ops/envmap.py sample_env_alias
constexpr float HASH_V_F = (float)4021.73;
constexpr float TWO_POW_M32_F = (float)(1.0 / 4294967296.0);

// integrators/common.py pick_random_light_slot: the slot and the pick
// probability.  The importance pick walks the lights three times (the
// total, the running sum against it, the picked weight) rather than keep
// a weight a light: every pass computes each weight the same way.
__device__ __forceinline__ int pick_light(const Args &a, float u, float ix,
                                          float iy, float iz, float &pdf) {
  const int L = (int)a.n_lights;
  if (!a.is_lights || L == 1) {
    int64_t s = (int64_t)(u * (float)L - PICK_EPS_F);
    s = s < 0 ? 0 : (s > L - 1 ? L - 1 : s);
    pdf = (float)(1.0 / (double)L);
    return (int)s;
  }
  float total = 0.0f;
  for (int l = 0; l < L; ++l) {
    const float w = light_weight(a, l, ix, iy, iz);
    total = l == 0 ? w : total + w;
  }
  const float e = total * u;
  float c = 0.0f;
  int slot = 0;
  for (int l = 0; l < L; ++l) {
    const float w = light_weight(a, l, ix, iy, iz);
    c = l == 0 ? w : c + w;
    slot += c < e ? 1 : 0;
  }
  slot = slot > L - 1 ? L - 1 : slot;
  pdf = light_weight(a, slot, ix, iy, iz) / clamp_min(total, CLAMP_W);
  return slot;
}

// ops/envmap.py _hash01
__device__ __forceinline__ float hash01(float x) {
  uint32_t b = __float_as_uint(x);
  b = (b ^ (b >> 16)) * 0x7FEB352Du;
  b = (b ^ (b >> 15)) * 0x846CA68Bu;
  b = b ^ (b >> 16);
  return (float)b * TWO_POW_M32_F;
}

// ops/traverse.py _intersect_planes for one query: the linear plane loop
// in its order.  Returns t, shortened by the nearest plane in front;
// `hit` says whether one was.  A query with t < 0 (or NaN) meets no plane.
__device__ __forceinline__ float plane_pass(const Args &a, const float o[3],
                                            const float d[3], float t,
                                            bool &hit) {
  hit = false;
  if (!(t >= 0.0f)) return t;
  for (int64_t k = 0; k < a.n_planes; ++k) {
    const float nx = __ldg(a.plane_n[0] + k), ny = __ldg(a.plane_n[1] + k),
                nz = __ldg(a.plane_n[2] + k);
    const float denom = nx * d[0] + ny * d[1] + nz * d[2];
    const float safe = denom == 0.0f ? -1.0f : denom;
    const float tp =
        (__ldg(a.plane_d + k) - (nx * o[0] + ny * o[1] + nz * o[2])) / safe;
    if (denom < -EPS_F && tp >= EPS_F && tp < t) {
      t = tp;
      hit = true;
    }
  }
  return t;
}

// One query of the shadow wave at wave lane j: its ray, its t0 after the
// plane pass, its ignored prim and its flags.
__device__ __forceinline__ void write_query(const Args &a, int64_t w,
                                            int64_t j, const float p[3],
                                            const float d[3], float max_t,
                                            int32_t ign, bool facing) {
  float o[3];
  for (int c = 0; c < 3; ++c) {
    o[c] = p[c] + d[c] * EPS_F;
    a.wf[(WF_O + c) * w + j] = o[c];
    a.wf[(WF_D + c) * w + j] = d[c];
  }
  bool plane;
  a.w_t[j] = plane_pass(a, o, d, max_t, plane);
  a.w_ign[j] = ign;
  a.w_flags[j] = (facing ? WB_FACING : 0) | (plane ? WB_PLANE : 0);
}

__device__ __forceinline__ void skip_query(const Args &a, int64_t j) {
  a.w_t[j] = -1.0f;
  a.w_flags[j] = 0;
}

// integrators/common.py random_point_on_light_rows for the picked light,
// then the light's terms and its shadow query
__device__ __forceinline__ void light_sample(const Args &a, int64_t i,
                                             int64_t w, const float p[3],
                                             const float N[3], float su,
                                             float u, float v) {
  const int64_t n = a.n;
  float rcp_pdf;
  const int slot = pick_light(a, su, p[0], p[1], p[2], rcp_pdf);
  const float *row = a.light16 + (int64_t)slot * LIGHT_ROW;
  float tl[3] = {__ldg(row + FWD_TX) - p[0], __ldg(row + FWD_TY) - p[1],
                 __ldg(row + FWD_TZ) - p[2]};
  const float rs = rsqrtf(dot3(tl[0], tl[1], tl[2], tl[0], tl[1], tl[2]));
  const float towards[3] = {-(tl[0] * rs), -(tl[1] * rs), -(tl[2] * rs)};
  // map_to_hemisphere(-towards_light, u, v)
  const float az = u * TAU_F;
  const float sy = sqrtf(clamp_min(1.0f - v * v, 0.0f));
  float nl[3];
  oriented(towards, cosf(az) * sy, v, sinf(az) * sy, nl);
  const float r = __ldg(row + LIGHT_R);
  const float pl[3] = {nl[0] * r, nl[1] * r, nl[2] * r};
  float lv[3];
  for (int c = 0; c < 3; ++c)
    lv[c] = (__ldg(row + 4 * c) * pl[0] + __ldg(row + 4 * c + 1) * pl[1] +
             __ldg(row + 4 * c + 2) * pl[2] + __ldg(row + 4 * c + 3)) -
            p[c];
  const float dist_sq = dot3(lv[0], lv[1], lv[2], lv[0], lv[1], lv[2]);
  const float dist = sqrtf(dist_sq);
  const float cd = clamp_min(dist, CLAMP_W);
  const float L[3] = {lv[0] / cd, lv[1] / cd, lv[2] / cd};
  const float n_dot_l = dot3(N[0], N[1], N[2], L[0], L[1], L[2]);
  const float nl_dot_l = -dot3(nl[0], nl[1], nl[2], L[0], L[1], L[2]);
  const bool facing = n_dot_l > 0.0f && nl_dot_l > 0.0f;
  float *nf = a.nf + i;
  nf[NF_NDL * n] = n_dot_l;
  nf[NF_NLDL * n] = nl_dot_l;
  nf[NF_AREA * n] = TAU_F * r * r;
  nf[NF_DSQ * n] = dist_sq;
  nf[NF_RCP * n] = rcp_pdf;
  a.nslot[i] = slot;
  write_query(a, w, i, p, L, facing ? dist - TWO_EPS_F : -1.0f,
              (int32_t)ld64(a.light_prim + slot), facing);
}

// ops/envmap.py sample_env_alias, then the environment's terms and its
// shadow query at wave lane j
__device__ __forceinline__ void env_sample(const Args &a, int64_t i,
                                           int64_t w, int64_t j,
                                           const float p[3], const float N[3],
                                           float u, float v) {
  const int64_t n = a.n;
  const int64_t k = a.env_h * a.env_w;
  int64_t idx = (int64_t)(u * (float)k);
  idx = idx < 0 ? 0 : (idx > k - 1 ? k - 1 : idx);
  if (!(v < __ldg(a.env_alias_prob + idx))) idx = ld64(a.env_alias_idx + idx);
  const int64_t row = idx / a.env_w;
  const int64_t col = idx - row * a.env_w;
  const float du = hash01(u * HASH_U_F + v);
  const float dv = hash01(v * HASH_V_F - u);
  // _texel_direction: a division by a Python int is a product with its
  // float reciprocal
  const float vv = ((float)row + dv) * (1.0f / (float)a.env_h);
  const float uu = ((float)col + du) * (1.0f / (float)a.env_w);
  const float phi = (uu - 0.5f) * TAU_F;
  const float theta = (vv - 0.5f) * PI_F;
  const float cos_t = cosf(theta);
  const float d[3] = {cos_t * cosf(phi), sinf(theta), cos_t * sinf(phi)};
  const float n_dot_e = dot3(N[0], N[1], N[2], d[0], d[1], d[2]);
  const bool facing = n_dot_e > 0.0f;
  float *nf = a.nf + i;
  nf[NF_NDE * n] = n_dot_e;
  nf[NF_PDFE * n] = __ldg(a.env_pdf_num + idx) / clamp_min(cos_t, CLAMP_COS);
  const float *px = a.env_pixels + idx * 3;
  for (int c = 0; c < 3; ++c) nf[(NF_RADE + c) * n] = __ldg(px + c);
  write_query(a, w, j, p, d, facing ? BIG_T_F : -1.0f, -1, facing);
}

// One lane of next-event estimation.
__device__ __forceinline__ void nee_lane(const Args &a, int64_t i) {
  const int64_t n = a.n;
  const int64_t w = (a.nee + a.env_nee) * n;  // the wave's lanes
  const int64_t e = a.nee ? n + i : i;        // the env query's wave lane
  if (!a.alive[i]) {
    if (a.nee) skip_query(a, i);
    if (a.env_nee) skip_query(a, e);
    return;
  }
  uint32_t s = (uint32_t)a.rng[i];
  if (!a.si[SI_NEE * n + i]) {
    // the draws alone: LIGHT_SELECTION and DIRECT_LIGHTING, ENV_LIGHTING
    const int draws = (a.nee ? 3 : 0) + (a.env_nee ? 2 : 0);
    for (int k = 0; k < draws; ++k) s = xorshift(s);
    if (a.nee) skip_query(a, i);
    if (a.env_nee) skip_query(a, e);
    a.rng[i] = (int64_t)s;
    return;
  }
  const float N[3] = {a.sf[(SF_N + 0) * n + i], a.sf[(SF_N + 1) * n + i],
                      a.sf[(SF_N + 2) * n + i]};
  const float p[3] = {__ldg(a.p[0] + i), __ldg(a.p[1] + i),
                      __ldg(a.p[2] + i)};
  if (a.nee) {
    const float su = draw_1d(a, s, DIM_SELECT, i);
    float u, v;
    draw_2d(a, s, DIM_DIRECT, i, u, v);
    light_sample(a, i, w, p, N, su, u, v);
  }
  if (a.env_nee) {
    float u, v;
    draw_2d(a, s, DIM_ENV, i, u, v);
    env_sample(a, i, w, e, p, N, u, v);
  }
  a.rng[i] = (int64_t)s;
}

}  // namespace shade
