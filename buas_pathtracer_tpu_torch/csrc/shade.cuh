// The shading of one lane of one bounce of the Advanced Pathtracer, in the
// two halves that csrc/shade.cu launches around next-event estimation:
// shade_hit_lane (after the closest-hit walk) and shade_next_lane (after the
// shadow walk).  The plain version is integrators/advanced.py
// _shade_hit_plain and _shade_next_plain; each line here is one of its
// PyTorch ops, in its order and in its float32 arithmetic as the card's
// PyTorch runs it:
//  - no fused multiply-add (the library is built with -fmad=false), IEEE
//    division and sqrtf, and expf, sinf, cosf, atan2f, asinf and powf;
//  - a tensor divided by a Python scalar c is multiplied by the float
//    reciprocal 1.0f / (float)c (PyTorch's CUDA division does so);
//    `c / tensor` is reciprocal(tensor) * (float)c (Tensor.__rtruediv__);
//  - a Python scalar is rounded to float32 as PyTorch rounds it: the
//    constants below are (float) of the double the Python expression makes;
//  - clamp and maximum propagate NaN as PyTorch's do;
//  - normalize is a * rsqrtf(dot(a, a)), PyTorch's CUDA rsqrt.
// The RNG draws keep the plain version's order: REFLECTANCE, the three fuzz
// draws, [the NEE draws, in PyTorch], INDIRECT_LIGHTING, ROULETTE.
//
// The header compiles with g++ as well (no __CUDACC__; lane.cuh), so the CPU
// tests can run its logic against the plain version (tests/shade_host/).

#pragma once

#include "lane.cuh"

namespace shade {

using lane::clamp_min;
using lane::ld64;

constexpr int STACK_DEPTH = 8;  // integrators/advanced.py STACK_DEPTH

// models/scene.py mat16 rows: [albedo3 | emission3 | absorb3 | checker3 |
// ior, metallic, roughness, code], code = flags + 8 * is_medium
constexpr int MAT_ALBEDO = 0;
constexpr int MAT_EMISSION = 3;
constexpr int MAT_ABSORB = 6;
constexpr int MAT_CHECKER = 9;
constexpr int MAT_IOR = 12;
constexpr int MAT_METALLIC = 13;
constexpr int MAT_ROUGHNESS = 14;
constexpr int MAT_CODE = 15;
constexpr int MAT_ROW = 16;
constexpr int CODE_CHECKERS = 0x2;  // models/materials.py FLAG_CHECKERS
constexpr int CODE_EMISSIVE = 0x4;  // FLAG_EMISSIVE
constexpr int CODE_MEDIUM = 8;      // 8 * is_participating_medium
// models/scene.py light16 rows: [fwd12 | r | emission3]
constexpr int LIGHT_R = 12;
constexpr int LIGHT_EMISSION = 13;
constexpr int LIGHT_ROW = 16;
// prim_fwd rows: the (3, 4) forward transform, row-major
constexpr int FWD_ROW = 12;
constexpr int FWD_TX = 3;
constexpr int FWD_TY = 7;
constexpr int FWD_TZ = 11;
constexpr int64_t PRIM_SPHERE = 2;  // models/scene.py PRIM_SPHERE

// core/sampler.py Strategy and SampleDimension
constexpr int64_t BLUE_NOISE = 1;
constexpr int64_t STRATIFIED = 2;
constexpr int DIM_INDIRECT = 1;
constexpr int DIM_REFLECTANCE = 3;
constexpr int DIM_ROULETTE = 6;

// the branch a lane continues with (scratch row SI_CODE)
constexpr uint8_t BR_NONE = 0;  // dead, missed or emissive: the path ends
constexpr uint8_t BR_REFLECT = 1;
constexpr uint8_t BR_REFRACT = 2;
constexpr uint8_t BR_DIFFUSE = 3;
// scratch rows between the kernels: float (SF_ROWS, n), uint8 (SI_ROWS, n)
constexpr int SF_N = 0;     // the oriented normal
constexpr int SF_BRDF = 3;  // diffuse: albedo / pi
constexpr int SF_O = 6;     // reflect / refract: the new ray
constexpr int SF_D = 9;
constexpr int SF_TINT = 12;  // reflect: the tint
constexpr int SF_ROWS = 15;
constexpr int SI_CODE = 0;
constexpr int SI_NEE = 1;  // bool: the lanes NEE serves (BR_DIFFUSE)
constexpr int SI_ROWS = 2;

constexpr double PI_D = 3.141592653589793;  // core/vec.py PI
constexpr float PI_F = (float)PI_D;
constexpr float TAU_F = (float)(2.0 * PI_D);       // TAU, 2.0 * PI
constexpr float RCP_PI_F = 1.0f / (float)PI_D;     // tensor / PI
constexpr float INV_PI_F = (float)(1.0 / PI_D);    // tensor * (1.0 / PI)
constexpr float INV_2PI_F = (float)(1.0 / (2.0 * PI_D));
constexpr float HALF_INV_PI_F = (float)(0.5 / PI_D);
constexpr float EPS_F = (float)0.001;  // core/vec.py EPSILON
constexpr float ONE_PLUS_EPS_F = (float)(1.0 + 0.001);
constexpr float THIRD_F = (float)(1.0 / 3.0);
constexpr float CLAMP_PDF = (float)1e-12;
constexpr float CLAMP_W = (float)1e-30;
constexpr float CLAMP_ETA = (float)1e-6;
constexpr float CLAMP_COS = (float)1e-8;
constexpr float RR_LO = (float)0.1;
constexpr float RR_HI = (float)0.9;

// Everything both kernels read and write, by value: pointers and 64-bit
// integers only, in the order of ops/shade_kernel.py's ShadeArgs.
struct Args {
  // lanes, flags (integrators/advanced.py _Flags) and sizes
  int64_t n, bounce, strategy, nee, env_nee, use_mis, is_lights, is_diffuse,
      rr, caustics, ref_mis, has_env, n_lights, env_h, env_w;
  // scene tables
  const float *mat16;
  const int64_t *light_prim;
  const float *light16, *prim_fwd;
  const int64_t *prim_mat;
  const float *prim_r;
  const int64_t *prim_type;
  const float *mat_emission[3], *sky_bot[3], *sky_top[3], *env_pixels,
      *env_pdf_num;
  // the loop's state, updated in place
  uint8_t *alive, *is_spec;
  float *o[3], *d[3], *tp[3], *total[3], *prev_n[3];
  int64_t *rng, *stack, stack_stride, *stack_at;
  const float *pre;  // first-bounce bases, (2 x 8, pre_stride)
  int64_t pre_stride;
  // the closest hit
  const int64_t *hit_id, *mat_id;
  const float *t, *p[3], *n_hit[3];
  const int64_t *node_visits, *tri_tests;
  // stats (3,) float32, updated in place; counters (3,) zeroed between
  // launches: two counts and the blocks done
  float *stats;
  unsigned long long *counters;
  // scratch between the kernels
  float *sf;
  uint8_t *si;
  // next-event estimation's results (shade_next; NEE's draws are in rng)
  const uint8_t *facing, *occluded;
  const float *nl_dot_l, *area, *dist_sq, *rcp_pdf, *n_dot_l;
  const int64_t *slot;
  const uint8_t *facing_e, *occluded_e;
  const float *n_dot_e, *pdf_e, *rad_e[3];
};

__device__ __forceinline__ float clamp_to(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float recip(float v) { return 1.0f / v; }

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

__device__ __forceinline__ int64_t floor_mod(int64_t a, int64_t b) {
  int64_t r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// core/rng.py xorshift32 and bits_to_unilateral
__device__ __forceinline__ uint32_t xorshift(uint32_t s) {
  s ^= s << 13;
  s ^= s >> 17;
  s ^= s << 5;
  return s;
}

__device__ __forceinline__ float unilateral(uint32_t s) {
  return __uint_as_float(0x3F800000u | (s >> 9)) - 1.0f;
}

// core/sampler.py sample_1d / sample_2d: white noise after bounce 0;
// at bounce 0 the first-bounce bases of the pass (the wrapper checks they
// exist when the strategy needs them)
__device__ __forceinline__ float draw_1d(const Args &a, uint32_t &s, int dim,
                                         int64_t i) {
  s = xorshift(s);
  const float ju = unilateral(s);
  if (a.bounce != 0 || (a.strategy != BLUE_NOISE && a.strategy != STRATIFIED))
    return ju;
  const float *b = a.pre + 2 * dim * a.pre_stride + i;
  if (a.strategy == BLUE_NOISE) return __ldg(b);
  return (__ldg(b) * 0.125f + __ldg(b + a.pre_stride)) + ju * 0.015625f;
}

__device__ __forceinline__ void draw_2d(const Args &a, uint32_t &s, int dim,
                                        int64_t i, float &u, float &v) {
  s = xorshift(s);
  const float ju = unilateral(s);
  s = xorshift(s);
  const float jv = unilateral(s);
  if (a.bounce != 0 ||
      (a.strategy != BLUE_NOISE && a.strategy != STRATIFIED)) {
    u = ju;
    v = jv;
    return;
  }
  const float *b = a.pre + 2 * dim * a.pre_stride + i;
  if (a.strategy == BLUE_NOISE) {
    u = __ldg(b);
    v = __ldg(b + a.pre_stride);
  } else {
    u = __ldg(b) + ju * 0.125f;
    v = __ldg(b + a.pre_stride) + jv * 0.125f;
  }
}

// ops/envmap.py: the texel coordinates of a direction
__device__ __forceinline__ void env_uv(float dx, float dy, float dz, float &u,
                                       float &v, float &theta) {
  const float phi = atan2f(dz, dx);
  theta = asinf(clamp_to(dy, -1.0f, 1.0f));
  u = phi * HALF_INV_PI_F + 0.5f;
  v = theta * INV_PI_F + 0.5f;
}

// integrators/common.py sample_sky: ops/envmap.py lookup_env, or the
// gradient sky (ops/shading.py sample_sky_gradient)
__device__ __forceinline__ void sample_sky(const Args &a, float dx, float dy,
                                           float dz, float sky[3]) {
  if (a.has_env) {
    float u, v, theta;
    env_uv(dx, dy, dz, u, v, theta);
    const int64_t x = floor_mod((int64_t)(u * (float)a.env_w), a.env_w);
    const int64_t y = floor_mod((int64_t)(v * (float)a.env_h), a.env_h);
    const float *px = a.env_pixels + (y * a.env_w + x) * 3;
    for (int c = 0; c < 3; ++c) sky[c] = __ldg(px + c);
    return;
  }
  const float t = fabsf(dy);
  for (int c = 0; c < 3; ++c) {
    const float bot = __ldg(a.sky_bot[c]);
    sky[c] = bot + (__ldg(a.sky_top[c]) - bot) * t;
  }
}

// ops/envmap.py env_pdf_table
__device__ __forceinline__ float env_pdf(const Args &a, float dx, float dy,
                                         float dz) {
  float u, v, theta;
  env_uv(dx, dy, dz, u, v, theta);
  int64_t row = (int64_t)(v * (float)a.env_h);
  int64_t col = (int64_t)(u * (float)a.env_w);
  row = row < 0 ? 0 : (row > a.env_h - 1 ? a.env_h - 1 : row);
  col = col < 0 ? 0 : (col > a.env_w - 1 ? a.env_w - 1 : col);
  return __ldg(a.env_pdf_num + row * a.env_w + col) /
         clamp_min(cosf(theta), CLAMP_COS);
}

// integrators/common.py _light_pdfs: light l's unnormalised pick weight
__device__ __forceinline__ float light_weight(const Args &a, int l, float ix,
                                              float iy, float iz) {
  const int64_t lp = ld64(a.light_prim + l);
  const float *fwd = a.prim_fwd + lp * FWD_ROW;
  const float vx = __ldg(fwd + FWD_TX) - ix;
  const float vy = __ldg(fwd + FWD_TY) - iy;
  const float vz = __ldg(fwd + FWD_TZ) - iz;
  const float dist_sq = vx * vx + vy * vy + vz * vz;
  const int64_t m = ld64(a.prim_mat + lp);
  const float lmax = maximum(__ldg(a.mat_emission[0] + m),
                             maximum(__ldg(a.mat_emission[1] + m),
                                     __ldg(a.mat_emission[2] + m)));
  const float r = __ldg(a.prim_r + lp);
  const float sph = ld64(a.prim_type + lp) == PRIM_SPHERE ? 1.0f : 0.0f;
  return lmax * sph * PI_F * (r * r) / clamp_min(dist_sq, CLAMP_PDF);
}

// integrators/common.py light_pick_pdf
__device__ __forceinline__ float light_pick_pdf(const Args &a, float ix,
                                                float iy, float iz,
                                                int64_t hit_id) {
  const int L = (int)a.n_lights;
  if (!a.is_lights || L == 1) return (float)(1.0 / (double)L);
  float total = 0.0f, picked = 0.0f;
  for (int l = 0; l < L; ++l) {
    const float w = light_weight(a, l, ix, iy, iz);
    total = l == 0 ? w : total + w;
    picked = picked + w * (ld64(a.light_prim + l) == hit_id ? 1.0f : 0.0f);
  }
  return picked / clamp_min(total, CLAMP_W);
}

// integrators/common.py light_radius_of_prim
__device__ __forceinline__ float light_radius(const Args &a, int64_t hit_id) {
  float r = 0.0f;
  for (int l = 0; l < (int)a.n_lights; ++l)
    if (hit_id == ld64(a.light_prim + l))
      r = __ldg(a.light16 + l * LIGHT_ROW + LIGHT_R);
  return r;
}

// core/vec.py oriented_around_normal (get_tangents) of a local vector
__device__ __forceinline__ void oriented(const float n[3], float vx, float vy,
                                         float vz, float out[3]) {
  const float sign = n[2] >= 0.0f ? 1.0f : -1.0f;
  const float a = recip(sign + n[2]) * -1.0f;
  const float b = n[0] * n[1] * a;
  const float t[3] = {sign * n[0] * n[0] * a + 1.0f, sign * b, -sign * n[0]};
  const float bb[3] = {b, sign + n[1] * n[1] * a, -n[1]};
  for (int c = 0; c < 3; ++c) out[c] = bb[c] * vx + n[c] * vy + t[c] * vz;
}

// One lane after the closest hit.  Returns whether the lane is alive (for
// the rays count).  A dead lane only gets BR_NONE.
__device__ __forceinline__ bool shade_hit_lane(const Args &a, int64_t i) {
  const int64_t n = a.n;
  uint8_t *code_out = a.si + SI_CODE * n + i;
  uint8_t *nee_out = a.si + SI_NEE * n + i;
  if (!a.alive[i]) {
    *code_out = BR_NONE;
    *nee_out = 0;
    return false;
  }
  const float d[3] = {a.d[0][i], a.d[1][i], a.d[2][i]};
  float tp[3] = {a.tp[0][i], a.tp[1][i], a.tp[2][i]};
  float total[3] = {a.total[0][i], a.total[1][i], a.total[2][i]};
  const bool is_spec = a.is_spec[i] != 0;
  uint32_t s = (uint32_t)a.rng[i];
  const int64_t hit_id = ld64(a.hit_id + i);
  const float *prev_n_f[3] = {a.prev_n[0], a.prev_n[1], a.prev_n[2]};

  if (hit_id < 0) {
    // ---- miss: sky, terminate ----
    float sky[3];
    sample_sky(a, d[0], d[1], d[2], sky);
    if (a.env_nee) {
      float w;
      if (a.use_mis) {
        const float e_pdf = env_pdf(a, d[0], d[1], d[2]);
        if (a.is_diffuse) {
          const float bp =
              clamp_min(dot3(prev_n_f[0][i], prev_n_f[1][i], prev_n_f[2][i],
                             d[0], d[1], d[2]),
                        0.0f) *
              RCP_PI_F;
          w = bp / clamp_min(bp + e_pdf, CLAMP_W);
        } else {
          w = recip(clamp_min(e_pdf + INV_2PI_F, CLAMP_W)) * INV_2PI_F;
        }
        if (is_spec) w = 1.0f;
      } else {
        w = is_spec ? 1.0f : 0.0f;
      }
      for (int c = 0; c < 3; ++c)
        a.total[c][i] = total[c] + tp[c] * sky[c] * w;
    } else {
      for (int c = 0; c < 3; ++c) a.total[c][i] = total[c] + tp[c] * sky[c];
    }
    // the REFLECTANCE and fuzz draws
    for (int k = 0; k < 4; ++k) s = xorshift(s);
    a.rng[i] = (int64_t)s;
    *code_out = BR_NONE;
    *nee_out = 0;
    return true;
  }

  // ---- orientation and the stack's materials ----
  const float hn[3] = {__ldg(a.n_hit[0] + i), __ldg(a.n_hit[1] + i),
                       __ldg(a.n_hit[2] + i)};
  const float p[3] = {__ldg(a.p[0] + i), __ldg(a.p[1] + i),
                      __ldg(a.p[2] + i)};
  const float t = __ldg(a.t + i);
  const float cos_i0 = -dot3(d[0], d[1], d[2], hn[0], hn[1], hn[2]);
  const bool inside = cos_i0 < 0.0f;
  const float N[3] = {inside ? -hn[0] : hn[0], inside ? -hn[1] : hn[1],
                      inside ? -hn[2] : hn[2]};
  const float cos_ti = fabsf(cos_i0);
  const int64_t at = a.stack_at[i];
  const int64_t surf = ld64(a.mat_id + i);
  const int64_t top = a.stack[at * a.stack_stride + i];
  const int64_t below = a.stack[(at > 0 ? at - 1 : 0) * a.stack_stride + i];
  const int64_t mat_i = inside ? surf : top;
  const int64_t mat_t = inside ? below : surf;
  const float *mi = a.mat16 + mat_i * MAT_ROW;
  const float *mt = a.mat16 + mat_t * MAT_ROW;
  const int64_t t_code = (int64_t)__ldg(mt + MAT_CODE);

  // ---- Beer's law through the incident medium ----
  const float neg_t = -t;
  if ((int64_t)__ldg(mi + MAT_CODE) >= CODE_MEDIUM) {
    for (int c = 0; c < 3; ++c)
      tp[c] = tp[c] * expf(__ldg(mi + MAT_ABSORB + c) * neg_t);
  }

  // ---- emissive hit: direct or MIS-weighted ----
  const bool t_emissive = (t_code & CODE_EMISSIVE) != 0;
  const bool allow_direct =
      !a.nee ? true : (a.caustics ? is_spec : (is_spec && a.bounce < 2));
  if (t_emissive && allow_direct) {
    for (int c = 0; c < 3; ++c)
      total[c] = total[c] + tp[c] * __ldg(mt + MAT_EMISSION + c);
  }
  if (t_emissive && !allow_direct && a.nee && a.use_mis && a.bounce > 0) {
    const float brdf_pdf =
        a.is_diffuse ? dot3(prev_n_f[0][i], prev_n_f[1][i], prev_n_f[2][i],
                            d[0], d[1], d[2]) *
                           RCP_PI_F
                     : INV_2PI_F;
    float w;
    if (a.ref_mis) {
      const float lp_ref = t * t / clamp_min(cos_ti, CLAMP_PDF);
      w = recip(clamp_min(lp_ref + brdf_pdf, CLAMP_W));
    } else {
      const float r = light_radius(a, hit_id);
      const float area = TAU_F * r * r;
      const float pick =
          light_pick_pdf(a, a.o[0][i], a.o[1][i], a.o[2][i], hit_id);
      const float lp_sa =
          pick * t * t / clamp_min(cos_ti * area, CLAMP_PDF);
      w = brdf_pdf / clamp_min(brdf_pdf + lp_sa, CLAMP_W);
    }
    for (int c = 0; c < 3; ++c)
      total[c] = total[c] + tp[c] * __ldg(mt + MAT_EMISSION + c) * w;
  }

  // ---- Fresnel split and the REFLECTANCE draw ----
  const float eta_i = __ldg(mi + MAT_IOR);
  const float eta_t = clamp_min(__ldg(mt + MAT_IOR), CLAMP_ETA);
  const float ratio = eta_i / eta_t;
  const float sin_ti = sqrtf(clamp_min(1.0f - cos_ti * cos_ti, 0.0f));
  const float sin_tt = ratio * sin_ti;
  const float cos_tt = sqrtf(clamp_min(1.0f - sin_tt * sin_tt, 0.0f));
  const float r_par = ((eta_t * cos_ti) - (eta_i * cos_tt)) /
                      ((eta_t * cos_ti) + (eta_i * cos_tt));
  const float r_perp = ((eta_i * cos_ti) - (eta_t * cos_tt)) /
                       ((eta_i * cos_ti) + (eta_t * cos_tt));
  float fres = (r_par * r_par + r_perp * r_perp) * 0.5f;
  if (sin_tt >= 1.0f) fres = 1.0f;
  const float metallic = __ldg(mt + MAT_METALLIC);
  const float reflectance = fres + (1.0f - fres) * metallic;
  const bool do_reflect = draw_1d(a, s, DIM_REFLECTANCE, i) < reflectance;

  // ---- the reflect branch, with the three fuzz draws ----
  const float k = dot3(d[0], d[1], d[2], N[0], N[1], N[2]) * 2.0f;
  float refl_d[3];
  for (int c = 0; c < 3; ++c) refl_d[c] = d[c] - N[c] * k;
  s = xorshift(s);
  const float u1 = unilateral(s);
  s = xorshift(s);
  const float u2 = unilateral(s);
  s = xorshift(s);
  const float u3 = unilateral(s);
  const float z = 1.0f - u1 * 2.0f;
  const float rz = sqrtf(clamp_min(1.0f - z * z, 0.0f));
  const float phi = u2 * TAU_F;
  const float cube = (u3 > 0.0f ? 1.0f : (u3 < 0.0f ? -1.0f : 0.0f)) *
                     powf(fabsf(u3), THIRD_F);
  const float fuzz[3] = {rz * cosf(phi) * cube, rz * sinf(phi) * cube,
                         z * cube};
  const float roughness = __ldg(mt + MAT_ROUGHNESS);
  if (roughness > 0.0f) {
    float q[3];
    for (int c = 0; c < 3; ++c)
      q[c] = refl_d[c] * ONE_PLUS_EPS_F + fuzz[c] * roughness;
    const float rs = rsqrtf(dot3(q[0], q[1], q[2], q[0], q[1], q[2]));
    for (int c = 0; c < 3; ++c) refl_d[c] = q[c] * rs;
  }

  // ---- the refract branch and the stack ----
  const bool t_is_medium = t_code >= CODE_MEDIUM;
  const bool do_refract = !do_reflect && t_is_medium;
  const bool pop = do_refract && inside && at > 0;
  const bool push = do_refract && !inside && at < STACK_DEPTH - 1;
  const int64_t new_at = at + (push ? 1 : 0) - (pop ? 1 : 0);
  if (push) a.stack[new_at * a.stack_stride + i] = mat_t;
  if (new_at != at) a.stack_at[i] = new_at;

  for (int c = 0; c < 3; ++c) {
    a.tp[c][i] = tp[c];
    a.total[c][i] = total[c];
    a.sf[(SF_N + c) * n + i] = N[c];
  }
  a.rng[i] = (int64_t)s;

  uint8_t code;
  if (t_emissive) {
    code = BR_NONE;
  } else if (do_reflect) {
    code = BR_REFLECT;
    for (int c = 0; c < 3; ++c) {
      const float alb = __ldg(mt + MAT_ALBEDO + c);
      a.sf[(SF_O + c) * n + i] = p[c] + refl_d[c] * EPS_F;
      a.sf[(SF_D + c) * n + i] = refl_d[c];
      a.sf[(SF_TINT + c) * n + i] = (alb - 1.0f) * metallic + 1.0f;
    }
  } else if (do_refract) {
    code = BR_REFRACT;
    const float k2 = ratio * cos_ti - cos_tt;
    for (int c = 0; c < 3; ++c) {
      const float rd = d[c] * ratio + N[c] * k2;
      a.sf[(SF_O + c) * n + i] = p[c] + rd * EPS_F;
      a.sf[(SF_D + c) * n + i] = rd;
    }
  } else {
    // ---- the diffuse branch: the checker albedo and the BRDF ----
    code = BR_DIFFUSE;
    const int cx = (int)floorf(p[0] * 0.25f);
    const int cz = (int)floorf(p[2] * 0.25f);
    const bool pick = ((cx ^ cz) & 1) != 0 && (t_code & CODE_CHECKERS) != 0;
    const int col = pick ? MAT_CHECKER : MAT_ALBEDO;
    for (int c = 0; c < 3; ++c)
      a.sf[(SF_BRDF + c) * n + i] = __ldg(mt + col + c) * INV_PI_F;
  }
  *code_out = code;
  *nee_out = code == BR_DIFFUSE;
  return true;
}

// One lane after the shadow walk.  Adds to cnt[0] / cnt[1] the lanes whose
// light / environment sample faced the surface.
__device__ __forceinline__ void shade_next_lane(const Args &a, int64_t i,
                                                int cnt[2]) {
  const int64_t n = a.n;
  if (!a.alive[i]) return;
  const uint8_t code = a.si[SI_CODE * n + i];
  uint32_t s = (uint32_t)a.rng[i];
  float tp[3] = {a.tp[0][i], a.tp[1][i], a.tp[2][i]};
  float N[3], brdf[3];
  if (code != BR_NONE)
    for (int c = 0; c < 3; ++c) N[c] = a.sf[(SF_N + c) * n + i];
  if (code == BR_DIFFUSE)
    for (int c = 0; c < 3; ++c) brdf[c] = a.sf[(SF_BRDF + c) * n + i];

  if (code == BR_DIFFUSE && (a.nee || a.env_nee)) {
    float total[3] = {a.total[0][i], a.total[1][i], a.total[2][i]};
    bool changed = false;
    if (a.nee && __ldg(a.facing + i)) {
      ++cnt[0];
      if (!__ldg(a.occluded + i)) {
        const float n_dot_l = __ldg(a.n_dot_l + i);
        const float rcp_pdf = __ldg(a.rcp_pdf + i);
        const float solid = (__ldg(a.nl_dot_l + i) * __ldg(a.area + i)) /
                            clamp_min(__ldg(a.dist_sq + i), CLAMP_PDF);
        const float lp_sa = rcp_pdf / clamp_min(solid, CLAMP_PDF);
        const float bp = a.is_diffuse ? n_dot_l * RCP_PI_F : INV_2PI_F;
        float pdf;
        if (a.use_mis && a.ref_mis)
          pdf = (recip(clamp_min(solid, CLAMP_PDF)) + bp) * rcp_pdf;
        else if (a.use_mis)
          pdf = lp_sa + bp;
        else
          pdf = lp_sa;
        const float q = n_dot_l / clamp_min(pdf, CLAMP_W);
        const float *le =
            a.light16 + ld64(a.slot + i) * LIGHT_ROW + LIGHT_EMISSION;
        for (int c = 0; c < 3; ++c)
          total[c] = total[c] + tp[c] * brdf[c] * __ldg(le + c) * q;
        changed = true;
      }
    }
    if (a.env_nee && __ldg(a.facing_e + i)) {
      ++cnt[1];
      if (!__ldg(a.occluded_e + i)) {
        const float n_dot_e = __ldg(a.n_dot_e + i);
        float pdf = __ldg(a.pdf_e + i);
        if (a.use_mis)
          pdf = pdf + (a.is_diffuse ? n_dot_e * RCP_PI_F : INV_2PI_F);
        const float q = n_dot_e / clamp_min(pdf, CLAMP_W);
        for (int c = 0; c < 3; ++c)
          total[c] = total[c] + tp[c] * brdf[c] * __ldg(a.rad_e[c] + i) * q;
        changed = true;
      }
    }
    if (changed)
      for (int c = 0; c < 3; ++c) a.total[c][i] = total[c];
  }

  // ---- the indirect bounce ----
  float u, v;
  draw_2d(a, s, DIM_INDIRECT, i, u, v);
  bool cont = code != BR_NONE;
  if (cont) {
    float new_o[3], new_d[3], mult[3];
    if (code == BR_DIFFUSE) {
      const float az = u * TAU_F;
      float hy, sy;
      if (a.is_diffuse) {
        sy = sqrtf(clamp_min(1.0f - v, 0.0f));
        hy = sqrtf(v);
      } else {
        sy = sqrtf(clamp_min(1.0f - v * v, 0.0f));
        hy = v;
      }
      oriented(N, cosf(az) * sy, hy, sinf(az) * sy, new_d);
      const float scale =
          a.is_diffuse ? PI_F
                       : dot3(N[0], N[1], N[2], new_d[0], new_d[1], new_d[2]) *
                             TAU_F;
      for (int c = 0; c < 3; ++c) {
        new_o[c] = __ldg(a.p[c] + i) + N[c] * EPS_F;
        mult[c] = scale * brdf[c];
      }
    } else {
      for (int c = 0; c < 3; ++c) {
        new_o[c] = a.sf[(SF_O + c) * n + i];
        new_d[c] = a.sf[(SF_D + c) * n + i];
        mult[c] = code == BR_REFLECT ? a.sf[(SF_TINT + c) * n + i] : 1.0f;
      }
    }
    for (int c = 0; c < 3; ++c) tp[c] = tp[c] * mult[c];

    // ---- Russian roulette ----
    if (a.rr) {
      const float pr =
          clamp_to(maximum(tp[0], maximum(tp[1], tp[2])), RR_LO, RR_HI);
      const float rr_u = draw_1d(a, s, DIM_ROULETTE, i);
      if (code == BR_DIFFUSE) {
        if (rr_u > pr) {
          cont = false;
        } else {
          const float boost = recip(pr);
          for (int c = 0; c < 3; ++c) tp[c] = tp[c] * boost;
        }
      }
    }
    for (int c = 0; c < 3; ++c) a.tp[c][i] = tp[c];
    if (cont) {
      for (int c = 0; c < 3; ++c) {
        a.o[c][i] = new_o[c];
        a.d[c][i] = new_d[c];
        a.prev_n[c][i] = N[c];
      }
      a.is_spec[i] = code != BR_DIFFUSE;
    }
  } else if (a.rr) {
    draw_1d(a, s, DIM_ROULETTE, i);
  }
  a.rng[i] = (int64_t)s;
  if (!cont) a.alive[i] = 0;
}

}  // namespace shade
