// post_rgba8: accumulation buffer -> uint8 RGBA, PIX pixels per thread.
//
// Replaces the TPU kernel buas_pathtracer_tpu/ops/pallas_post.py
// _post_kernel (:32): one fused pass of divide by weight -> exposure ->
// tonemap 1 - exp(-c) -> sRGB pow(c, 1/2.23333) -> sigmoidal contrast ->
// TPDF dither -> NaN shown cyan, negative weight shown magenta -> clip.
// The arithmetic follows the plain version (ops/post_kernel.py
// post_rgba8_plain, itself runtime/post.py _post_process_jnp of the JAX
// package) step for step, with IEEE division, expf, powf and rsqrtf.
//
// Layout: reads the (H, W, 4) float32 accumulation as float4 pixels and the
// 64x64x3 dither tile by (y % 64, x % 64); writes uint8 RGBA directly.  The
// Pallas kernel's channel planes, frame-size dither planes and int32 output
// were Mosaic limits and do not come over.
//
// What bounds it on an H100: instruction issue.  The 41.5 MB a 1080p frame
// moves (16 bytes read and 4 written per pixel) take 12 us at 3.35 TB/s,
// but each channel runs an IEEE division, expf and a full-precision powf,
// a few hundred SASS instructions per pixel.  So the design cuts the
// instructions around that math and keeps the memory system busy:
//  - a thread takes PIX consecutive pixels of the flat index, so every
//    group starts on a multiple of PIX and its PIX float4 loads and its one
//    16-byte store stay aligned whatever the width; the PIX loads are
//    issued before any arithmetic;
//  - one integer division per group for (y, x), then an increment that
//    wraps at the row's end;
//  - each setting's branch is taken once per group, over all 3 x PIX
//    channel values, not once per channel;
//  - the last group, which may run past H x W, loads and stores pixel by
//    pixel.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// 64-thread blocks: 2-7% less device time than 128 and 256 on a 1080p
// frame (H100 80GB HBM3, 700 W; PERF.md, the post kernel's steps)
constexpr int THREADS = 64;
constexpr int PIX = 4;  // pixels per thread, a multiple of 4
static_assert(PIX % 4 == 0, "a group stores whole 16-byte words");
constexpr int TILE = 64;

struct PostParams {
  float exposure_scale;  // 2**exposure, applied when exposure != 0
  float midpoint;
  float contrast;
  float mid_div;     // max(midpoint, 1e-6)
  float y_hi;        // 1 / max(1 - midpoint, 1e-6)
  float one_minus_mid;
  int exposure_on, tonemapping, srgb, contrast_on, dither;
};
// chip_smoke.py finds the flags in the kernel's SASS at these offsets after
// the kernel's first five parameters (its POST_FLAG_OFFSETS)
static_assert(sizeof(PostParams) == 44 &&
                  offsetof(PostParams, exposure_on) == 24 &&
                  offsetof(PostParams, dither) == 40,
              "PostParams: six floats, then the five int flags");

__device__ __forceinline__ float contrast_curve(float c, const PostParams &p) {
  const float scale_lo = c / p.mid_div;
  const float lo = p.midpoint * scale_lo * scale_lo;
  const float scale_hi = p.y_hi - p.y_hi * c;
  const float hi = 1.0f - p.one_minus_mid * scale_hi * scale_hi;
  const float curve = c < p.midpoint ? lo : hi;
  return c + (curve - c) * p.contrast;
}

// uniform [0, 1) -> triangular PDF on [-1, 1]
__device__ __forceinline__ float remap_tpdf(float d) {
  const float orig = 2.0f * d - 1.0f;
  float v = orig * rsqrtf(fmaxf(fabsf(orig), 1e-30f));
  v = fmaxf(-1.0f, v);
  const float sgn = v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
  return v - sgn;
}

__device__ __forceinline__ unsigned to_u8(float c) {
  return (unsigned)(unsigned char)fminf(fmaxf(c, 0.0f), 255.0f);
}

__global__ void __launch_bounds__(THREADS)
post_rgba8_kernel(const float4 *__restrict__ accum,
                  const float *__restrict__ tile, uchar4 *__restrict__ out,
                  int n, int w, PostParams p) {
  const int g = blockIdx.x * THREADS + threadIdx.x;
  const int first = g * PIX;
  if (first >= n) return;
  const bool whole = first + PIX <= n;
  float4 a[PIX];
#pragma unroll
  for (int j = 0; j < PIX; ++j)
    a[j] = whole || first + j < n ? __ldg(accum + first + j)
                                  : make_float4(0.0f, 0.0f, 0.0f, 1.0f);
  float c[PIX][3];
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    const float safe_w = a[j].w > 0.001f ? a[j].w : 1.0f;
    c[j][0] = fmaxf(a[j].x / safe_w, 0.0f);
    c[j][1] = fmaxf(a[j].y / safe_w, 0.0f);
    c[j][2] = fmaxf(a[j].z / safe_w, 0.0f);
  }
  if (p.exposure_on) {
#pragma unroll
    for (int j = 0; j < PIX; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k) c[j][k] = c[j][k] * p.exposure_scale;
  }
  if (p.tonemapping) {
#pragma unroll
    for (int j = 0; j < PIX; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k) c[j][k] = 1.0f - expf(-c[j][k]);
  }
  if (p.srgb) {
#pragma unroll
    for (int j = 0; j < PIX; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        c[j][k] = powf(fmaxf(c[j][k], 0.0f), (float)(1.0 / 2.23333));
  }
  if (p.contrast_on) {
#pragma unroll
    for (int j = 0; j < PIX; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k) c[j][k] = contrast_curve(c[j][k], p);
  }
#pragma unroll
  for (int j = 0; j < PIX; ++j)
#pragma unroll
    for (int k = 0; k < 3; ++k) c[j][k] = c[j][k] * 255.0f;
  if (p.dither) {
    int y = first / w, x = first - y * w;
#pragma unroll
    for (int j = 0; j < PIX; ++j) {
      const float *d = tile + ((y & (TILE - 1)) * TILE + (x & (TILE - 1))) * 3;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        c[j][k] = c[j][k] + 0.5f + remap_tpdf(__ldg(d + k));
      if (++x == w) {
        x = 0;
        ++y;
      }
    }
  }
  unsigned px[PIX];
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    const float wgt = a[j].w;
    float r = c[j][0], gr = c[j][1], b = c[j][2];
    if (!(wgt > 0.001f)) r = gr = b = 0.0f;
    if (isnan(a[j].x) || isnan(a[j].y) || isnan(a[j].z) || isnan(wgt)) {
      r = 0.0f;
      gr = 255.0f;
      b = 255.0f;
    } else if (wgt < -0.01f) {
      const float mag = -255.0f * wgt;
      r = mag;
      gr = 0.0f;
      b = mag;
    }
    px[j] = to_u8(r) | to_u8(gr) << 8 | to_u8(b) << 16 | 255u << 24;
  }
  if (whole) {
#pragma unroll
    for (int q = 0; q < PIX / 4; ++q)
      reinterpret_cast<uint4 *>(out + first)[q] =
          make_uint4(px[4 * q], px[4 * q + 1], px[4 * q + 2], px[4 * q + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < PIX; ++j)
      if (first + j < n) reinterpret_cast<unsigned *>(out)[first + j] = px[j];
  }
}

}  // namespace

extern "C" int post_rgba8_launch(const void *accum, const void *tile,
                                 void *out, int h, int w,
                                 float exposure_scale, float midpoint,
                                 float contrast, float mid_div, float y_hi,
                                 float one_minus_mid, int exposure_on,
                                 int tonemapping, int srgb, int contrast_on,
                                 int dither, void *stream) {
  const int n = h * w;
  if (n <= 0) return (int)cudaSuccess;
  PostParams p{exposure_scale, midpoint, contrast, mid_div, y_hi,
               one_minus_mid, exposure_on, tonemapping, srgb, contrast_on,
               dither};
  const int groups = (n + PIX - 1) / PIX;
  post_rgba8_kernel<<<(groups + THREADS - 1) / THREADS, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      (const float4 *)accum, (const float *)tile, (uchar4 *)out, n, w, p);
  return (int)cudaGetLastError();
}
