// post_rgba8: accumulation buffer -> uint8 RGBA, one thread per pixel.
//
// Replaces the TPU kernel buas_pathtracer_tpu/ops/pallas_post.py
// _post_kernel (:32): one fused pass of divide by weight -> exposure ->
// tonemap 1 - exp(-c) -> sRGB pow(c, 1/2.23333) -> sigmoidal contrast ->
// TPDF dither -> NaN shown cyan, negative weight shown magenta -> clip.
// The arithmetic follows the plain version (ops/post_kernel.py
// post_rgba8_plain, itself runtime/post.py _post_process_jnp of the JAX
// package) step for step, with expf / powf / rsqrtf.
//
// Layout: reads the (H, W, 4) float32 accumulation as one float4 per pixel
// and the 64x64x3 dither tile by (y % 64, x % 64); writes uint8 RGBA
// directly.  The Pallas kernel's channel planes, frame-size dither planes
// and int32 output were Mosaic limits and do not come over.
//
// What bounds it on an H100: memory.  20 bytes per pixel (16 read, 4
// written; the 48 KB tile stays in L1/L2), 41.5 MB per 1080p frame, about
// 12 us at 3.35 TB/s.  What is left to gain is fusing it into the splat or
// resolve pass, which would drop the 16-byte re-read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
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

__device__ __forceinline__ float channel(float c, float safe_w, float d,
                                         const PostParams &p) {
  c = fmaxf(c / safe_w, 0.0f);
  if (p.exposure_on) c = c * p.exposure_scale;
  if (p.tonemapping) c = 1.0f - expf(-c);
  if (p.srgb) c = powf(fmaxf(c, 0.0f), (float)(1.0 / 2.23333));
  if (p.contrast_on) {
    const float scale_lo = c / p.mid_div;
    const float lo = p.midpoint * scale_lo * scale_lo;
    const float scale_hi = p.y_hi - p.y_hi * c;
    const float hi = 1.0f - p.one_minus_mid * scale_hi * scale_hi;
    const float curve = c < p.midpoint ? lo : hi;
    c = c + (curve - c) * p.contrast;
  }
  c = c * 255.0f;
  if (p.dither) {
    const float orig = 2.0f * d - 1.0f;
    float v = orig * rsqrtf(fmaxf(fabsf(orig), 1e-30f));
    v = fmaxf(-1.0f, v);
    const float sgn = v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
    c = c + 0.5f + (v - sgn);
  }
  return c;
}

__device__ __forceinline__ unsigned char to_u8(float c) {
  return (unsigned char)fminf(fmaxf(c, 0.0f), 255.0f);
}

__global__ void __launch_bounds__(THREADS)
post_rgba8_kernel(const float4 *__restrict__ accum,
                  const float *__restrict__ tile, uchar4 *__restrict__ out,
                  int h, int w, PostParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h * w) return;
  const int y = i / w, x = i - y * w;
  const float4 a = accum[i];
  const float wgt = a.w;
  const bool has_weight = wgt > 0.001f;
  const bool neg_weight = wgt < -0.01f;
  const bool is_nan = isnan(a.x) || isnan(a.y) || isnan(a.z) || isnan(wgt);
  const float safe_w = has_weight ? wgt : 1.0f;
  const float *d = tile + ((y % TILE) * TILE + (x % TILE)) * 3;
  float r = channel(a.x, safe_w, p.dither ? __ldg(d + 0) : 0.0f, p);
  float g = channel(a.y, safe_w, p.dither ? __ldg(d + 1) : 0.0f, p);
  float b = channel(a.z, safe_w, p.dither ? __ldg(d + 2) : 0.0f, p);
  if (!has_weight) r = g = b = 0.0f;
  if (is_nan) {
    r = 0.0f;
    g = 255.0f;
    b = 255.0f;
  } else if (neg_weight) {
    const float mag = -255.0f * wgt;
    r = mag;
    g = 0.0f;
    b = mag;
  }
  out[i] = make_uchar4(to_u8(r), to_u8(g), to_u8(b), 255);
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
  post_rgba8_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      (const float4 *)accum, (const float *)tile, (uchar4 *)out, h, w, p);
  return (int)cudaGetLastError();
}
