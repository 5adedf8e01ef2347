// K1: batched inverse-homography warp of a whole clip (NHWC float32), and
// K3: its shutter-blur form, the mean of S sample warps per frame.
//
// Both replace the TPU kernel comfyui_video_stabilizer_tpu/ops/warp_pallas.py
// (_make_kernel, launched by _pallas_warp_core's pl.pallas_call at :525):
// K1 its n_samples=1 use (_warp_pallas_call), K3 its n_samples=S use
// (_warp_blur_pallas_call / warp_clip_blur_pallas).  The TPU
// kernel has no hardware gather, so it plans per-tile source windows,
// DMAs them into VMEM and samples with masked shift-FMAs.  Hopper gathers
// in hardware, so none of that carries over: one thread computes one
// output pixel's source coordinate and reads its taps straight from
// device memory.
//
// What bounds it on an H100: bytes.  At 1080p a bilinear warp reads each
// source pixel about once (near-identity warps keep the 2x2 taps of
// neighbouring threads on the same cache lines) and writes each output
// pixel once, ~12 bytes in and 12 out per RGB pixel, with ~40 flops of
// coordinate and weight math.  The simple design keeps that ratio: a
// 32x8 block walks a row-major patch of the output so a warp's taps fall
// on a few 128-byte lines (the taps of neighbouring rows come from L1
// and L2), the 8 coefficients and the border colour are read once per
// thread, and no scratch is written.  Fusing the padding mask, which the
// engine still computes in separate PyTorch passes, is left for later.
//
// What bounds K3 on an H100: operations.  It moves the same bytes as K1
// (each source pixel read, each output pixel written once: the taps of
// consecutive samples lie a few pixels apart, so they come from L1 and
// L2), but does S times K1's arithmetic: at 1080p x 80 frames, bicubic,
// S = 33, ~190 flops a sample and pixel, ~1 TFLOP against 4 GB.  The TPU
// kernel keeps the output tile resident in VMEM across its S revisits;
// here one thread keeps its pixel's running sum in registers over the S
// loop, so the output is written once and nothing else goes to device
// memory.  Sharing the per-row tap loads of neighbouring samples, and
// folding the soft mask's S coverage passes into this loop, are left for
// later.
//
// Numerics are the plain version's (ops/warp.py::warp_plain), op for op:
// the displacement form D = 1+gx+hy, dx = Qx/D of ops/warp.py in the JAX
// package, the +-1e6 clip and the D != 0 guard, exact integer/fraction
// split, cv2's bicubic kernel (A = -0.75), round-half-even nearest, and
// BORDER_CONSTANT taps that read the border colour.  The library is built
// with -fmad=false, so every multiply and add rounds on its own as in the
// plain PyTorch version and the two agree bitwise; K3 against
// ops/warp.py::warp_blur_plain the same way.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kMaxChannels = 4;
constexpr float kDispLim = 1.0e6f;

enum Interp { kBilinear = 0, kBicubic = 1, kNearest = 2 };

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  // NaN passes through, as jnp.clip / torch.clamp do.
  return v < lo ? lo : (v > hi ? hi : v);
}

struct Split {
  int x0, y0;
  float fx, fy;
};

// _split_coords: floor(source) and fraction, formed from the displacement
// only, never from the absolute source coordinate.
__device__ __forceinline__ Split split_coords(const float* __restrict__ k, int x, int y) {
  const float xx = (float)x;
  const float yy = (float)y;
  const float a = k[0], b = k[1], c = k[2], d = k[3];
  const float e = k[4], f = k[5], g = k[6], h = k[7];
  const float denom = (1.0f + g * xx) + h * yy;
  const float qx = ((((a - 1.0f) * xx + b * yy) + c) - (g * xx) * xx) - (h * xx) * yy;
  const float qy = (((d * xx + (e - 1.0f) * yy) + f) - (g * yy) * xx) - (h * yy) * yy;
  const bool safe = denom != 0.0f;
  const float inv_d = safe ? 1.0f / denom : 0.0f;
  float dx = qx * inv_d;
  float dy = qy * inv_d;
  dx = safe ? clip(dx, -kDispLim, kDispLim) : -kDispLim;
  dy = safe ? clip(dy, -kDispLim, kDispLim) : -kDispLim;
  const float dxf = floorf(dx);
  const float dyf = floorf(dy);
  Split s;
  s.x0 = x + (int)dxf;
  s.y0 = y + (int)dyf;
  s.fx = dx - dxf;
  s.fy = dy - dyf;
  return s;
}

__device__ __forceinline__ void cubic_weights(float t, float w[4]) {
  const float A = -0.75f;
  const float t1 = t + 1.0f;
  w[0] = ((A * t1 - (5.0f * A)) * t1 + (8.0f * A)) * t1 - (4.0f * A);
  w[1] = ((((A + 2.0f) * t) - (A + 3.0f)) * t) * t + 1.0f;
  const float u = 1.0f - t;
  w[2] = ((((A + 2.0f) * u) - (A + 3.0f)) * u) * u + 1.0f;
  w[3] = ((1.0f - w[0]) - w[1]) - w[2];
}

template <int C>
__device__ __forceinline__ void add_tap(const float* __restrict__ frame, const float* __restrict__ border,
                                        int h, int w, int ys, int xs, float wgt, float acc[kMaxChannels]) {
  const bool valid = xs >= 0 && xs < w && ys >= 0 && ys < h;
  // clamped address, as the plain version's clipped gather: never read out of bounds
  const float* px = frame + ((int64_t)min(max(ys, 0), h - 1) * w + min(max(xs, 0), w - 1)) * C;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    const float v = valid ? px[ch] : border[ch];
    acc[ch] = acc[ch] + v * wgt;
  }
}

// One output pixel's value under one set of inverse coefficients k: the
// whole per-sample computation, shared by K1 and K3 so the two cannot
// drift apart.  v receives C channels.
template <int C, int INTERP>
__device__ __forceinline__ void sample_pixel(const float* __restrict__ frame, const float* __restrict__ k,
                                             const float* __restrict__ bc, int h, int w, int x, int y,
                                             float v[kMaxChannels]) {
  const Split s = split_coords(k, x, y);
  if (INTERP == kNearest) {
    // round half to even, as cv2's saturate_cast
    const int xn = s.x0 + (s.fx > 0.5f ? 1 : (s.fx < 0.5f ? 0 : (s.x0 & 1)));
    const int yn = s.y0 + (s.fy > 0.5f ? 1 : (s.fy < 0.5f ? 0 : (s.y0 & 1)));
    const bool valid = xn >= 0 && xn < w && yn >= 0 && yn < h;
    const float* px = frame + ((int64_t)min(max(yn, 0), h - 1) * w + min(max(xn, 0), w - 1)) * C;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) v[ch] = valid ? px[ch] : bc[ch];
    return;
  }
#pragma unroll
  for (int ch = 0; ch < C; ++ch) v[ch] = 0.0f;
  if (INTERP == kBilinear) {
    const float w00 = (1.0f - s.fy) * (1.0f - s.fx);
    const float w01 = (1.0f - s.fy) * s.fx;
    const float w10 = s.fy * (1.0f - s.fx);
    const float w11 = s.fy * s.fx;
    add_tap<C>(frame, bc, h, w, s.y0, s.x0, w00, v);
    add_tap<C>(frame, bc, h, w, s.y0, s.x0 + 1, w01, v);
    add_tap<C>(frame, bc, h, w, s.y0 + 1, s.x0, w10, v);
    add_tap<C>(frame, bc, h, w, s.y0 + 1, s.x0 + 1, w11, v);
  } else {
    float wx[4], wy[4];
    cubic_weights(s.fx, wx);
    cubic_weights(s.fy, wy);
#pragma unroll
    for (int iy = 0; iy < 4; ++iy) {
#pragma unroll
      for (int ix = 0; ix < 4; ++ix) {
        add_tap<C>(frame, bc, h, w, s.y0 + iy - 1, s.x0 + ix - 1, wy[iy] * wx[ix], v);
      }
    }
  }
}

template <int C, int INTERP>
__global__ void __launch_bounds__(kBlockX * kBlockY)
warp_kernel(const float* __restrict__ frames, const float* __restrict__ coeffs,
            const float* __restrict__ border, float* __restrict__ out,
            int h, int w, int out_h, int out_w) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int n = blockIdx.z;
  if (x >= out_w || y >= out_h) return;

  float k[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) k[i] = coeffs[n * 8 + i];
  float bc[kMaxChannels];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) bc[ch] = border[ch];

  const float* frame = frames + (int64_t)n * h * w * C;
  float* dst = out + (((int64_t)n * out_h + y) * out_w + x) * C;
  float v[kMaxChannels];
  sample_pixel<C, INTERP>(frame, k, bc, h, w, x, y, v);
#pragma unroll
  for (int ch = 0; ch < C; ++ch) dst[ch] = v[ch];
}

// K3: the mean of S shutter-sample warps of one frame.  One thread owns
// one output pixel for all S samples: each sample's value is K1's
// (sample_pixel), the samples are summed in sample order (sample 0
// assigned, then total = total + v) and the sum is divided by (float)S,
// the op order of the plain version and of the JAX package's XLA path.
// The output is written once.
template <int C, int INTERP>
__global__ void __launch_bounds__(kBlockX * kBlockY)
warp_blur_kernel(const float* __restrict__ frames, const float* __restrict__ coeffs,
                 const float* __restrict__ border, float* __restrict__ out,
                 int h, int w, int out_h, int out_w, int n_samples) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int n = blockIdx.z;
  if (x >= out_w || y >= out_h) return;

  float bc[kMaxChannels];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) bc[ch] = border[ch];
  const float* frame = frames + (int64_t)n * h * w * C;
  float* dst = out + (((int64_t)n * out_h + y) * out_w + x) * C;

  float total[kMaxChannels];
  for (int smp = 0; smp < n_samples; ++smp) {
    const float* ks = coeffs + ((int64_t)n * n_samples + smp) * 8;
    float k[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) k[i] = ks[i];
    float v[kMaxChannels];
    sample_pixel<C, INTERP>(frame, k, bc, h, w, x, y, v);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) total[ch] = smp == 0 ? v[ch] : total[ch] + v[ch];
  }
  const float count = (float)n_samples;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) dst[ch] = total[ch] / count;
}

template <int C>
cudaError_t launch_c(const float* frames, const float* coeffs, const float* border, float* out,
                     int n, int h, int w, int out_h, int out_w, int interp, cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY, 1);
  const dim3 grid((out_w + kBlockX - 1) / kBlockX, (out_h + kBlockY - 1) / kBlockY, n);
  switch (interp) {
    case kBilinear:
      warp_kernel<C, kBilinear><<<grid, block, 0, stream>>>(frames, coeffs, border, out, h, w, out_h, out_w);
      break;
    case kBicubic:
      warp_kernel<C, kBicubic><<<grid, block, 0, stream>>>(frames, coeffs, border, out, h, w, out_h, out_w);
      break;
    case kNearest:
      warp_kernel<C, kNearest><<<grid, block, 0, stream>>>(frames, coeffs, border, out, h, w, out_h, out_w);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_blur_c(const float* frames, const float* coeffs, const float* border, float* out,
                          int n, int h, int w, int out_h, int out_w, int interp, int n_samples,
                          cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY, 1);
  const dim3 grid((out_w + kBlockX - 1) / kBlockX, (out_h + kBlockY - 1) / kBlockY, n);
  switch (interp) {
    case kBilinear:
      warp_blur_kernel<C, kBilinear><<<grid, block, 0, stream>>>(frames, coeffs, border, out, h, w, out_h,
                                                                 out_w, n_samples);
      break;
    case kBicubic:
      warp_blur_kernel<C, kBicubic><<<grid, block, 0, stream>>>(frames, coeffs, border, out, h, w, out_h,
                                                                out_w, n_samples);
      break;
    default:  // nearest has no shutter blur, as in models/motion_apply.py
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// frames (n, h, w, c), coeffs (n, 8), border (c,), out (n, out_h, out_w, c);
// all float32, contiguous, on the current device.  interp: 0 bilinear,
// 1 bicubic, 2 nearest.  Returns the launch's cudaError_t (0 on success).
extern "C" int cvst_warp(const float* frames, const float* coeffs, const float* border, float* out,
                         int n, int h, int w, int c, int out_h, int out_w, int interp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n > 65535 || out_h <= 0 || out_w <= 0 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  switch (c) {
    case 1: return (int)launch_c<1>(frames, coeffs, border, out, n, h, w, out_h, out_w, interp, s);
    case 2: return (int)launch_c<2>(frames, coeffs, border, out, n, h, w, out_h, out_w, interp, s);
    case 3: return (int)launch_c<3>(frames, coeffs, border, out, n, h, w, out_h, out_w, interp, s);
    case 4: return (int)launch_c<4>(frames, coeffs, border, out, n, h, w, out_h, out_w, interp, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K3.  frames (n, h, w, c), coeffs (n, n_samples, 8) sample-minor, border
// (c,), out (n, out_h, out_w, c); all float32, contiguous, on the current
// device.  interp: 0 bilinear, 1 bicubic.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int cvst_warp_blur(const float* frames, const float* coeffs, const float* border, float* out,
                              int n, int h, int w, int c, int out_h, int out_w, int interp, int n_samples,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n > 65535 || out_h <= 0 || out_w <= 0 || h <= 0 || w <= 0 || n_samples <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  switch (c) {
    case 1: return (int)launch_blur_c<1>(frames, coeffs, border, out, n, h, w, out_h, out_w, interp, n_samples, s);
    case 2: return (int)launch_blur_c<2>(frames, coeffs, border, out, n, h, w, out_h, out_w, interp, n_samples, s);
    case 3: return (int)launch_blur_c<3>(frames, coeffs, border, out, n, h, w, out_h, out_w, interp, n_samples, s);
    case 4: return (int)launch_blur_c<4>(frames, coeffs, border, out, n, h, w, out_h, out_w, interp, n_samples, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* cvst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
