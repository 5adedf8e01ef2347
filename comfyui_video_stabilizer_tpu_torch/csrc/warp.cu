// K1: batched inverse-homography warp of a whole clip (NHWC float32), and
// K3: its shutter-blur form, the mean of S sample warps per frame, with the
// soft mask (1 - mean nearest coverage, small values zeroed) in the same
// launch.
//
// Both replace the TPU kernel comfyui_video_stabilizer_tpu/ops/warp_pallas.py
// (_make_kernel, launched by _pallas_warp_core's pl.pallas_call at :525):
// K1 its n_samples=1 use (_warp_pallas_call), K3 its n_samples=S use
// (_warp_blur_pallas_call / warp_clip_blur_pallas); K3's mask replaces the
// XLA program _coverage_mean_xla of ops/warp.py in the JAX package.
//
// K8: the padding stats of the plain warp, the mask 1 - nearest coverage and
// the exact padded count of each frame, in one pass.  It replaces no
// pallas_call: the JAX package leaves this stage to XLA
// (comfyui_video_stabilizer_tpu/ops/warp.py:262 _padding_stats_xla and :283
// _padding_stats_bucket, the mask and its per-frame mean).  Its bound on an
// H100 is the float32 mask written once (663.6 MB at 80 x 1080p, 0.198 ms at
// 3.35 TB/s); what holds it back is the instruction rate, not the store: the
// exact per-pixel steps (the displacement, the clip, floor, float->int,
// round-half-even and bound tests) compile to several dozen instructions a
// pixel under -fmad=false.  The design cuts the instructions a pixel (comment
// above padding_stats_kernel): a route per frame that skips the denominator
// where it is exactly 1, the products of the row hoisted out of the pixel loop,
// the padded pixels counted in a register, and up to 16 pixels a thread (16
// where out_w % 16 == 0), which spreads a thread's fixed costs.  Integer
// atomics do not depend on their order, so the counts are exact and the same on
// every run.
//
// K1.  What bounds it on an H100: bytes.  At 1080p a bilinear warp reads
// each source pixel about once (near-identity warps keep the 2x2 taps of
// neighbouring threads on the same cache lines) and writes each output
// pixel once, ~12 bytes in and 12 out per RGB pixel, with ~40 flops of
// coordinate and weight math.  One thread computes one output pixel's
// source coordinate and reads its taps straight from device memory
// (Hopper gathers in hardware, so the TPU kernel's window planning does
// not carry over); a 32x8 block walks a row-major patch of the output.
//
// K3.  What bounds it on an H100: instruction issue.  Per pixel-sample a
// bicubic RGB sample is ~200 float operations that -fmad=false keeps
// apart (the split, the weights, a multiply and an add per tap and
// channel) and ~55 other instructions (tap loads, the mask's nearest
// test, the loop), against 4 warp-instructions a cycle per SM.  The old
// design read every tap as three scalar loads at a 12-byte stride
// straight from device memory.  So, as the TPU kernel solves each tile's
// source window and DMAs it into VMEM (warp_pallas.py:205-230, :544),
// each 32x8 block first finds its tile's source footprint over all S
// samples (split_coords at the tile's four corners for every sample, a
// shared min/max, plus the tap support and a 1-px margin) and stages that
// box in shared memory, with the border colour wherever it lies outside
// the frame.  A staged tap then needs no clamp and no validity test and
// is one shared-memory load: the box is staged as RGBA (one float4 a
// pixel), so a tap reads all channels at once.  A sample whose taps
// leave the staged box (a strong zoom, a degenerate denominator), or a tile whose
// footprint exceeds kStageBytes, reads device memory as K1 does, inside
// the same kernel, so the result never depends on the footprint
// estimate.  The S coefficient sets sit in shared memory too.  Per
// sample the thread also takes the round-half-even nearest source, tests
// it against the frame and counts it; the mask is finished with the
// plain version's op order and written beside the frames, so the soft
// mask costs no pass of its own.
//
// Numerics are the plain versions' (ops/warp.py::warp_plain,
// warp_blur_mask_plain), op for op: the displacement form D = 1+gx+hy,
// dx = Qx/D of ops/warp.py in the JAX package, the +-1e6 clip and the
// D != 0 guard, exact integer/fraction split, cv2's bicubic kernel
// (A = -0.75), round-half-even nearest, BORDER_CONSTANT taps that read
// the border colour, taps summed iy-major then ix, samples summed in
// order and divided by (float)S, the coverage count times (float)(1/S).
// A staged value equals the frame tap it replaces (pixel or border), so
// the source of a tap never changes a bit.  The library is built with
// -fmad=false, so every multiply and add rounds on its own as in the
// plain PyTorch versions and the kernels agree with them bitwise.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kThreads = kBlockX * kBlockY;
constexpr int kMaxChannels = 4;
constexpr int kMaxSamples = 33;
// Staging budget a block: a 32x8 tile of the 1080p Motion Apply clip
// (config 4's action shake, blur 0.5, S = 33) needs 9-17 KB as RGBA; 40 KB
// leaves room for stronger motion, and the 64-register cap of four blocks
// an SM, not shared memory, sets the occupancy.
constexpr int kStageBytes = 40 * 1024;
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
__device__ __forceinline__ Split split_coords(const float k[8], int x, int y) {
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

// round half to even, as cv2's saturate_cast
__device__ __forceinline__ int round_half_even(int base, float frac) {
  return base + (frac > 0.5f ? 1 : (frac < 0.5f ? 0 : (base & 1)));
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

// Taps read from the frame in device memory: the clamped address, as the
// plain version's clipped gather (never out of bounds), and the border
// colour where the tap lies outside the frame.
struct FrameTaps {
  const float* frame;
  float bc[kMaxChannels];
  int h, w;

  template <int C>
  __device__ __forceinline__ void get(int ys, int xs, float v[kMaxChannels]) const {
    const bool valid = xs >= 0 && xs < w && ys >= 0 && ys < h;
    const float* px = frame + ((int64_t)min(max(ys, 0), h - 1) * w + min(max(xs, 0), w - 1)) * C;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) v[ch] = valid ? px[ch] : bc[ch];
  }
};

template <int C>
__device__ __forceinline__ FrameTaps frame_taps(const float* frame, const float* border, int h, int w) {
  FrameTaps t;
  t.frame = frame;
  t.h = h;
  t.w = w;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) t.bc[ch] = border[ch];
  return t;
}

// Taps read from K3's staged RGBA box in shared memory (origin (oy, ox)):
// no clamp, no test; the caller checks that every tap lies in the box.
struct StagedTaps {
  const float4* base;
  int pitch, oy, ox;

  template <int C>
  __device__ __forceinline__ void get(int ys, int xs, float v[kMaxChannels]) const {
    const float4 q = base[(ys - oy) * pitch + (xs - ox)];
    v[0] = q.x;
    if (C > 1) v[1] = q.y;
    if (C > 2) v[2] = q.z;
    if (C > 3) v[3] = q.w;
  }
};

template <int C, class Taps>
__device__ __forceinline__ void add_tap(const Taps& taps, int ys, int xs, float wgt, float acc[kMaxChannels]) {
  float t[kMaxChannels];
  taps.template get<C>(ys, xs, t);
#pragma unroll
  for (int ch = 0; ch < C; ++ch) acc[ch] = acc[ch] + t[ch] * wgt;
}

// One output pixel's value under one sample's split coordinates: the
// whole per-sample computation, shared by K1 and K3 so the two cannot
// drift apart, whichever memory the taps come from.  v receives C channels.
template <int C, int INTERP, class Taps>
__device__ __forceinline__ void sample_pixel(const Taps& taps, const Split& s, float v[kMaxChannels]) {
  if (INTERP == kNearest) {
    taps.template get<C>(round_half_even(s.y0, s.fy), round_half_even(s.x0, s.fx), v);
    return;
  }
#pragma unroll
  for (int ch = 0; ch < C; ++ch) v[ch] = 0.0f;
  if (INTERP == kBilinear) {
    const float w00 = (1.0f - s.fy) * (1.0f - s.fx);
    const float w01 = (1.0f - s.fy) * s.fx;
    const float w10 = s.fy * (1.0f - s.fx);
    const float w11 = s.fy * s.fx;
    add_tap<C>(taps, s.y0, s.x0, w00, v);
    add_tap<C>(taps, s.y0, s.x0 + 1, w01, v);
    add_tap<C>(taps, s.y0 + 1, s.x0, w10, v);
    add_tap<C>(taps, s.y0 + 1, s.x0 + 1, w11, v);
  } else {
    float wx[4], wy[4];
    cubic_weights(s.fx, wx);
    cubic_weights(s.fy, wy);
#pragma unroll
    for (int iy = 0; iy < 4; ++iy) {
#pragma unroll
      for (int ix = 0; ix < 4; ++ix) {
        add_tap<C>(taps, s.y0 + iy - 1, s.x0 + ix - 1, wy[iy] * wx[ix], v);
      }
    }
  }
}

template <int C, int INTERP>
__global__ void __launch_bounds__(kThreads)
warp_kernel(const float* __restrict__ frames, const float* __restrict__ coeffs,
            const float* __restrict__ border, float* __restrict__ out,
            int h, int w, int out_h, int out_w, int row0) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int n = blockIdx.z;
  if (x >= out_w || y >= out_h) return;

  float k[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) k[i] = coeffs[n * 8 + i];
  const FrameTaps taps = frame_taps<C>(frames + (int64_t)n * h * w * C, border, h, w);
  float v[kMaxChannels];
  // out holds the band of output rows [row0, row0 + out_h): the pixel's
  // coordinate is its frame row, its store its row within the band
  sample_pixel<C, INTERP>(taps, split_coords(k, x, y + row0), v);
  float* dst = out + (((int64_t)n * out_h + y) * out_w + x) * C;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) dst[ch] = v[ch];
}

__device__ __forceinline__ void load_coeffs(const float4* ks, int smp, float k[8]) {
  const float4 a = ks[2 * smp];
  const float4 b = ks[2 * smp + 1];
  k[0] = a.x; k[1] = a.y; k[2] = a.z; k[3] = a.w;
  k[4] = b.x; k[5] = b.y; k[6] = b.z; k[7] = b.w;
}

// K3: the mean of S shutter-sample warps of one frame and, when mask is
// not null, the soft mask.  One block owns a 32x8 output tile and stages
// its source footprint; one thread owns one output pixel for all S
// samples: each sample's value is K1's (sample_pixel), the samples are
// summed in sample order (sample 0 assigned, then total = total + v) and
// the sum is divided by (float)S, the op order of the plain version and
// of the JAX package's XLA path.  stats, when not null, receives the
// count of tiles ([0]), of tiles that staged nothing ([1]) and of
// pixel-samples whose taps were read from device memory ([2]).
template <int C, int INTERP>
__global__ void __launch_bounds__(kThreads, 4)
warp_blur_kernel(const float* __restrict__ frames, const float* __restrict__ coeffs,
                 const float* __restrict__ border, float* __restrict__ out, float* __restrict__ mask,
                 unsigned long long* __restrict__ stats, int h, int w, int out_h, int out_w,
                 int n_samples) {
  constexpr int kLo = INTERP == kBicubic ? 1 : 0;  // a sample's taps span x0 - kLo .. x0 + kHi
  constexpr int kHi = INTERP == kBicubic ? 2 : 1;
  extern __shared__ float4 stage4[];
  __shared__ float4 ks[kMaxSamples * 2];
  __shared__ int box[4];  // min x0, min y0, max x0, max y0 over the tile's corners and samples

  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  const int n = blockIdx.z;
  const int tx0 = blockIdx.x * kBlockX;
  const int ty0 = blockIdx.y * kBlockY;
  const int tx1 = min(tx0 + kBlockX, out_w) - 1;
  const int ty1 = min(ty0 + kBlockY, out_h) - 1;

  if (tid < 4) box[tid] = tid < 2 ? INT_MAX : INT_MIN;
  const float* cs = coeffs + (int64_t)n * n_samples * 8;
  for (int i = tid; i < n_samples * 8; i += kThreads) reinterpret_cast<float*>(ks)[i] = cs[i];
  __syncthreads();

  for (int i = tid; i < 4 * n_samples; i += kThreads) {
    float k[8];
    load_coeffs(ks, i >> 2, k);
    const Split s = split_coords(k, (i & 1) ? tx1 : tx0, (i & 2) ? ty1 : ty0);
    atomicMin(&box[0], s.x0);
    atomicMin(&box[1], s.y0);
    atomicMax(&box[2], s.x0);
    atomicMax(&box[3], s.y0);
  }
  __syncthreads();

  // the footprint, widened by the tap support and a 1-px margin
  const int bx0 = box[0] - kLo - 1;
  const int by0 = box[1] - kLo - 1;
  const int bx1 = box[2] + kHi + 1;
  const int by1 = box[3] + kHi + 1;
  const int64_t fw = (int64_t)bx1 - bx0 + 1;
  const int64_t fh = (int64_t)by1 - by0 + 1;
  const bool staged = fh * fw * (int64_t)sizeof(float4) <= kStageBytes;

  const FrameTaps src = frame_taps<C>(frames + (int64_t)n * h * w * C, border, h, w);
  const int ipitch = staged ? (int)fw : 0;
  if (staged) {
    const int count = (int)(fh * fw);
    for (int i = tid; i < count; i += kThreads) {
      const int r = i / ipitch;
      const int c = i - r * ipitch;
      float v[kMaxChannels];
      src.get<C>(by0 + r, bx0 + c, v);
      stage4[i] = make_float4(v[0], C > 1 ? v[1] : 0.0f, C > 2 ? v[2] : 0.0f, C > 3 ? v[3] : 0.0f);
    }
  }
  if (stats != nullptr && tid == 0) {
    atomicAdd(&stats[0], 1ull);
    if (!staged) atomicAdd(&stats[1], 1ull);
  }
  __syncthreads();

  const int x = tx0 + threadIdx.x;
  const int y = ty0 + threadIdx.y;
  if (x >= out_w || y >= out_h) return;

  StagedTaps tile;
  tile.base = stage4;
  tile.pitch = ipitch;
  tile.oy = by0;
  tile.ox = bx0;
  const bool want_mask = mask != nullptr;
  float total[kMaxChannels];
  int inside = 0;
  int from_frame = 0;
  for (int smp = 0; smp < n_samples; ++smp) {
    float k[8];
    load_coeffs(ks, smp, k);
    const Split s = split_coords(k, x, y);
    if (want_mask) {  // nearest coverage, tested against the source frame
      const int xn = round_half_even(s.x0, s.fx);
      const int yn = round_half_even(s.y0, s.fy);
      inside += (xn >= 0 && xn < w && yn >= 0 && yn < h) ? 1 : 0;
    }
    float v[kMaxChannels];
    if (staged && s.x0 - kLo >= bx0 && s.x0 + kHi <= bx1 && s.y0 - kLo >= by0 && s.y0 + kHi <= by1) {
      sample_pixel<C, INTERP>(tile, s, v);
    } else {
      sample_pixel<C, INTERP>(src, s, v);
      ++from_frame;
    }
#pragma unroll
    for (int ch = 0; ch < C; ++ch) total[ch] = smp == 0 ? v[ch] : total[ch] + v[ch];
  }
  const int64_t o = ((int64_t)n * out_h + y) * out_w + x;
  const float count = (float)n_samples;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) out[o * C + ch] = total[ch] / count;
  if (want_mask) {
    // zero_small(1 - cover): the float32 sum of 0/1 coverages is exact
    const float cover = (float)inside * (float)(1.0 / (double)n_samples);
    const float m = 1.0f - cover;
    mask[o] = m < 1e-3f ? 0.0f : m;
  }
  if (stats != nullptr && from_frame > 0) atomicAdd(&stats[2], (unsigned long long)from_frame);
}

template <int C>
cudaError_t launch_c(const float* frames, const float* coeffs, const float* border, float* out,
                     int n, int h, int w, int out_h, int out_w, int row0, int interp, cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY, 1);
  const dim3 grid((out_w + kBlockX - 1) / kBlockX, (out_h + kBlockY - 1) / kBlockY, n);
  switch (interp) {
    case kBilinear:
      warp_kernel<C, kBilinear><<<grid, block, 0, stream>>>(frames, coeffs, border, out, h, w, out_h, out_w,
                                                                 row0);
      break;
    case kBicubic:
      warp_kernel<C, kBicubic><<<grid, block, 0, stream>>>(frames, coeffs, border, out, h, w, out_h, out_w,
                                                                 row0);
      break;
    case kNearest:
      warp_kernel<C, kNearest><<<grid, block, 0, stream>>>(frames, coeffs, border, out, h, w, out_h, out_w,
                                                                 row0);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_blur_c(const float* frames, const float* coeffs, const float* border, float* out,
                          float* mask, unsigned long long* stats, int n, int h, int w, int out_h, int out_w, int interp,
                          int n_samples, cudaStream_t stream) {
  const dim3 block(kBlockX, kBlockY, 1);
  const dim3 grid((out_w + kBlockX - 1) / kBlockX, (out_h + kBlockY - 1) / kBlockY, n);
  switch (interp) {
    case kBilinear:
      warp_blur_kernel<C, kBilinear><<<grid, block, kStageBytes, stream>>>(
          frames, coeffs, border, out, mask, stats, h, w, out_h, out_w, n_samples);
      break;
    case kBicubic:
      warp_blur_kernel<C, kBicubic><<<grid, block, kStageBytes, stream>>>(
          frames, coeffs, border, out, mask, stats, h, w, out_h, out_w, n_samples);
      break;
    default:  // nearest has no shutter blur, as in models/motion_apply.py
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// frames (n, h, w, c), coeffs (n, 8), border (c,), out (n, out_h, out_w, c);
// all float32, contiguous, on the current device.  out receives the
// output rows [row0, row0 + out_h) of the warp (row0 = 0: the whole
// canvas; row0 > 0: one row band of a canvas split over devices, each
// pixel computed as in the whole canvas).  interp: 0 bilinear,
// 1 bicubic, 2 nearest.  Returns the launch's cudaError_t (0 on success).
extern "C" int cvst_warp(const float* frames, const float* coeffs, const float* border, float* out,
                         int n, int h, int w, int c, int out_h, int out_w, int row0, int interp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n > 65535 || out_h <= 0 || out_w <= 0 || h <= 0 || w <= 0 || row0 < 0 || row0 > INT_MAX - out_h) {
    return (int)cudaErrorInvalidValue;
  }
  switch (c) {
    case 1: return (int)launch_c<1>(frames, coeffs, border, out, n, h, w, out_h, out_w, row0, interp, s);
    case 2: return (int)launch_c<2>(frames, coeffs, border, out, n, h, w, out_h, out_w, row0, interp, s);
    case 3: return (int)launch_c<3>(frames, coeffs, border, out, n, h, w, out_h, out_w, row0, interp, s);
    case 4: return (int)launch_c<4>(frames, coeffs, border, out, n, h, w, out_h, out_w, row0, interp, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K3.  frames (n, h, w, c), coeffs (n, n_samples, 8) sample-minor, border
// (c,), out (n, out_h, out_w, c), mask (n, out_h, out_w) or null, stats
// (3,) int64 or null; all float32 unless stated, contiguous, on the
// current device.  interp: 0 bilinear, 1 bicubic.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int cvst_warp_blur(const float* frames, const float* coeffs, const float* border, float* out,
                              float* mask, unsigned long long* stats, int n, int h, int w, int c, int out_h, int out_w,
                              int interp, int n_samples, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n > 65535 || out_h <= 0 || out_w <= 0 || h <= 0 || w <= 0 || n_samples <= 0 ||
      n_samples > kMaxSamples) {
    return (int)cudaErrorInvalidValue;
  }
  switch (c) {
    case 1: return (int)launch_blur_c<1>(frames, coeffs, border, out, mask, stats, n, h, w, out_h, out_w, interp,
                                         n_samples, s);
    case 2: return (int)launch_blur_c<2>(frames, coeffs, border, out, mask, stats, n, h, w, out_h, out_w, interp,
                                         n_samples, s);
    case 3: return (int)launch_blur_c<3>(frames, coeffs, border, out, mask, stats, n, h, w, out_h, out_w, interp,
                                         n_samples, s);
    case 4: return (int)launch_blur_c<4>(frames, coeffs, border, out, mask, stats, n, h, w, out_h, out_w, interp,
                                         n_samples, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

namespace {

constexpr int kStatsThreads = 256;

// One pixel of K8: 1 - coverage of the round-half-even nearest source of
// the displacement (dx, dy) at (x, frame_row), the steps of split_coords
// after the division.  safe == false is the zero denominator's guard.
__device__ __forceinline__ bool padded_at(float dx, float dy, bool safe, int x, int frame_row, int in_h, int in_w) {
  dx = safe ? clip(dx, -kDispLim, kDispLim) : -kDispLim;
  dy = safe ? clip(dy, -kDispLim, kDispLim) : -kDispLim;
  const float dxf = floorf(dx);
  const float dyf = floorf(dy);
  const int xn = round_half_even(x + (int)dxf, dx - dxf);
  const int yn = round_half_even(frame_row + (int)dyf, dy - dyf);
  // xn >= 0 && xn < in_w && yn >= 0 && yn < in_h, as two unsigned tests
  return !((unsigned)xn < (unsigned)in_w && (unsigned)yn < (unsigned)in_h);
}

// K8.  One thread owns VEC neighbouring pixels of one output row (VEC =
// 16, 8 or 4 needs out_w % VEC == 0, so a group never straddles a row and
// its mask values are VEC / 4 aligned float4 stores).  blockIdx.y is the
// frame.  out_wh, when not null, is the bucket's true canvas (w, h) on the
// device: only pixels with x < w and frame row < h are counted (the mask
// is written everywhere).  counts must be zeroed; it receives the padded
// pixels.
//
// Each frame takes one of two routes, uniformly across its blocks (the
// frame is blockIdx.y), chosen from its coefficients alone: never from
// out_wh or the band.
//   * Affine (k[6] == 0.0f && k[7] == 0.0f, true for +-0 and false for
//     NaN): qx = ((a-1)*x + b*y) + c and qy = (d*x + (e-1)*y) + f, then
//     the clip, floor, fraction and round-half-even of the plain version.
//     It skips the denominator, the reciprocal, the safe select and the
//     four g/h subtractions.  Why the result is bitwise the general
//     route's: with g = h = +-0 and finite x, y, denom = (1 + +-0) + +-0
//     is exactly 1, so inv_d = 1 and q * 1 = q (NaN and inf included);
//     (g*x)*x, (h*x)*y, (g*y)*x and (h*y)*y are zeros, and subtracting a
//     zero leaves every non-zero value (NaN and inf too) unchanged and can
//     flip only the sign of a zero.  The mask and the counts depend only
//     on the integers xn, yn, and a zero of either sign gives the same
//     floor (0), fraction (+0) and round (down).
//     ops/warp.py::padding_counts_affine_plain repeats this route op for
//     op, and the CPU tests hold it to padding_counts_plain.
//   * General (any other frame: perspective, NaN): split_coords' formula,
//     op for op, with the products of the row hoisted.
// On both routes b*y, (e-1)*y (and g*y, h*y, (h*y)*y) are formed once a
// thread: the same products, so nothing changes.  x in float is x0 + j
// (one conversion a thread, not a pixel): exact, since VEC > 1 is taken
// only where out_w <= 2^24; VEC 1 converts x itself.  Each thread counts its padded pixels in a register;
// a warp sums them with __reduce_add_sync, the block its warps, and one
// int64 atomicAdd a block adds that into the frame's count.
template <int VEC>
__global__ void __launch_bounds__(kStatsThreads)
padding_stats_kernel(const float* __restrict__ coeffs, const int* __restrict__ out_wh,
                     float* __restrict__ mask, unsigned long long* __restrict__ counts,
                     int out_h, int out_w, int in_h, int in_w, int row0) {
  __shared__ unsigned int warp_sums[kStatsThreads / 32];
  const int n = blockIdx.y;
  const int groups_per_row = out_w / VEC;
  const int64_t g = (int64_t)blockIdx.x * kStatsThreads + threadIdx.x;
  const bool live = g < (int64_t)out_h * groups_per_row;
  const int y = live ? (int)(g / groups_per_row) : 0;
  const int x0 = live ? (int)(g - (int64_t)y * groups_per_row) * VEC : 0;
  const int frame_row = y + row0;
  int cw = INT_MAX, ch = INT_MAX;
  if (out_wh != nullptr) {
    cw = out_wh[0];
    ch = out_wh[1];
  }
  float k[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) k[i] = coeffs[n * 8 + i];
  const float a1 = k[0] - 1.0f, b = k[1], c = k[2], d = k[3];
  const float e1 = k[4] - 1.0f, f = k[5], gg = k[6], hh = k[7];
  const float yy = (float)frame_row;
  const float by = b * yy;
  const float ey = e1 * yy;
  const float xx0 = (float)x0;
  const bool count_row = live && frame_row < ch;

  float m[VEC];
  unsigned int padded = 0;
  if (gg == 0.0f && hh == 0.0f) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int x = x0 + j;
      const float xx = j == 0 ? xx0 : xx0 + (float)j;
      const float qx = (a1 * xx + by) + c;
      const float qy = (d * xx + ey) + f;
      const bool pad = padded_at(qx, qy, true, x, frame_row, in_h, in_w);
      m[j] = pad ? 1.0f : 0.0f;  // 1 - coverage
      padded += (pad && count_row && x < cw) ? 1u : 0u;
    }
  } else {
    const float gy = gg * yy;
    const float hy = hh * yy;
    const float hyy = hy * yy;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int x = x0 + j;
      const float xx = j == 0 ? xx0 : xx0 + (float)j;
      const float denom = (1.0f + gg * xx) + hy;
      const float qx = ((((a1 * xx + by) + c) - (gg * xx) * xx) - (hh * xx) * yy);
      const float qy = (((d * xx + ey) + f) - gy * xx) - hyy;
      const bool safe = denom != 0.0f;
      const float inv_d = safe ? 1.0f / denom : 0.0f;
      const bool pad = padded_at(qx * inv_d, qy * inv_d, safe, x, frame_row, in_h, in_w);
      m[j] = pad ? 1.0f : 0.0f;
      padded += (pad && count_row && x < cw) ? 1u : 0u;
    }
  }
  if (live) {
    float* dst = mask + ((int64_t)n * out_h + y) * out_w + x0;
    if constexpr (VEC == 1) {
      dst[0] = m[0];
    } else {
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q) {
        reinterpret_cast<float4*>(dst)[q] = make_float4(m[4 * q], m[4 * q + 1], m[4 * q + 2], m[4 * q + 3]);
      }
    }
  }
  const unsigned int warp_total = __reduce_add_sync(0xffffffffu, padded);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = warp_total;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
#pragma unroll
    for (int i = 0; i < kStatsThreads / 32; ++i) total += warp_sums[i];
    if (total != 0) atomicAdd(&counts[n], total);
  }
}

template <int VEC>
cudaError_t launch_stats(dim3 grid, cudaStream_t s, const float* coeffs, const int* out_wh, float* mask,
                         unsigned long long* counts, int out_h, int out_w, int in_h, int in_w, int row0) {
  padding_stats_kernel<VEC><<<grid, kStatsThreads, 0, s>>>(coeffs, out_wh, mask, counts, out_h, out_w, in_h, in_w,
                                                          row0);
  return cudaGetLastError();
}

}  // namespace

// K8.  coeffs (n, 8) float32, out_wh (2,) int32 or null, mask (n, out_h,
// out_w) float32, counts (n,) int64 zeroed; contiguous, on the current
// device.  mask receives 1 - nearest coverage of the output rows
// [row0, row0 + out_h) against an in_h x in_w source; counts the padded
// pixels of each frame (with out_wh, those inside the true canvas).
// Returns the launch's cudaError_t (0 on success).
extern "C" int cvst_padding_stats(const float* coeffs, const int* out_wh, float* mask, unsigned long long* counts,
                                  int n, int out_h, int out_w, int in_h, int in_w, int row0, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n > 65535 || out_h <= 0 || out_w <= 0 || in_h <= 0 || in_w <= 0 || row0 < 0 ||
      row0 > INT_MAX - out_h) {
    return (int)cudaErrorInvalidValue;
  }
  // x0 + j in float is exact only below 2^24 (padding_stats_kernel)
  const int vec = out_w > (1 << 24) ? 1 : (out_w % 16 == 0 ? 16 : (out_w % 8 == 0 ? 8 : (out_w % 4 == 0 ? 4 : 1)));
  const int64_t groups = (int64_t)out_h * (out_w / vec);
  const int64_t blocks = (groups + kStatsThreads - 1) / kStatsThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, n, 1);
  switch (vec) {
    case 16: return (int)launch_stats<16>(grid, s, coeffs, out_wh, mask, counts, out_h, out_w, in_h, in_w, row0);
    case 8: return (int)launch_stats<8>(grid, s, coeffs, out_wh, mask, counts, out_h, out_w, in_h, in_w, row0);
    case 4: return (int)launch_stats<4>(grid, s, coeffs, out_wh, mask, counts, out_h, out_w, in_h, in_w, row0);
    default: return (int)launch_stats<1>(grid, s, coeffs, out_wh, mask, counts, out_h, out_w, in_h, in_w, row0);
  }
}

extern "C" const char* cvst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
