// K9: the estimation gray and its integer-factor area pool in one pass:
// the Rec.601 luma of each source pixel, the "x255 -> uint8" quantization
// (floor), and the mean of each fy x fx patch.
//
// It replaces no pallas_call: the JAX package leaves this stage to XLA
// (comfyui_video_stabilizer_tpu/ops/resize.py:93 _gray_pool_kernel, and
// :54 _gray_kernel for the gray alone, fy = fx = 1).
//
// What bounds it on an H100: bytes.  It reads the clip once (80 x 1080p
// RGB float32 is 1.99 GB, 0.594 ms at 3.35 TB/s) and writes the small
// gray once; per source pixel it does ~8 operations.  The plain version
// (ops/resize.py::gray_pool_plain) forms the luma through float64
// temporaries and passes ~15 full-size temporaries through device
// memory.  Here one thread computes one output pixel from its fy x fx
// patch, read straight from device memory, with neighbouring threads on
// neighbouring 4*C*fx-byte runs of each source row, so a warp's loads
// cover whole cache lines; nothing but the output is written.
//
// Numerics are the plain version's, op for op: the luma is
// fma(b, L2, fma(g, L1, r * L0)), each fma rounded once (__fmaf_rn: the
// chain XLA's CPU backend emits; -fmad=false does not touch an explicit
// fma), the quantization floor(clip(v * 255, 0, 255)), the patch summed
// in float32 in row-major order (exact on quantized grays; XLA's order
// otherwise) and multiplied by the float32 reciprocal of fy * fx, as
// XLA's mean.  A 1-channel clip takes channel 0 as the gray.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kGrayThreads = 128;
// the Rec.601 weights as float32 (ops/resize.py::_LUMA)
constexpr float kL0 = 0.299f;
constexpr float kL1 = 0.587f;
constexpr float kL2 = 0.114f;

template <int C, bool QUANTIZE>
__device__ __forceinline__ float gray_of(const float* __restrict__ px) {
  float v;
  if constexpr (C == 1) {
    v = __ldg(px);
  } else {
    const float r = __ldg(px), g = __ldg(px + 1), b = __ldg(px + 2);
    v = __fmaf_rn(b, kL2, __fmaf_rn(g, kL1, __fmul_rn(r, kL0)));
  }
  if constexpr (QUANTIZE) {
    v = v * 255.0f;
    v = v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);  // NaN passes, as torch.clamp
    v = floorf(v);
  }
  return v;
}

// One thread per output pixel: x the output column, blockIdx.y the output
// row, blockIdx.z the frame.
template <int C, bool QUANTIZE>
__global__ void __launch_bounds__(kGrayThreads)
gray_pool_kernel(const float* __restrict__ frames, float* __restrict__ out, int h, int w, int fy, int fx,
                 int out_w, float inv) {
  const int x = blockIdx.x * kGrayThreads + threadIdx.x;
  if (x >= out_w) return;
  const int y = blockIdx.y;
  const int n = blockIdx.z;
  const int out_h = gridDim.y;
  const float* src = frames + (((int64_t)n * h + (int64_t)y * fy) * w + (int64_t)x * fx) * C;
  float acc = 0.0f;
  for (int dy = 0; dy < fy; ++dy) {
    const float* row = src + (int64_t)dy * w * C;
    for (int dx = 0; dx < fx; ++dx) {
      const float v = gray_of<C, QUANTIZE>(row + dx * C);
      acc = (dy == 0 && dx == 0) ? v : acc + v;
    }
  }
  out[((int64_t)n * out_h + y) * out_w + x] = acc * inv;
}

template <int C>
cudaError_t launch_gray(const float* frames, float* out, int n, int h, int w, int fy, int fx, bool quantize,
                        cudaStream_t stream) {
  const int out_h = h / fy;
  const int out_w = w / fx;
  const float inv = 1.0f / (float)(fy * fx);
  const dim3 grid((out_w + kGrayThreads - 1) / kGrayThreads, out_h, n);
  if (quantize) {
    gray_pool_kernel<C, true><<<grid, kGrayThreads, 0, stream>>>(frames, out, h, w, fy, fx, out_w, inv);
  } else {
    gray_pool_kernel<C, false><<<grid, kGrayThreads, 0, stream>>>(frames, out, h, w, fy, fx, out_w, inv);
  }
  return cudaGetLastError();
}

}  // namespace

// K9.  frames (n, h, w, c) float32 with c = 1 or 3, out (n, h / fy, w / fx)
// float32; contiguous, on the current device; fy divides h and fx divides
// w.  quantize: 1 floors the gray to 0..255 levels, 0 keeps the luma.
// Returns the launch's cudaError_t (0 on success).
extern "C" int cvst_gray_pool(const float* frames, float* out, int n, int h, int w, int c, int fy, int fx,
                              int quantize, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n > 65535 || h <= 0 || w <= 0 || fy <= 0 || fx <= 0 || h % fy != 0 || w % fx != 0 ||
      h / fy > 65535 || fy > INT_MAX / fx) {
    return (int)cudaErrorInvalidValue;
  }
  switch (c) {
    case 1: return (int)launch_gray<1>(frames, out, n, h, w, fy, fx, quantize != 0, s);
    case 3: return (int)launch_gray<3>(frames, out, n, h, w, fy, fx, quantize != 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
