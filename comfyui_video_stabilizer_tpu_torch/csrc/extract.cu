// K6: per-feature window extraction -- an exact copy of each feature's
// wext x wext window of a zero-padded level at a clamped integer corner.
//
// Replaces the TPU kernel comfyui_video_stabilizer_tpu/ops/extract_pallas.py
// (_make_kernel, launched by extract_windows_dma's pl.pallas_call at
// :133).  Mosaic can only DMA (8, 128)-aligned blocks, so the TPU kernel
// copies an aligned superset of each window into VMEM and removes the
// residual offset with two dynamic rolls; without the kernel the JAX
// package selects windows with one-hot matmuls.  Hopper loads any
// address, so here one block copies one (pair, feature) window straight
// from the unpadded level: window cell (r, c) reads image pixel
// (cy - wext + r, cx - wext + c), or writes 0 where that lies outside
// the image.  The zero pad is index arithmetic, so the padded copy of
// the level (~0.2 GB per level at the Classic slice's size) never exists.
//
// What bounds it on an H100: device-memory writes.  At the slice's
// shape (79 pairs x 400 features, wext 49) it writes 304 MB of windows
// and reads about as much, ~0.2 ms at 3.35 TB/s; neighbouring threads
// copy neighbouring pixels of a window row, so both sides coalesce.
// Feeding K5 straight from the level (windows never in device memory) is
// left for later.
//
// An exact copy: kernel and plain version (ops/extract_cuda.py::
// extract_plain) agree bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
extract_kernel(const float* __restrict__ stack, const int* __restrict__ corners,
               float* __restrict__ out, int h, int w, int f, int wext) {
  const int feat = blockIdx.x;
  const int b = blockIdx.y;
  const int64_t bf = (int64_t)b * f + feat;
  // dynamic_slice semantics on the stack padded by wext a side
  const int cy = min(max(corners[2 * bf + 1] + wext, 0), h + wext);
  const int cx = min(max(corners[2 * bf + 0] + wext, 0), w + wext);
  const int y0 = cy - wext, x0 = cx - wext;   // image coordinates of cell (0, 0)
  const float* img = stack + (int64_t)b * h * w;
  float* win = out + bf * wext * wext;
  for (int i = threadIdx.x; i < wext * wext; i += kThreads) {
    const int r = i / wext, c = i - (i / wext) * wext;
    const int y = y0 + r, x = x0 + c;
    win[i] = (y >= 0 && y < h && x >= 0 && x < w) ? img[(int64_t)y * w + x] : 0.0f;
  }
}

}  // namespace

// stack (b, h, w) float32; corners (b, f, 2) int32 (x, y); out (b, f,
// wext, wext) float32; all contiguous on the current device.  Returns
// the launch's cudaError_t (0 on success).
extern "C" int cvst_extract_windows(const float* stack, const int* corners, float* out,
                                    int b, int h, int w, int f, int wext, void* stream) {
  if (b <= 0 || b > 65535 || h <= 0 || w <= 0 || f <= 0 || wext <= 0 || wext > 1024)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(f, b, 1);
  extract_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      stack, corners, out, h, w, f, wext);
  return (int)cudaGetLastError();
}
