// K2: DIS residual cost volume with streaming argmin and parabolic
// sub-pixel refinement.
//
// Replaces the TPU kernel comfyui_video_stabilizer_tpu/ops/cv_pallas.py
// (_make_kernel, launched by cost_volume_subpixel's pl.pallas_call).  On
// the TPU one grid step holds a whole pyramid level of one frame pair in
// VMEM.  Here one block owns a 16x16 output tile of one pair: it stages
// the I patch field ((16+7)^2) and the Jw field with its +-r halo
// ((16+7+2r)^2) in shared memory, and each thread scans the (2r+1)^2
// candidate shifts of its own pixel with every cost in registers.
//
// What bounds it on an H100: shared-memory loads and their latency, not
// device memory.  The levels are small (at most 79 x 135 x 240 on the
// 1080p slice, 10 MB of input per launch, or 37,920 pixels at the
// coarsest level), but every pixel reads 64 Jw values per candidate
// from shared memory (1,600 at r = 2) and keeps all (2r+1)^2 costs and
// its 8x8 I patch in registers; at 255 registers a thread, one
// 256-thread block fits an SM, so little latency is hidden.  The simple
// design spends no extra passes: one read of I and Jw per tile into
// shared memory, one write of (fx, fy, cmin), no cost volume in device
// memory.  Sharing the 8-row column sums between neighbouring threads
// (a separable box sum in shared memory), trimming registers for
// occupancy, and fusing the LK step that follows are left for later.
//
// Numerics are the plain version's (ops/cv_cuda.py::cost_volume_plain)
// and the JAX mirror's op order: inputs scaled by (float)(1/255), edge
// padding composed into one clamp of the source index (pad (4, 3) per
// axis plus r for Jw), the 8x8 sum of squared differences taken as the
// shift-add tree of _tree -- rows pairwise at steps 1, 2 and 4, then
// columns the same, then x(1/64) -- a dy-major candidate scan with a
// strict < (the first candidate wins a tie), then the neighbour
// selection and clipped parabola of _subpixel_from_costs.  Built with
// -fmad=false so every operation rounds as in PyTorch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPatch = 8;
constexpr int kTile = 16;
constexpr int kPadTop = kPatch / 2;  // (pt, pb) = (4, 3)

__device__ __forceinline__ float tree8(const float s[kPatch]) {
  return ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7]));
}

__device__ __forceinline__ float parab(float cm, float cl, float cr) {
  const float eps = (float)1e-9;
  const float denom = (cl + cr) - 2.0f * cm;
  float off = denom > eps ? (0.5f * (cl - cr)) / fmaxf(denom, eps) : 0.0f;
  off = off < -0.5f ? -0.5f : (off > 0.5f ? 0.5f : off);
  return off;
}

template <int R>
__global__ void __launch_bounds__(kTile * kTile)
cost_volume_kernel(const float* __restrict__ I, const float* __restrict__ Jw,
                   float* __restrict__ fx_out, float* __restrict__ fy_out,
                   float* __restrict__ cmin_out, int h, int w) {
  constexpr int K = 2 * R + 1;
  constexpr int IT = kTile + kPatch - 1;
  constexpr int JT = IT + 2 * R;
  __shared__ float Is[IT][IT];
  __shared__ float Js[JT][JT];

  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * kTile;
  const int tx0 = blockIdx.x * kTile;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const float* Ib = I + (int64_t)b * h * w;
  const float* Jb = Jw + (int64_t)b * h * w;
  const float inv255 = (float)(1.0 / 255.0);

  for (int i = tid; i < IT * IT; i += kTile * kTile) {
    const int u = i / IT, v = i - (i / IT) * IT;
    const int sy = min(max(ty0 + u - kPadTop, 0), h - 1);
    const int sx = min(max(tx0 + v - kPadTop, 0), w - 1);
    Is[u][v] = Ib[(int64_t)sy * w + sx] * inv255;
  }
  for (int i = tid; i < JT * JT; i += kTile * kTile) {
    const int u = i / JT, v = i - (i / JT) * JT;
    const int sy = min(max(ty0 + u - kPadTop - R, 0), h - 1);
    const int sx = min(max(tx0 + v - kPadTop - R, 0), w - 1);
    Js[u][v] = Jb[(int64_t)sy * w + sx] * inv255;
  }
  __syncthreads();

  const int ty = threadIdx.y, tx = threadIdx.x;
  const int oy = ty0 + ty, ox = tx0 + tx;
  if (oy >= h || ox >= w) return;

  // this pixel's I patch is the same for every candidate: keep it in registers
  float ip[kPatch][kPatch];
#pragma unroll
  for (int u = 0; u < kPatch; ++u) {
#pragma unroll
    for (int v = 0; v < kPatch; ++v) ip[u][v] = Is[ty + u][tx + v];
  }

  float costs[K * K];
  float cmin = 0.0f;
  int best = 0;
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      float col[kPatch];
#pragma unroll
      for (int v = 0; v < kPatch; ++v) {
        float s[kPatch];
#pragma unroll
        for (int u = 0; u < kPatch; ++u) {
          const float d = ip[u][v] - Js[ty + u + dy][tx + v + dx];
          s[u] = d * d;
        }
        col[v] = tree8(s);
      }
      const float c = tree8(col) * (1.0f / (kPatch * kPatch));
      const int i = dy * K + dx;
      costs[i] = c;
      if (i == 0) {
        cmin = c;
        best = 0;
      } else if (c < cmin) {
        cmin = c;
        best = i;
      }
    }
  }

  const int by = best / K;
  const int bx = best - by * K;
  const int tgt_y0 = max(by - 1, 0) * K + bx;
  const int tgt_y1 = min(by + 1, K - 1) * K + bx;
  const int tgt_x0 = by * K + max(bx - 1, 0);
  const int tgt_x1 = by * K + min(bx + 1, K - 1);
  float cy0 = 0.0f, cy1 = 0.0f, cx0 = 0.0f, cx1 = 0.0f;
#pragma unroll
  for (int i = 0; i < K * K; ++i) {
    cy0 = tgt_y0 == i ? costs[i] : cy0;
    cy1 = tgt_y1 == i ? costs[i] : cy1;
    cx0 = tgt_x0 == i ? costs[i] : cx0;
    cx1 = tgt_x1 == i ? costs[i] : cx1;
  }
  float suby = parab(cmin, cy0, cy1);
  float subx = parab(cmin, cx0, cx1);
  suby = (by == 0 || by == K - 1) ? 0.0f : suby;
  subx = (bx == 0 || bx == K - 1) ? 0.0f : subx;

  const int64_t o = ((int64_t)b * h + oy) * w + ox;
  fy_out[o] = ((float)by - (float)R) + suby;
  fx_out[o] = ((float)bx - (float)R) + subx;
  cmin_out[o] = cmin;
}

template <int R>
cudaError_t launch_r(const float* I, const float* Jw, float* fx, float* fy, float* cmin,
                     int b, int h, int w, cudaStream_t stream) {
  const dim3 block(kTile, kTile, 1);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, b);
  cost_volume_kernel<R><<<grid, block, 0, stream>>>(I, Jw, fx, fy, cmin, h, w);
  return cudaGetLastError();
}

}  // namespace

// I, Jw (b, h, w) float32 grays in 0..255 units; fx, fy, cmin (b, h, w)
// float32 outputs; all contiguous on the current device.  radius in
// {2, 3}, patch == 8.  Returns the launch's cudaError_t (0 on success).
extern "C" int cvst_cost_volume(const float* I, const float* Jw, float* fx, float* fy, float* cmin,
                                int b, int h, int w, int radius, int patch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (patch != kPatch || b <= 0 || b > 65535 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  switch (radius) {
    case 2: return (int)launch_r<2>(I, Jw, fx, fy, cmin, b, h, w, s);
    case 3: return (int)launch_r<3>(I, Jw, fx, fy, cmin, b, h, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
