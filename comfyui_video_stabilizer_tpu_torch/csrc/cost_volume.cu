// K2: DIS residual cost volume with its argmin and parabolic sub-pixel
// refinement.
//
// Replaces the TPU kernel comfyui_video_stabilizer_tpu/ops/cv_pallas.py
// (_make_kernel, launched by cost_volume_subpixel's pl.pallas_call).  On
// the TPU one grid step holds a whole pyramid level of one frame pair in
// VMEM and forms each candidate's 8x8 sums with the overlapping shift-add
// tree _tree, so every partial sum is made once per level.  Here one
// 512-thread block owns a 32x16 output tile of one pair and shares the
// tree's partial sums across the tile the same way.
//
// What bounds it on an H100: the level is small (79 x 135 x 240 on the
// 1080p Flow slice: I and Jw in, fx, fy and cmin out, 20 bytes a pixel,
// ~15 us of device memory), so the tree's work sets the pace: ~9
// operations a pixel a candidate as counted on the tree (~15 as done
// here, with the overlap of a thread's chunk), their shared-memory
// traffic and the instructions around them.  The earlier design re-summed
// every pixel's whole 8x8 patch from shared memory (64 loads and ~192
// operations a pixel a candidate) and was shared-memory bound.  The design:
//   * I and Jw, scaled by (float)(1/255), are staged once per tile,
//     (16+7) x (32+7) and (16+7+2r) x (32+7+2r), with the edge clamp;
//   * per candidate row dy, all 2r+1 dx candidates at once, two
//     __syncthreads() a row:
//     - vertical: a thread owns one column of one 8-row chunk (its 15 I
//       values stay in registers across candidates), forms the 15 d^2
//       values and runs the row steps 1, 2, 4 in registers: 8 column sums
//       into shared memory;
//     - horizontal: a thread owns 8 outputs of one row, reads 15 column
//       sums and runs the column steps 1, 2, 4 in registers, then x1/64,
//       into the tile's cost volume in shared memory (all (2r+1)^2
//       candidates, 53 KB at r = 2, so no thread holds a cost array in
//       registers: 40 registers and three 512-thread blocks an SM);
//   * then each thread scans its pixel's costs in the dy-major order
//     with the strict-< argmin and reads the four neighbour costs by
//     index for the parabolas.
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

#include <atomic>

namespace {

constexpr int kPatch = 8;
constexpr int kTileX = 32;
constexpr int kTileY = 16;
constexpr int kThreads = kTileX * kTileY;
constexpr int kPadTop = kPatch / 2;            // (pt, pb) = (4, 3)
constexpr int kChunk = 8;                       // output rows (vertical) / columns (horizontal) a thread's tree owns
constexpr int kSpan = kChunk + kPatch - 1;      // inputs that tree reads: 15
constexpr int kIW = kTileX + kPatch - 1;        // 39 staged I columns
constexpr int kIH = kTileY + kPatch - 1;        // 23 staged I rows
constexpr int kVItems = kIW * (kTileY / kChunk);   // vertical items per candidate: 39 columns x 2 chunks
constexpr int kHItems = kTileY * (kTileX / kChunk);  // horizontal items per candidate: 16 rows x 4 chunks
constexpr int kCPitch = kTileX + 1;             // cost rows padded against bank conflicts

__device__ __forceinline__ float parab(float cm, float cl, float cr) {
  const float eps = (float)1e-9;
  const float denom = (cl + cr) - 2.0f * cm;
  float off = denom > eps ? (0.5f * (cl - cr)) / fmaxf(denom, eps) : 0.0f;
  off = off < -0.5f ? -0.5f : (off > 0.5f ? 0.5f : off);
  return off;
}

// _tree's three doubling steps over kSpan values in registers: out[j] is
// ((s[j]+s[j+1]) + (s[j+2]+s[j+3])) + ((s[j+4]+s[j+5]) + (s[j+6]+s[j+7])),
// each partial sum formed once for the kChunk outputs.
__device__ __forceinline__ void tree_steps(float s[kSpan]) {
#pragma unroll
  for (int j = 0; j < kSpan - 1; ++j) s[j] = s[j] + s[j + 1];
#pragma unroll
  for (int j = 0; j < kSpan - 3; ++j) s[j] = s[j] + s[j + 2];
#pragma unroll
  for (int j = 0; j < kSpan - 7; ++j) s[j] = s[j] + s[j + 4];
}

template <int R>
struct Smem {
  static constexpr int K = 2 * R + 1;
  static constexpr int JW = kIW + 2 * R;
  static constexpr int JH = kIH + 2 * R;
  float Is[kIH][kIW];
  float Js[JH][JW];
  float V[K][kTileY][kIW];            // column sums of one candidate row
  float Cs[K * K][kTileY][kCPitch];  // every candidate's costs of the tile
};

template <int R>
__global__ void __launch_bounds__(kThreads, R == 2 ? 3 : 1)
cost_volume_kernel(const float* __restrict__ I, const float* __restrict__ Jw,
                   float* __restrict__ fx_out, float* __restrict__ fy_out,
                   float* __restrict__ cmin_out, int h, int w) {
  using S = Smem<R>;
  constexpr int K = S::K;
  constexpr int kVPer = (K * kVItems + kThreads - 1) / kThreads;  // vertical items a thread
  constexpr int kHPer = (K * kHItems + kThreads - 1) / kThreads;
  extern __shared__ float4 smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);

  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * kTileY;
  const int tx0 = blockIdx.x * kTileX;
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const float* Ib = I + (int64_t)b * h * w;
  const float* Jb = Jw + (int64_t)b * h * w;
  const float inv255 = (float)(1.0 / 255.0);

  // a warp stages 32 consecutive columns of a row: coalesced, no division
  for (int u = threadIdx.y; u < S::JH; u += kTileY) {
    const int64_t jrow = (int64_t)min(max(ty0 + u - kPadTop - R, 0), h - 1) * w;
    const int64_t irow = (int64_t)min(max(ty0 + u - kPadTop, 0), h - 1) * w;
    for (int v = threadIdx.x; v < S::JW; v += kTileX) {
      sm.Js[u][v] = Jb[jrow + min(max(tx0 + v - kPadTop - R, 0), w - 1)] * inv255;
      if (u < kIH && v < kIW) sm.Is[u][v] = Ib[irow + min(max(tx0 + v - kPadTop, 0), w - 1)] * inv255;
    }
  }
  __syncthreads();

  // this thread's vertical items: (dx, chunk, column), fixed over the dy
  // rows; a warp takes 32 consecutive columns of one (dx, chunk), so its
  // loads and stores fall on distinct banks, and the 7 columns past the
  // 32nd of every (dx, chunk) come last
  int v_dx[kVPer], v_row[kVPer], v_col[kVPer];
  float ireg[kVPer][kSpan];
#pragma unroll
  for (int p = 0; p < kVPer; ++p) {
    constexpr int kChunks = kTileY / kChunk;
    constexpr int kTail = kIW - kTileX;
    const int item = min(tid + p * kThreads, K * kVItems - 1);
    const bool head = item < K * kChunks * kTileX;
    const int t = head ? item : item - K * kChunks * kTileX;
    const int per = head ? kTileX : kTail;
    const int pair = t / per;  // dx * kChunks + chunk
    v_dx[p] = pair / kChunks;
    v_row[p] = (pair % kChunks) * kChunk;
    v_col[p] = (head ? 0 : kTileX) + t % per;
#pragma unroll
    for (int j = 0; j < kSpan; ++j) ireg[p][j] = sm.Is[v_row[p] + j][v_col[p]];
  }

  for (int dy = 0; dy < K; ++dy) {
#pragma unroll
    for (int p = 0; p < kVPer; ++p) {
      if (tid + p * kThreads < K * kVItems) {
        float s[kSpan];
#pragma unroll
        for (int j = 0; j < kSpan; ++j) {
          const float d = ireg[p][j] - sm.Js[v_row[p] + j + dy][v_col[p] + v_dx[p]];
          s[j] = d * d;
        }
        tree_steps(s);
#pragma unroll
        for (int j = 0; j < kChunk; ++j) sm.V[v_dx[p]][v_row[p] + j][v_col[p]] = s[j];
      }
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kHPer; ++p) {
      const int item = tid + p * kThreads;
      if (item < K * kHItems) {
        const int dx = item / kHItems;
        const int rem = item % kHItems;
        const int r = rem / (kTileX / kChunk);
        const int c0 = (rem % (kTileX / kChunk)) * kChunk;
        float s[kSpan];
#pragma unroll
        for (int j = 0; j < kSpan; ++j) s[j] = sm.V[dx][r][c0 + j];
        tree_steps(s);
#pragma unroll
        for (int j = 0; j < kChunk; ++j) sm.Cs[dy * K + dx][r][c0 + j] = s[j] * (1.0f / (kPatch * kPatch));
      }
    }
    __syncthreads();
  }

  const int ty = threadIdx.y, tx = threadIdx.x;
  const int oy = ty0 + ty, ox = tx0 + tx;
  if (oy >= h || ox >= w) return;
  float cmin = sm.Cs[0][ty][tx];
  int best = 0;
#pragma unroll
  for (int i = 1; i < K * K; ++i) {
    const float c = sm.Cs[i][ty][tx];
    if (c < cmin) {
      cmin = c;
      best = i;
    }
  }
  const int by = best / K;
  const int bx = best - by * K;
  const float cy0 = sm.Cs[max(by - 1, 0) * K + bx][ty][tx];
  const float cy1 = sm.Cs[min(by + 1, K - 1) * K + bx][ty][tx];
  const float cx0 = sm.Cs[by * K + max(bx - 1, 0)][ty][tx];
  const float cx1 = sm.Cs[by * K + min(bx + 1, K - 1)][ty][tx];
  float suby = parab(cmin, cy0, cy1);
  float subx = parab(cmin, cx0, cx1);
  suby = (by == 0 || by == K - 1) ? 0.0f : suby;
  subx = (bx == 0 || bx == K - 1) ? 0.0f : subx;

  const int64_t o = ((int64_t)b * h + oy) * w + ox;
  fy_out[o] = ((float)by - (float)R) + suby;
  fx_out[o] = ((float)bx - (float)R) + subx;
  cmin_out[o] = cmin;
}

// The opt-in to more than 48 KB of dynamic shared memory is an attribute
// of the kernel on the current device: set it on a device's first launch
// only, so later launches make no extra driver call.
constexpr int kMaxDevices = 64;

template <int R>
cudaError_t opt_in_smem(int bytes) {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(cost_volume_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && known) done[dev].store(true, std::memory_order_release);
  return err;
}

template <int R>
cudaError_t launch_r(const float* I, const float* Jw, float* fx, float* fy, float* cmin,
                     int b, int h, int w, cudaStream_t stream) {
  const dim3 block(kTileX, kTileY, 1);
  const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY, b);
  const int bytes = (int)sizeof(Smem<R>);  // above 48 KB: dynamic shared memory, opted in
  const cudaError_t err = opt_in_smem<R>(bytes);
  if (err != cudaSuccess) return err;
  cost_volume_kernel<R><<<grid, block, bytes, stream>>>(I, Jw, fx, fy, cmin, h, w);
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
