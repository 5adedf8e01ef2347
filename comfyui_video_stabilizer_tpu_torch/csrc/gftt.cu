// K4: GFTT corner scores -- 21x21 structure-tensor box sums, minimum
// eigenvalue and 3x3 non-maximum suppression.
//
// Replaces the TPU kernel comfyui_video_stabilizer_tpu/ops/gftt_pallas.py
// (_make_kernel, launched by gftt_scores's pl.pallas_call at :151).  On
// the TPU one grid step DMAs a 104-row strip of the three reflect-padded
// products into VMEM and sums it with sublane and lane rolls.  Here one
// block owns a 32x32 output tile of one frame and works through the
// three products one after another: it stages the product over the tile
// plus a 10 + 1 pixel halo (54x54, reflect-101 applied by index
// arithmetic, so no padded copy exists in device memory), takes the
// 21-row sums of 34 rows (the tile and its NMS halo), then the 21-column
// sums of those, and keeps the three 34x34 box sums in shared memory
// (33 KB in all).  The eigenvalue and the NMS then run on the 34x34 box
// sums, and only the 32x32 scores go back to device memory.
//
// What bounds it on an H100: device-memory traffic.  At the Classic
// slice's shape (79 x 540 x 960) it reads three 164 MB products and
// writes one 164 MB score map, ~0.65 GB, or ~0.2 ms at 3.35 TB/s; the
// halo makes each block read 2.85x its own pixels, served mostly from L2.
// The adds (~20 per box sum, ~3,000 box sums per block and product) are
// far below the card's rate.  The simple design spends one pass over the
// inputs and one write; sharing halos between neighbouring tiles or
// fusing the Sobel products into the load are left for later.
//
// Numerics are the plain version's (ops/gftt_cuda.py::gftt_plain): each
// 21-term sum is the doubling tree of the Pallas _rollsum,
// ((S16[i] + S4[i+16]) + x[i+20]), rows then columns; the eigenvalue is
// 0.5 * ((a + c) - sqrt((a - c)(a - c) + (4 b) b)) with a correctly
// rounded sqrtf.  Built with -fmad=false, so kernel and plain version
// agree bitwise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRadius = 10;
constexpr int kTile = 32;                   // output tile side
constexpr int kE = kTile + 2;               // eigenvalue tile: the tile + the NMS halo
constexpr int kP = kE + 2 * kRadius;        // product tile: + the box halo (54)
constexpr int kThreads = 256;

// reflect-101 source index of position i on an axis of n (any i: the
// pad reflects again past the far edge, as jnp.pad does); ops/pad.py
// builds the same map for the plain version
__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  int m = i % period;
  if (m < 0) m += period;
  return m < n ? m : period - m;
}

// partial sums of the doubling tree over p[0], p[s], p[2s], ...
__device__ __forceinline__ float s2(const float* p, int s) { return p[0] + p[s]; }
__device__ __forceinline__ float s4(const float* p, int s) { return s2(p, s) + s2(p + 2 * s, s); }
__device__ __forceinline__ float s8(const float* p, int s) { return s4(p, s) + s4(p + 4 * s, s); }
__device__ __forceinline__ float s16(const float* p, int s) { return s8(p, s) + s8(p + 8 * s, s); }

// p[0] + p[s] + ... + p[20 s] in the order of _rollsum(x, 21)
__device__ __forceinline__ float tree21(const float* p, int s) {
  return (s16(p, s) + s4(p + 16 * s, s)) + p[20 * s];
}

__global__ void __launch_bounds__(kThreads)
gftt_kernel(const float* __restrict__ pa, const float* __restrict__ pb,
            const float* __restrict__ pc, float* __restrict__ out, int h, int w) {
  __shared__ float src[kP * kP];            // one product over the tile + halos
  __shared__ float rows[kE * kP];           // its 21-row sums
  __shared__ float box[3][kE * kE];         // the three box sums

  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * kTile;
  const int tx0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int64_t plane = (int64_t)h * w;
  const float* prods[3] = {pa + b * plane, pb + b * plane, pc + b * plane};

  for (int k = 0; k < 3; ++k) {
    const float* p = prods[k];
    // src[u][v] holds the padded product at image (ty0 - 11 + u, tx0 - 11 + v)
    for (int i = tid; i < kP * kP; i += kThreads) {
      const int u = i / kP, v = i - (i / kP) * kP;
      const int y = reflect101(ty0 - 1 - kRadius + u, h);
      const int x = reflect101(tx0 - 1 - kRadius + v, w);
      src[i] = p[(int64_t)y * w + x];
    }
    __syncthreads();
    for (int i = tid; i < kE * kP; i += kThreads) {
      rows[i] = tree21(&src[i], kP);        // rows u..u+20 of column v
    }
    __syncthreads();
    for (int i = tid; i < kE * kE; i += kThreads) {
      const int u = i / kE, v = i - (i / kE) * kE;
      box[k][i] = tree21(&rows[u * kP + v], 1);
    }
    __syncthreads();
  }

  // eigenvalues of the tile and its halo, -inf outside the image (reuses src)
  float* eig = src;
  for (int i = tid; i < kE * kE; i += kThreads) {
    const int u = i / kE, v = i - (i / kE) * kE;
    const int gy = ty0 - 1 + u, gx = tx0 - 1 + v;
    float e = -INFINITY;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      const float a = box[0][i], bb = box[1][i], c = box[2][i];
      const float d = a - c;
      e = 0.5f * ((a + c) - sqrtf(d * d + (4.0f * bb) * bb));
    }
    eig[i] = e;
  }
  __syncthreads();

  for (int i = tid; i < kTile * kTile; i += kThreads) {
    const int u = i / kTile, v = i - (i / kTile) * kTile;
    const int oy = ty0 + u, ox = tx0 + v;
    if (oy >= h || ox >= w) continue;
    const float e = eig[(u + 1) * kE + (v + 1)];
    float m = e;
#pragma unroll
    for (int du = 0; du < 3; ++du) {
#pragma unroll
      for (int dv = 0; dv < 3; ++dv) m = fmaxf(m, eig[(u + du) * kE + (v + dv)]);
    }
    out[b * plane + (int64_t)oy * w + ox] = e >= m ? e : -INFINITY;
  }
}

}  // namespace

// pa, pb, pc (b, h, w) float32 Sobel products; out (b, h, w) float32
// scores; all contiguous on the current device.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int cvst_gftt(const float* pa, const float* pb, const float* pc, float* out,
                         int b, int h, int w, void* stream) {
  if (b <= 0 || b > 65535 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, b);
  gftt_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(pa, pb, pc, out, h, w);
  return (int)cudaGetLastError();
}
