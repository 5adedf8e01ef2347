// K5: pyramidal Lucas-Kanade Gauss-Newton iterations, one feature per
// block.
//
// Replaces the TPU kernel comfyui_video_stabilizer_tpu/ops/lk_pallas.py
// (_make_kernel, launched by lk_gn_iterate's pl.pallas_call at :177).
// The TPU kernel puts 128 features on the vector lanes, turns each
// feature's sub-pixel sample into a blend over 19 static shifts (a TPU
// has no per-lane gather) and iterates until all 128 lanes are done.
// Here one 32-thread block owns one feature: its 49x49 search window
// and its 31x31 template and gradients sit in shared memory (21 KB);
// thread i samples row i of the 31x31 patch with a two-tap bilinear
// blend at the feature's own offset, forms the residual and sums its
// row of gx*r and gy*r; then every thread adds the 31 row sums in
// order, so all threads hold the same step and loop state and no
// broadcast is needed.  Each feature stops on its own (a finished
// feature never moves, so this gives the Pallas positions exactly).
//
// What bounds it on an H100: latency, not bandwidth.  At the Classic
// slice's level 0 (79 x 400 features) the inputs are 0.67 GB (read
// once into shared memory, ~0.2 ms at 3.35 TB/s); an iteration is a
// 31-step dependent chain per thread plus a 31-step chain for the row
// sums, and 21 KB of shared memory a block lets only ~10 one-warp
// blocks share an SM.  The simple design keeps every operand in shared
// memory and exits each feature as soon as it is done; packing several
// features per block, splitting the row-sum chain, and loading the
// window straight from the level (fusing K6) are left for later.
//
// Numerics are the plain version's (ops/lk_cuda.py::lk_gn_plain): the
// same clip, blend, step and stop rules in the same order, each row's
// 31 products summed in sequence and then the 31 row sums in sequence.
// Built with -fmad=false, so kernel and plain version agree bitwise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWin = 31;
constexpr int kWext = 49;
constexpr int kHalf = kWin / 2;
constexpr int kScal = 9;  // a, b, c, inv_det, run, base_x, base_y, guess_x, guess_y
constexpr int kThreads = 32;

// jnp.clip / torch.clamp order: max with lo, then min with hi (NaN passes through)
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

__global__ void __launch_bounds__(kThreads)
lk_gn_kernel(const float* __restrict__ jw, const float* __restrict__ T,
             const float* __restrict__ gx, const float* __restrict__ gy,
             const float* __restrict__ scal, float* __restrict__ g_out,
             int* __restrict__ iters_out, int iters, float eps2) {
  __shared__ float sJ[kWext * kWext];
  __shared__ float sT[kWin * kWin];
  __shared__ float sGx[kWin * kWin];
  __shared__ float sGy[kWin * kWin];
  __shared__ float rowx[kWin];
  __shared__ float rowy[kWin];

  const int64_t n = blockIdx.x;
  const int tid = threadIdx.x;
  const float* sc = scal + n * kScal;
  const float a = sc[0], b = sc[1], c = sc[2], inv_det = sc[3];
  const bool run = sc[4] > 0.5f;
  const float base_x = sc[5], base_y = sc[6];
  float g_x = sc[7], g_y = sc[8];
  int it = 0;

  if (run) {
    for (int i = tid; i < kWext * kWext; i += kThreads) sJ[i] = jw[n * kWext * kWext + i];
    for (int i = tid; i < kWin * kWin; i += kThreads) {
      sT[i] = T[n * kWin * kWin + i];
      sGx[i] = gx[n * kWin * kWin + i];
      sGy[i] = gy[n * kWin * kWin + i];
    }
    __syncthreads();

    const float lo = 0.5f, hi = (float)(kWext - kWin) - 0.5f;
    const float gx_lo = (base_x + (float)kHalf) + lo, gx_hi = (base_x + (float)kHalf) + hi;
    const float gy_lo = (base_y + (float)kHalf) + lo, gy_hi = (base_y + (float)kHalf) + hi;
    float prev2 = 1.0e30f;
    int stall = 0;
    bool done = false;
    while (!done && it < iters) {
      const float ly = clip((g_y - (float)kHalf) - base_y, lo, hi);
      const float lx = clip((g_x - (float)kHalf) - base_x, lo, hi);
      const float ey = floorf(ly), ex = floorf(lx);
      const float fy = ly - ey, fx = lx - ex;
      const float wy = 1.0f - fy, wx = 1.0f - fx;
      const int eyi = (int)ey, exi = (int)ex;
      if (tid < kWin) {
        const float* r0 = sJ + (eyi + tid) * kWext + exi;
        const float* r1 = r0 + kWext;
        const float* t = sT + tid * kWin;
        const float* px = sGx + tid * kWin;
        const float* py = sGy + tid * kWin;
        float left = wy * r0[0] + fy * r1[0];
        float sx = 0.0f, sy = 0.0f;
        for (int j = 0; j < kWin; ++j) {
          const float right = wy * r0[j + 1] + fy * r1[j + 1];
          const float res = (wx * left + fx * right) - t[j];
          const float ux = px[j] * res, uy = py[j] * res;
          sx = j == 0 ? ux : sx + ux;
          sy = j == 0 ? uy : sy + uy;
          left = right;
        }
        rowx[tid] = sx;
        rowy[tid] = sy;
      }
      __syncthreads();
      float bx = rowx[0], by = rowy[0];
      for (int i = 1; i < kWin; ++i) {
        bx = bx + rowx[i];
        by = by + rowy[i];
      }
      __syncthreads();  // the row sums are rewritten by the next iteration

      const float dx = -(c * bx - b * by) * inv_det;
      const float dy = -(-b * bx + a * by) * inv_det;
      g_x = clip(g_x + dx, gx_lo, gx_hi);
      g_y = clip(g_y + dy, gy_lo, gy_hi);
      const float step2 = dx * dx + dy * dy;
      stall = step2 >= 0.98f * prev2 ? stall + 1 : 0;
      prev2 = step2;
      ++it;
      done = step2 <= eps2 || stall >= 5;
    }
  }
  if (tid == 0) {
    g_out[2 * n] = g_x;
    g_out[2 * n + 1] = g_y;
    iters_out[n] = it;
  }
}

}  // namespace

// jw (n, 49, 49), T / gx / gy (n, 31, 31), scal (n, 9) float32 inputs;
// g_out (n, 2) float32 and iters_out (n,) int32 outputs; all contiguous
// on the current device.  eps2 is float32(eps * eps).  Returns the
// launch's cudaError_t (0 on success).
extern "C" int cvst_lk_gn(const float* jw, const float* T, const float* gx, const float* gy,
                          const float* scal, float* g_out, int* iters_out, int n, int iters,
                          float eps2, void* stream) {
  if (n <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  lk_gn_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      jw, T, gx, gy, scal, g_out, iters_out, iters, eps2);
  return (int)cudaGetLastError();
}
