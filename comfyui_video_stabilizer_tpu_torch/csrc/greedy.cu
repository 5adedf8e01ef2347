// K7: the score-descending min-distance greedy that picks GFTT's corners
// from each frame's ranked candidates.
//
// No pallas_call stands behind it: the JAX package leaves this stage to
// XLA, as a lax.scan of 16-candidate blocks
// (comfyui_video_stabilizer_tpu/ops/lk.py::_greedy_device, :162).  Its
// sequential oracle is the native greedy (native/rectangle.cpp).
//
// Semantics (those of _greedy_device): a frame's candidates are flat
// pixel indices idx = y * w + x in score order, -1 for an invalid one.
// In that order a valid candidate is accepted if and only if fewer than
// max_corners were accepted before it and its squared distance
// (ay - y)^2 + (ax - x)^2 to every accepted corner (ax, ay), in float32,
// is at least min_d2.  The accepted corners fill the output slots in
// order as float32 (x, y); unused slots hold (0, 0); counts[f] is the
// number accepted.
//
// What bounds it on an H100: the chain of dependent steps.  Each
// candidate's verdict depends on every verdict before it, so a frame is
// up to K = 2048 steps in a row.  Its bytes (4 a candidate in, 8 a slot
// and 4 a count out: ~0.9 MB at (79, 2048)) take ~0.3 us at 3.35 TB/s,
// and its ~2 x 10^7 distance tests are nothing beside the card's rate.
// The design keeps each step short:
//   * one warp a frame (a block of 32 threads, the frame on the grid's
//     x axis, at most 65,535 a launch), so a step needs no
//     __syncthreads, only warp votes and shuffles;
//   * the warp reads its candidates 32 at a time in one coalesced load,
//     takes a ballot of the valid ones and walks their set bits in
//     order, each candidate's (x, y) broadcast by a shuffle;
//   * the accepted corners sit in shared memory (8 bytes a slot); lane l
//     tests slots l, l + 32, ..., so a step costs ceil(n / 32) distance
//     tests a lane and one __any_sync, and lane 0 writes an accepted
//     corner into slot n;
//   * the walk stops once max_corners corners are accepted.
//
// Exactness: x and y are integers; below 2^12 they, their differences
// and their squares are exact in float32, and the sum is rounded once
// as in the JAX scan (built with -fmad=false, so nothing is contracted).
// The kernel, its plain version (ops/greedy_cuda.py::greedy_plain), the
// JAX scan and the native greedy therefore agree exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxCorners = 6144;  // 48 KB of accepted corners: no opt-in needed

__global__ void __launch_bounds__(kLanes) greedy_kernel(const int* __restrict__ top_idx, float* __restrict__ pts,
                                                        int* __restrict__ counts, int k, int w, int max_corners,
                                                        float min_d2) {
  extern __shared__ float2 acc[];  // accepted (x, y), max_corners slots
  const int lane = threadIdx.x;
  const int64_t f = blockIdx.x;
  const int* cand = top_idx + f * (int64_t)k;
  int n = 0;  // accepted so far, the same in every lane
  for (int c0 = 0; c0 < k && n < max_corners; c0 += kLanes) {
    const int i = c0 + lane;
    const int idx = i < k ? cand[i] : -1;
    const int yi = idx >= 0 ? idx / w : 0;
    const float fy = (float)yi;
    const float fx = (float)(idx - yi * w);
    unsigned valid = __ballot_sync(kAll, idx >= 0);
    while (valid != 0u && n < max_corners) {
      const int j = __ffs(valid) - 1;
      valid &= valid - 1u;
      const float cx = __shfl_sync(kAll, fx, j);
      const float cy = __shfl_sync(kAll, fy, j);
      bool near = false;
      for (int s = lane; s < n; s += kLanes) {
        const float2 a = acc[s];
        const float dy = a.y - cy;
        const float dx = a.x - cx;
        near |= dy * dy + dx * dx < min_d2;
      }
      if (!__any_sync(kAll, near)) {
        if (lane == 0) acc[n] = make_float2(cx, cy);
        ++n;
        __syncwarp();  // the new slot is visible to every lane's next test
      }
    }
  }
  float2* out = reinterpret_cast<float2*>(pts) + f * (int64_t)max_corners;
  for (int s = lane; s < max_corners; s += kLanes) out[s] = s < n ? acc[s] : make_float2(0.0f, 0.0f);
  if (lane == 0) counts[f] = n;
}

}  // namespace

extern "C" int cvst_greedy(const int* top_idx, float* pts, int* counts, int b, int k, int w, int max_corners,
                           float min_d2, void* stream) {
  if (b <= 0 || b > 65535 || k <= 0 || w <= 0 || max_corners <= 0 || max_corners > kMaxCorners) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t bytes = (size_t)max_corners * sizeof(float2);
  greedy_kernel<<<b, kLanes, bytes, static_cast<cudaStream_t>(stream)>>>(top_idx, pts, counts, k, w, max_corners,
                                                                           min_d2);
  return (int)cudaGetLastError();
}
