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
// What bounds it on an H100: latency.  Its bytes (4 a candidate in, 8 a
// slot and 4 a count out: ~0.9 MB at (79, 2048)) take ~0.3 us at 3.35
// TB/s and its ~2 x 10^7 distance tests ~1.6 us at the float32 rate, but
// a verdict depends on every verdict before it.  The design shortens
// that chain from one step a candidate to one step a block of kBlock =
// 32 candidates.  One block of kWarps = 16 warps a frame (the frame on
// the grid's x axis, at most 65,535 a launch); the accepted corners sit
// in shared memory (8 bytes a slot).  Every warp holds the block's 32
// candidates, one a lane (the next block's load starts a block ahead),
// and for each block:
//   1. outside test: lane l of warp v tests candidate l against the
//      accepted slots v, v + 16, ...; a ballot gives the warp's "near"
//      bits;
//   2. inside test: warp v forms, for candidates i = v and v + 16, the
//      32-bit mask of the earlier candidates j < i of the block that lie
//      closer than min_d2 (a shuffle of candidate i, a ballot over j);
//   3. resolve (warp 0, bit operations, lane i = candidate i): live =
//      valid and near to no earlier corner; then in rounds, every live
//      undecided candidate with no undecided earlier neighbour is
//      accepted, and every undecided one with an earlier neighbour just
//      accepted is rejected.  The first undecided candidate is decided in
//      each round, so the rounds end (one or two on the slice's
//      candidates); the accepted set is then cut to its first
//      max_corners - n members, which take the next slots in order;
//   4. a barrier publishes the new slots and n; the walk ends at
//      max_corners or at the end of the candidates.
// A block of invalid candidates costs no barrier.
//
// Exactness: a candidate's verdict depends only on the corners accepted
// before it.  Step 1 covers those of earlier blocks and step 3 those of
// its own block: a candidate is accepted in a round only once every
// earlier neighbour in the block is decided and none was accepted, which
// is the in-order walk's verdict, and the cut keeps the acceptances that
// precede the max_corners-th, where the walk stops.  So the result is the
// sequential greedy's: ops/greedy_cuda.py::greedy_plain (one step a
// candidate), greedy_blocked_plain (these four steps in plain torch), the
// JAX scan and the native greedy.  Every test is the same float32
// dy * dy + dx * dx < min_d2 with dy = (earlier y) - (later y); x and y
// are integers, below 2^12 they, their differences and their squares are
// exact in float32, and the sum is rounded once as in the JAX scan (built
// with -fmad=false, so nothing is contracted).
//
// Shared memory is max_corners slots and 196 bytes of scratch: 3.4 KB at
// the Classic graph's 400 corners.  Past 48 KB (max_corners >= 6120) the
// launch opts in to more dynamic shared memory first; that call is not
// stream-ordered, and the graphs never reach it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 32;  // candidates a block, one a lane
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxCorners = 6144;
constexpr size_t kDefaultShared = 48 * 1024;

struct Scratch {
  unsigned near[kWarps];     // step 1's ballot of each warp
  unsigned earlier[kBlock];  // step 2's masks
  int n;                     // accepted after step 3
};

__global__ void __launch_bounds__(kThreads) greedy_kernel(const int* __restrict__ top_idx, float* __restrict__ pts,
                                                          int* __restrict__ counts, int k, int w, int max_corners,
                                                          float min_d2) {
  extern __shared__ float2 acc[];  // accepted (x, y), max_corners slots, then the Scratch
  Scratch& sc = *reinterpret_cast<Scratch*>(acc + max_corners);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned bit = 1u << lane;
  const int64_t f = blockIdx.x;
  const int* cand = top_idx + f * (int64_t)k;
  int n = 0;  // accepted so far, the same in every thread
  int next = lane < k ? cand[lane] : -1;
  for (int64_t c0 = 0; c0 < k && n < max_corners; c0 += kBlock) {
    const int idx = next;
    next = c0 + kBlock + lane < k ? cand[c0 + kBlock + lane] : -1;
    const unsigned valid = __ballot_sync(kAll, idx >= 0);
    if (valid == 0u) continue;  // every warp holds the same candidates: uniform
    const int yi = idx >= 0 ? idx / w : 0;
    const float cy = (float)yi;
    const float cx = (float)(idx - yi * w);

    bool near = false;  // 1. against the corners of earlier blocks
#pragma unroll 4
    for (int s = warp; s < n; s += kWarps) {
      const float2 a = acc[s];
      const float dy = a.y - cy;
      const float dx = a.x - cx;
      near |= dy * dy + dx * dx < min_d2;
    }
    const unsigned near_bits = __ballot_sync(kAll, near);
    for (int i = warp; i < kBlock; i += kWarps) {  // 2. the earlier candidates of the block
      const float iy = __shfl_sync(kAll, cy, i);
      const float ix = __shfl_sync(kAll, cx, i);
      const float dy = cy - iy;
      const float dx = cx - ix;
      const unsigned m = __ballot_sync(kAll, lane < i && dy * dy + dx * dx < min_d2);
      if (lane == 0) sc.earlier[i] = m;
    }
    if (lane == 0) sc.near[warp] = near_bits;
    __syncthreads();

    if (warp == 0) {  // 3. resolve in score order
      const unsigned near_any = __reduce_or_sync(kAll, lane < kWarps ? sc.near[lane] : 0u);
      const unsigned m = sc.earlier[lane];
      unsigned open = valid & ~near_any;  // live and undecided
      unsigned take = 0u;
      while (open != 0u) {
        const bool mine = (open & bit) != 0u;
        const unsigned now = __ballot_sync(kAll, mine && (m & open) == 0u);
        const unsigned lost = __ballot_sync(kAll, mine && (m & now) != 0u);
        take |= now;
        open &= ~(now | lost);
      }
      while (__popc(take) > max_corners - n) take &= ~(0x80000000u >> __clz(take));  // the walk stops there
      if (take & bit) acc[n + __popc(take & (bit - 1u))] = make_float2(cx, cy);
      if (lane == 0) sc.n = n + __popc(take);
    }
    __syncthreads();  // 4. the new slots and n
    n = sc.n;
  }
  float2* out = reinterpret_cast<float2*>(pts) + f * (int64_t)max_corners;
  for (int s = threadIdx.x; s < max_corners; s += kThreads) out[s] = s < n ? acc[s] : make_float2(0.0f, 0.0f);
  if (threadIdx.x == 0) counts[f] = n;
}

}  // namespace

extern "C" int cvst_greedy(const int* top_idx, float* pts, int* counts, int b, int k, int w, int max_corners,
                           float min_d2, void* stream) {
  if (b <= 0 || b > 65535 || k <= 0 || w <= 0 || max_corners <= 0 || max_corners > kMaxCorners) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t bytes = (size_t)max_corners * sizeof(float2) + sizeof(Scratch);
  if (bytes > kDefaultShared) {
    const cudaError_t err = cudaFuncSetAttribute(greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  greedy_kernel<<<b, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(top_idx, pts, counts, k, w, max_corners,
                                                                            min_d2);
  return (int)cudaGetLastError();
}
