// K10 and K11: the small batched linear algebra of the perspective fits.
//
// K10 (smallest_eigvec) replaces jnp.linalg.eigh in the DLT refit
// (comfyui_video_stabilizer_tpu/ops/ransac.py:112, _refit_homography):
// the unit eigenvector of the smallest eigenvalue of each 9x9 normal
// matrix.  K11 replaces jnp.linalg.solve of the 4-point homography
// systems (ops/ransac.py:60, _solve_homography_4pt; here the entry
// homography_4pt, which builds each system itself) and of the IRLS
// pre-warp's normal equations (ops/flow_dis.py:341; the general entry
// solve8).  Neither is a pallas_call: XLA lowers both.  The port's
// library calls for them (torch.linalg.eigh, torch.linalg.solve_ex) read
// the card on the host, so no CUDA graph can hold them; these kernels can.
//
// What bounds them on an H100.  K10 reads 79-127 matrices (25-41 KB,
// nanoseconds at 3.35 TB/s): it is latency, a chain of 5-8 Jacobi sweeps
// a matrix.  One warp takes a matrix, its upper triangle and V in shared
// memory, and runs each sweep in the parallel (round-robin) order: 9
// rounds of 4 disjoint pairs (one index sits out a round).  In a round
// every lane computes one pair's test and rotation (lanes k, k + 4, ...
// the same pair k), the warp shares them by shuffles, then 30 lanes
// apply the four rotations at once, each to four entries of A or V by
// the same code (no divergent paths; its entries' offsets a round come
// from a table the warp builds first): the 2x2 blocks where two pairs
// cross (the earlier pair's rotation first), the sitting-out index's
// row, the pairs' own entries and V's rows.  The chain is 9 rounds a
// sweep where the cyclic order had 36 rotations.  Disjoint pairs do not
// touch each other's test or rotation, so a round rounds exactly as its
// four rotations one after the other, which is what the plain version
// does.
//
// K11 reads 40,448-65,024 8x8 systems (10-17 MB) a call, or 79 of the
// IRLS ones: bytes, if they are read well.  One thread solves a system,
// A and b in registers, the pivot row swap done by selects over the rows
// below k so no index is dynamic.  A block stages its 128 systems
// through shared memory: coalesced 16-byte loads in, 16-byte reads of
// each thread's own rows (the row stride padded to 68 floats, which
// keeps a quarter warp's reads on distinct banks), and the solutions out
// the same way.  The 4-point entry reads each hypothesis's four
// correspondences (16 floats) and builds A + 1e-12 I and b in registers,
// as the torch construction does, so the systems (256 bytes each) never
// pass through device memory.
//
// The arithmetic is the plain versions' (ops/linalg_cuda.py:
// smallest_eigvec_plain, solve8_plain, homography_4pt_plain) op for op;
// built with -fmad=false, every product and sum rounds on its own and
// the kernels are bitwise equal to them.  Every division and square root
// is IEEE (nvcc's default -prec-div=true -prec-sqrt=true).

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kN = 9;                       // K10's matrix order
constexpr int kSlots = 4;                   // disjoint pairs a round
constexpr int kRounds = 9;                  // rounds a sweep
constexpr float kTol = 1.1920928955078125e-07f;  // 2**-23 (linalg_cuda.JACOBI_TOL)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kS = 8;                       // K11's system order
constexpr int kSolveThreads = 128;          // systems a block
constexpr int kAStride = kS * kS + 4;       // floats a staged system: 16-byte aligned, no bank conflicts
constexpr int kVecStride = kS + 4;          // floats a staged right-hand side, solution or 4-point set
constexpr float kRidge = 1e-12f;            // the 4-point systems' ridge (ops/ransac.py)

// (i, j) of the upper triangle of a row-major 9x9 matrix, either order
__device__ __forceinline__ int up(int i, int j) { return i <= j ? i * kN + j : j * kN + i; }

// The pair in slot k of round r: r + k + 1 and r - k - 1 (mod 9), the
// smaller first; index r sits out.  Over r = 0..8 every pair comes once.
__device__ __forceinline__ void round_pair(int r, int k, int& p, int& q) {
  int i = r + k + 1, j = r - k - 1;
  if (i >= kN) i -= kN;
  if (j < 0) j += kN;
  p = min(i, j);
  q = max(i, j);
}

// (x, y) <- (c x - s y, s x + c y) where the rotation is taken
__device__ __forceinline__ void mix(float& x, float& y, float c, float s, bool rot) {
  const float nx = c * x - s * y, ny = s * x + c * y;
  x = rot ? nx : x;
  y = rot ? ny : y;
}

// A warp's shared floats: the matrix (its upper triangle, i <= j, is
// used), V, and a slot the idle lanes read and write.
constexpr int kVOff = kN * kN;
constexpr int kScratch = 2 * kN * kN;

// What a lane updates in a round: four entries x0..x3 of A or V, mixed
// first (x0, x1) and (x2, x3) by the rotations of slots p and p2, then
// (x0, x2) and (x1, x3) by slot q's.  Lanes 0-5: the 2x2 block where
// slots a < b cross (rows of a, columns of b: a's rotation first, as the
// plain version's order has it); 6-23: half a row of V (two slots);
// 24-25: the sitting-out index's row against two slots; 26-29: a slot's
// own a_pp, a_pq, a_pq, a_qq, mixed with c = 1 and s = t (1 a_pp - t a_pq
// and t a_pq + 1 a_qq round as the plain version's a_pp - t a_pq and
// a_qq + t a_pq), a_pq then 0; 30-31: none.  Every lane runs the same
// code, so the warp never splits.
struct LaneTask {
  int p, p2, q;  // slots
  bool second;   // the (x0, x2), (x1, x3) mixes are taken
  bool own;      // a slot's own entries
  bool idle;
};

__device__ __forceinline__ LaneTask lane_task(int lane) {
  LaneTask k{0, 0, 0, false, false, false};
  if (lane < 6) {
    k.p = k.p2 = lane < 3 ? 0 : lane < 5 ? 1 : 2;
    k.q = lane < 3 ? lane + 1 : lane < 5 ? lane - 1 : 3;
    k.second = true;
  } else if (lane < 26) {
    k.p = 2 * ((lane - 6) & 1);
    k.p2 = k.p + 1;
  } else if (lane < 30) {
    k.p = k.p2 = lane - 26;
    k.own = true;
  } else {
    k.idle = true;
  }
  return k;
}

// The shared offsets of the lane's four entries in round r, a byte each.
__device__ __forceinline__ unsigned lane_entries(int lane, int r, const LaneTask& k) {
  int pa, qa, pb, qb;
  round_pair(r, k.p, pa, qa);
  round_pair(r, k.p2, pb, qb);
  int e0, e1, e2, e3;
  if (k.second) {  // the slots k.p (rows) and k.q (columns) cross
    round_pair(r, k.q, pb, qb);
    e0 = up(pa, pb), e1 = up(qa, pb), e2 = up(pa, qb), e3 = up(qa, qb);
  } else if (lane < 24) {  // row (lane - 6) / 2 of V
    const int row = kVOff + ((lane - 6) >> 1) * kN;
    e0 = row + pa, e1 = row + qa, e2 = row + pb, e3 = row + qb;
  } else if (lane < 26) {  // row r against two slots
    e0 = up(r, pa), e1 = up(r, qa), e2 = up(r, pb), e3 = up(r, qb);
  } else if (k.own) {
    e0 = pa * kN + pa, e1 = e2 = pa * kN + qa, e3 = qa * kN + qa;
  } else {
    e0 = e1 = e2 = e3 = kScratch;
  }
  return (unsigned)e0 | (unsigned)e1 << 8 | (unsigned)e2 << 16 | (unsigned)e3 << 24;
}

__global__ void __launch_bounds__(32)
smallest_eigvec_kernel(const float* __restrict__ mats, float* __restrict__ out, int sweeps) {
  __shared__ float m[2 * kN * kN + 1];
  __shared__ unsigned entries[kRounds * 32];
  const int lane = threadIdx.x;
  const float* src = mats + (int64_t)blockIdx.x * kN * kN;
  for (int e = lane; e < kN * kN; e += 32) {
    const int i = e / kN, j = e - i * kN;
    if (j >= i) m[e] = src[e];
    m[kVOff + e] = i == j ? 1.0f : 0.0f;
  }
  if (lane == 0) m[kScratch] = 0.0f;
  const LaneTask task = lane_task(lane);
  for (int r = 0; r < kRounds; ++r) entries[r * 32 + lane] = lane_entries(lane, r, task);
  __syncwarp();
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    bool rotated = false;
    for (int r = 0; r < kRounds; ++r) {
      // slot (lane & 3)'s test and rotation, from the matrix as the round found it
      int p, q;
      round_pair(r, lane & 3, p, q);
      const float app = m[p * kN + p], aqq = m[q * kN + q], apq = m[p * kN + q];
      const bool rot = fabsf(apq) > kTol * (sqrtf(fabsf(app)) * sqrtf(fabsf(aqq)));
      const float theta = (aqq - app) / (2.0f * apq);
      float t = 1.0f / (fabsf(theta) + sqrtf(theta * theta + 1.0f));
      if (theta < 0.0f) t = -t;
      const float c = 1.0f / sqrtf(t * t + 1.0f);
      const float s = t * c;
      rotated |= __any_sync(kFull, rot);
      const int irot = rot;
      float c1 = __shfl_sync(kFull, c, task.p), s1 = __shfl_sync(kFull, s, task.p);
      const float t1 = __shfl_sync(kFull, t, task.p);
      const bool r1 = __shfl_sync(kFull, irot, task.p) && !task.idle;
      float c2 = __shfl_sync(kFull, c, task.p2), s2 = __shfl_sync(kFull, s, task.p2);
      const bool r2 = __shfl_sync(kFull, irot, task.p2) && !task.idle;
      const float cq = __shfl_sync(kFull, c, task.q), sq = __shfl_sync(kFull, s, task.q);
      const bool rq = __shfl_sync(kFull, irot, task.q) && task.second;
      c1 = task.own ? 1.0f : c1;
      s1 = task.own ? t1 : s1;
      c2 = task.own ? 1.0f : c2;
      s2 = task.own ? t1 : s2;
      const unsigned e = entries[r * 32 + lane];
      const int e0 = e & 0xff, e1 = (e >> 8) & 0xff, e2 = (e >> 16) & 0xff, e3 = e >> 24;
      __syncwarp();  // every read of the round's parameters before any write
      float x0 = m[e0], x1 = m[e1], x2 = m[e2], x3 = m[e3];
      mix(x0, x1, c1, s1, r1);
      mix(x2, x3, c2, s2, r2);
      mix(x0, x2, cq, sq, rq);
      mix(x1, x3, cq, sq, rq);
      if (task.own && r1) x1 = x2 = 0.0f;
      m[e0] = x0;
      m[e1] = x1;
      m[e2] = x2;
      m[e3] = x3;
      __syncwarp();
    }
    if (!rotated) break;
  }
  // the smallest diagonal entry, the first on ties
  float best = m[0];
  int idx = 0;
#pragma unroll
  for (int i = 1; i < kN; ++i) {
    if (m[i * kN + i] < best) {
      best = m[i * kN + i];
      idx = i;
    }
  }
  if (lane < kN) out[(int64_t)blockIdx.x * kN + lane] = m[kVOff + lane * kN + idx];
}

// Gaussian elimination with partial pivoting of one system in registers;
// the solution into sol.
__device__ __forceinline__ void eliminate(float (&a)[kS][kS], float (&r)[kS], float (&sol)[kS]) {
#pragma unroll
  for (int k = 0; k < kS; ++k) {
    // the first row of largest |a_ik|, i >= k
    float best = fabsf(a[k][k]);
    int piv = k;
#pragma unroll
    for (int i = k + 1; i < kS; ++i) {
      const float cand = fabsf(a[i][k]);
      if (cand > best) {
        best = cand;
        piv = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < kS; ++i) {
      const bool swap = piv == i;
#pragma unroll
      for (int j = 0; j < kS; ++j) {
        const float rk = a[k][j], ri = a[i][j];
        a[k][j] = swap ? ri : rk;
        a[i][j] = swap ? rk : ri;
      }
      const float bk = r[k], bi = r[i];
      r[k] = swap ? bi : bk;
      r[i] = swap ? bk : bi;
    }
    // LAPACK's sgetf2: the column times the pivot's reciprocal, a
    // division where the pivot is below the smallest normal float32
    const float pivot = a[k][k];
    const bool by_reciprocal = fabsf(pivot) >= FLT_MIN;
    const float reciprocal = 1.0f / pivot;
#pragma unroll
    for (int i = k + 1; i < kS; ++i) {
      const float l = by_reciprocal ? a[i][k] * reciprocal : a[i][k] / pivot;
#pragma unroll
      for (int j = k + 1; j < kS; ++j) a[i][j] = a[i][j] - l * a[k][j];
      r[i] = r[i] - l * r[k];
    }
  }
#pragma unroll
  for (int i = kS - 1; i >= 0; --i) {
    float s = r[i];
#pragma unroll
    for (int j = i + 1; j < kS; ++j) s = s - a[i][j] * sol[j];
    sol[i] = s / a[i][i];
  }
}

// Copy `count` float4s from device memory into shared memory, `per`
// float4s an item at `stride` floats an item; all threads of the block.
__device__ __forceinline__ void stage_in(float* dst, const float* src, int count, int per, int stride) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int f = threadIdx.x; f < count; f += kSolveThreads) {
    const int item = f / per, part = f - item * per;
    *reinterpret_cast<float4*>(dst + item * stride + part * 4) = s4[f];
  }
}

__global__ void __launch_bounds__(kSolveThreads)
solve8_kernel(const float* __restrict__ A, const float* __restrict__ rhs, float* __restrict__ x, int n) {
  __shared__ __align__(16) float s_a[kSolveThreads * kAStride];
  __shared__ __align__(16) float s_b[kSolveThreads * kVecStride];
  const int64_t first = (int64_t)blockIdx.x * kSolveThreads;
  const int nb = (int)min((int64_t)kSolveThreads, (int64_t)n - first);
  stage_in(s_a, A + first * kS * kS, nb * (kS * kS / 4), kS * kS / 4, kAStride);
  stage_in(s_b, rhs + first * kS, nb * (kS / 4), kS / 4, kVecStride);
  __syncthreads();
  const int t = threadIdx.x;
  if (t < nb) {
    float a[kS][kS], r[kS], sol[kS];
    const float* my_a = s_a + t * kAStride;
    float* my_b = s_b + t * kVecStride;
#pragma unroll
    for (int f = 0; f < kS * kS / 4; ++f) {
      const float4 v = *reinterpret_cast<const float4*>(my_a + 4 * f);
      a[f / 2][(f % 2) * 4 + 0] = v.x;
      a[f / 2][(f % 2) * 4 + 1] = v.y;
      a[f / 2][(f % 2) * 4 + 2] = v.z;
      a[f / 2][(f % 2) * 4 + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < kS; ++i) r[i] = my_b[i];
    eliminate(a, r, sol);
#pragma unroll
    for (int i = 0; i < kS; ++i) my_b[i] = sol[i];
  }
  __syncthreads();
  float4* x4 = reinterpret_cast<float4*>(x + first * kS);
  for (int f = t; f < nb * (kS / 4); f += kSolveThreads) {
    const int item = f / (kS / 4), part = f - item * (kS / 4);
    x4[f] = *reinterpret_cast<const float4*>(s_b + item * kVecStride + part * 4);
  }
}

__global__ void __launch_bounds__(kSolveThreads)
homography_4pt_kernel(const float* __restrict__ p, const float* __restrict__ q, float* __restrict__ H, int n) {
  __shared__ __align__(16) float s_p[kSolveThreads * kVecStride];
  __shared__ __align__(16) float s_q[kSolveThreads * kVecStride];
  __shared__ float s_h[kSolveThreads * 9];
  const int64_t first = (int64_t)blockIdx.x * kSolveThreads;
  const int nb = (int)min((int64_t)kSolveThreads, (int64_t)n - first);
  stage_in(s_p, p + first * 8, nb * 2, 2, kVecStride);
  stage_in(s_q, q + first * 8, nb * 2, 2, kVecStride);
  __syncthreads();
  const int t = threadIdx.x;
  if (t < nb) {
    // rows i: [x, y, 1, 0, 0, 0, -x u, -y u] = u; rows 4 + i: [0, 0, 0,
    // x, y, 1, -x v, -y v] = v; then + 1e-12 I over every entry, as
    // A + 1e-12 * eye adds it (so a -0 becomes +0)
    float a[kS][kS], r[kS], sol[kS];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = s_p[t * kVecStride + 2 * i], y = s_p[t * kVecStride + 2 * i + 1];
      const float u = s_q[t * kVecStride + 2 * i], v = s_q[t * kVecStride + 2 * i + 1];
      const float row_u[kS] = {x, y, 1.0f, 0.0f, 0.0f, 0.0f, -x * u, -y * u};
      const float row_v[kS] = {0.0f, 0.0f, 0.0f, x, y, 1.0f, -x * v, -y * v};
#pragma unroll
      for (int j = 0; j < kS; ++j) {
        a[i][j] = row_u[j] + (i == j ? kRidge : 0.0f);
        a[4 + i][j] = row_v[j] + (4 + i == j ? kRidge : 0.0f);
      }
      r[i] = u;
      r[4 + i] = v;
    }
    eliminate(a, r, sol);
#pragma unroll
    for (int i = 0; i < kS; ++i) s_h[t * 9 + i] = sol[i];
    s_h[t * 9 + kS] = 1.0f;
  }
  __syncthreads();
  float* dst = H + first * 9;
  for (int f = t; f < nb * 9; f += kSolveThreads) dst[f] = s_h[f];
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

}  // namespace

// K10.  mats (b, 9, 9) float32, symmetric (the upper triangle is read),
// finite; out (b, 9) float32; contiguous, on the current device.  At
// most ``sweeps`` Jacobi sweeps.  Returns the launch's cudaError_t.
extern "C" int cvst_smallest_eigvec(const float* mats, float* out, int b, int sweeps, void* stream) {
  if (b <= 0 || sweeps <= 0) return (int)cudaErrorInvalidValue;
  smallest_eigvec_kernel<<<b, 32, 0, static_cast<cudaStream_t>(stream)>>>(mats, out, sweeps);
  return (int)cudaGetLastError();
}

// K11, the general entry.  A (n, 8, 8) and rhs (n, 8) float32; x (n, 8)
// float32; contiguous, 16-byte aligned, on the current device.  Returns
// the launch's cudaError_t.
extern "C" int cvst_solve8(const float* A, const float* rhs, float* x, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  if (!aligned16(A) || !aligned16(rhs) || !aligned16(x)) return (int)cudaErrorMisalignedAddress;
  const int blocks = (int)(((int64_t)n + kSolveThreads - 1) / kSolveThreads);
  solve8_kernel<<<blocks, kSolveThreads, 0, static_cast<cudaStream_t>(stream)>>>(A, rhs, x, n);
  return (int)cudaGetLastError();
}

// K11, the 4-point entry.  p, q (n, 4, 2) float32 correspondences
// (16-byte aligned); H (n, 9) float32, each the homography's first eight
// entries and h22 = 1; contiguous, on the current device.  Returns the
// launch's cudaError_t.
extern "C" int cvst_homography_4pt(const float* p, const float* q, float* H, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  if (!aligned16(p) || !aligned16(q)) return (int)cudaErrorMisalignedAddress;
  const int blocks = (int)(((int64_t)n + kSolveThreads - 1) / kSolveThreads);
  homography_4pt_kernel<<<blocks, kSolveThreads, 0, static_cast<cudaStream_t>(stream)>>>(p, q, H, n);
  return (int)cudaGetLastError();
}
