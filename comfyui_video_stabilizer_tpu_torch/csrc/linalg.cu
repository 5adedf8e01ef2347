// K10 and K11: the small batched linear algebra of the perspective fits.
//
// K10 (smallest_eigvec) replaces jnp.linalg.eigh in the DLT refit
// (comfyui_video_stabilizer_tpu/ops/ransac.py:112, _refit_homography):
// the unit eigenvector of the smallest eigenvalue of each 9x9 normal
// matrix.  K11 (solve8) replaces jnp.linalg.solve of the 4-point
// homography systems (ops/ransac.py:60, _solve_homography_4pt) and of
// the IRLS pre-warp's normal equations (ops/flow_dis.py:341).  Neither
// is a pallas_call: XLA lowers both.  The port's library calls for them
// (torch.linalg.eigh, torch.linalg.solve_ex) read the card on the host,
// so no CUDA graph can hold them; these kernels can.
//
// What bounds them on an H100: latency, not bytes.  K10 reads 79-127
// matrices (25-41 KB, nanoseconds at 3.35 TB/s) and runs a serial chain
// of rotations on each: one thread a matrix, the upper triangle (45
// floats) and V (81) in registers, every index a compile-time constant
// (the sweep's 36 pairs unrolled).  K11 reads 40,448-65,024 8x8 systems
// (10-17 MB): one thread a system, A and b in registers, the pivot row
// swap done by selects over the rows below k so no index is dynamic.
//
// The arithmetic is the plain versions' (ops/linalg_cuda.py:
// smallest_eigvec_plain, solve8_plain) op for op; built with
// -fmad=false, every product and sum rounds on its own and the kernels
// are bitwise equal to them.  Every division and square root is IEEE
// (nvcc's default -prec-div=true -prec-sqrt=true).

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kN = 9;                       // K10's matrix order
constexpr int kTri = kN * (kN + 1) / 2;     // its upper triangle
constexpr float kTol = 1.1920928955078125e-07f;  // 2**-23 (linalg_cuda.JACOBI_TOL)
constexpr int kEigThreads = 32;
constexpr int kS = 8;                       // K11's system order
constexpr int kSolveThreads = 128;

// index of (i, j) in the row-major upper triangle, either order
__host__ __device__ constexpr int tri(int i, int j) {
  return i <= j ? i * kN - i * (i + 1) / 2 + j : j * kN - j * (j + 1) / 2 + i;
}

// One cyclic Jacobi rotation of the pair (P, Q) (linalg_cuda's docstring).
template <int P, int Q>
__device__ __forceinline__ void rotate(float (&a)[kTri], float (&v)[kN][kN], bool& rotated) {
  const float app = a[tri(P, P)], aqq = a[tri(Q, Q)], apq = a[tri(P, Q)];
  if (!(fabsf(apq) > kTol * (sqrtf(fabsf(app)) * sqrtf(fabsf(aqq))))) return;
  rotated = true;
  const float theta = (aqq - app) / (2.0f * apq);
  float t = 1.0f / (fabsf(theta) + sqrtf(theta * theta + 1.0f));
  if (theta < 0.0f) t = -t;
  const float c = 1.0f / sqrtf(t * t + 1.0f);
  const float s = t * c;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    if (k == P || k == Q) continue;
    const float akp = a[tri(k, P)], akq = a[tri(k, Q)];
    a[tri(k, P)] = c * akp - s * akq;
    a[tri(k, Q)] = s * akp + c * akq;
  }
  a[tri(P, P)] = app - t * apq;
  a[tri(Q, Q)] = aqq + t * apq;
  a[tri(P, Q)] = 0.0f;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const float vkp = v[k][P], vkq = v[k][Q];
    v[k][P] = c * vkp - s * vkq;
    v[k][Q] = s * vkp + c * vkq;
  }
}

// The pairs (P, Q), Q = P+1..8, of row P, then the rows after it.
template <int P, int Q>
__device__ __forceinline__ void sweep_from(float (&a)[kTri], float (&v)[kN][kN], bool& rotated) {
  if constexpr (P < kN - 1) {
    rotate<P, Q>(a, v, rotated);
    if constexpr (Q + 1 < kN) {
      sweep_from<P, Q + 1>(a, v, rotated);
    } else {
      sweep_from<P + 1, P + 2>(a, v, rotated);
    }
  }
}

__global__ void __launch_bounds__(kEigThreads)
smallest_eigvec_kernel(const float* __restrict__ mats, float* __restrict__ out, int b, int sweeps) {
  const int m = blockIdx.x * kEigThreads + threadIdx.x;
  if (m >= b) return;
  const float* src = mats + (int64_t)m * kN * kN;
  float a[kTri];
  float v[kN][kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
#pragma unroll
    for (int j = i; j < kN; ++j) a[tri(i, j)] = src[i * kN + j];
#pragma unroll
    for (int j = 0; j < kN; ++j) v[i][j] = i == j ? 1.0f : 0.0f;
  }
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    bool rotated = false;
    sweep_from<0, 1>(a, v, rotated);
    if (!rotated) break;
  }
  // the smallest diagonal entry, the first on ties
  float best = a[tri(0, 0)];
  int idx = 0;
#pragma unroll
  for (int i = 1; i < kN; ++i) {
    if (a[tri(i, i)] < best) {
      best = a[tri(i, i)];
      idx = i;
    }
  }
  float* dst = out + (int64_t)m * kN;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    float val = v[k][0];
#pragma unroll
    for (int j = 1; j < kN; ++j) val = idx == j ? v[k][j] : val;
    dst[k] = val;
  }
}

__global__ void __launch_bounds__(kSolveThreads)
solve8_kernel(const float* __restrict__ A, const float* __restrict__ rhs, float* __restrict__ x, int n) {
  const int64_t m = (int64_t)blockIdx.x * kSolveThreads + threadIdx.x;
  if (m >= n) return;
  const float* src = A + m * kS * kS;
  float a[kS][kS], r[kS];
#pragma unroll
  for (int i = 0; i < kS; ++i) {
#pragma unroll
    for (int j = 0; j < kS; ++j) a[i][j] = src[i * kS + j];
    r[i] = rhs[m * kS + i];
  }
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
  float sol[kS];
#pragma unroll
  for (int i = kS - 1; i >= 0; --i) {
    float s = r[i];
#pragma unroll
    for (int j = i + 1; j < kS; ++j) s = s - a[i][j] * sol[j];
    sol[i] = s / a[i][i];
  }
#pragma unroll
  for (int i = 0; i < kS; ++i) x[m * kS + i] = sol[i];
}

}  // namespace

// K10.  mats (b, 9, 9) float32, symmetric (the upper triangle is read),
// finite; out (b, 9) float32; contiguous, on the current device.  At
// most ``sweeps`` Jacobi sweeps.  Returns the launch's cudaError_t.
extern "C" int cvst_smallest_eigvec(const float* mats, float* out, int b, int sweeps, void* stream) {
  if (b <= 0 || sweeps <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (b + kEigThreads - 1) / kEigThreads;
  smallest_eigvec_kernel<<<blocks, kEigThreads, 0, static_cast<cudaStream_t>(stream)>>>(mats, out, b, sweeps);
  return (int)cudaGetLastError();
}

// K11.  A (n, 8, 8) and rhs (n, 8) float32; x (n, 8) float32; contiguous,
// on the current device.  Returns the launch's cudaError_t.
extern "C" int cvst_solve8(const float* A, const float* rhs, float* x, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (int)(((int64_t)n + kSolveThreads - 1) / kSolveThreads);
  solve8_kernel<<<blocks, kSolveThreads, 0, static_cast<cudaStream_t>(stream)>>>(A, rhs, x, n);
  return (int)cudaGetLastError();
}
