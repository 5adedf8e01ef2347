// K4: GFTT corner scores straight from the gray -- Sobel gradients and
// their products, 21x21 structure-tensor box sums, minimum eigenvalue
// and 3x3 non-maximum suppression, in one launch.
//
// Replaces the TPU kernel comfyui_video_stabilizer_tpu/ops/gftt_pallas.py
// (_make_kernel, launched by gftt_scores's pl.pallas_call at :151) and the
// Sobel gradients and products its caller forms in device memory
// (comfyui_video_stabilizer_tpu/ops/lk.py::_topk_packed).  On the TPU one
// grid step DMAs a strip of the three reflect-padded products into VMEM
// and sums it with sublane and lane rolls.  Here one 128-thread block
// walks down a strip 74 output columns wide and up to 190 rows tall of
// one frame, 32 rows a band, and reads only the gray.
//
// What bounds it on an H100: device-memory traffic.  The gray in and the
// scores out are 8 bytes a pixel: 328 MB, ~0.098 ms at 3.35 TB/s at the
// Classic slice's shape (79 x 540 x 960).  Its arithmetic, counted on
// the shared tree, is ~73 operations a pixel (~0.045 ms at 67 TFLOP/s);
// what the block recomputes in its halo, the shared-memory traffic and
// the wait for the gray come on top.  The design:
//   * the vertical trees are carried in registers down the strip: a
//     thread owns one of the 96 box columns (the 74 outputs, 1 + 10 a
//     side: three whole warps) and walks down it with the 3x3 gray
//     window in registers (four new shared-memory loads a row where the
//     rows run on, eight at a reflected edge), forms dx, dy and the
//     three products there and feeds three 21-term doubling trees, whose
//     partial sums S2, S4, S8 and S16 live in small register rings: each
//     is formed once per position (~6 adds a box value an axis, against
//     20 adds and 21 shared-memory loads for a fresh tree per value), and
//     there is no vertical halo but the 20 rows a segment starts with;
//     dx, dy and the products never leave registers;
//   * the gray is read once per band, with the next band's rows copied
//     into a second buffer by cp.async while this band computes, through
//     per-band tables of the reflect-101 map (no modulo per element);
//   * per band: the 21-row sums of the three products go to shared
//     memory, the columns pass runs the same trees along 19-column
//     chunks of them (all four warps) and finishes each eigenvalue in
//     registers, and the NMS slides a 3x3 window down 16-row runs of one
//     column, with the band before's last two eigenvalue rows kept aside;
//   * four __syncthreads() a band; ~68 KB of shared memory and 168
//     registers a thread, three blocks an SM.
//
// The two pads compose: the product at box position q is the product at
// image position reflect101(q), and its Sobel reads the gray at
// reflect101 of that position +-1 (not one pad of 11, which would
// reverse the taps' order past the edge).  A band's staged row s holds
// the gray at reflect101(e0 + s), where e0 is one less than the lowest
// reflect101(q) of the band's box rows that an output needs; the window
// of box row q sits around staged row reflect101(q) - e0, and the rows a
// band needs span at most kGB staged rows.  Box rows no output needs
// (past the frame's bottom or the segment's end) read clamped rows;
// their eigenvalues are -inf or unused.  Columns: each thread's window
// columns come from the same map, once per block.
//
// Numerics are the plain version's (ops/gftt_cuda.py::gftt_gray_plain):
// the Sobel in _conv2's order (rows then columns, each tap a separate
// multiply, zero taps skipped), the products dx*dx, dx*dy, dy*dy, each
// 21-term sum in the order of the Pallas _rollsum,
// ((S16[i] + S4[i+16]) + x[i+20]), rows then columns; the eigenvalue
// 0.5 * ((a + c) - sqrt((a - c)(a - c) + (4 b) b)) with a correctly
// rounded sqrtf.  Built with -fmad=false, so kernel and plain version
// agree bitwise.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kRadius = 10;
constexpr int kWarm = 2 * kRadius;          // box rows a segment pushes before its first output
constexpr int kTW = 74;                     // output columns of a strip: 96 box columns, three warps
constexpr int kEC = kTW + 2;                // eigenvalue columns: + the NMS halo (76)
constexpr int kBC = kEC + 2 * kRadius;      // box columns: + the box halo (96)
constexpr int kGC = kBC + 2;                // staged gray columns: + the Sobel halo (98)
constexpr int kBand = 32;                   // eigenvalue rows (and box rows pushed) a band
constexpr int kSteps = kBand > kWarm ? kBand : kWarm;  // box rows a table
constexpr int kGB = kSteps + 2;             // staged gray rows a table
constexpr int kSegBands = 6;
constexpr int kSeg = kSegBands * kBand - 2;  // output rows of a segment (190)
constexpr int kTabs = kSegBands + 1;        // row tables: the warm-up, then each band
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kHC = 19;                     // columns pass: outputs an item (one row)
constexpr int kHItems = kBand * (kEC / kHC);  // 128
constexpr int kNRun = 16;                   // NMS: outputs an item (one column)
constexpr int kNItems = (kBand / kNRun) * kTW;
constexpr int kRP = kBC + 1;                // odd pitches: a warp's rows fall on distinct banks
constexpr int kEP = kEC + 1;
static_assert(kBC <= kThreads && kHItems <= kThreads, "one item a thread");
static_assert(kEC % kHC == 0 && kBand % kNRun == 0, "items tile the band");
static_assert(kBand % 16 == 0, "the rings' slots repeat every band");
static_assert(kBand * kEP <= kGB * kGC, "a band's eigenvalues fit in its gray buffer");

struct Smem {
  int gcol[kGC];                            // image column of each staged column
  int bcol[kBC];                            // staged centre column of each box column
  int grow[kTabs][kGB];                     // image row of each staged row, per table
  int brow[kTabs][kSteps];                  // staged centre row of each box row, per table
  int slide[kTabs];                         // whether a table's centre rows run on one by one
  float rsum[3][kBand][kRP];                // 21-row sums of the three products
  float eprev[2][2][kEP];                   // the band before's last two eigenvalue rows
  union {
    float gray[kGB][kGC];                   // the band's gray (rows pass) ...
    float eig[kBand][kEP];                  // ... then its eigenvalues (columns pass, NMS)
  } buf[2];
};

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

__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// The 21-term sums out[n - 20] = x[n - 20] + ... + x[n] of a stream of
// inputs x[0], x[1], ..., in the order of _rollsum: ((S16[i] + S4[i+16])
// + x[i+20]) with S2[j] = x[j] + x[j+1], S4[j] = S2[j] + S2[j+2],
// S8[j] = S4[j] + S4[j+4], S16[j] = S8[j] + S8[j+8].  Each partial sum
// is formed once, as soon as its inputs exist, into a ring long enough
// for its last reader.  n is a compile-time constant in fully unrolled
// loops (or equal to one modulo 16), so the rings live in registers.
struct Ring21 {
  float x[2], s2[4], s4[8], s8[16], s16[8];

  __device__ __forceinline__ void push(int n, float v) {
    x[n & 1] = v;
    if (n >= 1) s2[(n - 1) & 3] = x[(n - 1) & 1] + x[n & 1];
    if (n >= 3) s4[(n - 3) & 7] = s2[(n - 3) & 3] + s2[(n - 1) & 3];
    if (n >= 7) s8[(n - 7) & 15] = s4[(n - 7) & 7] + s4[(n - 3) & 7];
    if (n >= 15) s16[(n - 15) & 7] = s8[(n - 15) & 15] + s8[(n - 7) & 15];
  }
  // the sum ending at x[n], n >= 20
  __device__ __forceinline__ float out(int n) const { return (s16[(n - 20) & 7] + s4[(n - 4) & 7]) + x[n & 1]; }
};

// One box column's walk: the 3x3 gray window around the products'
// staged centre, the Sobel and the three trees.
struct Column {
  Ring21 ta, tb, tc;
  float w0l, w0m, w0r, w1l, w1r, w2l, w2m, w2r;

  // the window around staged row r of g, at staged column c
  __device__ __forceinline__ void load(const float (*g)[kGC], int r, int c) {
    w0l = g[r - 1][c - 1]; w0m = g[r - 1][c]; w0r = g[r - 1][c + 1];
    w1l = g[r][c - 1]; w1r = g[r][c + 1];
    w2l = g[r + 1][c - 1]; w2m = g[r + 1][c]; w2r = g[r + 1][c + 1];
  }
  // the window one staged row further down than the last one, around r
  __device__ __forceinline__ void slide(const float (*g)[kGC], int r, int c) {
    w0l = w1l; w0m = g[r - 1][c]; w0r = w1r;
    w1l = w2l; w1r = w2r;
    w2l = g[r + 1][c - 1]; w2m = g[r + 1][c]; w2r = g[r + 1][c + 1];
  }
  // push box row n (n & 15 known at compile time) from the window
  __device__ __forceinline__ void push(int n) {
    // _SOBEL_X: rows (-1, -2, -1) at columns c - 1 and c + 1, then columns (1, -1)
    const float xl = ((w0l * -1.0f) + (w1l * -2.0f)) + (w2l * -1.0f);
    const float xr = ((w0r * -1.0f) + (w1r * -2.0f)) + (w2r * -1.0f);
    const float dx = (xl * 1.0f) + (xr * -1.0f);
    // _SOBEL_Y: rows (-1, 1) at columns c - 1, c and c + 1, then columns (1, 2, 1)
    const float yl = (w0l * -1.0f) + (w2l * 1.0f);
    const float ym = (w0m * -1.0f) + (w2m * 1.0f);
    const float yr = (w0r * -1.0f) + (w2r * 1.0f);
    const float dy = ((yl * 1.0f) + (ym * 2.0f)) + (yr * 1.0f);
    ta.push(n, dx * dx);
    tb.push(n, dx * dy);
    tc.push(n, dy * dy);
  }
};

// Push a table's box rows n0 .. n0 + S - 1 (n0 & 15 known at compile
// time), calling emit(t, n) after each.  When the table's staged centre
// rows run on one by one (slide[tab]), the window slides down with fixed
// offsets; otherwise each row reads its whole window through the table.
template <int S, class Emit>
__device__ __forceinline__ void walk(Column& col, const Smem& sm, const float (*g)[kGC], int tab, int n0, int c,
                                     Emit emit) {
  if (sm.slide[tab]) {
    const float (*g0)[kGC] = g + sm.brow[tab][0];
#pragma unroll
    for (int t = 0; t < S; ++t) {
      if (t == 0) {
        col.load(g0, 0, c);
      } else {
        col.slide(g0, t, c);
      }
      col.push(n0 + t);
      emit(t, n0 + t);
    }
  } else {
#pragma unroll
    for (int t = 0; t < S; ++t) {
      col.load(g, sm.brow[tab][t], c);
      col.push(n0 + t);
      emit(t, n0 + t);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 3)
gftt_gray_kernel(const float* __restrict__ gray, float* __restrict__ out, int h, int w) {
  extern __shared__ float4 smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * kSeg;
  const int oy1 = min(oy0 + kSeg, h);
  const int tx0 = blockIdx.x * kTW;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int64_t plane = (int64_t)h * w;
  const float* g = gray + b * plane;
  // eigenvalue rows i = 0, 1, ... are image rows oy0 - 1 + i; box row
  // n is image row oy0 - 11 + n.  Bands of kBand eigenvalue rows, as
  // many as the segment's outputs need; box rows an output needs end at
  // qmax.
  const int nb = (oy1 - oy0 + 2 + kBand - 1) / kBand;
  const int qmax = min(oy1, h - 1) + kRadius;

  // the column maps, once per block
  for (int i = tid; i < kGC + kBC; i += kThreads) {
    if (i < kGC) {
      sm.gcol[i] = reflect101(tx0 - kRadius - 2 + i, w);
    } else {
      const int v = i - kGC;
      sm.bcol[v] = min(max(reflect101(tx0 - kRadius - 1 + v, w) - (tx0 - kRadius - 2), 1), kGC - 2);
    }
  }
  // the row tables: table 0 is the warm-up (box rows 0 .. 19), table
  // k + 1 band k (box rows 20 + 32k .. 51 + 32k); lane t takes step t
  for (int tab = warp; tab <= nb; tab += kWarps) {
    const int steps = tab == 0 ? kWarm : kBand;
    const int n = tab == 0 ? lane : kWarm + (tab - 1) * kBand + lane;
    const int q = oy0 - kRadius - 1 + n;
    const bool needed = lane < steps && q <= qmax;
    const int rq = reflect101(q, h);
    int lo = needed ? rq - 1 : INT_MAX;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    if (lo == INT_MAX) lo = 0;              // no output needs this band's box rows
    const int r = min(max(rq - lo, 1), kGB - 2);
    if (lane < steps) sm.brow[tab][lane] = r;
    int dmin = lane < steps ? r - lane : INT_MAX, dmax = lane < steps ? r - lane : INT_MIN;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      dmin = min(dmin, __shfl_xor_sync(0xffffffffu, dmin, o));
      dmax = max(dmax, __shfl_xor_sync(0xffffffffu, dmax, o));
    }
    if (lane == 0) sm.slide[tab] = dmin == dmax;
    for (int s = lane; s < kGB; s += 32) sm.grow[tab][s] = reflect101(lo + s, h);
  }
  __syncthreads();

  // this lane's staged columns, for every band's copies
  constexpr int kLaneCols = (kGC + 31) / 32;
  int gcl[kLaneCols];
#pragma unroll
  for (int i = 0; i < kLaneCols; ++i) gcl[i] = lane + 32 * i < kGC ? sm.gcol[lane + 32 * i] : 0;
  auto stage = [&](int tab, float (*dst)[kGC]) {
    for (int s = warp; s < kGB; s += kWarps) {
      const float* row = g + (int64_t)sm.grow[tab][s] * w;
#pragma unroll
      for (int i = 0; i < kLaneCols; ++i) {
        if (lane + 32 * i < kGC) copy4_async(&dst[s][lane + 32 * i], row + gcl[i]);
      }
    }
    async_commit();
  };

  // the warm-up: box rows 0 .. 19 into the trees, no outputs yet
  stage(0, sm.buf[0].gray);
  stage(1, sm.buf[1].gray);
  async_wait<1>();
  __syncthreads();
  Column col;
  const bool walker = tid < kBC;
  const int c = walker ? sm.bcol[tid] : 1;
  if (walker) walk<kWarm>(col, sm, sm.buf[0].gray, 0, 0, c, [](int, int) {});
  __syncthreads();

  for (int k = 0; k < nb; ++k) {
    float (*gb)[kGC] = sm.buf[(k + 1) & 1].gray;
    if (k + 1 < nb) {
      stage(k + 2, sm.buf[k & 1].gray);     // the next band's gray, while this one computes
      async_wait<1>();
    } else {
      async_wait<0>();
    }
    __syncthreads();

    // the rows pass: box rows 20 + 32k + t, their 21-row sums are
    // eigenvalue rows 32k + t
    if (walker) {
      // n = kWarm + t: the box row modulo kBand
      walk<kBand>(col, sm, gb, k + 1, kWarm, c, [&](int t, int n) {
        sm.rsum[0][t][tid] = col.ta.out(n);
        sm.rsum[1][t][tid] = col.tb.out(n);
        sm.rsum[2][t][tid] = col.tc.out(n);
      });
    }
    __syncthreads();

    // the columns pass and the eigenvalues, -inf outside the image, over
    // the band's gray; a warp takes 32 consecutive rows of one chunk
    float (*eig)[kEP] = sm.buf[(k + 1) & 1].eig;
    if (tid < kHItems) {
      const int t = tid % kBand;
      const int c0 = (tid / kBand) * kHC;
      const int gy = oy0 - 1 + k * kBand + t;
      const bool row_in = gy >= 0 && gy < h;
      Ring21 ta, tb, tc;
#pragma unroll
      for (int j = 0; j < kHC + 2 * kRadius; ++j) {
        ta.push(j, sm.rsum[0][t][c0 + j]);
        tb.push(j, sm.rsum[1][t][c0 + j]);
        tc.push(j, sm.rsum[2][t][c0 + j]);
        if (j >= 2 * kRadius) {
          const int gx = tx0 - 1 + c0 + j - 2 * kRadius;
          const float a = ta.out(j), bb = tb.out(j), cc = tc.out(j);
          const float d = a - cc;
          const float e = 0.5f * ((a + cc) - sqrtf(d * d + (4.0f * bb) * bb));
          eig[t][c0 + j - 2 * kRadius] = row_in && gx >= 0 && gx < w ? e : -INFINITY;
        }
      }
    }
    __syncthreads();

    // the 3x3 NMS of output rows oy0 + 32k - 2 + (0 .. 31), a 16-row run
    // of one column a thread (rows 0, 1 of the window are the band
    // before's last two eigenvalue rows); only the scores go to device
    // memory.  Then this band's last two rows are kept for the next.
    for (int item = tid; item < kNItems; item += kThreads) {
      const int v = item % kTW;
      const int u0 = (item / kTW) * kNRun;
      const int ox = tx0 + v;
      const float (*prev)[kEP] = sm.eprev[k & 1];
      float rmax[kNRun + 2], mid[kNRun + 2];
#pragma unroll
      for (int m = 0; m < kNRun + 2; ++m) {
        const int rho = u0 + m;
        const float* e = rho < 2 ? &prev[rho][v] : &eig[rho - 2][v];
        mid[m] = e[1];
        rmax[m] = fmaxf(fmaxf(e[0], e[1]), e[2]);
      }
      if (ox < w) {
#pragma unroll
        for (int m = 0; m < kNRun; ++m) {
          const int j = k * kBand - 2 + u0 + m;
          const int oy = oy0 + j;
          const float e = mid[m + 1];
          const float mx = fmaxf(fmaxf(rmax[m], rmax[m + 1]), rmax[m + 2]);
          if (j >= 0 && oy < oy1) out[b * plane + (int64_t)oy * w + ox] = e >= mx ? e : -INFINITY;
        }
      }
    }
    for (int i = tid; i < 2 * kEC; i += kThreads) {
      const int r = i / kEC, cc = i - (i / kEC) * kEC;
      sm.eprev[(k + 1) & 1][r][cc] = eig[kBand - 2 + r][cc];
    }
    __syncthreads();
  }
}

// The opt-in to more than 48 KB of dynamic shared memory is an attribute
// of the kernel on the current device: set it on a device's first launch
// only, so later launches make no extra driver call.
constexpr int kMaxDevices = 64;

cudaError_t opt_in_smem(int bytes) {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(gftt_gray_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && known) done[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace

// gray (b, h, w) float32; out (b, h, w) float32 scores; both contiguous
// on the current device.  Returns the launch's cudaError_t (0 on success).
extern "C" int cvst_gftt_gray(const float* gray, float* out, int b, int h, int w, void* stream) {
  if (b <= 0 || b > 65535 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const int bytes = (int)sizeof(Smem);  // above 48 KB: dynamic shared memory, opted in
  const cudaError_t err = opt_in_smem(bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + kTW - 1) / kTW, (h + kSeg - 1) / kSeg, b);
  gftt_gray_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(gray, out, h, w);
  return (int)cudaGetLastError();
}
