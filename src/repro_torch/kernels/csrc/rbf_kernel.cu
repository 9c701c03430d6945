// RBF kernel matrix over a leading machine axis.
//
// Replaces the TPU kernel repro/kernels/rbf_kernel.py (rbf_kernel_pallas,
// pl.pallas_call at :44):
//
//     K[i, j] = exp(-max(||x_i||^2 + ||y_j||^2 - 2 x_i.y_j, 0) * inv_h2)
//
// with inv_h2 = float32(1 / (h h)) from the host, expf (never __expf) and
// no fast math.  It feeds ActiveSetSelection (one kernel row per greedy
// step, against every candidate of every machine) and FacilityLocation
// (the eval set against every candidate).
//
// Order of the sums: ||x||^2, ||y||^2 and x.y are each accumulated over the
// feature axis in order, every product rounded before its add (__fmul_rn /
// __fadd_rn, never contracted into an fma), and d^2 = (x2 + y2) - 2 xy is
// rounded step by step: the order of the plain version
// (kernels/ref.py::rbf_kernel), so both give a pair the same d^2 bits.  Near
// x = y the contraction form cancels, and at h = 0.5 an ulp of ||x||^2 in
// d^2 moves K by four, so any other order would part the kernel from its
// plain version by more than the tolerance on rows of large norm.
//
// Two instantiations, chosen by n in kernels/rbf_kernel.py::launch:
//
// * the 32 x 128 tile (n > ROWVEC_N or d > ROWVEC_D; FacilityLocation's
//   512 eval rows): one CTA per (32-row x 128-column) output tile of one
//   machine, 256 threads as 8 row groups x 32 column lanes; each thread
//   owns 4 rows x 4 columns (columns lane + 32 q), so each warp stores 128
//   consecutive bytes of a row.  The feature axis streams through shared
//   memory DK columns at a time (any d; ragged edges zero-filled, and a zero
//   product adds nothing), and the norms of the tile's rows are computed
//   once, from the staged features.
// * the row vector (n <= ROWVEC_N and d <= ROWVEC_D: ActiveSetSelection's
//   update, one row against every candidate): at n = 1 the tile leaves 31
//   of its 32 rows empty, and each CTA stages 128 Y rows for 512 bytes of
//   output.  Here a CTA owns a span of SPAN consecutive Y rows of one
//   machine and keeps the n X rows and their norms in shared memory.  It
//   stages VT rows (VT * d contiguous floats) at a time with 16-byte loads,
//   coalesced across rows, behind a scalar head and tail where the span
//   does not start on 16 bytes; thread t then scores row t of the pass
//   against every X row and writes it, so each warp stores 128 consecutive
//   bytes of each output row.  Grid (ceil(m / SPAN), M).
//
// Machine axis: grid.z (tile) or grid.y (row vector).  X and Y each take a
// machine stride in elements (0 for an operand every machine shares, as
// FacilityLocation's eval set); rows are contiguous (row stride d).  out
// (M, n, m) is contiguous.
//
// Bound on the H100: bytes.  The output is 4 n m bytes per machine: at the
// FacilityLocation gain shape (512 eval rows x 22,500 candidates x 2,000
// machines) 92 GB a step; at the ActiveSetSelection update shape (one row
// against 22,500 candidates x 2,000 machines) it reads every candidate row
// (1.08 GB) and writes 0.18 GB, which the row vector streams.  The next
// limit is expf on the SFUs.  No atomics.
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 32;       // X rows per tile
constexpr int COLS = 128;      // Y rows (output columns) per tile
constexpr int DK = 8;          // features staged per pass
constexpr int THREADS = 256;   // 8 row groups x 32 column lanes
constexpr int RPT = 4;         // rows per thread
constexpr int CPT = 4;         // columns per thread

static_assert((THREADS / 32) * RPT == ROWS && 32 * CPT == COLS, "layout");
static_assert(ROWS * DK == THREADS && COLS * DK % THREADS == 0, "staging");
static_assert(ROWS + COLS <= THREADS, "one norm per thread");

__global__ void __launch_bounds__(THREADS)
rbf_kernel_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                  float* __restrict__ out, long long sx, long long sy,
                  long long n, long long m, int d, float inv_h2) {
  __shared__ float xs[DK][ROWS];
  __shared__ float ys[DK][COLS];
  __shared__ float x2s[ROWS];
  __shared__ float y2s[COLS];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ty = tid >> 5;
  const long long mach = blockIdx.z;
  const long long row0 = (long long)blockIdx.y * ROWS;
  const long long col0 = (long long)blockIdx.x * COLS;
  const float* Xm = X + mach * sx;
  const float* Ym = Y + mach * sy;

  float acc[RPT][CPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int q = 0; q < CPT; ++q) acc[r][q] = 0.f;
  float norm = 0.f;  // threads < ROWS: an X row's; the next COLS: a Y row's

  for (int c0 = 0; c0 < d; c0 += DK) {
    __syncthreads();  // the previous pass is done with the tiles
    {
      const int r = tid / DK, c = tid % DK;
      const long long row = row0 + r;
      const int col = c0 + c;
      xs[c][r] = (row < n && col < d) ? Xm[row * d + col] : 0.f;
    }
#pragma unroll
    for (int p = 0; p < COLS * DK / THREADS; ++p) {
      const int idx = tid + p * THREADS;
      const int r = idx / DK, c = idx % DK;
      const long long row = col0 + r;
      const int col = c0 + c;
      ys[c][r] = (row < m && col < d) ? Ym[row * d + col] : 0.f;
    }
    __syncthreads();
    if (tid < ROWS) {
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        norm = __fadd_rn(norm, __fmul_rn(xs[kk][tid], xs[kk][tid]));
    } else if (tid < ROWS + COLS) {
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        norm = __fadd_rn(norm, __fmul_rn(ys[kk][tid - ROWS],
                                         ys[kk][tid - ROWS]));
    }
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      float a[RPT], b[CPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) a[r] = xs[kk][ty * RPT + r];
#pragma unroll
      for (int q = 0; q < CPT; ++q) b[q] = ys[kk][lane + 32 * q];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int q = 0; q < CPT; ++q)
          acc[r][q] = __fadd_rn(acc[r][q], __fmul_rn(a[r], b[q]));
    }
  }
  if (tid < ROWS)
    x2s[tid] = norm;
  else if (tid < ROWS + COLS)
    y2s[tid - ROWS] = norm;
  __syncthreads();

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const long long row = row0 + ty * RPT + r;
    if (row >= n) break;
    float* o = out + (mach * n + row) * m;
    const float x2 = x2s[ty * RPT + r];
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const long long col = col0 + lane + 32 * q;
      if (col < m) {
        const float s = __fadd_rn(x2, y2s[lane + 32 * q]);
        const float d2 = fmaxf(__fsub_rn(s, __fmul_rn(2.f, acc[r][q])), 0.f);
        o[col] = expf(__fmul_rn(-d2, inv_h2));
      }
    }
  }
}

// Row vector: n <= ROWVEC_N X rows against SPAN consecutive Y rows.
constexpr int ROWVEC_N = 4;    // X rows the row vector takes
constexpr int ROWVEC_D = 32;   // features it takes
constexpr int VT = 256;        // threads; Y rows per staged pass
constexpr int PASSES = 4;      // passes per CTA
constexpr int SPAN = VT * PASSES;

// count floats of global src -> shared dst: a scalar head up to the first
// 16-byte boundary of src, 16-byte loads, a scalar tail.  dst + head is
// 16-byte aligned (the caller offsets dst by (4 - head) % 4 floats).
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ src,
                                           int count, int head) {
  const int tid = threadIdx.x;
  if (tid < head) dst[tid] = src[tid];
  const int body = (count - head) / 4;
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int i = tid; i < body; i += VT) d4[i] = s4[i];
  for (int i = head + 4 * body + tid; i < count; i += VT) dst[i] = src[i];
}

template <int NR>
__global__ void __launch_bounds__(VT)
rbf_rowvec_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                  float* __restrict__ out, long long sx, long long sy,
                  long long m, int d, float inv_h2) {
  __shared__ float xs[NR * ROWVEC_D];
  __shared__ float x2s[NR];
  extern __shared__ float4 ys4[];  // VT * d + 4 floats
  float* ys = reinterpret_cast<float*>(ys4);
  const int tid = threadIdx.x;
  const long long mach = blockIdx.y;
  const long long row0 = (long long)blockIdx.x * SPAN;
  const float* Xm = X + mach * sx;
  const float* Ym = Y + mach * sy;
  for (int i = tid; i < NR * d; i += VT) xs[i] = Xm[i];
  __syncthreads();
  if (tid < NR) {
    float norm = 0.f;
    for (int c = 0; c < d; ++c)
      norm = __fadd_rn(norm, __fmul_rn(xs[tid * d + c], xs[tid * d + c]));
    x2s[tid] = norm;
  }
  for (int p = 0; p < PASSES; ++p) {
    const long long base = row0 + (long long)p * VT;
    if (base >= m) break;
    const int rows = (int)min((long long)VT, m - base);
    const float* src = Ym + base * d;
    const int head = (int)min(
        (long long)((16 - (reinterpret_cast<unsigned long long>(src) & 15))
                    & 15) / 4, (long long)rows * d);
    const int pad = (4 - head) & 3;
    __syncthreads();  // the last pass is done with ys (and x2s is written)
    stage_rows(ys + pad, src, rows * d, head);
    __syncthreads();
    if (tid < rows) {
      const float* y = ys + pad + tid * d;
      float y2 = 0.f, acc[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r) acc[r] = 0.f;
      for (int c = 0; c < d; ++c) {
        const float yc = y[c];
        y2 = __fadd_rn(y2, __fmul_rn(yc, yc));
#pragma unroll
        for (int r = 0; r < NR; ++r)
          acc[r] = __fadd_rn(acc[r], __fmul_rn(xs[r * d + c], yc));
      }
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const float s = __fadd_rn(x2s[r], y2);
        const float d2 = fmaxf(__fsub_rn(s, __fmul_rn(2.f, acc[r])), 0.f);
        out[(mach * NR + r) * m + base + tid] = expf(__fmul_rn(-d2, inv_h2));
      }
    }
  }
}

template <int NR>
int launch_rowvec(const void* X, const void* Y, void* out, long long sx,
                  long long sy, long long M, long long m, int d, float inv_h2,
                  void* stream) {
  const dim3 grid((unsigned)((m + SPAN - 1) / SPAN), (unsigned)M);
  const size_t smem = (size_t)(VT * d + 4) * sizeof(float);
  rbf_rowvec_kernel<NR><<<grid, VT, smem, (cudaStream_t)stream>>>(
      (const float*)X, (const float*)Y, (float*)out, sx, sy, m, d, inv_h2);
  return (int)cudaGetLastError();
}

}  // namespace

// X rows at X + mach * sx, Y rows at Y + mach * sy (fp32, row stride d;
// a stride of 0 shares the operand); out (M, n, m) fp32 contiguous.
// rowvec = 1 takes the row vector (n <= 4 and d <= 32, else
// cudaErrorInvalidValue), 0 the 32 x 128 tile.
extern "C" int rbf_kernel_launch(const void* X, const void* Y, void* out,
                                 long long sx, long long sy, long long M,
                                 long long n, long long m, int d,
                                 float inv_h2, int rowvec, void* stream) {
  if (rowvec) {
    if (d > ROWVEC_D) return (int)cudaErrorInvalidValue;
    switch (n) {
      case 1: return launch_rowvec<1>(X, Y, out, sx, sy, M, m, d, inv_h2,
                                      stream);
      case 2: return launch_rowvec<2>(X, Y, out, sx, sy, M, m, d, inv_h2,
                                      stream);
      case 3: return launch_rowvec<3>(X, Y, out, sx, sy, M, m, d, inv_h2,
                                      stream);
      case 4: return launch_rowvec<4>(X, Y, out, sx, sy, M, m, d, inv_h2,
                                      stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const dim3 grid((unsigned)((m + COLS - 1) / COLS),
                  (unsigned)((n + ROWS - 1) / ROWS), (unsigned)M);
  rbf_kernel_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)X, (const float*)Y, (float*)out, sx, sy, n, m, d, inv_h2);
  return (int)cudaGetLastError();
}
