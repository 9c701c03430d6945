// Fused k-step exemplar-clustering greedy over a leading machine axis.
//
// Replaces the TPU kernel repro/kernels/greedy_select.py
// (greedy_select_pallas, pl.pallas_call at :265).  The TPU version is one
// launch whose sequential grid (steps x candidate blocks) carries cur_min,
// availability and a running argmax in VMEM/SMEM scratch.  Hopper runs
// blocks in parallel and in no order, so each step here is two launches:
//
//   greedy_step_kernel   grid (candidate tiles, M): gains of BN rows
//                        (exemplar_tile.cuh, the same bits as
//                        exemplar_gains.cu), divided by the unpadded m,
//                        masked to -1e30 where unavailable, and the tile's
//                        (best value, lowest index) written out;
//   greedy_commit_kernel grid (M): reduces the tile winners (lowest index
//                        on ties), and if the best is a real candidate
//                        (> -1e30 / 2) refreshes cur_min in the difference
//                        form sum_c (e_c - x_c)^2, clears the winner's
//                        availability and writes sel; else writes -1.
//
// 2k launches per call, each over all M machines, so one tree round is one
// call.  The step kernel fills the card even at M = 1 (the centralized
// baseline over the whole ground set), where a block-per-machine kernel
// would use one SM of 132.
//
// Bound on the H100: fp32 FMA issue, (2d + 3) operations per candidate and
// eval column per step (see exemplar_gains.cu); the commit is O(m d) per
// machine per step.  State (cur_min, availability, tile winners) lives in
// device scratch the wrapper allocates.  A cooperative single launch,
// precomputing the step-invariant distances and tensor cores are later work.
#include <climits>
#include <cmath>

#include "exemplar_tile.cuh"

using namespace exemplar;

constexpr int COMMIT_THREADS = 512;

__global__ void __launch_bounds__(THREADS)
greedy_step_kernel(const float* __restrict__ X, const float* __restrict__ E,
                   const float* __restrict__ cm,
                   const unsigned char* __restrict__ avail,
                   float* __restrict__ win_v, int* __restrict__ win_i,
                   long long n, int d, int mp, int m_true, int ntiles) {
  __shared__ TileSmem sm;
  __shared__ float tv[BN];
  const long long mach = blockIdx.y;
  const long long row0 = (long long)blockIdx.x * BN;
  float sums[TR];
  row_gain_sums(X + mach * n * d, E, cm + mach * mp, n, d, mp, row0, sm, sums);
  if ((threadIdx.x & 15) == 0) {
    const int ty = threadIdx.x >> 4;
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const long long row = row0 + ty * TR + r;
      const bool ok = row < n && avail[mach * n + row];
      tv[ty * TR + r] = ok ? sums[r] / (float)m_true : NEG_INF;
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float v = tv[lane];
    int i = lane;
#pragma unroll
    for (int q = 1; q < BN / 32; ++q)
      if (better(tv[lane + 32 * q], lane + 32 * q, v, i)) {
        v = tv[lane + 32 * q];
        i = lane + 32 * q;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, i, off);
      if (better(ov, oi, v, i)) {
        v = ov;
        i = oi;
      }
    }
    if (lane == 0) {
      win_v[mach * ntiles + blockIdx.x] = v;
      win_i[mach * ntiles + blockIdx.x] = (int)(row0 + i);
    }
  }
}

__global__ void __launch_bounds__(COMMIT_THREADS)
greedy_commit_kernel(const float* __restrict__ X, const float* __restrict__ E,
                     float* __restrict__ cm, unsigned char* __restrict__ avail,
                     const float* __restrict__ win_v,
                     const int* __restrict__ win_i, int* __restrict__ sel,
                     long long n, int d, int mp, int ntiles, int k, int step) {
  __shared__ float rv[COMMIT_THREADS / 32];
  __shared__ int ri[COMMIT_THREADS / 32];
  const long long mach = blockIdx.x;
  const int tid = threadIdx.x;
  float v = -INFINITY;
  int i = INT_MAX;
  for (int t = tid; t < ntiles; t += COMMIT_THREADS) {
    const float tv = win_v[mach * ntiles + t];
    const int ti = win_i[mach * ntiles + t];
    if (better(tv, ti, v, i)) {
      v = tv;
      i = ti;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  if ((tid & 31) == 0) {
    rv[tid >> 5] = v;
    ri[tid >> 5] = i;
  }
  __syncthreads();
  v = rv[0];
  i = ri[0];
  for (int w = 1; w < COMMIT_THREADS / 32; ++w)
    if (better(rv[w], ri[w], v, i)) {
      v = rv[w];
      i = ri[w];
    }
  if (!(v > NEG_INF / 2)) {  // no candidate left: -1 from here on
    if (tid == 0) sel[mach * k + step] = -1;
    return;
  }
  const float* x = X + (mach * n + i) * d;
  for (int j = tid; j < mp; j += COMMIT_THREADS) {
    const float* e = E + (long long)j * d;
    float s = 0.f;
    for (int c = 0; c < d; ++c) {
      const float df = e[c] - x[c];
      s = fmaf(df, df, s);
    }
    cm[mach * mp + j] = fminf(cm[mach * mp + j], s);
  }
  if (tid == 0) {
    avail[mach * n + i] = 0;
    sel[mach * k + step] = i;
  }
}

// X (M, n, d), E (mp, d) fp32; cm (M, mp) fp32 and avail (M, n) uint8 are
// the running state, updated in place; win_v/win_i (M, ceil(n / BN)) are
// scratch; sel (M, k) int32.  Launches 2k kernels on `stream`.
extern "C" int greedy_select_launch(const void* X, const void* E, void* cm,
                                    void* avail, void* win_v, void* win_i,
                                    void* sel, long long M, long long n, int d,
                                    int mp, int m_true, int k, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int ntiles = (int)((n + BN - 1) / BN);
  const dim3 grid((unsigned)ntiles, (unsigned)M);
  for (int t = 0; t < k; ++t) {
    greedy_step_kernel<<<grid, THREADS, 0, s>>>(
        (const float*)X, (const float*)E, (const float*)cm,
        (const unsigned char*)avail, (float*)win_v, (int*)win_i, n, d, mp,
        m_true, ntiles);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
    greedy_commit_kernel<<<(unsigned)M, COMMIT_THREADS, 0, s>>>(
        (const float*)X, (const float*)E, (float*)cm, (unsigned char*)avail,
        (const float*)win_v, (const int*)win_i, (int*)sel, n, d, mp, ntiles, k,
        t);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return 0;
}
