// Shared gain tile of the exemplar-clustering kernels (exemplar_gains.cu,
// greedy_select.cu, threshold_select.cu).
//
// For the BN candidate rows [row0, row0 + BN) of one machine block it
// computes, against the whole (zero-padded) eval set,
//
//     sum_j max(0, cm[j] - max(x2_i + e2_j - 2 x_i.e_j, 0))
//
// — the contraction form of repro's exemplar_gains — or, with eval weights,
// sum_j w_j max(0, ...).  Every selection kernel calls this
// one function, so the step-wise scan (exemplar_gains) and the fused greedy
// (greedy_select) see the same bits for the same row and the same cm, which
// is what lets the fused path reproduce the scan's selections.
//
// Tiling: 256 threads as 16 row groups x 16 column groups; each thread
// keeps an 8-row x 4-column block of dot products in registers while the
// feature axis streams through shared memory DK columns at a time (any d,
// ragged edges zero-filled: a zero column adds fma(0, 0, acc) == acc).
// The eval axis is walked BM columns at a time; every thread keeps its
// rows' partial sums across eval tiles, and the 16 column groups of a row
// are folded with a fixed butterfly at the end.  No atomics: the order of
// every sum is fixed, so a row's gain is the same from run to run.
#pragma once

#include <cuda_runtime.h>

namespace exemplar {

constexpr int BN = 128;       // candidate rows per block
constexpr int BM = 64;        // eval columns per tile (the wrapper pads m)
constexpr int DK = 8;         // feature columns staged per pass
constexpr int TR = 8;         // rows per thread
constexpr int TC = 4;         // eval columns per thread
constexpr int THREADS = 256;  // (BN / TR) x (BM / TC)
constexpr int LDX = BN + 4;   // row pitch of the staged tiles (16-byte
constexpr int LDE = BM + 4;   // aligned, off the 32-bank stride)
constexpr float NEG_INF = -1e30f;

static_assert((BN / TR) * (BM / TC) == THREADS, "thread layout");
static_assert(BN * DK % THREADS == 0 && BM * DK % THREADS == 0, "staging");

struct __align__(16) TileSmem {
  float xs[DK][LDX];  // X tile, feature-major
  float es[DK][LDE];  // E tile, feature-major
  float x2[BN];       // squared row norms
  float e2[BM];       // squared eval norms of the current eval tile
  float cm[BM];       // running minimum of the current eval tile
};

// Raw gain sums of rows row0 + ty*TR + r, r < TR.  On return every thread
// of a row group holds the same sums (the butterfly is symmetric).
//
// kCmRewritten: the calling kernel rewrites cm between calls within one
// launch (threshold_select), so cm is read by a volatile load, which the
// compiler neither hoists out of the caller's block loop nor sends down the
// non-coherent read-only path; otherwise (exemplar_gains, greedy_select) cm
// is read-only for the launch and loaded as any other operand.
//
// kWeighted: the eval columns carry weights ew (mp,), zero-padded like cm,
// staged per eval tile into s_ew (BM,) in the caller's shared memory, and
// each column's clamped contribution is multiplied by its weight before it
// is added: fmaf(contrib, w, sum), which for w == 1.0f is the unweighted
// sum + contrib, so unit weights give the unweighted bits.  The unweighted
// instantiation never touches ew or s_ew and compiles as before.
template <bool kCmRewritten = false, bool kWeighted = false>
__device__ __forceinline__ void row_gain_sums(
    const float* __restrict__ X,   // this machine's (n, d) block
    const float* __restrict__ E,   // (mp, d), mp % BM == 0, zero-padded
    const float* __restrict__ cm,  // this machine's (mp,), zero-padded
    long long n, int d, int mp, long long row0, TileSmem& sm,
    float sums[TR], const float* __restrict__ ew = nullptr,
    float* s_ew = nullptr) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
#pragma unroll
  for (int r = 0; r < TR; ++r) sums[r] = 0.f;
  float x2acc = 0.f;

  for (int j0 = 0; j0 < mp; j0 += BM) {
    float acc[TR][TC];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int c = 0; c < TC; ++c) acc[r][c] = 0.f;
    float e2acc = 0.f;

    for (int c0 = 0; c0 < d; c0 += DK) {
      __syncthreads();  // the previous pass is done with the tiles
#pragma unroll
      for (int q = 0; q < BN * DK / THREADS; ++q) {
        const int idx = tid + q * THREADS;
        const int r = idx / DK, c = idx % DK;
        const long long row = row0 + r;
        const int col = c0 + c;
        sm.xs[c][r] = (row < n && col < d) ? X[row * d + col] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < BM * DK / THREADS; ++q) {
        const int idx = tid + q * THREADS;
        const int r = idx / DK, c = idx % DK;
        const int col = c0 + c;
        sm.es[c][r] = col < d ? E[(long long)(j0 + r) * d + col] : 0.f;
      }
      __syncthreads();
      if (j0 == 0 && tid < BN) {
#pragma unroll
        for (int kk = 0; kk < DK; ++kk)
          x2acc = fmaf(sm.xs[kk][tid], sm.xs[kk][tid], x2acc);
      } else if (tid >= BN && tid < BN + BM) {
#pragma unroll
        for (int kk = 0; kk < DK; ++kk)
          e2acc = fmaf(sm.es[kk][tid - BN], sm.es[kk][tid - BN], e2acc);
      }
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&sm.xs[kk][ty * TR]);
        const float4 a1 = *reinterpret_cast<const float4*>(&sm.xs[kk][ty * TR + 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&sm.es[kk][tx * TC]);
        const float a[TR] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[TC] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
        for (int r = 0; r < TR; ++r)
#pragma unroll
          for (int c = 0; c < TC; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
    }
    if (j0 == 0 && tid < BN) sm.x2[tid] = x2acc;
    if (tid >= BN && tid < BN + BM) {
      sm.e2[tid - BN] = e2acc;
      if constexpr (kCmRewritten) {
        sm.cm[tid - BN] = *(const volatile float*)(cm + j0 + tid - BN);
      } else {
        sm.cm[tid - BN] = cm[j0 + tid - BN];
      }
      if constexpr (kWeighted) s_ew[tid - BN] = ew[j0 + tid - BN];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const float x2 = sm.x2[ty * TR + r];
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const float d2 = fmaxf(x2 + sm.e2[tx * TC + c] - 2.f * acc[r][c], 0.f);
        if constexpr (kWeighted) {
          sums[r] = fmaf(fmaxf(sm.cm[tx * TC + c] - d2, 0.f),
                         s_ew[tx * TC + c], sums[r]);
        } else {
          sums[r] += fmaxf(sm.cm[tx * TC + c] - d2, 0.f);
        }
      }
    }
  }
  // fold the 16 column groups of each row (lanes of one half-warp)
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      sums[r] += __shfl_xor_sync(0xffffffffu, sums[r], off);
}

// (value, index) order of every argmax here: larger value first, and the
// lower index among equal values — the lowest-index tie rule of argmax.
__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

}  // namespace exemplar
