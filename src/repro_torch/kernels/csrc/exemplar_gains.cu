// Step-wise exemplar-clustering gains over a leading machine axis.
//
// Replaces the TPU kernel repro/kernels/exemplar_gains.py
// (exemplar_gains_pallas, pl.pallas_call at :107): raw
// sum_j max(0, cm[j] - ||x_i - e_j||^2) per candidate row, contraction form,
// clamped at 0, optionally weighted per eval column (its own template
// instantiation).  The caller divides by the unpadded eval-set size.
//
// Bound on the H100: fp32 FMA issue.  Each (row, eval column) pair costs
// 2d + 3 operations against 4d bytes of its row read once, so at d = 6 the
// kernel needs ~2.5 operations per byte of X but reads E and cm for every
// row tile from L2: it is compute bound without tensor cores (fp32 has no
// tensor-core route except TF32, which this port does not use).  The design
// keeps an 8 x 4 register block of dot products per thread so every shared
// memory read feeds two FMAs or more, and walks any d in DK-wide passes.
//
// Grid: (ceil(n / BN), M).  Block: 256 threads.  No atomics.
#include "exemplar_tile.cuh"

using namespace exemplar;

template <bool kWeighted>
__global__ void __launch_bounds__(THREADS)
exemplar_gains_kernel(const float* __restrict__ X, const float* __restrict__ E,
                      const float* __restrict__ cm, float* __restrict__ out,
                      long long n, int d, int mp,
                      const float* __restrict__ ew) {
  __shared__ TileSmem sm;
  __shared__ float s_ew[kWeighted ? BM : 1];
  const long long mach = blockIdx.y;
  const long long row0 = (long long)blockIdx.x * BN;
  float sums[TR];
  row_gain_sums<false, kWeighted>(X + mach * n * d, E, cm + mach * mp, n, d,
                                  mp, row0, sm, sums, ew, s_ew);
  if ((threadIdx.x & 15) == 0) {
    const int ty = threadIdx.x >> 4;
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const long long row = row0 + ty * TR + r;
      if (row < n) out[mach * n + row] = sums[r];
    }
  }
}

// X (M, n, d), E (mp, d), cm (M, mp) fp32 contiguous; out (M, n) raw sums;
// ew (mp,) fp32 eval weights, zero-padded, or null for the unweighted
// instantiation.
extern "C" int exemplar_gains_launch(const void* X, const void* E,
                                     const void* cm, void* out, long long M,
                                     long long n, int d, int mp,
                                     const void* ew, void* stream) {
  const dim3 grid((unsigned)((n + BN - 1) / BN), (unsigned)M);
  const cudaStream_t s = (cudaStream_t)stream;
  if (ew == nullptr)
    exemplar_gains_kernel<false><<<grid, THREADS, 0, s>>>(
        (const float*)X, (const float*)E, (const float*)cm, (float*)out, n, d,
        mp, nullptr);
  else
    exemplar_gains_kernel<true><<<grid, THREADS, 0, s>>>(
        (const float*)X, (const float*)E, (const float*)cm, (float*)out, n, d,
        mp, (const float*)ew);
  return (int)cudaGetLastError();
}
