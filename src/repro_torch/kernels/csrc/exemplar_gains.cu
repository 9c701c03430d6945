// Step-wise exemplar-clustering gains over a leading machine axis.
//
// Replaces the TPU kernel repro/kernels/exemplar_gains.py
// (exemplar_gains_pallas, pl.pallas_call at :107): raw
// sum_j max(0, cm[j] - ||x_i - e_j||^2) per candidate row, contraction form,
// clamped at 0, optionally weighted per eval column (its own template
// instantiation).  The caller divides by the unpadded eval-set size.
//
// Bound on the H100: the shared tile (exemplar_tile.cuh) forms each pair's
// distance on the tensor cores (three TF32 products per 8-deep k-step,
// the split that keeps fp32's accuracy) and spends four fp32 issue slots a
// pair on the clamp and the sum, which is the tighter bound.  Each CTA
// stages e~ once and scores one 128-row tile.
//
// Grid: (ceil(n / BN), M).  Block: 128 threads.  No atomics.
#include "exemplar_tile.cuh"

using namespace exemplar;

template <bool kWeighted>
__global__ void __launch_bounds__(THREADS)
exemplar_gains_kernel(const float* __restrict__ X, const float* __restrict__ E,
                      const float* __restrict__ cm, float* __restrict__ out,
                      long long n, int d, int mp,
                      const float* __restrict__ ew) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(d, mp, kWeighted);
  const long long mach = blockIdx.y;
  const long long row0 = (long long)blockIdx.x * BN;
  const float* Xm = X + mach * n * d;
  float* s_cm = reinterpret_cast<float*>(smem + L.cm);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  if (L.resident) load_rows(xs, Xm, n, d, row0);
  for (int j = threadIdx.x; j < mp; j += THREADS) s_cm[j] = cm[mach * mp + j];
  stage_eval<kWeighted>(L, smem, E, d, mp, ew);
  cp_async_wait_all();
  __syncthreads();
  float sums[4];
  row_gain_sums<kWeighted>(L, smem, Xm, E, n, d, mp, row0, s_cm,
                           reinterpret_cast<const float*>(smem + L.ew), xs,
                           sums);
  if ((threadIdx.x & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long row = row0 + sum_row(r);
      if (row < n) out[mach * n + row] = sums[r];
    }
  }
}

// X (M, n, d), E (mp, d), cm (M, mp) fp32 contiguous; out (M, n) raw sums;
// ew (mp,) fp32 eval weights, zero-padded, or null for the unweighted
// instantiation.
template <bool kWeighted>
static int launch(const void* X, const void* E, const void* cm, void* out,
                  long long M, long long n, int d, int mp, const void* ew,
                  void* stream) {
  const size_t smem = Layout(d, mp, kWeighted).end;
  int err = (int)cudaFuncSetAttribute(
      exemplar_gains_kernel<kWeighted>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != 0) return err;
  const dim3 grid((unsigned)((n + BN - 1) / BN), (unsigned)M);
  exemplar_gains_kernel<kWeighted><<<grid, THREADS, smem,
                                     (cudaStream_t)stream>>>(
      (const float*)X, (const float*)E, (const float*)cm, (float*)out, n, d,
      mp, (const float*)ew);
  return (int)cudaGetLastError();
}

extern "C" int exemplar_gains_launch(const void* X, const void* E,
                                     const void* cm, void* out, long long M,
                                     long long n, int d, int mp,
                                     const void* ew, void* stream) {
  return ew == nullptr
             ? launch<false>(X, E, cm, out, M, n, d, mp, ew, stream)
             : launch<true>(X, E, cm, out, M, n, d, mp, ew, stream);
}

// Bytes of dynamic shared memory one CTA of the tile needs at (d, mp): the
// wrappers refuse shapes past the card's opt-in limit.
extern "C" long long exemplar_tile_smem(int d, int mp, int weighted) {
  return (long long)Layout(d, mp, weighted != 0).end;
}
