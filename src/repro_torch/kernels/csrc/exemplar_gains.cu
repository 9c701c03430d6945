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
// pair on the clamp and the sum, which is the tighter bound.
//
// Narrow rows (bf16, or int8 with per-row scale and zero-point: the
// quantized instantiation of the TPU kernel) and the bf16 x.e contraction
// are the tile's Operand instantiations (exemplar_tile.cuh): the rows are
// dequantized to fp32 as they are staged, before the gains.  A narrow row
// moves d * itemsize bytes (+ 8 of scale and zero-point at int8) instead
// of 4 d; the tile's operations do not change.
//
// Grid: the tile's persistent grid (persistent_tiles / persistent_grid, as
// greedy_select scores a step): resident CTAs per SM x 132 CTAs, each
// walking a contiguous range of the flattened (machine, 128-row tile)
// space.  One CTA per tile (352,000 at round 0) made every CTA rebuild e~'s
// fragments for all eval columns, load its machine's cur_min and wait on
// its row copy before a single product, for 128 rows; here e~ is staged
// once per CTA, cur_min when the CTA enters a machine, and the row tiles
// are double-buffered by cp.async, so the staging hides behind the tile.
// Each row's sum is the same call of row_gain_sums on the same operands as
// before, so the same bits (and the bits the fused kernels compute).  The
// gains are written straight from the quad leaders' registers: 4 B a row,
// 8 consecutive rows (one 32-byte sector) per store instruction, 180 MB
// at round 0 against the tile's ~9 ms.  Block: 128 threads.  No atomics.
//
// Small calls (the scan block: M = 1, 176 tiles) get a grid of P = T
// CTAs, one tile each, as before: the call lasts one CTA's prologue and
// one tile, and the tile's column loop (latency, not rows: one 64-row
// tile takes 10.5 us where one 128-row tile takes 11.7) is most of it.
// A 64-row tile for such calls and a staging of e~ that loads |e|^2 first
// were measured on the H100 and left out: the first saved nothing at the
// scan block, the second 3 us there but cost the persistent kernels 5-23%
// at round 0 (PERF.md §6).
#include "exemplar_tile.cuh"

using namespace exemplar;

template <class Op, bool kWeighted>
__global__ void __launch_bounds__(THREADS)
exemplar_gains_kernel(Rows<typename Op::T> X, const float* __restrict__ E,
                      const float* __restrict__ cm, float* __restrict__ out,
                      long long M, long long n, int d, int mp,
                      long long ntiles, const float* __restrict__ ew) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(d, mp, kWeighted);
  persistent_tiles<Op, kWeighted>(
      L, smem, X, E, cm, ew, M, n, d, mp, ntiles,
      [](long long) { return 0LL; },
      [&](long long mach, long long row0, const float sums[4]) {
        if ((threadIdx.x & 3) != 0) return;  // the quad holds the same sums
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const long long row = row0 + sum_row(r);
          if (row < n) out[mach * n + row] = sums[r];
        }
      },
      [](long long) {});
}

// X (M, n, d) contiguous, fp32, bf16 or int8 (xtype 0, 1, 2) with
// x_scale, x_zp (M, n) fp32 for int8 (null otherwise); E (mp, d), cm
// (M, mp) fp32 contiguous; out (M, n) raw sums; ew (mp,) fp32 eval weights,
// zero-padded, or null for the unweighted instantiation; bf16dot selects
// the bf16 x.e contraction.
template <class Op, bool kWeighted>
static int launch(const void* X, const void* xs, const void* xz,
                  const void* E, const void* cm, void* out, long long M,
                  long long n, int d, int mp, const void* ew, void* stream) {
  const size_t smem = Layout(d, mp, kWeighted).end;
  const long long ntiles = (n + BN - 1) / BN;
  const long long P = persistent_grid(exemplar_gains_kernel<Op, kWeighted>,
                                      smem, M * ntiles);
  if (P < 1) {
    const int err = (int)cudaGetLastError();
    return err != 0 ? err : (int)cudaErrorInvalidConfiguration;
  }
  const Rows<typename Op::T> R{(const typename Op::T*)X, (const float*)xs,
                               (const float*)xz};
  exemplar_gains_kernel<Op, kWeighted><<<(unsigned)P, THREADS, smem,
                                         (cudaStream_t)stream>>>(
      R, (const float*)E, (const float*)cm, (float*)out, M, n, d, mp, ntiles,
      (const float*)ew);
  return (int)cudaGetLastError();
}

extern "C" int exemplar_gains_launch(const void* X, int xtype,
                                     const void* x_scale, const void* x_zp,
                                     int bf16dot, const void* E,
                                     const void* cm, void* out, long long M,
                                     long long n, int d, int mp,
                                     const void* ew, void* stream) {
  return with_operand(xtype, bf16dot, (int)cudaErrorInvalidValue,
                      [&](auto op) {
    using Op = decltype(op);
    return ew == nullptr
               ? launch<Op, false>(X, x_scale, x_zp, E, cm, out, M, n, d, mp,
                                   ew, stream)
               : launch<Op, true>(X, x_scale, x_zp, E, cm, out, M, n, d, mp,
                                  ew, stream);
  });
}

// Bytes of dynamic shared memory one CTA of the tile needs at (d, mp): the
// wrappers refuse shapes past the card's opt-in limit.
extern "C" long long exemplar_tile_smem(int d, int mp, int weighted) {
  return (long long)Layout(d, mp, weighted != 0).end;
}
