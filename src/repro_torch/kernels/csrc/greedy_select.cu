// Fused k-step exemplar-clustering greedy over a leading machine axis.
//
// Replaces the TPU kernel repro/kernels/greedy_select.py
// (greedy_select_pallas, pl.pallas_call at :265).  The TPU version is one
// launch whose sequential grid (steps x candidate blocks) carries cur_min,
// availability and a running argmax in VMEM/SMEM scratch.  Hopper runs
// blocks in parallel and in no order, so here each greedy step is one
// launch of a persistent grid (resident CTAs per SM x 132):
//
//   score   each CTA walks a contiguous range of the flattened (machine,
//           128-row tile) space (exemplar_tile.cuh's persistent_tiles: e~
//           staged once, a machine's cur_min when the CTA enters it, X
//           tiles by cp.async two deep) and scores its rows with the shared
//           tile — the bits exemplar_gains gives them — divided by the
//           unpadded m, masked to -1e30 where unavailable (or infeasible);
//           it keeps a running (best value, lowest index) per machine
//           segment and writes one winner per (CTA, machine segment);
//   commit  a per-machine ticket (__threadfence, then atomicAdd) elects the
//           last CTA to finish a machine; it reduces that machine's segment
//           winners (lowest index on ties) and, if the best is a real
//           candidate (> -1e30 / 2), refreshes cur_min in the difference
//           form sum_c (e_c - x_c)^2, clears the winner's availability and
//           writes sel, else writes -1; then it sets the ticket back to 0.
//
// Every CTA of the grid is resident and none waits on another, so the
// ticket cannot hang; there is no grid-wide barrier across steps.  k
// launches a call.  At M = 1 (the centralized baseline over the whole
// ground set) every CTA scores a share of the one machine and the commit
// reduces one winner per CTA.
//
// Constrained variant (the knapsack and partition-matroid encodings of
// the JAX kernel, either or both): a row is masked unless it is available
// and feasible, used[mach] + w <= limit and counts[mach][gid] < caps[gid];
// the commit adds w[best] to used (one fp32 add per step, the reference's
// order) and increments counts[gid[best]].  limit = float32(budget +
// KNAPSACK_TOL) comes from the host.  A group id outside [0, G) belongs
// to no open group.  Null weight and group-id pointers select the
// unconstrained instantiation (kConstrained = false), which compiles no
// feasibility code at all.
//
// Weighted variant (WeightedExemplarClustering): eval weights ew (mp,),
// zero-padded, weigh each eval column's contribution to a gain (the tile's
// kWeighted instantiation); the commit is unchanged, since cur_min does
// not depend on the weights.
//
// Bound on the H100: the tile's CUDA-core epilogue, four fp32 issue slots
// per (candidate, eval column) pair per step, beside three TF32 products
// per 128 pairs and 8-deep k-step; the commit is O(m d) per machine per
// step.  The step-invariant distances are recomputed each step: at round 0
// they would be 92 GB.
#include <climits>
#include <cmath>

#include "exemplar_tile.cuh"

using namespace exemplar;

// The fused constraint encodings; null pointers switch a part off.
struct Constraint {
  const float* w;    // (M, n) knapsack weights, or null
  const int* gid;    // (M, n) partition group ids, or null
  const int* caps;   // (G,) per-group caps
  float* used;       // (M,) running knapsack weight (device scratch)
  int* counts;       // (M, G) running group counts (device scratch)
  float limit;       // float32(budget + KNAPSACK_TOL)
  int G;
};

__device__ __forceinline__ bool feasible(const Constraint& c, long long mach,
                                         long long n, long long row) {
  const long long at = mach * n + row;
  if (c.w != nullptr && !(c.used[mach] + c.w[at] <= c.limit)) return false;
  if (c.gid != nullptr) {
    const int g = c.gid[at];
    if (g < 0 || g >= c.G || c.counts[mach * c.G + g] >= c.caps[g])
      return false;
  }
  return true;
}

// The (value, index) argmax of the CTA's threads; every thread gets it.
__device__ __forceinline__ void cta_best(float& v, int& i, float* s_v,
                                         int* s_i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  __syncthreads();  // s_v / s_i of an earlier call are read
  if ((threadIdx.x & 31) == 0) {
    s_v[threadIdx.x >> 5] = v;
    s_i[threadIdx.x >> 5] = i;
  }
  __syncthreads();
  v = s_v[0];
  i = s_i[0];
  for (int w = 1; w < THREADS / 32; ++w)
    if (better(s_v[w], s_i[w], v, i)) {
      v = s_v[w];
      i = s_i[w];
    }
}

template <bool kConstrained, bool kWeighted>
__global__ void __launch_bounds__(THREADS)
greedy_step_kernel(const float* __restrict__ X, const float* __restrict__ E,
                   float* cm, unsigned char* avail, float* win_v, int* win_i,
                   int* ticket, int* __restrict__ sel, long long M,
                   long long n, int d, int mp, int m_true, int k, int step,
                   long long ntiles, Constraint con,
                   const float* __restrict__ ew) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_v[THREADS / 32];
  __shared__ int s_i[THREADS / 32];
  __shared__ int s_last;
  const Layout L(d, mp, kWeighted);
  const long long T = M * ntiles, P = gridDim.x, c = blockIdx.x;
  const int tid = threadIdx.x;
  float bv = -INFINITY;  // this thread's best of the current segment
  int bi = INT_MAX;

  auto on_rows = [&](long long mach, long long row0, const float sums[4]) {
    if ((tid & 3) != 0) return;  // the quad holds the same sums
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long row = row0 + sum_row(r);
      bool ok = row < n && avail[mach * n + row];
      if constexpr (kConstrained) ok = ok && feasible(con, mach, n, row);
      const float v = ok ? sums[r] / (float)m_true : NEG_INF;
      if (better(v, (int)row, bv, bi)) {
        bv = v;
        bi = (int)row;
      }
    }
  };

  auto on_leave = [&](long long mach) {
    // this CTA's winner of the machine's segment, then its ticket
    float v = bv;
    int i = bi;
    cta_best(v, i, s_v, s_i);
    bv = -INFINITY;
    bi = INT_MAX;
    const long long c_lo = cta_of(mach * ntiles, P, T);
    const long long c_hi = cta_of(mach * ntiles + ntiles - 1, P, T);
    if (tid == 0) {
      win_v[c + mach] = v;  // segment (c, mach) has slot c + mach
      win_i[c + mach] = i;
      __threadfence();
      s_last = atomicAdd(ticket + mach, 1) == (int)(c_hi - c_lo);
    }
    __syncthreads();
    if (!s_last) return;
    // the last CTA of the machine: reduce its segment winners
    __threadfence();
    v = -INFINITY;
    i = INT_MAX;
    for (long long s = c_lo + tid; s <= c_hi; s += THREADS) {
      const float sv = __ldcg(win_v + s + mach);
      const int si = __ldcg(win_i + s + mach);
      if (better(sv, si, v, i)) {
        v = sv;
        i = si;
      }
    }
    cta_best(v, i, s_v, s_i);
    if (v > NEG_INF / 2) {
      const float* x = X + (mach * n + i) * d;
      for (int j = tid; j < mp; j += THREADS) {
        const float* e = E + (long long)j * d;
        float s = 0.f;
        for (int q = 0; q < d; ++q) {
          const float df = e[q] - x[q];
          s = fmaf(df, df, s);
        }
        cm[mach * mp + j] = fminf(cm[mach * mp + j], s);
      }
    }
    if (tid == 0) {
      if (v > NEG_INF / 2) {
        avail[mach * n + i] = 0;
        sel[mach * k + step] = i;
        if constexpr (kConstrained) {
          const long long at = mach * n + i;
          if (con.w != nullptr) con.used[mach] = con.used[mach] + con.w[at];
          if (con.gid != nullptr) con.counts[mach * con.G + con.gid[at]] += 1;
        }
      } else {
        sel[mach * k + step] = -1;  // no candidate left: -1 from here on
      }
      ticket[mach] = 0;
    }
  };

  persistent_tiles<kWeighted>(
      L, smem, X, E, cm, ew, M, n, d, mp, ntiles,
      [](long long) { return 0LL; }, on_rows, on_leave);
}

template <bool kConstrained, bool kWeighted>
static long long grid_of(long long M, long long n, int d, int mp) {
  const long long T = M * ((n + BN - 1) / BN);
  return persistent_grid(greedy_step_kernel<kConstrained, kWeighted>,
                         Layout(d, mp, kWeighted).end, T);
}

// The persistent grid of one step at this shape (0 on error): the wrapper
// sizes the segment-winner scratch, M + grid slots, from it.
extern "C" long long greedy_select_grid(long long M, long long n, int d,
                                        int mp, int constrained,
                                        int weighted) {
  if (weighted)
    return constrained ? grid_of<true, true>(M, n, d, mp)
                       : grid_of<false, true>(M, n, d, mp);
  return constrained ? grid_of<true, false>(M, n, d, mp)
                     : grid_of<false, false>(M, n, d, mp);
}

template <bool kConstrained, bool kWeighted>
static int run_steps(const void* X, const void* E, void* cm, void* avail,
                     void* win_v, void* win_i, void* ticket, void* sel,
                     long long M, long long n, int d, int mp, int m_true,
                     int k, long long P, const Constraint& con,
                     const void* ew, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long long ntiles = (n + BN - 1) / BN;
  const size_t smem = Layout(d, mp, kWeighted).end;
  if (P != grid_of<kConstrained, kWeighted>(M, n, d, mp))
    return (int)cudaErrorInvalidConfiguration;
  for (int t = 0; t < k; ++t) {
    greedy_step_kernel<kConstrained, kWeighted><<<(unsigned)P, THREADS,
                                                  smem, s>>>(
        (const float*)X, (const float*)E, (float*)cm, (unsigned char*)avail,
        (float*)win_v, (int*)win_i, (int*)ticket, (int*)sel, M, n, d, mp,
        m_true, k, t, ntiles, con, (const float*)ew);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return 0;
}

// X (M, n, d), E (mp, d) fp32; cm (M, mp) fp32 and avail (M, n) uint8 are
// the running state, updated in place; win_v/win_i (M + P,) and ticket
// (M,) int32, zero on entry, are scratch (P = greedy_select_grid(...));
// sel (M, k) int32.  Constraint operands: w (M, n) fp32 with used (M,)
// fp32 scratch and limit, gid (M, n) int32 with caps (G,) int32 and counts
// (M, G) int32 scratch; null w / gid switch a part off.  ew (mp,) fp32
// eval weights, zero-padded, or null (unweighted).  Launches k kernels on
// `stream`.
extern "C" int greedy_select_launch(const void* X, const void* E, void* cm,
                                    void* avail, void* win_v, void* win_i,
                                    void* ticket, void* sel, long long M,
                                    long long n, int d, int mp, int m_true,
                                    int k, long long P, const void* w,
                                    void* used, float limit, const void* gid,
                                    const void* caps, void* counts, int G,
                                    const void* ew, void* stream) {
  const Constraint con{(const float*)w, (const int*)gid, (const int*)caps,
                       (float*)used, (int*)counts, limit, G};
  const bool constrained = w != nullptr || gid != nullptr;
  if (ew == nullptr)
    return constrained
               ? run_steps<true, false>(X, E, cm, avail, win_v, win_i, ticket,
                                        sel, M, n, d, mp, m_true, k, P, con,
                                        ew, stream)
               : run_steps<false, false>(X, E, cm, avail, win_v, win_i,
                                         ticket, sel, M, n, d, mp, m_true, k,
                                         P, con, ew, stream);
  return constrained
             ? run_steps<true, true>(X, E, cm, avail, win_v, win_i, ticket,
                                     sel, M, n, d, mp, m_true, k, P, con, ew,
                                     stream)
             : run_steps<false, true>(X, E, cm, avail, win_v, win_i, ticket,
                                      sel, M, n, d, mp, m_true, k, P, con, ew,
                                      stream);
}
