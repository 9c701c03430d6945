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
// Constrained variant (the knapsack and partition-matroid encodings of
// the JAX kernel, either or both): the step kernel masks a row unless it
// is available and feasible, used[mach] + w <= limit and
// counts[mach][gid] < caps[gid]; the commit adds w[best] to used (one
// fp32 add per step, the reference's order) and increments
// counts[gid[best]].  limit = float32(budget + KNAPSACK_TOL) comes from
// the host.  A group id outside [0, G) belongs to no open group.  Null
// weight and group-id pointers select the unconstrained instantiation
// (kConstrained = false), which compiles no feasibility code at all.
//
// Weighted variant (WeightedExemplarClustering): eval weights ew (mp,),
// zero-padded, weigh each eval column's contribution to a gain (the tile's
// kWeighted instantiation, its own step-kernel instantiation); the commit
// is unchanged, since cur_min does not depend on the weights.
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

template <bool kConstrained, bool kWeighted>
__global__ void __launch_bounds__(THREADS)
greedy_step_kernel(const float* __restrict__ X, const float* __restrict__ E,
                   const float* __restrict__ cm,
                   const unsigned char* __restrict__ avail,
                   float* __restrict__ win_v, int* __restrict__ win_i,
                   long long n, int d, int mp, int m_true, int ntiles,
                   Constraint con, const float* __restrict__ ew) {
  __shared__ TileSmem sm;
  __shared__ float tv[BN];
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
      bool ok = row < n && avail[mach * n + row];
      if constexpr (kConstrained) ok = ok && feasible(con, mach, n, row);
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

template <bool kConstrained>
__global__ void __launch_bounds__(COMMIT_THREADS)
greedy_commit_kernel(const float* __restrict__ X, const float* __restrict__ E,
                     float* __restrict__ cm, unsigned char* __restrict__ avail,
                     const float* __restrict__ win_v,
                     const int* __restrict__ win_i, int* __restrict__ sel,
                     long long n, int d, int mp, int ntiles, int k, int step,
                     Constraint con) {
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
    if constexpr (kConstrained) {
      const long long at = mach * n + i;
      if (con.w != nullptr) con.used[mach] = con.used[mach] + con.w[at];
      if (con.gid != nullptr) con.counts[mach * con.G + con.gid[at]] += 1;
    }
  }
}

template <bool kConstrained, bool kWeighted>
static int run_steps(const void* X, const void* E, void* cm, void* avail,
                     void* win_v, void* win_i, void* sel, long long M,
                     long long n, int d, int mp, int m_true, int k,
                     const Constraint& con, const void* ew, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int ntiles = (int)((n + BN - 1) / BN);
  const dim3 grid((unsigned)ntiles, (unsigned)M);
  for (int t = 0; t < k; ++t) {
    greedy_step_kernel<kConstrained, kWeighted><<<grid, THREADS, 0, s>>>(
        (const float*)X, (const float*)E, (const float*)cm,
        (const unsigned char*)avail, (float*)win_v, (int*)win_i, n, d, mp,
        m_true, ntiles, con, (const float*)ew);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
    greedy_commit_kernel<kConstrained><<<(unsigned)M, COMMIT_THREADS, 0, s>>>(
        (const float*)X, (const float*)E, (float*)cm, (unsigned char*)avail,
        (const float*)win_v, (const int*)win_i, (int*)sel, n, d, mp, ntiles, k,
        t, con);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return 0;
}

// X (M, n, d), E (mp, d) fp32; cm (M, mp) fp32 and avail (M, n) uint8 are
// the running state, updated in place; win_v/win_i (M, ceil(n / BN)) are
// scratch; sel (M, k) int32.  Constraint operands: w (M, n) fp32 with used
// (M,) fp32 scratch and limit, gid (M, n) int32 with caps (G,) int32 and
// counts (M, G) int32 scratch; null w / gid switch a part off.  ew (mp,)
// fp32 eval weights, zero-padded, or null (unweighted).  Launches 2k
// kernels on `stream`.
extern "C" int greedy_select_launch(const void* X, const void* E, void* cm,
                                    void* avail, void* win_v, void* win_i,
                                    void* sel, long long M, long long n, int d,
                                    int mp, int m_true, int k, const void* w,
                                    void* used, float limit, const void* gid,
                                    const void* caps, void* counts, int G,
                                    const void* ew, void* stream) {
  const Constraint con{(const float*)w, (const int*)gid, (const int*)caps,
                       (float*)used, (int*)counts, limit, G};
  const bool constrained = w != nullptr || gid != nullptr;
  if (ew == nullptr)
    return constrained
               ? run_steps<true, false>(X, E, cm, avail, win_v, win_i, sel, M,
                                        n, d, mp, m_true, k, con, ew, stream)
               : run_steps<false, false>(X, E, cm, avail, win_v, win_i, sel,
                                         M, n, d, mp, m_true, k, con, ew,
                                         stream);
  return constrained
             ? run_steps<true, true>(X, E, cm, avail, win_v, win_i, sel, M, n,
                                     d, mp, m_true, k, con, ew, stream)
             : run_steps<false, true>(X, E, cm, avail, win_v, win_i, sel, M,
                                      n, d, mp, m_true, k, con, ew, stream);
}
