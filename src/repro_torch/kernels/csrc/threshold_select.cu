// One tau-level of threshold-batch selection over a leading machine axis.
//
// Replaces the TPU kernel repro/kernels/threshold_select.py
// (threshold_select_pallas, pl.pallas_call at :238).  The TPU version walks
// its grid of bn-row candidate blocks in order on one core, carrying
// cur_min, the stop flag, count, used and the group counts from block to
// block in VMEM/SMEM scratch.  The semantics are block-sequential: block
// b's gains see the cur_min that blocks < b left, and a violation stops
// the whole launch.  So here one CTA owns one machine and loops over its
// blocks (grid (M,)); machines run in parallel.  Per block of bn <= 256
// rows:
//
//   gains    the rows' gains against the block-entry cur_min, BN = 128
//            rows at a time with the shared tile (exemplar_tile.cuh), so a
//            gain has the bits exemplar_gains gives it: the row that sets
//            the ladder's d_max qualifies at level 0;
//   qualify  available, gain >= tau, and singly feasible against the
//            block-entry used / group counts (used + w <= limit; the
//            row's group id in [0, G) and its count below its cap);
//   accept   lane 0 of warp 0 walks the qualifying rows in row order
//            (ballots over 32-row chunks): a row whose inclusive count,
//            weight (used + cumw, fp32, sequential) or group count would
//            exceed k, the limit or its cap sets the launch-wide stop
//            flag; the rows before it are accepted;
//   fold     the accepted rows' contraction-form d^2 fold into cur_min
//            (a masked row-min).  cur_min lives in the machine's own
//            slice of the output, which the tile reads for the next block.
//
// limit = float32(budget + KNAPSACK_TOL) comes from the host.  Weights are
// knapsack weights (>= 0).  Eval weights ew (mp,), where given, weigh the
// gains' eval columns (the tile's kWeighted instantiation, this kernel's
// own instantiation); the fold does not depend on them.  A group id outside [0, G) belongs to no open
// group.  A machine whose ladder has ended (active == 0) is left alone.
//
// Bound on the H100: fp32 FMA throughput of the gains, n * m * (2d + 3)
// operations per machine per level, as exemplar_gains; the accept walk
// and the fold touch only qualifying rows.  Rounds with few machines use
// few SMs (M = 5 uses 5 of 132): recorded, not redesigned here.
#include "exemplar_tile.cuh"

using namespace exemplar;

constexpr int MAX_BN = 256;
static_assert(MAX_BN <= THREADS, "one thread per block row");

template <bool kWeighted>
__global__ void __launch_bounds__(THREADS)
threshold_select_kernel(const float* __restrict__ X,
                        const float* __restrict__ E, float* cm,
                        const unsigned char* __restrict__ avail,
                        const float* __restrict__ tau,
                        const float* __restrict__ used0,
                        const int* __restrict__ count0,
                        const int* __restrict__ counts0,
                        const unsigned char* __restrict__ active,
                        const float* __restrict__ w,
                        const int* __restrict__ gid,
                        const int* __restrict__ caps,
                        unsigned char* __restrict__ accept, long long n, int d,
                        int mp, int m_true, int k, int bn, int G,
                        float limit, const float* __restrict__ ew) {
  extern __shared__ int s_counts[];  // (G,) running group counts
  __shared__ TileSmem sm;
  __shared__ float s_ew[kWeighted ? BM : 1];
  __shared__ float s_g[MAX_BN];
  __shared__ unsigned char s_q[MAX_BN];
  __shared__ int s_acc[MAX_BN];      // accepted rows of the block, in order
  __shared__ int s_nacc, s_stop, s_count;
  __shared__ float s_used;
  const long long mach = blockIdx.x;
  if (!active[mach]) return;
  const int tid = threadIdx.x;
  const float* Xm = X + mach * n * d;
  const long long base = mach * n;
  float* cmm = cm + mach * mp;
  const float t = tau[mach];
  int over = 0;  // a group already above its cap: every qualifier violates
  if (gid != nullptr)
    for (int g = tid; g < G; g += THREADS) {
      s_counts[g] = counts0[mach * G + g];
      over |= s_counts[g] > caps[g];
    }
  if (tid == 0) {
    s_count = count0[mach];
    s_used = used0[mach];
    s_stop = 0;
  }
  if (__syncthreads_or(over)) return;  // accepts nothing, cm unchanged

  for (long long b0 = 0; b0 < n; b0 += bn) {
    if (s_stop || s_count >= k) break;  // later blocks accept nothing
    const long long b1 = b0 + bn < n ? b0 + bn : n;
    const int nb = (int)(b1 - b0);
    for (int r0 = 0; r0 < nb; r0 += BN) {
      float sums[TR];
      row_gain_sums<true, kWeighted>(Xm, E, cmm, b1, d, mp, b0 + r0, sm,
                                     sums, ew, s_ew);
      if ((tid & 15) == 0) {
        const int ty = tid >> 4;
#pragma unroll
        for (int r = 0; r < TR; ++r) {
          const int i = r0 + ty * TR + r;
          if (i < nb) s_g[i] = sums[r] / (float)m_true;
        }
      }
    }
    __syncthreads();
    if (tid < nb) {
      const long long at = base + b0 + tid;
      bool q = avail[at] && s_g[tid] >= t;
      if (w != nullptr) q = q && s_used + w[at] <= limit;
      if (gid != nullptr) {
        const int g = gid[at];
        q = q && g >= 0 && g < G && s_counts[g] < caps[g];
      }
      s_q[tid] = q;
    }
    __syncthreads();
    if (tid < 32) {
      int cnt = s_count, na = 0, stop = 0;
      float cw = 0.f;
      for (int c0 = 0; c0 < nb && !stop; c0 += 32) {
        const int i = c0 + tid;
        unsigned bits = __ballot_sync(0xffffffffu, i < nb && s_q[i]);
        if (tid == 0) {
          while (bits) {
            const int j = c0 + __ffs(bits) - 1;
            bits &= bits - 1;
            const long long at = base + b0 + j;
            float cwj = cw;
            int viol = cnt + 1 > k;
            if (w != nullptr) {
              cwj = cw + w[at];
              viol |= s_used + cwj > limit;
            }
            const int g = gid != nullptr ? gid[at] : 0;
            if (gid != nullptr) viol |= s_counts[g] + 1 > caps[g];
            if (viol) {
              stop = 1;
              break;
            }
            cnt += 1;
            cw = cwj;
            if (gid != nullptr) s_counts[g] += 1;
            s_acc[na++] = j;
            accept[at] = 1;
          }
        }
        stop = __shfl_sync(0xffffffffu, stop, 0);
      }
      if (tid == 0) {
        s_count = cnt;
        if (w != nullptr) s_used = s_used + cw;
        s_nacc = na;
        s_stop = stop;
      }
    }
    __syncthreads();
    const int na = s_nacc;
    if (na > 0) {
      for (int j = tid; j < mp; j += THREADS) {
        const float* e = E + (long long)j * d;
        float e2 = 0.f;
        for (int c = 0; c < d; ++c) e2 = fmaf(e[c], e[c], e2);
        float v = cmm[j];
        for (int a = 0; a < na; ++a) {
          const float* x = Xm + (b0 + s_acc[a]) * d;
          float x2 = 0.f, xy = 0.f;
          for (int c = 0; c < d; ++c) {
            x2 = fmaf(x[c], x[c], x2);
            xy = fmaf(x[c], e[c], xy);
          }
          v = fminf(v, fmaxf(x2 + e2 - 2.f * xy, 0.f));
        }
        cmm[j] = v;
      }
    }
    __syncthreads();
  }
}

// X (M, n, d), E (mp, d) fp32 contiguous; cm (M, mp) fp32, updated in
// place; avail (M, n) uint8; tau, used (M,) fp32; count (M,) int32;
// counts (M, G) int32; active (M,) uint8; w (M, n) fp32 or null; gid
// (M, n) int32 or null with caps (G,) int32; accept (M, n) uint8, zero on
// entry; ew (mp,) fp32 eval weights, zero-padded, or null (unweighted).
// One launch of M blocks on `stream`; G must not exceed
// threshold_select_max_groups() for the same weighting.
template <bool kWeighted>
static int launch(const void* X, const void* E, void* cm, const void* avail,
                  const void* tau, const void* used, const void* count,
                  const void* counts, const void* active, const void* w,
                  const void* gid, const void* caps, void* accept, long long M,
                  long long n, int d, int mp, int m_true, int k, int bn, int G,
                  float limit, const void* ew, void* stream) {
  const size_t smem = gid != nullptr ? (size_t)G * sizeof(int) : 0;
  if (smem > 0) {  // past 48 KB the kernel must opt in to more
    const int err = (int)cudaFuncSetAttribute(
        threshold_select_kernel<kWeighted>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != 0) return err;
  }
  threshold_select_kernel<kWeighted><<<(unsigned)M, THREADS, smem,
                                       (cudaStream_t)stream>>>(
      (const float*)X, (const float*)E, (float*)cm,
      (const unsigned char*)avail, (const float*)tau, (const float*)used,
      (const int*)count, (const int*)counts, (const unsigned char*)active,
      (const float*)w, (const int*)gid, (const int*)caps,
      (unsigned char*)accept, n, d, mp, m_true, k, bn, G, limit,
      (const float*)ew);
  return (int)cudaGetLastError();
}

extern "C" int threshold_select_launch(
    const void* X, const void* E, void* cm, const void* avail,
    const void* tau, const void* used, const void* count, const void* counts,
    const void* active, const void* w, const void* gid, const void* caps,
    void* accept, long long M, long long n, int d, int mp, int m_true, int k,
    int bn, int G, float limit, const void* ew, void* stream) {
  return ew == nullptr
             ? launch<false>(X, E, cm, avail, tau, used, count, counts, active,
                             w, gid, caps, accept, M, n, d, mp, m_true, k, bn,
                             G, limit, ew, stream)
             : launch<true>(X, E, cm, avail, tau, used, count, counts, active,
                            w, gid, caps, accept, M, n, d, mp, m_true, k, bn,
                            G, limit, ew, stream);
}

// The most partition groups one launch takes on `device`: the group counts
// live in dynamic shared memory, which is the opt-in maximum per block less
// the kernel's static shared memory (the gain tile and the block buffers,
// and the eval weights' stage where `weighted`).
extern "C" int threshold_select_max_groups(int device, int weighted) {
  cudaFuncAttributes attr;
  int optin = 0;
  const cudaError_t got =
      weighted ? cudaFuncGetAttributes(&attr, threshold_select_kernel<true>)
               : cudaFuncGetAttributes(&attr, threshold_select_kernel<false>);
  if (got != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -(int)cudaGetLastError();
  return (optin - (int)attr.sharedSizeBytes) / (int)sizeof(int);
}
