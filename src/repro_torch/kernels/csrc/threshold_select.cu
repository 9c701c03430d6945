// One tau-level of threshold-batch selection over a leading machine axis.
//
// Replaces the TPU kernel repro/kernels/threshold_select.py
// (threshold_select_pallas, pl.pallas_call at :238).  The TPU version walks
// its grid of bn-row candidate blocks in order on one core, carrying
// cur_min, the stop flag, count, used and the group counts from block to
// block in VMEM/SMEM scratch.  The semantics are block-sequential: block
// b's gains see the cur_min that blocks < b left, and a violation stops
// the whole launch.  Three launches here, each machine's walk in one CTA:
//
//   head      (grid (M,)) walks each machine's blocks from the first,
//             scoring each at its block-entry cur_min with the shared tile,
//             as the block-sequential walk does, until the machine is done
//             (the stop flag, count = k, or no block left) or
//             kHeadEmpties blocks in a row have accepted nothing; then it
//             leaves the machine pending with its state (count, used, group
//             counts, the next block) in device scratch.  A level at which
//             many rows qualify fills k or stops within a few blocks;
//   pre-pass  a persistent grid over the flattened (pending machine,
//             128-row tile) space (exemplar_tile.cuh's persistent_tiles,
//             as greedy_select scores a step) scores every row from the
//             next block on at the head's exit cur_min and writes the gains
//             and a flag per (machine, bn-row block): some row of the block
//             is available, has gain >= tau and is singly feasible against
//             the head's exit used and group counts;
//   tail      (grid (M,)) resumes each pending machine and visits its
//             flagged blocks only.  Until its first accept, cur_min is the
//             pre-pass's, so a block's gains are the pre-pass's (the same
//             tile, the same cm: the same bits) and are read as they are;
//             after it, a flagged block is rescored at its block-entry
//             cur_min with the same tile.
//
// Per visited block (head and tail):
//     qualify  available, gain >= tau, and singly feasible against the
//              block-entry used / group counts (used + w <= limit; the
//              row's group id in [0, G) and its count below its cap);
//     accept   lane 0 of warp 0 walks the qualifying rows in row order
//              (ballots over 32-row chunks): a row whose inclusive count,
//              weight (used + cumw, fp32, sequential) or group count would
//              exceed k, the limit or its cap sets the launch-wide stop
//              flag; the rows before it are accepted;
//     fold     the accepted rows' contraction-form d^2 fold into cur_min
//              (a masked row-min), kept in shared memory for the next block
//              and written back when the walk leaves the machine.
//
// Skipping an unflagged block is exact.  Each term max(cm - max(t, 0), 0)
// is monotone in cm, fp32 rounding is monotone, and the tile sums its
// non-negative terms in a fixed order, so a row's gain at any later cm of
// the level (cm only falls: the fold is a min) is at most its gain at the
// pre-pass, bit for bit.  used and the group counts only grow, and
// availability is fixed within a level.  So a row that does not qualify
// at the pre-pass qualifies at no later block either: an unflagged block
// accepts nothing, raises no stop flag and leaves cm as it is — what the
// block-sequential walk would have done there.
//
// limit (one fp32, float32(budget + KNAPSACK_TOL) of a static budget or the
// device's budget + KNAPSACK_TOL of a per-request one) is read from device
// memory, so a captured CUDA graph serves every budget.  Weights are
// knapsack weights (>= 0).  Eval weights ew (mp,), where given, weigh the
// gains' eval columns (the tile's kWeighted instantiation, these kernels'
// own instantiations); the fold does not depend on them.  A group id
// outside [0, G) belongs to no open group.  A machine whose ladder has
// ended (active == 0) is left alone.
//
// Narrow rows and the bf16 x.e contraction (the TPU kernel's quantized and
// compute_dtype instantiations) are the tile's Operand instantiations: the
// head, pre-pass and tail score dequantized fp32 rows, and the fold
// dequantizes the accepted rows the same way (Rows::at); under bf16 dot
// its x.e is taken over bf16(x), bf16(e) as the gains' is, with |x|^2 and
// |e|^2 in fp32 (the plain version folds the same contraction).
//
// Bound on the H100: the tile, four fp32 issue slots per (candidate, eval
// column) pair scored, beside three TF32 products per 128 pairs.  Where few
// rows qualify (the ladder's first level), the pre-pass scores a machine's
// rows on the whole card and the tail visits a few blocks; where many do,
// the head fills k or stops in a few blocks and the pre-pass scores
// nothing.
#include "exemplar_tile.cuh"

using namespace exemplar;

constexpr int MAX_BN = 256;
// consecutive blocks without an accept after which the head leaves a
// machine to the pre-pass and the tail
constexpr int kHeadEmpties = 2;

// A pending machine's state between the head and the tail (device scratch;
// pending zero on entry).
struct Resume {
  unsigned char* pending;  // (M,) the head left the machine to the tail
  int* next;               // (M,) the first block the tail walks
  int* count;              // (M,) count, used and group counts at the
  float* used;             // (M,) head's exit
  int* counts;             // (M, G)
};

// The pre-pass: gains and block flags (M, nblk, zero on entry) of the
// pending machines from their next block on, at the head's exit state.
template <class Op, bool kWeighted>
__global__ void __launch_bounds__(THREADS)
threshold_prepass_kernel(Rows<typename Op::T> X,
                         const float* __restrict__ E,
                         const float* __restrict__ cm,
                         const unsigned char* __restrict__ avail,
                         const float* __restrict__ tau, Resume rs,
                         const float* __restrict__ w,
                         const int* __restrict__ gid,
                         const int* __restrict__ caps,
                         float* __restrict__ gains,
                         unsigned char* __restrict__ flags, long long M,
                         long long n, int d, int mp, int m_true, int bn,
                         int G, const float* __restrict__ limit_p,
                         const float* __restrict__ ew, long long ntiles,
                         long long nblk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(d, mp, kWeighted);
  const float limit = w != nullptr ? *limit_p : 0.f;
  auto on_rows = [&](long long mach, long long row0, const float sums[4]) {
    if ((threadIdx.x & 3) != 0) return;  // the quad holds the same sums
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long row = row0 + sum_row(r);
      if (row >= n) continue;
      const long long at = mach * n + row;
      const float g = sums[r] / (float)m_true;
      gains[at] = g;
      bool q = avail[at] && g >= tau[mach];
      if (w != nullptr) q = q && rs.used[mach] + w[at] <= limit;
      if (gid != nullptr) {
        const int grp = gid[at];
        q = q && grp >= 0 && grp < G &&
            rs.counts[mach * G + grp] < caps[grp];
      }
      if (q) flags[mach * nblk + row / bn] = 1;
    }
  };
  persistent_tiles<Op, kWeighted>(
      L, smem, X, E, cm, ew, M, n, d, mp, ntiles,
      [&](long long mach) {
        return rs.pending[mach] ? (long long)rs.next[mach] * bn : -1LL;
      },
      on_rows, [](long long) {});
}

// The walk: the head (kTail false) from block 0 and the level's entry
// state, or the tail (kTail true) of the pending machines from their next
// block and the head's exit state, over the flagged blocks only.
template <class Op, bool kWeighted, bool kTail>
__global__ void __launch_bounds__(THREADS)
threshold_walk_kernel(Rows<typename Op::T> X,
                      const float* __restrict__ E, float* cm,
                      const unsigned char* __restrict__ avail,
                      const float* __restrict__ tau,
                      const float* __restrict__ used0,
                      const int* __restrict__ count0,
                      const int* __restrict__ counts0,
                      const unsigned char* __restrict__ active, Resume rs,
                      const float* __restrict__ w,
                      const int* __restrict__ gid,
                      const int* __restrict__ caps,
                      const float* __restrict__ gains,
                      const unsigned char* __restrict__ flags,
                      unsigned char* __restrict__ accept, long long n, int d,
                      int mp, int m_true, int k, int bn, int G,
                      const float* __restrict__ limit_p,
                      const float* __restrict__ ew, long long nblk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(d, mp, kWeighted);
  int* s_counts = reinterpret_cast<int*>(smem + L.end);  // (G,)
  float* s_cm = reinterpret_cast<float*>(smem + L.cm);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  __shared__ float s_g[MAX_BN];
  __shared__ unsigned char s_q[MAX_BN];
  __shared__ int s_acc[MAX_BN];      // accepted rows of the block, in order
  __shared__ int s_nacc, s_stop, s_count;
  __shared__ float s_used;
  const long long mach = blockIdx.x;
  if (kTail ? !rs.pending[mach] : !active[mach]) return;
  const int tid = threadIdx.x;
  const float limit = w != nullptr ? *limit_p : 0.f;
  const Rows<typename Op::T> Xm = X.from(mach * n, d);
  const long long base = mach * n;
  float* cmm = cm + mach * mp;
  const float t = tau[mach];
  const int* counts_in = kTail ? rs.counts : counts0;
  int over = 0;  // a group already above its cap: every qualifier violates
  if (gid != nullptr)
    for (int g = tid; g < G; g += THREADS) {
      s_counts[g] = counts_in[mach * G + g];
      over |= s_counts[g] > caps[g];
    }
  if (tid == 0) {
    s_count = kTail ? rs.count[mach] : count0[mach];
    s_used = kTail ? rs.used[mach] : used0[mach];
    s_stop = 0;
  }
  if (__syncthreads_or(over)) return;  // accepts nothing, cm unchanged
  for (int j = tid; j < mp; j += THREADS) s_cm[j] = cmm[j];
  bool staged = false;  // e~ in shared memory (before the first rescore)
  bool moved = false;   // some row accepted: rescore from here on
  int empties = 0;      // head: blocks in a row that accepted nothing

  for (long long b = kTail ? rs.next[mach] : 0; b < nblk; ++b) {
    if (s_stop || s_count >= k) break;  // later blocks accept nothing
    if (kTail && !flags[mach * nblk + b]) continue;  // (see above)
    const long long b0 = b * bn, b1 = b0 + bn < n ? b0 + bn : n;
    const int nb = (int)(b1 - b0);
    if (kTail && !moved) {
      for (int i = tid; i < nb; i += THREADS) s_g[i] = gains[base + b0 + i];
    } else {
      if (!staged) {
        stage_eval<Op, kWeighted>(L, smem, E, d, mp, ew);
        staged = true;
      }
      for (int r0 = 0; r0 < nb; r0 += BN) {
        __syncthreads();  // the stage of the previous pass is consumed
        if (L.resident) load_rows(xs, Xm, b1, d, b0 + r0);
        cp_async_wait_all();
        __syncthreads();
        float sums[4];
        row_gain_sums<Op, kWeighted>(
            L, smem, Xm, E, b1, d, mp, b0 + r0, s_cm,
            reinterpret_cast<const float*>(smem + L.ew), xs, sums);
        if ((tid & 3) == 0) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = r0 + sum_row(r);
            if (i < nb) s_g[i] = sums[r] / (float)m_true;
          }
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < nb; i += THREADS) {
      const long long at = base + b0 + i;
      bool q = avail[at] && s_g[i] >= t;
      if (w != nullptr) q = q && s_used + w[at] <= limit;
      if (gid != nullptr) {
        const int g = gid[at];
        q = q && g >= 0 && g < G && s_counts[g] < caps[g];
      }
      s_q[i] = q;
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
      moved = true;
      for (int j = tid; j < mp; j += THREADS) {
        const float* e = E + (long long)j * d;
        float e2 = 0.f;
        for (int c = 0; c < d; ++c) e2 = fmaf(e[c], e[c], e2);
        float v = s_cm[j];
        for (int a = 0; a < na; ++a) {
          const long long row = b0 + s_acc[a];
          float x2 = 0.f, xy = 0.f;
          for (int c = 0; c < d; ++c) {
            const float x = Xm.at(row, c, d);
            x2 = fmaf(x, x, x2);
            xy = fmaf(dot_operand<Op::kBf16Dot>(x),
                      dot_operand<Op::kBf16Dot>(e[c]), xy);
          }
          v = fminf(v, fmaxf(x2 + e2 - 2.f * xy, 0.f));
        }
        s_cm[j] = v;
      }
    }
    __syncthreads();
    if constexpr (!kTail) {
      empties = na > 0 ? 0 : empties + 1;
      if (empties >= kHeadEmpties && b + 1 < nblk && !s_stop &&
          s_count < k) {  // leave the rest to the pre-pass and the tail
        if (gid != nullptr)
          for (int g = tid; g < G; g += THREADS)
            rs.counts[mach * G + g] = s_counts[g];
        if (tid == 0) {
          rs.pending[mach] = 1;
          rs.next[mach] = (int)(b + 1);
          rs.count[mach] = s_count;
          rs.used[mach] = s_used;
        }
        break;
      }
    }
  }
  if (moved)
    for (int j = tid; j < mp; j += THREADS) cmm[j] = s_cm[j];
}

// Dynamic shared memory of the walk: the tile's layout, then the group
// counts (G,).
static size_t walk_smem(int d, int mp, bool weighted, int G) {
  return Layout(d, mp, weighted).end + (size_t)G * sizeof(int);
}

// X (M, n, d) contiguous, fp32, bf16 or int8 (xtype 0, 1, 2) with
// x_scale, x_zp (M, n) fp32 for int8 (null otherwise); bf16dot the bf16 x.e
// contraction; E (mp, d) fp32 contiguous; cm (M, mp) fp32, updated in
// place; avail (M, n) uint8; tau, used (M,) fp32; count (M,) int32;
// counts (M, G) int32; active (M,) uint8; w (M, n) fp32 or null; gid
// (M, n) int32 or null with caps (G,) int32; limit (1,) fp32 (read where w
// is given); accept (M, n) uint8, zero on entry; gains (M, n) fp32
// scratch; flags (M, ceil(n / bn)) uint8, zero on entry; rs the head's
// scratch (pending zero on entry; counts (M, G)); ew (mp,) fp32 eval
// weights, zero-padded, or null (unweighted).  Three
// launches on `stream`: the head and the tail on M blocks, the pre-pass
// between them on a persistent grid; G must not exceed
// threshold_select_max_groups() for the same weighting, d and mp.
template <class Op, bool kWeighted>
static int launch(const Rows<typename Op::T>& X, const void* E, void* cm,
                  const void* avail, const void* tau, const void* used,
                  const void* count, const void* counts, const void* active,
                  const void* w, const void* gid, const void* caps,
                  void* accept, void* gains, void* flags, const Resume& rs,
                  long long M, long long n, int d, int mp, int m_true, int k,
                  int bn, int G, const void* limit, const void* ew,
                  void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long long ntiles = (n + BN - 1) / BN, nblk = (n + bn - 1) / bn;
  const size_t smem = walk_smem(d, mp, kWeighted, gid != nullptr ? G : 0);
  int err = 0;
  auto walk = [&](auto kernel) {
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != 0) return;
    kernel<<<(unsigned)M, THREADS, smem, s>>>(
        X, (const float*)E, (float*)cm, (const unsigned char*)avail,
        (const float*)tau, (const float*)used, (const int*)count,
        (const int*)counts, (const unsigned char*)active, rs, (const float*)w,
        (const int*)gid, (const int*)caps, (const float*)gains,
        (const unsigned char*)flags, (unsigned char*)accept, n, d, mp, m_true,
        k, bn, G, (const float*)limit, (const float*)ew, nblk);
    err = (int)cudaGetLastError();
  };
  walk(threshold_walk_kernel<Op, kWeighted, false>);
  if (err != 0) return err;
  const size_t pre_smem = Layout(d, mp, kWeighted).end;
  const long long P = persistent_grid(threshold_prepass_kernel<Op, kWeighted>,
                                      pre_smem, M * ntiles);
  if (P <= 0) return (int)cudaErrorInvalidConfiguration;
  threshold_prepass_kernel<Op, kWeighted><<<(unsigned)P, THREADS, pre_smem,
                                            s>>>(
      X, (const float*)E, (const float*)cm, (const unsigned char*)avail,
      (const float*)tau, rs, (const float*)w, (const int*)gid,
      (const int*)caps, (float*)gains, (unsigned char*)flags, M, n, d, mp,
      m_true, bn, G, (const float*)limit, (const float*)ew, ntiles, nblk);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  walk(threshold_walk_kernel<Op, kWeighted, true>);
  return err;
}

extern "C" int threshold_select_launch(
    const void* X, int xtype, const void* x_scale, const void* x_zp,
    int bf16dot, const void* E, void* cm, const void* avail,
    const void* tau, const void* used, const void* count, const void* counts,
    const void* active, const void* w, const void* gid, const void* caps,
    void* accept, void* gains, void* flags, void* pending, void* next,
    void* count_mid, void* used_mid, void* counts_mid, long long M,
    long long n, int d, int mp, int m_true, int k, int bn, int G,
    const void* limit, const void* ew, void* stream) {
  const Resume rs{(unsigned char*)pending, (int*)next, (int*)count_mid,
                  (float*)used_mid, (int*)counts_mid};
  return with_operand(xtype, bf16dot, (int)cudaErrorInvalidValue,
                      [&](auto op) {
    using Op = decltype(op);
    const Rows<typename Op::T> R{(const typename Op::T*)X,
                                 (const float*)x_scale, (const float*)x_zp};
    return ew == nullptr
               ? launch<Op, false>(R, E, cm, avail, tau, used, count, counts,
                                   active, w, gid, caps, accept, gains, flags,
                                   rs, M, n, d, mp, m_true, k, bn, G, limit,
                                   ew, stream)
               : launch<Op, true>(R, E, cm, avail, tau, used, count, counts,
                                  active, w, gid, caps, accept, gains, flags,
                                  rs, M, n, d, mp, m_true, k, bn, G, limit,
                                  ew, stream);
  });
}

// The most partition groups one launch takes on `device` at (d, mp): the
// group counts live in the walk's dynamic shared memory after the tile's,
// which with the kernel's static shared memory must fit the opt-in maximum
// per block (the weighted instantiation stages its eval weights there too;
// the operand instantiations have the same static shared memory).
extern "C" int threshold_select_max_groups(int device, int weighted, int d,
                                           int mp) {
  cudaFuncAttributes attr;
  int optin = 0;
  const cudaError_t got =
      weighted
          ? cudaFuncGetAttributes(
                &attr, threshold_walk_kernel<Operand<float, false>, true, false>)
          : cudaFuncGetAttributes(
                &attr,
                threshold_walk_kernel<Operand<float, false>, false, false>);
  if (got != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -(int)cudaGetLastError();
  const long long room = (long long)optin - (long long)attr.sharedSizeBytes -
                         (long long)walk_smem(d, mp, weighted != 0, 0);
  return room > 0 ? (int)(room / (long long)sizeof(int)) : 0;
}
