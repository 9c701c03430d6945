// Shared gain tile of the exemplar-clustering kernels (exemplar_gains.cu,
// greedy_select.cu, threshold_select.cu), on the tensor cores.
//
// For the BN candidate rows [row0, row0 + BN) of one machine block it
// computes, against the whole (zero-padded) eval set,
//
//     sum_j max(0, cm[j] - max(x2_i + e2_j - 2 x_i.e_j, 0))
//
// — the contraction form of repro's exemplar_gains — or, with eval weights,
// sum_j w_j max(0, ...).  Every selection kernel calls this one function, so
// the step-wise scan (exemplar_gains), the fused greedy (greedy_select) and
// the threshold walk see the same bits for the same row and the same cm:
// the fused path reproduces the scan's selections, and the row that sets
// the ladder's d_max qualifies at level 0.
//
// The squared norms fold into one product of depth K = round_up(d + 2, 8):
//
//     x~ = (x_1 .. x_d, |x|^2, 1, 0 ..)      e~ = (-2 e_1 .. -2 e_d, 1, |e|^2, 0 ..)
//
// so t = x~.e~ = |x|^2 + |e|^2 - 2 x.e (|x|^2 and |e|^2 by fp32 FMAs in
// feature order; -2e is exact).  Each operand value v is split into
// hi = tf32(v) and lo = tf32(v - hi) (cvt.rna), and each 8-deep k-step
// issues three mma.sync.m16n8k8 TF32 products, lo.hi, hi.lo, hi.hi, into
// one fp32 accumulator (lo.lo, ~2^-22 of a term, is dropped).  One
// unsplit TF32 product keeps ~2^-11 of each term and fails the port's
// RTOL/ATOL against the fp32 plain version; the split meets it
// (tests/test_torch_exemplar_tile.py models both on the CPU).
//
// What bounds it on the H100: at d = 6 a pair costs three HMMA per 128
// pairs and four fp32 issue slots on the CUDA cores (max(t, 0), cm - d2,
// max(., 0), the add: fmaf(contrib, w, sum) with eval weights, so w == 1
// gives the unweighted bits).  The CUDA-core epilogue is the tighter bound.
//
// Layout: 128 threads as 4 warps of 32 rows (two m16 tiles each, so every
// e~ fragment read from shared memory feeds two products).  The eval axis
// is walked BMT = 64 columns (eight n8 chunks) at a time; e~'s hi and lo
// parts sit in shared memory in fragment order, one float4 per lane
// (hi b0, hi b1, lo b0, lo b1), so a fragment is one conflict-free LDS.128.
//
// Two ways to stage the operands, the same arithmetic (the same products
// in the same order for every pair, so the same bits):
//   resident (K == 8, i.e. d <= 6, and mp <= RESIDENT_MP): e~ for every
//     column is staged once per CTA (stage_eval), the X tile by the caller
//     (load_rows, cp.async), and the row fragments are built once per tile;
//   chunked (any other d or mp): the tile stages one 8-deep k-step of X
//     and of e~ for one column tile at a time, between barriers.
// Each thread keeps 4 rows' sums over its 8 columns of every column tile in
// column order; the 4 threads of a quad fold with a fixed butterfly.  No
// atomics: a row's gain is the same bits from run to run.
#pragma once

#include <cuda_runtime.h>

namespace exemplar {

constexpr int BN = 128;       // candidate rows per tile
constexpr int BM = 64;        // the wrapper pads the eval axis to this
constexpr int BMT = 64;       // eval columns per column tile
constexpr int NCH = BMT / 8;  // n8 chunks per column tile
constexpr int THREADS = 128;  // 4 warps x 32 rows
constexpr int RESIDENT_MP = 1024;  // e~ resident up to 64 KB
constexpr float NEG_INF = -1e30f;

static_assert(THREADS / 32 * 32 == BN, "a warp owns 32 rows");
static_assert(BM % BMT == 0, "column tiles divide the padding");

// Byte offsets of the tile's dynamic shared memory (host and device agree):
// e~ fragments, two X stages, the machine's cur_min and the eval weights.
struct Layout {
  int nks;        // k-steps of 8 in K = round_up(d + 2, 8)
  bool resident;  // every column's e~ staged once
  size_t ef, xs, cm, ew, end;
  __host__ __device__ Layout(int d, int mp, bool weighted) {
    nks = (d + 2 + 7) / 8;
    resident = nks == 1 && mp <= RESIDENT_MP;
    ef = 0;
    xs = ef + (size_t)(resident ? mp / 8 : NCH) * 32 * 16;
    cm = xs + 2 * BN * 8 * sizeof(float);
    ew = cm + (size_t)mp * sizeof(float);
    end = ew + (weighted ? (size_t)mp * sizeof(float) : 0);
  }
};

__device__ __forceinline__ unsigned tf32_rna(float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo to ~2^-22 of v, both TF32
__device__ __forceinline__ void split(float v, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// |v|^2 of a d-vector by fp32 FMAs in feature order (X rows and E rows alike)
__device__ __forceinline__ float sq_norm(const float* v, int d) {
  float s = 0.f;
  for (int c = 0; c < d; ++c) s = fmaf(v[c], v[c], s);
  return s;
}

// e~[j][k] of eval row j (E zero-padded to mp rows)
__device__ __forceinline__ float eval_aug(const float* __restrict__ E, int d,
                                          int j, int k) {
  const float* e = E + (long long)j * d;
  if (k < d) return -2.f * e[k];
  if (k == d) return 1.f;
  if (k == d + 1) return sq_norm(e, d);
  return 0.f;
}

// The fragment float4 of lane `lane` for k-step ks and n8 chunk `ch` (global
// column chunk): b0 = e~[8 ch + lane / 4][8 ks + lane % 4], b1 four deeper.
__device__ __forceinline__ float4 eval_frag(const float* __restrict__ E,
                                            int d, int ks, int ch, int lane) {
  const int j = ch * 8 + (lane >> 2), k = ks * 8 + (lane & 3);
  unsigned h0, l0, h1, l1;
  split(eval_aug(E, d, j, k), h0, l0);
  split(eval_aug(E, d, j, k + 4), h1, l1);
  return make_float4(__uint_as_float(h0), __uint_as_float(h1),
                     __uint_as_float(l0), __uint_as_float(l1));
}

// Once per CTA: every column's e~ fragments where resident, and the eval
// weights (kWeighted).  Ends with a barrier.
template <bool kWeighted>
__device__ void stage_eval(const Layout& L, unsigned char* smem,
                           const float* __restrict__ E, int d, int mp,
                           const float* __restrict__ ew) {
  if (L.resident) {
    float4* ef = reinterpret_cast<float4*>(smem + L.ef);
    for (int q = threadIdx.x; q < mp / 8 * 32; q += THREADS)
      ef[q] = eval_frag(E, d, 0, q >> 5, q & 31);
  }
  if constexpr (kWeighted) {
    float* s_ew = reinterpret_cast<float*>(smem + L.ew);
    for (int j = threadIdx.x; j < mp; j += THREADS) s_ew[j] = ew[j];
  }
  __syncthreads();
}

// The caller's half of the resident path: cp.async the tile's rows
// [row0, row0 + BN) of this machine's (n, d) block into xs (row-major,
// rows at or past n zero-filled) and commit the group.  Rows are
// contiguous, so the tile is one run of BN * d floats.
__device__ __forceinline__ void load_rows(float* xs,
                                          const float* __restrict__ X,
                                          long long n, int d,
                                          long long row0) {
  const long long avail = (n - row0) * d;
  const float* src = X + row0 * d;
  for (int q = threadIdx.x; q < BN * d; q += THREADS) {
    if (q < avail)
      cp_async4(xs + q, src + q);
    else
      xs[q] = 0.f;
  }
  cp_async_commit();
}

// Raw gain sums of this thread's 4 rows: sums[2 mt + h] is row
// warp * 32 + mt * 16 + h * 8 + lane / 4 of the tile.  The 4 threads of a
// quad hold the same sums on return.  cm and s_ew are the machine's
// cur_min and the eval weights in shared memory (mp each, zero-padded).
// xs holds the staged rows (load_rows) on the resident path and is not
// read otherwise.  Every thread of the CTA calls it.
template <bool kWeighted>
__device__ void row_gain_sums(const Layout& L, unsigned char* smem,
                              const float* __restrict__ X,
                              const float* __restrict__ E, long long n,
                              int d, int mp, long long row0,
                              const float* cm, const float* s_ew,
                              const float* xs, float sums[4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  float4* ef = reinterpret_cast<float4*>(smem + L.ef);
  float* xc = reinterpret_cast<float*>(smem + L.xs);  // chunked X stage
#pragma unroll
  for (int r = 0; r < 4; ++r) sums[r] = 0.f;

  // |x|^2 of this thread's 4 rows, by FMAs in feature order
  float x2[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int rl = warp * 32 + (r >> 1) * 16 + (r & 1) * 8 + g;
    if (L.resident)
      x2[r] = sq_norm(xs + rl * d, d);
    else
      x2[r] = row0 + rl < n ? sq_norm(X + (row0 + rl) * d, d) : 0.f;
  }

  // the row fragments of k-step ks: a[mt][0..3] hi, a[mt][4..7] lo; on the
  // resident path src is the staged row-major tile, else the chunk stage
  unsigned a[2][8];
  auto build_a = [&](int ks, const float* src, int pitch, int kbase) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int h = q & 1, kk = tig + (q >> 1) * 4;  // a0..a3 of m16n8k8
        const int rl = warp * 32 + mt * 16 + h * 8 + g;
        const int k = ks * 8 + kk;
        const float v = k < d        ? src[rl * pitch + k - kbase]
                        : k == d     ? x2[mt * 2 + h]
                        : k == d + 1 ? 1.f
                                     : 0.f;  // x~ = (x, |x|^2, 1, 0 ..)
        split(v, a[mt][q], a[mt][q + 4]);
      }
  };
  if (L.resident) build_a(0, xs, d, 0);

  for (int j0 = 0; j0 < mp; j0 += BMT) {
    float acc[2][NCH][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][c][i] = 0.f;

    for (int ks = 0; ks < L.nks; ++ks) {
      const float4* eb;
      if (L.resident) {
        eb = ef + (j0 / 8) * 32;
      } else {
        __syncthreads();  // the previous chunk is consumed
        for (int q = threadIdx.x; q < BN * 8; q += THREADS) {
          const int rl = q >> 3, k = ks * 8 + (q & 7);
          const long long row = row0 + rl;
          xc[q] = row < n && k < d ? X[row * d + k] : 0.f;
        }
        for (int q = threadIdx.x; q < NCH * 32; q += THREADS)
          ef[q] = eval_frag(E, d, ks, j0 / 8 + (q >> 5), q & 31);
        __syncthreads();
        build_a(ks, xc, 8, ks * 8);
        eb = ef;
      }
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const float4 f = eb[c * 32 + lane];
        const unsigned bh0 = __float_as_uint(f.x), bh1 = __float_as_uint(f.y);
        const unsigned bl0 = __float_as_uint(f.z), bl1 = __float_as_uint(f.w);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const unsigned* ah = a[mt];
          const unsigned* al = a[mt] + 4;
          mma_tf32(acc[mt][c], al, bh0, bh1);
          mma_tf32(acc[mt][c], ah, bl0, bl1);
          mma_tf32(acc[mt][c], ah, bh0, bh1);
        }
      }
    }
    // epilogue: columns j0 + 8c + 2 tig + e of rows (mt, h)
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int j = j0 + c * 8 + 2 * tig;
      const float2 cm2 = *reinterpret_cast<const float2*>(cm + j);
      float2 w2 = make_float2(1.f, 1.f);
      if constexpr (kWeighted) w2 = *reinterpret_cast<const float2*>(s_ew + j);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float d2 = fmaxf(acc[mt][c][2 * h + e], 0.f);
            const float contrib = fmaxf((e ? cm2.y : cm2.x) - d2, 0.f);
            float& s = sums[mt * 2 + h];
            if constexpr (kWeighted)
              s = fmaf(contrib, e ? w2.y : w2.x, s);
            else
              s += contrib;
          }
    }
  }
  // fold the quad's 4 column groups of each row (fixed butterfly)
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    sums[r] += __shfl_xor_sync(0xffffffffu, sums[r], 1);
    sums[r] += __shfl_xor_sync(0xffffffffu, sums[r], 2);
  }
}

// The tile-local index of sums[r] for the calling thread
__device__ __forceinline__ int sum_row(int r) {
  return (threadIdx.x >> 5) * 32 + (r >> 1) * 16 + (r & 1) * 8 +
         ((threadIdx.x & 31) >> 2);
}

// (value, index) order of every argmax here: larger value first, and the
// lower index among equal values — the lowest-index tie rule of argmax.
__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// Persistent pass over the flattened (machine, BN-row tile) space: CTA c of
// the grid walks tiles [c T / P, (c + 1) T / P) in order (T = M * ntiles,
// P = gridDim.x <= T, so no range is empty).  e~ is staged once; a
// machine's cur_min when the CTA enters it; the X tiles by cp.async two
// stages deep, the next in flight while this one is scored (resident path).
// first_row(mach) is the first row of the machine to score, or negative to
// skip the machine; tiles wholly before it are skipped.  on_rows(mach, row0,
// sums) sees every scored tile; on_leave(mach) runs when the CTA leaves a
// machine's segment (all threads, barriers allowed).
template <bool kWeighted, class FirstRow, class OnRows, class OnLeave>
__device__ void persistent_tiles(const Layout& L, unsigned char* smem,
                                 const float* __restrict__ X,
                                 const float* __restrict__ E, const float* cm,
                                 const float* __restrict__ ew, long long M,
                                 long long n, int d, int mp, long long ntiles,
                                 FirstRow first_row, OnRows on_rows,
                                 OnLeave on_leave) {
  float* s_cm = reinterpret_cast<float*>(smem + L.cm);
  const float* s_ew = reinterpret_cast<const float*>(smem + L.ew);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  stage_eval<kWeighted>(L, smem, E, d, mp, ew);
  const long long T = M * ntiles, P = gridDim.x, c = blockIdx.x;
  const long long t0 = c * T / P, t1 = (c + 1) * T / P;
  auto scored = [&](long long t) {
    const long long f = first_row(t / ntiles);
    return f >= 0 && (t % ntiles) * BN + BN > f;
  };
  auto prefetch = [&](long long t) {
    if (L.resident && t < t1 && scored(t))
      load_rows(xs + (t & 1) * BN * 8, X + (t / ntiles) * n * d, n, d,
                (t % ntiles) * BN);
  };
  prefetch(t0);
  long long cur = -1;
  for (long long t = t0; t < t1; ++t) {
    const long long mach = t / ntiles;
    if (mach != cur) {
      if (cur >= 0) on_leave(cur);
      cur = mach;
      __syncthreads();  // s_cm of the previous machine is consumed
      if (first_row(mach) >= 0)
        for (int j = threadIdx.x; j < mp; j += THREADS)
          s_cm[j] = cm[mach * mp + j];
    }
    const bool now = scored(t);
    if (!now && !(t + 1 < t1 && scored(t + 1))) continue;  // no barrier
    cp_async_wait_all();
    __syncthreads();  // tile t staged, tile t - 1 consumed
    prefetch(t + 1);
    if (!now) continue;
    const long long row0 = (t % ntiles) * BN;
    float sums[4];
    row_gain_sums<kWeighted>(L, smem, X + mach * n * d, E, n, d, mp, row0,
                             s_cm, s_ew, xs + (t & 1) * BN * 8, sums);
    on_rows(mach, row0, sums);
  }
  if (cur >= 0) on_leave(cur);
}

// The CTA of the persistent grid whose range holds flattened tile t
__host__ __device__ __forceinline__ long long cta_of(long long t, long long P,
                                                     long long T) {
  return ((t + 1) * P - 1) / T;
}

// Persistent grid size: resident CTAs per SM of `kernel` at `smem` bytes
// of dynamic shared memory, times the SMs, at most T.  Opts the kernel in
// to past 48 KB.  Returns 0 on error.
template <class K>
inline long long persistent_grid(K kernel, size_t smem, long long T) {
  int dev = 0, sms = 0, per = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, THREADS,
                                                    smem) != cudaSuccess ||
      per < 1)
    return 0;
  const long long P = (long long)per * sms;
  return P < T ? P : T;
}

}  // namespace exemplar
