// RWKV-6 WKV recurrence, backward, in chunks: time runs in parallel over
// chunks and the chunk products run on the tensor cores.
//
// Replaces no TPU kernel: the JAX package differentiates its recurrence with
// jax.value_and_grad (repro/train/train_step.py:67 through
// repro/models/layers.py::gla_chunked).  It computes the function of
// csrc/wkv6_bwd.cu (the recurrent backward, which keeps the shapes this file
// has no instantiation of): for the forward
//
//     y_t = r_t (S_{t-1} + diag(u) k_t^T v_t),   S_t = diag(w_t) S_{t-1} + k_t^T v_t
//
// from S_0 and the gradients dy and dS_T, the gradients (dr, dk, dv, dw, du,
// dS_0); dr, dk, dv in r's type, dw and dS_0 fp32, du in u's type.  Its
// formulas are written out in PyTorch in repro_torch/kernels/ref.py::
// wkv6_backward_chunked, which the CPU tests hold against autograd; this
// kernel sums in other orders than the recurrence, and is held against it
// within repro_torch/testing.py::WKV_GRAD_TOL.
//
// Chunks of C = 64 steps, each cut in four sub-chunks of 16.  In a
// sub-chunk, A_s = prod_{p<s} w_p (from its start), B_s = prod_{s<p} w_p (to
// its end), g the whole product, per channel.  Every decay factor is a
// product of w's taken outward from one step, so it is <= 1: a strong decay
// underflows to the negligible term it stands for, with no division by a
// cumulative decay and no clip.  Four launches:
//   1. wkv6_bwd_chunk_kernel, per (b, h, chunk): the chunk's own state U
//      (sub-chunks in order, U <- diag(g) U + (k B)^T V), its own
//      gradient-state Y = (r P)^T dY (P the prefix product over the chunk)
//      and its decay;
//   2. wkv6_bwd_scan_kernel, per (b, h, i, j): each chunk's entry state from
//      S_0 (E <- diag(g) E + U) in place of U, each chunk's exit
//      gradient-state from dS_T in reverse (X <- diag(g) X + Y) in place of
//      Y, and dS_0, the last;
//   3. wkv6_bwd_grad_kernel, per (b, h, chunk): the sub-chunks' entry states
//      forward from the chunk's (kept in shared memory, each thread its own
//      elements), then the sub-chunks in reverse with the exit
//      gradient-state X in the accumulators.  In a sub-chunk with entry
//      state E, per channel i, F_m = (S_{s-1} dy_m)_i walked from (E dY^T)
//      by F <- w_s F + k_s (v_s . dy_m), F_X = (S_{s-1} . X)_i from the
//      column sums of E o X, and rd_m = r_m prod_{s<p<m} w_p:
//         dr_s = F_s + c_s u k_s
//         dk_s = B_s (X v_s) + sum_{m>s} (v_s . dy_m) rd_m + c_s u r_s
//         dw_s = B_s F_X + sum_{m>s} rd_m F_m   (= sum_j G_s[i,j] S_{s-1}[i,j])
//         dv   = (k B) X + P^T dY,  P_ms = sum_i k_s rd_m (m > s), P_ss = a_s
//      (c_s = v_s . dy_s, a_s = r_s . (u k_s)), then X <- diag(g) X +
//      (r A)^T dY; du's partial sum over the chunk's steps;
//   4. wkv6_bwd_chunked_du_kernel: du summed over the chunks, then over b,
//      in order.
// dw thus comes from G o S, never from the log-decay identity (a reverse
// sum of r dr - k dk divided by w, which at w = 1e-6 cancels O(1) sums down
// to O(1e-6)).  No float atomic: every output element is written once by
// one thread, and a second call gives the same bits.
//
// Tensor cores: mma.sync m16n8k16 bf16 with fp32 accumulators (the chunk
// products are 64 x 64 x 16 or smaller, which mma.sync serves as well as
// wgmma, and its fragments map onto the per-channel work without the
// warpgroup's 64-row tiles).  Every fp32 operand x is split in three bf16
// pieces, h = bf16(x), m = bf16(x - h), l = bf16(x - h - m); the products of
// piece pairs whose orders sum to at most 2 are run, smallest first (three
// where the other operand is bf16, as r, k, v, dy are in the model: they
// enter a product exactly).  No TF32.  The products: U, Y, E and X updates
// (state += (16 steps)^T x (16 steps)), E dY^T and X V^T (contracting the
// state's columns; the accumulators are their A fragments), Q = dY V^T,
// (k B) X and P^T dY.  The per-channel walk above, the pairwise scores P
// (as csrc/wkv6_chunked.cu forms them: a half warp a column) and the decay
// products run on the CUDA cores.
//
// Layout: 128 threads, 4 warps.  The state (DK x DV) as m16n8 accumulator
// tiles, rows i: at 64 x 64 warp w holds rows [16 w, 16 w + 16), all
// columns; at 16 x DV the warps split the columns (16 x 16: warp 0 alone).
// Channel i's walk runs on thread i; its prefix products (r A) on thread
// i and its suffix products (k B) on a thread of the next warps, side by
// side.  A sub-chunk's r, k, v, w, dy come
// into shared memory by cp.async, two stages, the next in flight while
// this one is used (steps past T zero, w = 1).  A CTA's phases run one
// after another between barriers, so CTAs overlap one another instead:
// launch 3 keeps two sub-chunk entry states in shared memory (the last
// one stays in the accumulators), 110 KB at 64 x 64 in bf16, so two CTAs
// share an SM, and three at 16 x DV (registers capped for it).
//
// Bound on the H100: bytes (r, k, v, dy read and dr, dk, dv written in r's
// type, w read and dw written in fp32): 0.110 ms at rwkv6-1.6b's training
// microbatch (B = 4, H = 32, T = 2,048, Dk = Dv = 64, bf16).  The scratch
// (two fp32 states a chunk, written by launch 1, read and rewritten by the
// scan, read by launch 3: 2 x 67 MB there) adds about as many bytes again.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int C = 64;        // steps per chunk
constexpr int SUB = 16;      // steps per sub-chunk
constexpr int THREADS = 128;
constexpr int LDT = SUB + 8; // row stride (bf16) of [channel][step] pieces
constexpr int LDS = SUB + 1; // row stride (fp32) of [channel][step] sums
constexpr int NPAIR = SUB * (SUB + 1) / 2;
constexpr int SCAN_THREADS = 256;

// operands with (b, head, position) strides, in this order
enum { R_, K_, V_, W_, DY_, DR_, DK_, DV_, DW_, NOPS };

struct Args {
  const void *r, *k, *v;
  const float* w;
  const void* u;
  const float* s0;   // (B, H, DK, DV) or null for zeros
  const void* dy;
  const float* dsT;  // (B, H, DK, DV) or null for zeros
  void *dr, *dk, *dv;
  float* dw;
  void* du;
  float* ds0;  // (B, H, DK, DV)
  float* se;   // (B, H, nc, DK, DV): own states, then entry states
  float* sx;   // (B, H, nc, DK, DV): own gradient-states, then exit ones
  float* dc;   // (B, H, nc, DK): chunk decays
  float* dup;  // (B, H, nc, DK): du summed over a chunk
  long long st[3 * NOPS];
  int B, H, T, nc, u_bf16;
};

// x as three bf16 pieces: h = bf16(x), m = bf16(x - h), l = bf16(x - h - m)
__device__ __forceinline__ void pieces3(float x, __nv_bfloat16 p[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[i] = __float2bfloat16_rn(x);
    x = __fsub_rn(x, __bfloat162float(p[i]));  // exact
  }
}

// Two fp32 values (the lower column first) as three packed bf16 piece pairs.
__device__ __forceinline__ void split2(float x0, float x1, unsigned p[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 hb = __floats2bfloat162_rn(x0, x1);
    p[i] = *reinterpret_cast<const unsigned*>(&hb);
    if (i < 2) {
      const float2 f = __bfloat1622float2(hb);
      x0 = __fsub_rn(x0, f.x);  // exact
      x1 = __fsub_rn(x1, f.y);
    }
  }
}

__device__ __forceinline__ unsigned ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The pair (p0 low, p1 high) of a stage operand as its bf16 pieces: one
// for bf16 (exact), three for fp32.
template <typename T>
struct Op;
template <>
struct Op<float> {
  static constexpr int NP = 3;
  static __device__ __forceinline__ void pair(const float* p0,
                                              const float* p1,
                                              unsigned out[3]) {
    split2(*p0, *p1, out);
  }
  // p[0], p[1] (8-byte aligned)
  static __device__ __forceinline__ void adj(const float* p,
                                             unsigned out[3]) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    split2(f.x, f.y, out);
  }
};
template <>
struct Op<__nv_bfloat16> {
  static constexpr int NP = 1;
  static __device__ __forceinline__ void pair(const __nv_bfloat16* p0,
                                              const __nv_bfloat16* p1,
                                              unsigned out[1]) {
    out[0] = (unsigned)*reinterpret_cast<const unsigned short*>(p0) |
             ((unsigned)*reinterpret_cast<const unsigned short*>(p1) << 16);
  }
  static __device__ __forceinline__ void adj(const __nv_bfloat16* p,
                                             unsigned out[1]) {
    out[0] = ld32(p);
  }
};

__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += A B over the piece pairs (i, j) with i + j <= 2, smallest first.
template <int NA, int NB>
__device__ __forceinline__ void mma_split(float c[4], const unsigned a[][4],
                                          const unsigned b0[NB],
                                          const unsigned b1[NB]) {
#pragma unroll
  for (int s = 2; s >= 0; --s)
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int j = s - i;
      if (j >= 0 && j < NB) mma_bf16(c, a[i], b0[j], b1[j]);
    }
}

// 16 bytes global -> shared; zero-filled where !valid (src then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 4 consecutive values from p (8 or 16 bytes, aligned) as fp32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void put2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void put2(__nv_bfloat16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

// The geometry of an instantiation: a (DK x DV) state, operands Tin.
template <typename Tin, int DK, int DV>
struct Geo {
  static constexpr int RB = DK / 16;  // 16-row blocks of the state
  static constexpr int NB = DV / 8;   // 8-column tiles of the state
  // tiles a warp holds (pairs: a 16-column block is an A fragment), warps
  // that share a row block, warps that hold tiles
  static constexpr int NTW = RB * NB / 4 > 2 ? RB * NB / 4 : 2;
  static constexpr int WPR = NB / NTW;
  static constexpr int NWA = RB * WPR;
  static constexpr int NE = NTW * 4;  // state elements a thread
  // dv's 8-column tiles a warp, and the warps that hold them
  static constexpr int NVW = NB / 4 > 1 ? NB / 4 : 1;
  static constexpr int NWV = NB / NVW;
  static constexpr int KQ = DK / 4;  // lanes sharing a pairwise score
  static constexpr int NP = Op<Tin>::NP;
  static constexpr int SZ = sizeof(Tin);
  static constexpr int LDX = DV + 4;   // row stride (fp32) of the X copy
  static constexpr int LDKB = DK + 8;  // row stride (bf16) of (k B) pieces
  // a stage: a sub-chunk's raw operands, [step][channel]
  static constexpr int SK = 0, SV = SK + SUB * DK * SZ,
                       SW = SV + SUB * DV * SZ, SR = SW + SUB * DK * 4,
                       SDY = SR + SUB * DK * SZ, STAGE = SDY + SUB * DV * SZ;
  // launch 3's shared memory, bytes
  // the entry states of sub-chunks 1 and 2, each thread its elements (the
  // last sub-chunk's is still in the accumulators when the reverse pass
  // starts, the first's in global memory)
  static constexpr int EST = 2 * STAGE;  // fp32 [2][NE][THREADS]
  static constexpr int XS = EST + 2 * NE * THREADS * 4;  // fp32 [DK][LDX]
  static constexpr int EDS = XS + DK * LDX * 4;  // fp32 [WPR][DK][LDS]
  static constexpr int XVS = EDS + WPR * DK * LDS * 4;
  static constexpr int EXS = XVS + WPR * DK * LDS * 4;  // fp32 [WPR][DK]
  static constexpr int QS = EXS + WPR * DK * 4;         // fp32 [SUB][LDS]
  static constexpr int GS = QS + SUB * LDS * 4;         // fp32 [DK]
  static constexpr int US = GS + DK * 4;                // fp32 [DK]
  static constexpr int PS = (US + DK * 4 + 15) / 16 * 16;  // [NPAIR][KQ]
  static constexpr int PPT = PS + NPAIR * KQ * 4;  // bf16 [3][SUB][LDT]
  static constexpr int KB = PPT + 3 * SUB * LDT * 2;  // bf16 [3][SUB][LDKB]
  static constexpr int RAT = KB + 3 * SUB * LDKB * 2;  // bf16 [3][DK][LDT]
  static constexpr int BYTES = RAT + 3 * DK * LDT * 2;
  // launch 1's shared memory, bytes
  static constexpr int P1_KBT = 2 * STAGE;  // bf16 [3][DK][LDT]
  static constexpr int P1_RAT = P1_KBT + 3 * DK * LDT * 2;
  static constexpr int P1_GS = P1_RAT + 3 * DK * LDT * 2;
  static constexpr int P1_BYTES = P1_GS + DK * 4;
  static_assert(DK % 16 == 0 && DV % 16 == 0 && NWA <= 4 && NWV <= 4 &&
                    NTW % 2 == 0 && 8 * KQ <= THREADS,
                "geometry");
  static_assert(STAGE % 16 == 0 && XS % 16 == 0 && EDS % 16 == 0 &&
                    PS % 16 == 0 && PPT % 16 == 0 && KB % 16 == 0 &&
                    RAT % 16 == 0,
                "alignment");
};

// The first thread of the suffix products (k B), which run beside the
// prefix products (r A) of threads [0, DK): the next warp boundary.
template <int DK>
constexpr int SUFFIX0 = DK < 32 ? 32 : DK;

// cp.async a sub-chunk's rows [ts, ts + SUB) of one operand (D wide) into
// [step][channel]; steps past T zero-filled
template <typename El, int D>
__device__ __forceinline__ void copy_rows(char* dst, const void* src,
                                          long long base, long long ts_,
                                          long long stride, int T) {
  constexpr int PER = 16 / sizeof(El);
  constexpr int CR = D / PER;
  for (int x = threadIdx.x; x < SUB * CR; x += THREADS) {
    const int tt = x / CR, c0 = (x % CR) * PER;
    const long long t = ts_ + tt;
    const bool ok = t < T;
    const El* p = static_cast<const El*>(src) + base + (ok ? t : 0) * stride +
                 c0;
    cp_async16(reinterpret_cast<El*>(dst) + tt * D + c0, p, ok);
  }
}

template <typename Tin, int DK, int DV>
__device__ __forceinline__ void load_stage(char* st, const Args& a,
                                           const long long* base,
                                           long long ts_) {
  using G = Geo<Tin, DK, DV>;
  copy_rows<Tin, DK>(st + G::SK, a.k, base[K_], ts_, a.st[3 * K_ + 2], a.T);
  copy_rows<Tin, DV>(st + G::SV, a.v, base[V_], ts_, a.st[3 * V_ + 2], a.T);
  copy_rows<float, DK>(st + G::SW, a.w, base[W_], ts_, a.st[3 * W_ + 2],
                       a.T);
  copy_rows<Tin, DK>(st + G::SR, a.r, base[R_], ts_, a.st[3 * R_ + 2], a.T);
  copy_rows<Tin, DV>(st + G::SDY, a.dy, base[DY_], ts_, a.st[3 * DY_ + 2],
                     a.T);
  cp_async_commit();
}

// w = 1 on the steps past T of a landed stage, in the pieces this thread
// copied (a masked step decays nothing)
template <typename Tin, int DK, int DV>
__device__ __forceinline__ void fix_stage(char* st, int T, long long ts_) {
  using G = Geo<Tin, DK, DV>;
  if (ts_ + SUB <= T) return;
  float* ws = reinterpret_cast<float*>(st + G::SW);
  for (int x = threadIdx.x; x < SUB * DK / 4; x += THREADS) {
    const int tt = x / (DK / 4), c0 = (x % (DK / 4)) * 4;
    if (ts_ + tt >= T)
      *reinterpret_cast<float4*>(ws + tt * DK + c0) =
          make_float4(1.f, 1.f, 1.f, 1.f);
  }
}

// acc (this warp's state tiles: rows 16 rb + g (+8), columns 8 (n0 + n) +
// 2 cq (+1)) += A M, A (DK x 16 steps) as pieces [3][DK][LDT], M (16 steps
// x DV) a stage operand [step][column]
template <typename Tin, int DK, int DV>
__device__ __forceinline__ void state_mma(float acc[][4],
                                          const __nv_bfloat16* ap,
                                          const Tin* m, int rb, int n0,
                                          int g, int cq) {
  using G = Geo<Tin, DK, DV>;
  unsigned af[3][4];
#pragma unroll
  for (int z = 0; z < 3; ++z) {
    const __nv_bfloat16* p = ap + (z * DK + 16 * rb + g) * LDT + 2 * cq;
    af[z][0] = ld32(p);
    af[z][1] = ld32(p + 8 * LDT);
    af[z][2] = ld32(p + 8);
    af[z][3] = ld32(p + 8 * LDT + 8);
  }
#pragma unroll
  for (int n = 0; n < G::NTW; ++n) {
    const int col = 8 * (n0 + n) + g;
    unsigned b0[G::NP], b1[G::NP];
    Op<Tin>::pair(m + (2 * cq) * DV + col, m + (2 * cq + 1) * DV + col, b0);
    Op<Tin>::pair(m + (2 * cq + 8) * DV + col, m + (2 * cq + 9) * DV + col,
                  b1);
    mma_split<3, G::NP>(acc[n], af, b0, b1);
  }
}

// out[nn] (rows 16 rb + g (+8), steps 8 nn + 2 cq (+1)) = sum over this
// warp's state columns j of S[i][j] M[s][j], S this warp's accumulator
// tiles, M a stage operand [step][column]
template <typename Tin, int DK, int DV>
__device__ __forceinline__ void cols_mma(float out[2][4], const float S[][4],
                                         const Tin* m, int n0, int g,
                                         int cq) {
  using G = Geo<Tin, DK, DV>;
#pragma unroll
  for (int nn = 0; nn < 2; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[nn][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < G::NTW / 2; ++kk) {
    unsigned af[3][4];
    {
      unsigned p0[3], p1[3], p2[3], p3[3];
      split2(S[2 * kk][0], S[2 * kk][1], p0);
      split2(S[2 * kk][2], S[2 * kk][3], p1);
      split2(S[2 * kk + 1][0], S[2 * kk + 1][1], p2);
      split2(S[2 * kk + 1][2], S[2 * kk + 1][3], p3);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        af[i][0] = p0[i];
        af[i][1] = p1[i];
        af[i][2] = p2[i];
        af[i][3] = p3[i];
      }
    }
    const int k0 = 8 * (n0 + 2 * kk) + 2 * cq;
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
      const Tin* row = m + (8 * nn + g) * DV + k0;
      unsigned b0[G::NP], b1[G::NP];
      Op<Tin>::adj(row, b0);
      Op<Tin>::adj(row + 8, b1);
      mma_split<3, G::NP>(out[nn], af, b0, b1);
    }
  }
}

// Launch 1: per (b, h, chunk), the chunk's own state U (from zeros), own
// gradient-state Y (from zeros at its end) and decay, into se, sx, dc.
template <typename Tin, int DK, int DV>
__global__ void __launch_bounds__(THREADS) wkv6_bwd_chunk_kernel(
    const Args a) {
  using G = Geo<Tin, DK, DV>;
  extern __shared__ float4 sm4[];
  char* sm = reinterpret_cast<char*>(sm4);
  __nv_bfloat16* kbt = reinterpret_cast<__nv_bfloat16*>(sm + G::P1_KBT);
  __nv_bfloat16* rat = reinterpret_cast<__nv_bfloat16*>(sm + G::P1_RAT);
  float* gs = reinterpret_cast<float*>(sm + G::P1_GS);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, cq = lane & 3;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * C;
  const int nsub = min(C / SUB, (a.T - t0 + SUB - 1) / SUB);
  const long long bh = (long long)b * a.H + h;
  long long base[NOPS];
#pragma unroll
  for (int q = 0; q < NOPS; ++q)
    base[q] = b * a.st[3 * q] + h * a.st[3 * q + 1];
  const bool active = warp < G::NWA;
  const int rb = warp / G::WPR, n0 = (warp % G::WPR) * G::NTW;
  float U[G::NTW][4], Y[G::NTW][4];
#pragma unroll
  for (int n = 0; n < G::NTW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) U[n][e] = Y[n][e] = 0.f;
  float pc = 1.f;  // thread i < DK: the decay from the chunk's start
  load_stage<Tin, DK, DV>(sm, a, base, t0);
  for (int n = 0; n < nsub; ++n) {
    char* st = sm + (n & 1) * G::STAGE;
    if (n + 1 < nsub) {
      load_stage<Tin, DK, DV>(sm + ((n + 1) & 1) * G::STAGE, a, base,
                              t0 + (n + 1) * SUB);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fix_stage<Tin, DK, DV>(st, a.T, t0 + n * SUB);
    __syncthreads();  // the stage visible
    const Tin* rs = reinterpret_cast<const Tin*>(st + G::SR);
    const Tin* ks = reinterpret_cast<const Tin*>(st + G::SK);
    const float* ws = reinterpret_cast<const float*>(st + G::SW);
    if (tid < DK) {
      const int i = tid;
      float x = 1.f;  // prefix A_s
#pragma unroll
      for (int s = 0; s < SUB; ++s) {
        __nv_bfloat16 p[3];
        pieces3(to_f(rs[s * DK + i]) * (pc * x), p);
#pragma unroll
        for (int z = 0; z < 3; ++z) rat[(z * DK + i) * LDT + s] = p[z];
        x *= ws[s * DK + i];
      }
      gs[i] = x;
      pc *= x;
    } else if (tid >= SUFFIX0<DK> && tid < SUFFIX0<DK> + DK) {
      const int i = tid - SUFFIX0<DK>;
      float y = 1.f;  // suffix B_s
#pragma unroll
      for (int s = SUB - 1; s >= 0; --s) {
        __nv_bfloat16 p[3];
        pieces3(to_f(ks[s * DK + i]) * y, p);
#pragma unroll
        for (int z = 0; z < 3; ++z) kbt[(z * DK + i) * LDT + s] = p[z];
        y *= ws[s * DK + i];
      }
    }
    __syncthreads();  // the pieces and g visible
    if (active) {
      const float g0 = gs[16 * rb + g], g1 = gs[16 * rb + g + 8];
#pragma unroll
      for (int q = 0; q < G::NTW; ++q) {
        U[q][0] *= g0;
        U[q][1] *= g0;
        U[q][2] *= g1;
        U[q][3] *= g1;
      }
      state_mma<Tin, DK, DV>(U, kbt, reinterpret_cast<const Tin*>(st + G::SV),
                             rb, n0, g, cq);
      state_mma<Tin, DK, DV>(Y, rat,
                             reinterpret_cast<const Tin*>(st + G::SDY), rb,
                             n0, g, cq);
    }
    __syncthreads();  // the stage, pieces and g read
  }
  if (active) {
    float* se = a.se + (bh * a.nc + c) * DK * DV;
    float* sx = a.sx + (bh * a.nc + c) * DK * DV;
#pragma unroll
    for (int n = 0; n < G::NTW; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int at = (16 * rb + g + 8 * hf) * DV + 8 * (n0 + n) + 2 * cq;
        *reinterpret_cast<float2*>(se + at) =
            make_float2(U[n][2 * hf], U[n][2 * hf + 1]);
        *reinterpret_cast<float2*>(sx + at) =
            make_float2(Y[n][2 * hf], Y[n][2 * hf + 1]);
      }
  }
  if (tid < DK) a.dc[(bh * a.nc + c) * DK + tid] = pc;
}

// Launch 2: per (b, h, i, j), the entry states forward (in place of the
// own states) and the exit gradient-states in reverse (in place of the own
// gradient-states); dS_0 the last.
template <int DK, int DV>
__global__ void __launch_bounds__(SCAN_THREADS) wkv6_bwd_scan_kernel(
    const Args a) {
  const int e = blockIdx.x * SCAN_THREADS + threadIdx.x;
  if (e >= DK * DV) return;
  const int i = e / DV;
  const long long bh = (long long)blockIdx.z * a.H + blockIdx.y;
  const long long so = bh * DK * DV + e;
  const long long step = (long long)DK * DV;
  float* se = a.se + bh * a.nc * step + e;
  float* sx = a.sx + bh * a.nc * step + e;
  const float* dc = a.dc + bh * a.nc * DK + i;
  float S = a.s0 != nullptr ? a.s0[so] : 0.f;
  float own = se[0], dec = dc[0];
  for (int c = 0; c < a.nc; ++c) {
    const float own_c = own, dec_c = dec;
    if (c + 1 < a.nc) {
      own = se[(c + 1) * step];
      dec = dc[(c + 1) * DK];
    }
    se[c * step] = S;
    S = fmaf(dec_c, S, own_c);
  }
  float X = a.dsT != nullptr ? a.dsT[so] : 0.f;
  const int last = a.nc - 1;
  own = sx[last * step];
  dec = dc[last * DK];
  for (int c = last; c >= 0; --c) {
    const float own_c = own, dec_c = dec;
    if (c > 0) {
      own = sx[(c - 1) * step];
      dec = dc[(c - 1) * DK];
    }
    sx[c * step] = X;
    X = fmaf(dec_c, X, own_c);
  }
  a.ds0[so] = X;
}

// Launch 3: per (b, h, chunk), the gradients of the chunk's steps and its
// du partial, from its entry state and exit gradient-state.
template <typename Tin, int DK, int DV>
__global__ void __launch_bounds__(THREADS, DK == 16 ? 3 : 2)
    wkv6_bwd_grad_kernel(
    const Args a) {
  using G = Geo<Tin, DK, DV>;
  extern __shared__ float4 sm4[];
  char* sm = reinterpret_cast<char*>(sm4);
  float* est = reinterpret_cast<float*>(sm + G::EST);
  float* xs = reinterpret_cast<float*>(sm + G::XS);
  float* eds = reinterpret_cast<float*>(sm + G::EDS);
  float* xvs = reinterpret_cast<float*>(sm + G::XVS);
  float* exs = reinterpret_cast<float*>(sm + G::EXS);
  float* qs = reinterpret_cast<float*>(sm + G::QS);
  float* gs = reinterpret_cast<float*>(sm + G::GS);
  float* us = reinterpret_cast<float*>(sm + G::US);
  float* ps = reinterpret_cast<float*>(sm + G::PS);
  __nv_bfloat16* ppt = reinterpret_cast<__nv_bfloat16*>(sm + G::PPT);
  __nv_bfloat16* kb = reinterpret_cast<__nv_bfloat16*>(sm + G::KB);
  __nv_bfloat16* rat = reinterpret_cast<__nv_bfloat16*>(sm + G::RAT);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, cq = lane & 3;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * C;
  const int nsub = min(C / SUB, (a.T - t0 + SUB - 1) / SUB);
  const long long bh = (long long)b * a.H + h;
  long long base[NOPS];
#pragma unroll
  for (int q = 0; q < NOPS; ++q)
    base[q] = b * a.st[3 * q] + h * a.st[3 * q + 1];
  const bool active = warp < G::NWA;
  const int rb = warp / G::WPR, cg = warp % G::WPR, n0 = cg * G::NTW;
  const float* se = a.se + (bh * a.nc + c) * DK * DV;
  const float* sx = a.sx + (bh * a.nc + c) * DK * DV;

  if (tid < DK)
    us[tid] = a.u_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(
                             a.u)[h * DK + tid])
                       : static_cast<const float*>(a.u)[h * DK + tid];
  // P^T below the diagonal stays zero
  for (int x = tid; x < 3 * SUB * LDT; x += THREADS)
    ppt[x] = __float2bfloat16_rn(0.f);

  // this warp's tiles of a (DK x DV) fp32 state [i][j] in global memory
  auto load_state = [&](float S[][4], const float* src) {
#pragma unroll
    for (int n = 0; n < G::NTW; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float2 f = *reinterpret_cast<const float2*>(
            src + (16 * rb + g + 8 * hf) * DV + 8 * (n0 + n) + 2 * cq);
        S[n][2 * hf] = f.x;
        S[n][2 * hf + 1] = f.y;
      }
  };
  float E[G::NTW][4], X[G::NTW][4];
  if (active) load_state(E, se);
  float du = 0.f;  // thread i < DK: du's sum over the chunk

  // the stages in order: sub-chunks 0 .. nsub - 2 (the entry states,
  // forward), then nsub - 1 .. 0 (the gradients, in reverse)
  const int nload = 2 * nsub - 1;
  auto sub_of = [&](int q) { return q < nsub - 1 ? q : 2 * nsub - 2 - q; };
  load_stage<Tin, DK, DV>(sm, a, base, t0 + sub_of(0) * SUB);
  for (int q = 0; q < nload; ++q) {
    const int n = sub_of(q);
    const int ts_ = t0 + n * SUB;
    char* st = sm + (q & 1) * G::STAGE;
    if (q + 1 < nload) {
      load_stage<Tin, DK, DV>(sm + ((q + 1) & 1) * G::STAGE, a, base,
                              t0 + sub_of(q + 1) * SUB);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fix_stage<Tin, DK, DV>(st, a.T, ts_);
    __syncthreads();  // (1) the stage visible; the last step's reads done
    const Tin* rs = reinterpret_cast<const Tin*>(st + G::SR);
    const Tin* ks = reinterpret_cast<const Tin*>(st + G::SK);
    const Tin* vs = reinterpret_cast<const Tin*>(st + G::SV);
    const Tin* dys = reinterpret_cast<const Tin*>(st + G::SDY);
    const float* ws = reinterpret_cast<const float*>(st + G::SW);

    if (q < nsub - 1) {
      // entry state of sub-chunk n + 1: E <- diag(g) E + (k B)^T V
      if (tid < DK) {
        const int i = tid;
        float y = 1.f;
#pragma unroll
        for (int s = SUB - 1; s >= 0; --s) {
          __nv_bfloat16 p[3];
          pieces3(to_f(ks[s * DK + i]) * y, p);
#pragma unroll
          for (int z = 0; z < 3; ++z) rat[(z * DK + i) * LDT + s] = p[z];
          y *= ws[s * DK + i];
        }
        gs[i] = y;
      }
      __syncthreads();
      if (active) {
        const float g0 = gs[16 * rb + g], g1 = gs[16 * rb + g + 8];
#pragma unroll
        for (int m = 0; m < G::NTW; ++m) {
          E[m][0] *= g0;
          E[m][1] *= g0;
          E[m][2] *= g1;
          E[m][3] *= g1;
        }
        state_mma<Tin, DK, DV>(E, rat, vs, rb, n0, g, cq);
        if (q + 1 < nsub - 1) {
#pragma unroll
          for (int m = 0; m < G::NTW; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              est[(n * G::NE + 4 * m + e) * THREADS + tid] = E[m][e];
        }
      }
      __syncthreads();  // the pieces and g read
      continue;
    }

    // ---- sub-chunk n, in reverse: its entry state E and exit
    // gradient-state X
    if (active) {
      if (q == nsub - 1) load_state(X, sx);
      if (n == 0) {
        load_state(E, se);
      } else if (q > nsub - 1) {  // else E holds the last entry state
#pragma unroll
        for (int m = 0; m < G::NTW; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            E[m][e] = est[((n - 1) * G::NE + 4 * m + e) * THREADS + tid];
      }
    }
    if (tid < DK) {
      // (r A)^T pieces [i][s], (k B) pieces [s][i], g
      const int i = tid;
      float x = 1.f;
#pragma unroll
      for (int s = 0; s < SUB; ++s) {
        __nv_bfloat16 p[3];
        pieces3(to_f(rs[s * DK + i]) * x, p);
#pragma unroll
        for (int z = 0; z < 3; ++z) rat[(z * DK + i) * LDT + s] = p[z];
        x *= ws[s * DK + i];
      }
      gs[i] = x;
    } else if (tid >= SUFFIX0<DK> && tid < SUFFIX0<DK> + DK) {
      const int i = tid - SUFFIX0<DK>;
      float y = 1.f;
#pragma unroll
      for (int s = SUB - 1; s >= 0; --s) {
        __nv_bfloat16 p[3];
        pieces3(to_f(ks[s * DK + i]) * y, p);
#pragma unroll
        for (int z = 0; z < 3; ++z) kb[(z * SUB + s) * G::LDKB + i] = p[z];
        y *= ws[s * DK + i];
      }
    }
    if (tid < 8 * G::KQ) {
      // the pairwise scores P_ms (m > s) and a_s: the lanes of a group of
      // KQ share the column s (4 channels a lane), pairing s with 15 - s;
      // each lane's partial sum to shared memory
      const int jp = tid / G::KQ, qq = tid % G::KQ, k0 = 4 * qq;
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const int j = side ? SUB - 1 - jp : jp;
        const float4 kj = load4(ks + j * DK + k0);
        const float4 rj = load4(rs + j * DK + k0);
        const float rv[4] = {rj.x, rj.y, rj.z, rj.w};
        float kd[4] = {kj.x, kj.y, kj.z, kj.w};
        float diag = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          diag = fmaf(rv[e] * us[k0 + e], kd[e], diag);
        ps[(j * (j + 1) / 2 + j) * G::KQ + qq] = diag;
        for (int t = j + 1; t < SUB; ++t) {
          const float4 rt4 = load4(rs + t * DK + k0);
          const float4 wt4 = load4(ws + t * DK + k0);
          const float rt[4] = {rt4.x, rt4.y, rt4.z, rt4.w};
          const float wt[4] = {wt4.x, wt4.y, wt4.z, wt4.w};
          float x = 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            x = fmaf(rt[e], kd[e], x);
            kd[e] *= wt[e];
          }
          ps[(t * (t + 1) / 2 + j) * G::KQ + qq] = x;
        }
      }
    }
    if (active) {
      // E dY^T and X V^T over this warp's columns, the column sums of
      // E o X, and X itself to shared memory
      float o[2][4];
      cols_mma<Tin, DK, DV>(o, E, dys, n0, g, cq);
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          eds[(cg * DK + 16 * rb + g + 8 * (e >> 1)) * LDS + 8 * nn + 2 * cq +
              (e & 1)] = o[nn][e];
      cols_mma<Tin, DK, DV>(o, X, vs, n0, g, cq);
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xvs[(cg * DK + 16 * rb + g + 8 * (e >> 1)) * LDS + 8 * nn + 2 * cq +
              (e & 1)] = o[nn][e];
      float x0 = 0.f, x1 = 0.f;
#pragma unroll
      for (int m = 0; m < G::NTW; ++m) {
        x0 = fmaf(E[m][0], X[m][0], x0);
        x0 = fmaf(E[m][1], X[m][1], x0);
        x1 = fmaf(E[m][2], X[m][2], x1);
        x1 = fmaf(E[m][3], X[m][3], x1);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        x0 += __shfl_xor_sync(0xffffffffu, x0, off);
        x1 += __shfl_xor_sync(0xffffffffu, x1, off);
      }
      if (cq == 0) {
        exs[cg * DK + 16 * rb + g] = x0;
        exs[cg * DK + 16 * rb + g + 8] = x1;
      }
#pragma unroll
      for (int m = 0; m < G::NTW; ++m)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(
              xs + (16 * rb + g + 8 * hf) * G::LDX + 8 * (n0 + m) + 2 * cq) =
              make_float2(X[m][2 * hf], X[m][2 * hf + 1]);
    }
    if (warp < 2) {
      // Q[m][j] = v_j . dy_m, the columns j of 8 warp .. 8 warp + 7
      float qa[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        unsigned af[G::NP][4], t0p[G::NP], t1p[G::NP], t2p[G::NP],
            t3p[G::NP];
        const Tin* d0 = dys + g * DV + 16 * kk + 2 * cq;
        Op<Tin>::adj(d0, t0p);
        Op<Tin>::adj(d0 + 8 * DV, t1p);
        Op<Tin>::adj(d0 + 8, t2p);
        Op<Tin>::adj(d0 + 8 * DV + 8, t3p);
#pragma unroll
        for (int z = 0; z < G::NP; ++z) {
          af[z][0] = t0p[z];
          af[z][1] = t1p[z];
          af[z][2] = t2p[z];
          af[z][3] = t3p[z];
        }
        unsigned b0[G::NP], b1[G::NP];
        const Tin* v0 = vs + (8 * warp + g) * DV + 16 * kk + 2 * cq;
        Op<Tin>::adj(v0, b0);
        Op<Tin>::adj(v0 + 8, b1);
        mma_split<G::NP, G::NP>(qa, af, b0, b1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        qs[(g + 8 * (e >> 1)) * LDS + 8 * warp + 2 * cq + (e & 1)] = qa[e];
    }
    __syncthreads();  // (2) pieces, partial scores, E dY^T, X V^T, Q

    if (tid >= 64) {
      // the pairwise scores summed in lane order, as P^T pieces [s][m]
      for (int x = tid - 64; x < SUB * SUB; x += THREADS - 64) {
        const int t = x / SUB, j = x % SUB;
        if (t < j) continue;
        const float4* p4 = reinterpret_cast<const float4*>(
            ps + (t * (t + 1) / 2 + j) * G::KQ);
        float y = 0.f;
#pragma unroll
        for (int z = 0; z < G::KQ / 4; ++z) {
          const float4 v4 = p4[z];
          y = z == 0 ? v4.x : y + v4.x;
          y = ((y + v4.y) + v4.z) + v4.w;
        }
        __nv_bfloat16 p[3];
        pieces3(y, p);
#pragma unroll
        for (int z = 0; z < 3; ++z) ppt[(z * SUB + j) * LDT + t] = p[z];
      }
    }
    if (tid < DK) {
      // the channel's walk over the sub-chunk's steps
      const int i = tid;
      float F[SUB], XV[SUB], rv[SUB], kv[SUB], wv[SUB];
#pragma unroll
      for (int m = 0; m < SUB; ++m) {
        float x = eds[i * LDS + m], y = xvs[i * LDS + m];
#pragma unroll
        for (int p = 1; p < G::WPR; ++p) {
          x += eds[(p * DK + i) * LDS + m];
          y += xvs[(p * DK + i) * LDS + m];
        }
        F[m] = x;
        XV[m] = y;
        rv[m] = to_f(rs[m * DK + i]);
        kv[m] = to_f(ks[m * DK + i]);
        wv[m] = ws[m * DK + i];
      }
      float FX = exs[i];
#pragma unroll
      for (int p = 1; p < G::WPR; ++p) FX += exs[p * DK + i];
      const float ui = us[i];
#pragma unroll
      for (int s = 0; s < SUB; ++s) {
        float prod = 1.f, dws = 0.f, dks = 0.f;
#pragma unroll
        for (int m = s + 1; m < SUB; ++m) {
          const float qm = qs[m * LDS + s];  // v_s . dy_m
          const float rd = rv[m] * prod;     // r_m prod_{s<p<m} w_p
          dws = fmaf(rd, F[m], dws);
          dks = fmaf(qm, rd, dks);
          prod *= wv[m];
          F[m] = fmaf(wv[s], F[m], kv[s] * qm);  // S_s dy_m
        }
        const float cs = qs[s * LDS + s];
        const float drv = fmaf(cs * ui, kv[s], F[s]);
        const float dkv = fmaf(prod, XV[s], dks) + cs * ui * rv[s];
        const float dwv = fmaf(prod, FX, dws);
        du = fmaf(cs, rv[s] * kv[s], du);
        FX = fmaf(wv[s], FX, kv[s] * XV[s]);
        const long long t = ts_ + s;
        if (t < a.T) {
          put(static_cast<Tin*>(a.dr) + base[DR_] + t * a.st[3 * DR_ + 2] + i,
              drv);
          put(static_cast<Tin*>(a.dk) + base[DK_] + t * a.st[3 * DK_ + 2] + i,
              dkv);
          a.dw[base[DW_] + t * a.st[3 * DW_ + 2] + i] = dwv;
        }
      }
    }
    __syncthreads();  // (3) P^T pieces
    if (warp < G::NWV) {
      // dv = (k B) X + P^T dY, columns 8 (warp NVW + n) ..
      float acc[G::NVW][4];
#pragma unroll
      for (int n = 0; n < G::NVW; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        unsigned af[3][4];
#pragma unroll
        for (int z = 0; z < 3; ++z) {
          const __nv_bfloat16* p =
              kb + (z * SUB + g) * G::LDKB + 16 * kk + 2 * cq;
          af[z][0] = ld32(p);
          af[z][1] = ld32(p + 8 * G::LDKB);
          af[z][2] = ld32(p + 8);
          af[z][3] = ld32(p + 8 * G::LDKB + 8);
        }
#pragma unroll
        for (int n = 0; n < G::NVW; ++n) {
          const int col = 8 * (warp * G::NVW + n) + g;
          const float* x0 = xs + (16 * kk + 2 * cq) * G::LDX + col;
          unsigned b0[3], b1[3];
          split2(x0[0], x0[G::LDX], b0);
          split2(x0[8 * G::LDX], x0[9 * G::LDX], b1);
          mma_split<3, 3>(acc[n], af, b0, b1);
        }
      }
      {
        unsigned af[3][4];
#pragma unroll
        for (int z = 0; z < 3; ++z) {
          const __nv_bfloat16* p = ppt + (z * SUB + g) * LDT + 2 * cq;
          af[z][0] = ld32(p);
          af[z][1] = ld32(p + 8 * LDT);
          af[z][2] = ld32(p + 8);
          af[z][3] = ld32(p + 8 * LDT + 8);
        }
#pragma unroll
        for (int n = 0; n < G::NVW; ++n) {
          const int col = 8 * (warp * G::NVW + n) + g;
          unsigned b0[G::NP], b1[G::NP];
          Op<Tin>::pair(dys + (2 * cq) * DV + col,
                        dys + (2 * cq + 1) * DV + col, b0);
          Op<Tin>::pair(dys + (2 * cq + 8) * DV + col,
                        dys + (2 * cq + 9) * DV + col, b1);
          mma_split<3, G::NP>(acc[n], af, b0, b1);
        }
      }
#pragma unroll
      for (int n = 0; n < G::NVW; ++n) {
        const int col = 8 * (warp * G::NVW + n) + 2 * cq;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const long long t = ts_ + g + 8 * hf;
          if (t < a.T)
            put2(static_cast<Tin*>(a.dv) + base[DV_] + t * a.st[3 * DV_ + 2] +
                     col,
                 acc[n][2 * hf], acc[n][2 * hf + 1]);
        }
      }
    }
    if (active) {
      // X <- diag(g) X + (r A)^T dY: the exit gradient-state of n - 1
      const float g0 = gs[16 * rb + g], g1 = gs[16 * rb + g + 8];
#pragma unroll
      for (int m = 0; m < G::NTW; ++m) {
        X[m][0] *= g0;
        X[m][1] *= g0;
        X[m][2] *= g1;
        X[m][3] *= g1;
      }
      state_mma<Tin, DK, DV>(X, rat, dys, rb, n0, g, cq);
    }
    __syncthreads();  // (4) this step's shared memory read
  }
  if (tid < DK) a.dup[(bh * a.nc + c) * DK + tid] = du;
}

// Launch 4: du[h, i] = sum over b, then over the chunks, of dup, in order.
__global__ void wkv6_bwd_chunked_du_kernel(const float* dup, void* du, int B,
                                           int H, int nc, int DK,
                                           int u_bf16) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= H * DK) return;
  const int h = x / DK, i = x % DK;
  float y = 0.f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < nc; ++c)
      y += dup[(((long long)b * H + h) * nc + c) * DK + i];
  if (u_bf16)
    static_cast<__nv_bfloat16*>(du)[x] = __float2bfloat16_rn(y);
  else
    static_cast<float*>(du)[x] = y;
}

// Opt in to the dynamic shared memory a kernel needs, once.
template <typename Kern>
cudaError_t opt_in(Kern* kern, int smem, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  *done = err == cudaSuccess;
  return err;
}

template <typename Tin, int DK, int DV>
int launch_t(const Args& a, cudaStream_t stream) {
  using G = Geo<Tin, DK, DV>;
  static bool done[2] = {false, false};
  cudaError_t err =
      opt_in(wkv6_bwd_chunk_kernel<Tin, DK, DV>, G::P1_BYTES, &done[0]);
  if (err == cudaSuccess)
    err = opt_in(wkv6_bwd_grad_kernel<Tin, DK, DV>, G::BYTES, &done[1]);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)a.nc, (unsigned)a.H, (unsigned)a.B);
  wkv6_bwd_chunk_kernel<Tin, DK, DV><<<grid, THREADS, G::P1_BYTES, stream>>>(
      a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  wkv6_bwd_scan_kernel<DK, DV>
      <<<dim3((DK * DV + SCAN_THREADS - 1) / SCAN_THREADS, a.H, a.B),
         SCAN_THREADS, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  wkv6_bwd_grad_kernel<Tin, DK, DV><<<grid, THREADS, G::BYTES, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int n = a.H * DK;
  wkv6_bwd_chunked_du_kernel<<<(n + 127) / 128, 128, 0, stream>>>(
      a.dup, a.du, a.B, a.H, a.nc, DK, a.u_bf16);
  return (int)cudaGetLastError();
}

// the instantiations, by (Dk, Dv): rwkv6-1.6b's head, reduced()'s, Jamba's
// Mamba scan
#define WKV_BWD_CHUNKED_SHAPES(X) X(64, 64) X(16, 16) X(16, 128)

}  // namespace

// Dynamic shared memory of one launch-3 CTA (launch 1 takes less), 0 for a
// shape with no instantiation.
extern "C" int wkv6_bwd_chunked_smem(int dk, int dv, int bf16) {
#define WKV_BWD_CHUNKED_S(D1, D2)                                       \
  if (dk == D1 && dv == D2)                                             \
    return bf16 ? Geo<__nv_bfloat16, D1, D2>::BYTES : Geo<float, D1, D2>::BYTES;
  WKV_BWD_CHUNKED_SHAPES(WKV_BWD_CHUNKED_S)
#undef WKV_BWD_CHUNKED_S
  return 0;
}

// r, k, w (B, H, T, Dk), v and dy (B, H, T, Dv), dr, dk, dw (B, H, T, Dk) and
// dv (B, H, T, Dv), each given by its (b, head, position) strides in
// elements (strides: 27 values, in the order R, K, V, W, DY, DR, DK, DV,
// DW), the last axis contiguous and rows on 16-byte boundaries; r, k, v,
// dy and dr, dk, dv all fp32 (bf16 = 0) or all bf16, w and dw fp32; u and
// du (H, Dk) contiguous in u's type (u_bf16); s0, dsT and ds0 contiguous
// (B, H, Dk, Dv) fp32, s0 and dsT null for zeros; scratch se and sx (B, H,
// nc, Dk, Dv), dc and dup (B, H, nc, Dk) fp32, nc = ceil(T / 64).  Four
// launches on the stream.  Returns cudaErrorInvalidValue for a shape with
// no instantiation.
extern "C" int wkv6_bwd_chunked_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s0, const void* dy, const void* dsT, void* dr,
    void* dk, void* dv, void* dw, void* du, void* ds0, void* se, void* sx,
    void* dc, void* dup, const long long* strides, int B, int H, int T,
    int Dk, int Dv, int bf16, int u_bf16, void* stream) {
  Args a{};
  a.r = r;
  a.k = k;
  a.v = v;
  a.w = (const float*)w;
  a.u = u;
  a.s0 = (const float*)s0;
  a.dy = dy;
  a.dsT = (const float*)dsT;
  a.dr = dr;
  a.dk = dk;
  a.dv = dv;
  a.dw = (float*)dw;
  a.du = du;
  a.ds0 = (float*)ds0;
  a.se = (float*)se;
  a.sx = (float*)sx;
  a.dc = (float*)dc;
  a.dup = (float*)dup;
  for (int q = 0; q < 3 * NOPS; ++q) a.st[q] = strides[q];
  a.B = B;
  a.H = H;
  a.T = T;
  a.nc = (T + C - 1) / C;
  a.u_bf16 = u_bf16;
  if (T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define WKV_BWD_CHUNKED_L(D1, D2)                                  \
  if (Dk == D1 && Dv == D2)                                        \
    return bf16 ? launch_t<__nv_bfloat16, D1, D2>(a, st)           \
                : launch_t<float, D1, D2>(a, st);
  WKV_BWD_CHUNKED_SHAPES(WKV_BWD_CHUNKED_L)
#undef WKV_BWD_CHUNKED_L
  return (int)cudaErrorInvalidValue;
}
