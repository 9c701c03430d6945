// RWKV-6 WKV recurrence in chunks, its products on the tensor cores.
//
// Replaces the TPU kernel repro/kernels/wkv6.py (wkv6_pallas, pl.pallas_call
// at :69) for prefill; the recurrent kernel (wkv6.cu) keeps its other uses
// (kernels/wkv6.py says which call takes which).  The function is the
// recurrence's: for r, k, w (B, H, T, Dk), v (B, H, T, Dv), u (H, Dk) and a
// state S (Dk, Dv) per (b, h), zeros or given,
//
//     y_t = r_t (S + diag(u) k_t^T v_t),    S = diag(w_t) S + k_t^T v_t,
//
// y in r's type or fp32, the final state in fp32, for any w in (0, 1].
//
// Chunks of C = 64 steps, each cut in four sub-chunks of 16.  Inside a
// sub-chunk, with c_t = prod_{s < t} w_s (from its start, c_0 = 1),
// d_j = prod_{j < s < 16} w_s and g = c_16, per channel k:
//
//     y_t = (r_t c_t) S + sum_{j < t} P_tj v_j + P_tt v_t,
//     P_tj = sum_k r_tk (k_jk prod_{j < s < t} w_sk),  P_tt = sum_k r_tk u_k k_tk,
//     S   <- diag(g) S + (k d)^T V.
//
// Every decay factor is a product of w's taken from the later step back to
// the earlier one, so each is <= 1 (the exp of a difference of cumulative
// log-decays in the direction that makes it so): a strong decay underflows
// to the negligible terms it stands for and never overflows, with no clip.
// The pairwise factors of a sub-chunk are formed on the CUDA cores; a term
// that crosses a sub-chunk boundary is factored there, r_t c_t on one side
// and k_j d_j on the other, both <= 1, and flows through the state.
//
// The products (r c) S, P V and (k d)^T V run on the tensor cores as
// mma.sync m16n8k16 bf16 with fp32 accumulators.  Every fp32 operand x is
// split in three bf16 pieces, h = bf16(x), m = bf16(x - h), l = bf16(x - h
// - m), which hold its 24 significant bits; the products of piece pairs
// whose orders sum to at most 2 are run, smallest first (six for two
// split operands; three where the other operand is bf16, as r, k, v are in
// the model, which enter a product exactly).  The dropped pieces are <=
// 3 * 2^-24 of a term.  So the sums differ from the recurrence's only in
// their order and in fp32 rounding, which repro_torch/testing.py states as
// an error model against the magnitude of the terms (WKV_TERMS_RTOL).
//
// Three launches, so that time runs in parallel where B * H is small:
//   1. wkv6_chunk_kernel<false>: per (b, h, chunk), the chunk's own state
//      from zeros and its decay D_c = g_0 g_1 g_2 g_3, into scratch;
//   2. wkv6_scan_kernel: per (b, h, k, j), S_c = D_c S_{c-1} + S_loc,c in
//      chunk order from the state given (or zeros), each chunk's entry
//      state into scratch, the last the final state;
//   3. wkv6_chunk_kernel<true>: per (b, h, chunk), y from the entry state,
//      the state carried across the four sub-chunks in the accumulators.
// One call's chunk grid starts at its step 0, so two calls split on a
// multiple of 64 give the bits of one call.
//
// Layout of phases 1 and 3: 128 threads, 4 warps; warp w owns rows
// [16 w, 16 w + 16) of S^T (Dv x Dk, padded to 64 x 64) as 8 m16n8
// accumulator tiles, which are also the A fragments of y^T += S^T (r c)^T
// (the accumulator layout of a 16 x 16 block is the A layout).  Each
// sub-chunk's r, k, v, w come into shared memory by cp.async, two stages,
// the next sub-chunk in flight while this one is used (steps past T zero,
// w = 1; channels past Dk and Dv zero); v is turned into its bf16 pieces,
// and the threads that form r c, k d and P write them as pieces in the
// layout their fragments are read in (32-bit loads, no bank conflict).  The pairwise scores: a half warp shares a column j (4
// channels a lane; the 16 lanes' partials added in shared memory in lane
// order), and takes j and 15 - j, so every half warp forms 15 scores.  y leaves through a shared tile so
// its rows are stored whole.
//
// Bound on the H100: bytes (r, k, v, u read once, w fp32, y written, the
// state out): 0.121 ms at B = 8, H = 32, T = 2,048, Dk = Dv = 64 with bf16
// operands; the recurrence's operations at the TF32 tensor-core rate are
// below it.  The scratch (16 KB of state a chunk, written, read by the
// scan, which writes the entry states, read) adds four times that
// state's bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int C = 64;        // steps per chunk
constexpr int SUB = 16;      // steps per sub-chunk
constexpr int D = 64;        // Dk and Dv, padded
constexpr int LDF = D + 4;   // row stride of the y tile (floats)
constexpr int LDR = D + 8;   // row stride of (r c) pieces [step][channel]
constexpr int LDT = SUB + 8; // row stride of the [channel][step] pieces
constexpr int THREADS = 128;
constexpr int KQ = 16;       // lanes sharing a pairwise sum (4 channels each)
constexpr int SCAN_THREADS = 256;

static_assert(THREADS / KQ * 2 == SUB && D / KQ == 4, "pairwise layout");
static_assert(THREADS / 32 * 16 == D, "a warp owns 16 rows of S^T");

// x as NP bf16 pieces: h = bf16(x), m = bf16(x - h), l = bf16(x - h - m)
template <int NP>
__device__ __forceinline__ void pieces(float x, __nv_bfloat16 p[NP]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    p[i] = __float2bfloat16_rn(x);
    x = __fsub_rn(x, __bfloat162float(p[i]));  // exact
  }
}

// Two fp32 values (the lower column first) as NP packed bf16 piece pairs
// (the same pieces as pieces<NP> of each, one paired conversion a piece).
template <int NP>
__device__ __forceinline__ void split2(float x0, float x1, unsigned p[NP]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const __nv_bfloat162 hb = __floats2bfloat162_rn(x0, x1);
    p[i] = *reinterpret_cast<const unsigned*>(&hb);
    if (i + 1 < NP) {
      const float2 f = __bfloat1622float2(hb);
      x0 = __fsub_rn(x0, f.x);  // exact
      x1 = __fsub_rn(x1, f.y);
    }
  }
}

__device__ __forceinline__ unsigned ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

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

struct Args {
  const void *r, *k, *v;
  const float* w;
  const void* u;
  const float* s_in;  // (B, H, Dk, Dv) or null for zeros
  float* s_out;       // (B, H, Dk, Dv); may be s_in
  void* y;
  float* st;          // scratch (B, H, NC, D, D): each chunk's own state
  float* se;          // scratch (B, H, NC, D, D): each chunk's entry state
  float* dc;          // scratch (B, H, NC, D): chunk decays
  // strides in elements along (b, head, position)
  long long rb, rh, rt, kb, kh, kt, vb, vh, vt, wb, wh, wt, yb, yh, yt;
  int H, T, Dk, Dv, nc, u_bf16, y_f32;
};

// 16 bytes global -> shared without a register round trip; zero-filled
// where !valid (the source address is then not read)
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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// Shared memory of the chunk kernel, in bytes: two stages of one
// sub-chunk's raw operands ([step][channel], Tin; w fp32), then the
// pieces; phase 1 takes the regions up to P1, phase 3 all of them.
template <typename Tin, bool OUT>
struct Smem {
  static constexpr int NV = std::is_same<Tin, float>::value ? 3 : 1;
  static constexpr int RT = SUB * D * (int)sizeof(Tin);  // one Tin operand
  static constexpr int RW = SUB * D * 4;                  // w
  static constexpr int SK = 0, SV = RT, SW = 2 * RT, SR = 2 * RT + RW;
  static constexpr int STAGE = SR + (OUT ? RT : 0);
  static constexpr int G = 2 * STAGE;                // g [D]
  static constexpr int KD = G + D * 4;               // bf16 [3][D][LDT]
  static constexpr int VT = KD + 3 * D * LDT * 2;    // bf16 [NV][D][LDT]
  static constexpr int P1 = VT + NV * D * LDT * 2;
  static constexpr int U = P1;                       // u [D]
  // the pairwise partial sums (fp32 [t(t+1)/2 + j][KQ], t >= j) and,
  // later in each sub-chunk, the y tile (fp32 [SUB][LDF]) share a region
  static constexpr int NPAIR = SUB * (SUB + 1) / 2;
  static constexpr int Y = U + D * 4;
  static constexpr int RD = Y + NPAIR * KQ * 4;      // bf16 [3][SUB][LDR]
  static constexpr int P = RD + 3 * SUB * LDR * 2;   // bf16 [3][SUB][LDT]
  static constexpr int BYTES = OUT ? P + 3 * SUB * LDT * 2 : P1;
  static_assert(NPAIR * KQ >= SUB * LDF, "partials cover the y tile");
  static_assert(RT % 16 == 0 && STAGE % 16 == 0, "align");
};

// cp.async a sub-chunk's k, v, w (and r) into a stage: steps past T and
// channels past Dk, Dv zero-filled (w of a step past T is set to 1 by
// fix_stage once the copy has landed)
template <typename Tin, bool OUT>
__device__ __forceinline__ void load_stage(char* st, const Tin* rb,
                                            const Tin* kb, const Tin* vb,
                                            const float* wb, const Args& a,
                                            long long ts) {
  using S_ = Smem<Tin, OUT>;
  constexpr int PER = 16 / sizeof(Tin);  // elements per 16 bytes
  constexpr int CR = D / PER;            // 16-byte pieces of a row
  Tin* ks = reinterpret_cast<Tin*>(st + S_::SK);
  Tin* vs = reinterpret_cast<Tin*>(st + S_::SV);
  float* ws = reinterpret_cast<float*>(st + S_::SW);
  Tin* rs = reinterpret_cast<Tin*>(st + S_::SR);
  for (int i = threadIdx.x; i < SUB * CR; i += THREADS) {
    const int tt = i / CR, c0 = (i % CR) * PER;
    const long long t = ts + tt;
    const bool ok = t < a.T;
    const long long tc = ok ? t : 0;
    const bool okk = ok && c0 < a.Dk, okv = ok && c0 < a.Dv;
    cp_async16(ks + tt * D + c0, kb + tc * a.kt + (okk ? c0 : 0), okk);
    cp_async16(vs + tt * D + c0, vb + tc * a.vt + (okv ? c0 : 0), okv);
    if (OUT)
      cp_async16(rs + tt * D + c0, rb + tc * a.rt + (okk ? c0 : 0), okk);
  }
  for (int i = threadIdx.x; i < SUB * D / 4; i += THREADS) {
    const int tt = i / (D / 4), c0 = (i % (D / 4)) * 4;
    const long long t = ts + tt;
    const bool okk = t < a.T && c0 < a.Dk;
    const long long tc = t < a.T ? t : 0;
    cp_async16(ws + tt * D + c0, wb + tc * a.wt + (okk ? c0 : 0), okk);
  }
  cp_async_commit();
}

// w = 1 on the steps past T of a landed stage, in the pieces this thread
// copied (a masked step decays nothing; a masked channel's zero w meets
// zero r, k and state rows)
template <typename Tin, bool OUT>
__device__ __forceinline__ void fix_stage(char* st, const Args& a,
                                          long long ts) {
  using S_ = Smem<Tin, OUT>;
  if (ts + SUB <= a.T) return;
  float* ws = reinterpret_cast<float*>(st + S_::SW);
  for (int i = threadIdx.x; i < SUB * D / 4; i += THREADS) {
    const int tt = i / (D / 4), c0 = (i % (D / 4)) * 4;
    if (ts + tt >= a.T)
      *reinterpret_cast<float4*>(ws + tt * D + c0) =
          make_float4(1.f, 1.f, 1.f, 1.f);
  }
}

// The first n (> 0) of 8 values to p, with 16-byte stores where all 8 go
// (p then on a 16-byte boundary: rows of y are, and n is 4 or 8 for fp32).
__device__ __forceinline__ void store8(float* p, const float* x, int n) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  if (n == 8)
    *reinterpret_cast<float4*>(p + 4) = make_float4(x[4], x[5], x[6], x[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* x,
                                       int n) {
  __nv_bfloat162 q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    q[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(q);
}

// The chunk kernel: OUT = false is phase 1 (the chunk's own state from
// zeros and its decay), OUT = true phase 3 (y from the entry state).
template <typename Tin, bool OUT>
__global__ void __launch_bounds__(THREADS, 4) wkv6_chunk_kernel(const Args a) {
  using S_ = Smem<Tin, OUT>;
  constexpr int NV = S_::NV;  // v pieces
  extern __shared__ float4 sm4[];
  char* sm = reinterpret_cast<char*>(sm4);
  float* yt = reinterpret_cast<float*>(sm + S_::Y);
  float* ps = yt;
  float* gs = reinterpret_cast<float*>(sm + S_::G);
  float* us = reinterpret_cast<float*>(sm + S_::U);
  __nv_bfloat16* rdp = reinterpret_cast<__nv_bfloat16*>(sm + S_::RD);
  __nv_bfloat16* kdt = reinterpret_cast<__nv_bfloat16*>(sm + S_::KD);
  __nv_bfloat16* vtp = reinterpret_cast<__nv_bfloat16*>(sm + S_::VT);
  __nv_bfloat16* pp = reinterpret_cast<__nv_bfloat16*>(sm + S_::P);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, cq = lane & 3;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * C;
  const long long bh = (long long)b * a.H + h;
  const Tin* rb = static_cast<const Tin*>(a.r) + b * a.rb + h * a.rh;
  const Tin* kb = static_cast<const Tin*>(a.k) + b * a.kb + h * a.kh;
  const Tin* vb = static_cast<const Tin*>(a.v) + b * a.vb + h * a.vh;
  const float* wb = a.w + b * a.wb + h * a.wh;
  const int nsub = min(C / SUB, (a.T - t0 + SUB - 1) / SUB);
  load_stage<Tin, OUT>(sm, rb, kb, vb, wb, a, t0);

  if (OUT) {
    if (tid < D) {
      float x = 0.f;
      if (tid < a.Dk)
        x = a.u_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(
                           a.u)[h * a.Dk + tid])
                     : static_cast<const float*>(a.u)[h * a.Dk + tid];
      us[tid] = x;
    }
    // P above the diagonal stays zero
    for (int i = tid; i < 3 * SUB * LDT; i += THREADS)
      pp[i] = __float2bfloat16_rn(0.f);
  }

  // S^T rows [16 warp, +16) x columns (channels) [0, 64): tile n holds
  // (row g, cols 8n + 2cq, +1) and (row g + 8, the same cols)
  float S[D / 8][4];
  // phase 1 writes the chunk's own state, phase 3 reads its entry state
  float* st = (OUT ? a.se : a.st) + ((bh * a.nc + c) * D) * D;  // [k][j]
  const int row0 = 16 * warp + g;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + 8 * (e >> 1), col = 8 * n + 2 * cq + (e & 1);
      S[n][e] = OUT ? st[col * D + row] : 0.f;
    }
  float dec = 1.f;  // phase 1, thread k < D: the chunk's decay of row k

  for (int s = 0; s < nsub; ++s) {
    // the next sub-chunk's operands in flight while this one is used; its
    // stage was last read before the previous sub-chunk's second barrier
    char* stage = sm + (s & 1) * S_::STAGE;
    if (s + 1 < nsub) {
      load_stage<Tin, OUT>(sm + ((s + 1) & 1) * S_::STAGE, rb, kb, vb, wb,
                            a, t0 + (s + 1) * SUB);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fix_stage<Tin, OUT>(stage, a, t0 + s * SUB);
    __syncthreads();  // this sub-chunk's operands visible to every thread
    const Tin* rs = reinterpret_cast<const Tin*>(stage + S_::SR);
    const Tin* ks = reinterpret_cast<const Tin*>(stage + S_::SK);
    const Tin* vs = reinterpret_cast<const Tin*>(stage + S_::SV);
    const float* ws = reinterpret_cast<const float*>(stage + S_::SW);
    // v^T as its pieces, [piece][channel][step]
    for (int i = tid; i < SUB * D; i += THREADS) {
      const int tt = i / D, col = i % D;
      __nv_bfloat16 p[NV];
      pieces<NV>(to_f(vs[tt * D + col]), p);
#pragma unroll
      for (int q = 0; q < NV; ++q) vtp[(q * D + col) * LDT + tt] = p[q];
    }
    if (tid < D) {
      // prefix c_t: r c and g = c_16 for channel tid
      float cp = 1.f;
#pragma unroll
      for (int t = 0; t < SUB; ++t) {
        if (OUT) {
          __nv_bfloat16 p[3];
          pieces<3>(__fmul_rn(to_f(rs[t * D + tid]), cp), p);
#pragma unroll
          for (int q = 0; q < 3; ++q) rdp[(q * SUB + t) * LDR + tid] = p[q];
        }
        cp = __fmul_rn(cp, ws[t * D + tid]);
      }
      gs[tid] = cp;
      if (!OUT) dec = s == 0 ? cp : __fmul_rn(dec, cp);
    } else {
      // suffix d_j: k d for channel tid - D
      const int k = tid - D;
      float dp = 1.f;
#pragma unroll
      for (int j = SUB - 1; j >= 0; --j) {
        __nv_bfloat16 p[3];
        pieces<3>(__fmul_rn(to_f(ks[j * D + k]), dp), p);
#pragma unroll
        for (int q = 0; q < 3; ++q) kdt[(q * D + k) * LDT + j] = p[q];
        dp = __fmul_rn(dp, ws[j * D + k]);
      }
    }
    if (OUT) {
      // pairwise scores: the lanes of a half warp share the column j (4
      // channels a lane), pairing j with 15 - j so every half warp forms 15
      // scores and two diagonals; each lane's partial sum goes to shared
      // memory, and the 16 partials of a score are added there in lane order
      const int jp = tid / KQ, q = tid % KQ, k0 = 4 * q;
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const int j = side ? SUB - 1 - jp : jp;
        const float4 kj = load4(ks + j * D + k0);
        const float4 rj = load4(rs + j * D + k0);
        const float rv[4] = {rj.x, rj.y, rj.z, rj.w};
        // kd[i]: k_j decayed to step t, prod_{j < s < t} w_s k_j
        float kd[4] = {kj.x, kj.y, kj.z, kj.w};
        float diag = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = __fmul_rn(__fmul_rn(rv[i], us[k0 + i]), kd[i]);
          diag = i == 0 ? p : __fadd_rn(diag, p);
        }
        ps[(j * (j + 1) / 2 + j) * KQ + q] = diag;
        for (int t = j + 1; t < SUB; ++t) {
          const float4 rt4 = load4(rs + t * D + k0);
          const float4 wt4 = load4(ws + t * D + k0);
          const float rt[4] = {rt4.x, rt4.y, rt4.z, rt4.w};
          const float wt[4] = {wt4.x, wt4.y, wt4.z, wt4.w};
          float x = 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = __fmul_rn(rt[i], kd[i]);
            x = i == 0 ? p : __fadd_rn(x, p);
            kd[i] = __fmul_rn(kd[i], wt[i]);
          }
          ps[(t * (t + 1) / 2 + j) * KQ + q] = x;
        }
      }
      __syncthreads();
      for (int i = tid; i < SUB * SUB; i += THREADS) {
        const int t = i / SUB, j = i % SUB;
        if (t < j) continue;  // above the diagonal P stays zero
        const float4* p4 =
            reinterpret_cast<const float4*>(ps + (t * (t + 1) / 2 + j) * KQ);
        float x = 0.f;
#pragma unroll
        for (int z = 0; z < KQ / 4; ++z) {
          const float4 v4 = p4[z];
          x = z == 0 ? v4.x : __fadd_rn(x, v4.x);
          x = __fadd_rn(__fadd_rn(__fadd_rn(x, v4.y), v4.z), v4.w);
        }
        __nv_bfloat16 p[3];
        pieces<3>(x, p);
#pragma unroll
        for (int z = 0; z < 3; ++z) pp[(z * SUB + t) * LDT + j] = p[z];
      }
    }
    __syncthreads();
    // V^T fragments (rows dv of this warp, the sub-chunk's 16 steps)
    unsigned av[NV][4];
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const __nv_bfloat16* v0 = vtp + (q * D + 16 * warp + g) * LDT + 2 * cq;
      av[q][0] = ld32(v0);
      av[q][1] = ld32(v0 + 8 * LDT);
      av[q][2] = ld32(v0 + 8);
      av[q][3] = ld32(v0 + 8 * LDT + 8);
    }
    if (OUT) {
      float Y[2][4] = {};
      // y^T += S^T (r c)^T over 4 k-steps of 16 channels
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        unsigned af[3][4];
        {
          unsigned p0[3], p1[3], p2[3], p3[3];
          split2<3>(S[2 * kk][0], S[2 * kk][1], p0);
          split2<3>(S[2 * kk][2], S[2 * kk][3], p1);
          split2<3>(S[2 * kk + 1][0], S[2 * kk + 1][1], p2);
          split2<3>(S[2 * kk + 1][2], S[2 * kk + 1][3], p3);
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            af[i][0] = p0[i];
            af[i][1] = p1[i];
            af[i][2] = p2[i];
            af[i][3] = p3[i];
          }
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          unsigned b0[3], b1[3];
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const __nv_bfloat16* src =
                rdp + (q * SUB + 8 * n + g) * LDR + 16 * kk + 2 * cq;
            b0[q] = ld32(src);
            b1[q] = ld32(src + 8);
          }
          mma_split<3, 3>(Y[n], af, b0, b1);
        }
      }
      // y^T += V^T P^T over the sub-chunk's 16 steps
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        unsigned b0[3], b1[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const __nv_bfloat16* src = pp + (q * SUB + 8 * n + g) * LDT + 2 * cq;
          b0[q] = ld32(src);
          b1[q] = ld32(src + 8);
        }
        mma_split<NV, 3>(Y[n], av, b0, b1);
      }
      // y^T -> the shared tile [step][channel] -> y, rows whole
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          yt[(8 * n + 2 * cq + (e & 1)) * LDF + row0 + 8 * (e >> 1)] =
              Y[n][e];
      __syncthreads();
      {
        // thread (step tid / 8, channels 8 (tid % 8) ..): 8 values a store
        const int tt = tid >> 3, c0 = (tid & 7) * 8;
        const long long t = t0 + s * SUB + tt;
        const int nv = t < a.T ? min(8, a.Dv - c0) : 0;
        if (nv > 0) {
          const long long at = b * a.yb + h * a.yh + t * a.yt + c0;
          const float* x = yt + tt * LDF + c0;
          if (a.y_f32)
            store8(static_cast<float*>(a.y) + at, x, nv);
          else
            store8(static_cast<Tin*>(a.y) + at, x, nv);
        }
      }
      if (s + 1 == nsub) break;  // the next chunk's entry state comes from
                                 // the scan
    }
    // S^T <- S^T diag(g) + V^T (k d)
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float g0 = gs[8 * n + 2 * cq], g1 = gs[8 * n + 2 * cq + 1];
      S[n][0] = __fmul_rn(S[n][0], g0);
      S[n][1] = __fmul_rn(S[n][1], g1);
      S[n][2] = __fmul_rn(S[n][2], g0);
      S[n][3] = __fmul_rn(S[n][3], g1);
      unsigned b0[3], b1[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const __nv_bfloat16* src = kdt + (q * D + 8 * n + g) * LDT + 2 * cq;
        b0[q] = ld32(src);
        b1[q] = ld32(src + 8);
      }
      mma_split<NV, 3>(S[n], av, b0, b1);
    }
  }
  if (!OUT) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e >> 1), col = 8 * n + 2 * cq + (e & 1);
        st[col * D + row] = S[n][e];
      }
    if (tid < D) a.dc[(bh * a.nc + c) * D + tid] = dec;
  }
}

// Phase 2: one thread per (b, h, k, j) walks the chunks in order, the
// next chunk's loads in flight while this one's entry state is stored.
__global__ void __launch_bounds__(SCAN_THREADS) wkv6_scan_kernel(
    const Args a) {
  const int e = blockIdx.x * SCAN_THREADS + threadIdx.x;
  const int k = e / D, j = e % D;
  const long long bh = (long long)blockIdx.z * a.H + blockIdx.y;
  const bool real = k < a.Dk && j < a.Dv;
  const long long so = (bh * a.Dk + k) * a.Dv + j;
  float S = a.s_in != nullptr && real ? a.s_in[so] : 0.f;
  const float* __restrict__ st = a.st + bh * a.nc * D * D + e;
  float* __restrict__ se = a.se + bh * a.nc * D * D + e;
  const float* __restrict__ dc = a.dc + bh * a.nc * D + k;
  float loc = st[0], dec = dc[0];
  for (int c = 0; c < a.nc; ++c) {
    const float loc_c = loc, dec_c = dec;
    if (c + 1 < a.nc) {
      loc = st[(long long)(c + 1) * D * D];
      dec = dc[(c + 1) * D];
    }
    se[(long long)c * D * D] = S;
    S = __fadd_rn(__fmul_rn(dec_c, S), loc_c);
  }
  if (real) a.s_out[so] = S;
}

// Opt in to the dynamic shared memory an instantiation needs, once.
template <typename Kern>
cudaError_t opt_in(Kern* kern, int smem, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  *done = err == cudaSuccess;
  return err;
}

template <typename Tin>
int launch_t(const Args& a, int B, cudaStream_t stream) {
  constexpr int SMEM1 = Smem<Tin, false>::BYTES;
  constexpr int SMEM3 = Smem<Tin, true>::BYTES;
  static bool done[2] = {false, false};
  cudaError_t err = opt_in(wkv6_chunk_kernel<Tin, false>, SMEM1, &done[0]);
  if (err == cudaSuccess)
    err = opt_in(wkv6_chunk_kernel<Tin, true>, SMEM3, &done[1]);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)a.nc, (unsigned)a.H, (unsigned)B);
  wkv6_chunk_kernel<Tin, false><<<grid, THREADS, SMEM1, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv6_scan_kernel<<<dim3(D * D / SCAN_THREADS, a.H, B), SCAN_THREADS, 0,
                     stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv6_chunk_kernel<Tin, true><<<grid, THREADS, SMEM3, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// As wkv6_launch (wkv6.cu), plus the scratch: st and se (B, H, nc, 64, 64)
// and dc (B, H, nc, 64) fp32 with nc = ceil(T / 64).  Dk, Dv <= 64; s_out not
// null.  Three launches on the stream.
extern "C" int wkv6_chunked_launch(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s_in, void* s_out, void* y, void* st,
    void* se, void* dc, long long rb, long long rh, long long rt, long long kb,
    long long kh, long long kt, long long vb, long long vh, long long vt,
    long long wb, long long wh, long long wt, long long yb, long long yh,
    long long yt, int B, int H, int T, int Dk, int Dv, int bf16, int u_bf16,
    int y_f32, void* stream) {
  if (Dk > D || Dv > D || s_out == nullptr) return (int)cudaErrorInvalidValue;
  const int nc = (T + C - 1) / C;
  const Args a{r,  k,  v,  (const float*)w, u,  (const float*)s_in,
               (float*)s_out, y, (float*)st, (float*)se, (float*)dc, rb, rh,
               rt, kb, kh, kt, vb, vh, vt, wb, wh, wt, yb, yh, yt, H, T, Dk,
               Dv, nc, u_bf16, y_f32};
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch_t<__nv_bfloat16>(a, B, s) : launch_t<float>(a, B, s);
}

// Dynamic shared memory of one phase-3 CTA (phase 1 takes less), by
// operand type.
extern "C" int wkv6_chunked_smem(int bf16) {
  return bf16 ? Smem<__nv_bfloat16, true>::BYTES : Smem<float, true>::BYTES;
}
