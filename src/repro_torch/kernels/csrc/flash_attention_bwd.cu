// The backward of attention (GQA by head groups, a causal mask with the
// (T - S) offset), two routes, no float atomics: every output element is
// written once, by one thread, in a fixed order of sums, so a call gives
// the same bits every time.
//
// No TPU kernel precedes it: the JAX package differentiates its jnp
// reference (repro/kernels/ref.py: flash_attention under jax.checkpoint per
// 1,024-query chunk).  It differentiates csrc/flash_attention.cu's prefill,
// which leaves the fp32 natural log-sum-exp of each query row behind a
// flag.  For q (B, H, S, D), k, v (B, Hkv, T, D), the forward's output o,
// its lse (B, H, S) and the output's gradient dO, query head h reading KV
// head h / G (G = H / Hkv):
//
//     P    = exp(s * scale - lse), s = q . k, 0 where masked     fp32
//     dV_j = sum_i P_ij dO_i                  (over the G heads of a group)
//     dP   = dO . v,  Delta_i = dO_i . o_i
//     dS   = P (dP - Delta)
//     dQ_i = scale sum_j dS_ij k_j,  dK_j = scale sum_i dS_ij q_i
//
// flash_bwd_delta_kernel (the CUDA-core route's pre-pass): Delta, a row's
// 16-byte chunks over up to 32 lanes.
//
// Tensor cores (bf16 at D in {64, 128}, the model path): the forward's
// producer/consumer layout.  A CTA holds two consumer warpgroups and a
// producer warp (in a warpgroup of its own; setmaxnreg takes the producers
// to 40 registers a thread and the consumers to 232); tiles come by TMA
// over 4-D tensor maps on the operands' own strides, 128-byte swizzled,
// into rings of stages with full/empty mbarriers, and every product is a
// wgmma (bf16 in, fp32 accumulators).
//   flash_bwd_dkdv_wgmma_kernel: one CTA per (64-key tile, KV head, b),
//     numbered longest causal walk first (key tile 0 sees every query
//     tile, the last its own).  K and V come once; the producer streams
//     64-query tiles (128 at D = 64) of Q and dO, with their rows' lse *
//     log2 e and Delta (written by its 32 lanes), for each head of the
//     group in turn, so GQA sums in the CTA in a fixed order.  Both
//     consumer warpgroups cover the CTA's 64 keys: warpgroup w computes
//     S^T = K Q^T and dP^T = V dO^T (SS) for query half w of the tile,
//     P^T = exp2(S^T scale log2 e - lse log2 e) and dS^T = P^T (dP^T -
//     Delta) in registers, and writes both in bf16 to shared memory (TMA's
//     swizzled layout, two buffers); after a barrier of the two,
//     warpgroup 0 accumulates dV += P^T dO and warpgroup 1 dK += dS^T Q
//     over the whole tile (SS, B read MN-major), D / 2 fp32 registers a
//     thread, with the next tile's S^T and dP^T issued behind; dK and dV
//     are written once, in bf16.  Measured at Qwen3-8B's training shape
//     (ab_attention.py): 128-key tiles with each warpgroup holding dK and
//     dV of its own 64 keys took 128 registers a thread at D = 128, and
//     ptxas serialized every wgmma of the kernel (C7512, "insufficient
//     register resources") in each arrangement tried (products grouped or
//     split, 32-query stages, 232 or 240 registers): 0.338 ms a call; on
//     128 CTAs for 132 SMs the group's heads had to be split over CTAs
//     with an ordered fp32 fold (split 1 0.519 ms, 2 0.377, 4 0.397).
//     The 64-key tiles fill the card unsplit (0.305 ms; split 2 0.322).
//   flash_bwd_dq_wgmma_kernel, launched first: one CTA per (128-query
//     tile, head, b), the last query tile (the longest causal walk) first.
//     Q and dO stay; a consumer thread reads its two rows' lse and sums
//     their Delta = rowsum(dO o) from o and dO in device memory (a lane
//     quad a row), and writes Delta for the dK/dV kernel: this route has
//     no Delta pre-pass.  64-key tiles of K and V are streamed.  A
//     consumer warpgroup takes 64 rows: S = Q K^T and dP = dO V^T (SS), P
//     and dS in registers, dQ += dS K (RS).
//   P and dS are each one bf16 operand: a plain model of this arithmetic
//   (tests/test_torch_attention_bwd.py) sits at <= 0.0049 of the largest
//   |gradient| against float64 autograd at S = T in {256, 333}, D 64/128,
//   G 1/4, causal or not, the bound 2^-6; splitting both into hi/lo bf16
//   parts took the worst case to 0.0035, not worth 1.6x the RS products.
//   dS comes out of dP - Delta in fp32; its cancellation is done before
//   the rounding.  A warpgroup waits for each group of products (the
//   forward found ptxas serializing products that are issued ahead while
//   their operands' registers are live).
//   D = 256 stays on the CUDA cores: there a warpgroup's dV (or dK) alone
//   would take 128 registers a thread, the count at which ptxas
//   serialized the 128-key design at D = 128, and a stage of Q and dO 64
//   KB (not tried).
//
// CUDA cores (fp32 operands, whose products on the tensor cores would be
// TF32 and miss the fp32 bound; D in {16, 256}): FA2's design.
//   flash_bwd_dkdv_kernel: one CTA of 256 threads per (key tile, KV head,
//     b), dK and dV of its keys in registers; it walks the query tiles
//     that see the tile, for each of the G query heads of its group in
//     turn, so GQA sums in one CTA, in a fixed order.
//   flash_bwd_dq_kernel: one CTA per (query tile, head, b), dQ of its rows
//     in registers; it walks the key tiles its rows see.  Query tiles
//     start from the last, whose causal work is the largest.
//   Tiles are BQ = BK = 64 (32 at D = 256) positions.  Each thread holds
//   R x R (R = BQ / 16) of the logit tile, rows ty R.. and keys tx R.. of
//   a 16 x 16 thread grid, and R rows (keys in dkdv) x D / 16 columns of
//   its accumulators.  The products along D read transposed tiles ([D][BQ
//   + 4] in shared memory); the products along the tile read row tiles
//   ([BQ][D + 4]), loaded into the same buffer after the first products
//   are done (a second read of the same rows, from L2).  Everything is
//   fp32 in shared memory and registers; operands fp32 or bf16, read
//   through their (b, head, position) strides, the last axis contiguous;
//   dq, dk, dv are written in the operands' type.
//
// Bound on the H100: operations, 5 products of 2 S T D a head (halved where
// causal) on the bf16 tensor cores.  The tensor-core route issues 7 (S and
// dP again in the dQ kernel); the CUDA-core route runs 7 in fp32.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// strides in elements along (b, head, position) of one operand
struct Str {
  long long b, h, s;
};
// q, k, v, o, dO, dq, dk, dv
struct BwdLayout {
  Str q, k, v, o, d, dq, dk, dv;
};

constexpr int THREADS = 256;  // 16 x 16

template <int D>
struct Bwd {
  static_assert(D % 16 == 0, "D");
  static constexpr int BQ = D == 256 ? 32 : 64;  // queries of a tile
  static constexpr int BK = BQ;                  // keys of a tile
  static constexpr int R = BQ / 16;              // logit rows/keys a thread
  static constexpr int PADT = BQ + 4;  // row stride of a transposed tile
  static constexpr int PADR = D + 4;   // row stride of a row tile
  static constexpr int VEC = D >= 64 ? 4 : 1;  // columns per shared load
  static constexpr int CPT = D / 16;           // accumulator columns
  static constexpr int NV = CPT / VEC;
  static constexpr int TT = D * PADT;  // floats of a transposed tile
  static constexpr int TR = BQ * PADR;  // floats of a row tile
  static constexpr int TB = TT > TR ? TT : TR;  // a buffer for either
  static constexpr int TP = BQ * PADT;          // a logit tile
  // dkdv: K^T, V^T; Q^T / Q rows, dO^T / dO rows; P, dS
  static constexpr int SMEM_KV = (2 * TT + 2 * TB + 2 * TP) * 4;
  // dq: Q^T, dO^T, V^T; K^T / K rows; dS^T
  static constexpr int SMEM_Q = (3 * TT + TB + TP) * 4;
  static __device__ __forceinline__ int col(int cv, int tx, int e) {
    return cv * 16 * VEC + tx * VEC + e;
  }
};

// R consecutive floats of shared memory (aligned to R * 4 bytes)
template <int R>
__device__ __forceinline__ void ldv(const float* p, float (&o)[R]) {
  if constexpr (R == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    o[0] = t.x;
    o[1] = t.y;
    o[2] = t.z;
    o[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    o[0] = t.x;
    o[1] = t.y;
  }
}
template <int R>
__device__ __forceinline__ void stv(float* p, const float (&x)[R]) {
  if constexpr (R == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
}
// VEC consecutive floats of shared memory
template <int VEC>
__device__ __forceinline__ void ldc(const float* p, float (&o)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    o[0] = t.x;
    o[1] = t.y;
    o[2] = t.z;
    o[3] = t.w;
  } else {
    o[0] = *p;
  }
}

// rows [r0, r0 + n) of one head (rows at or past `rows` zero) into shared
// memory, transposed: dst[d * PADT + r]
template <typename Tin, int D>
__device__ __forceinline__ void load_t(float* dst, const Tin* src, long long ss,
                                       int r0, int rows, int tid) {
  using C = Bwd<D>;
  for (int idx = tid; idx < C::BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    dst[d * C::PADT + r] =
        r0 + r < rows ? to_f(src[(long long)(r0 + r) * ss + d]) : 0.f;
  }
}
// the same rows as they are: dst[r * PADR + d]
template <typename Tin, int D>
__device__ __forceinline__ void load_r(float* dst, const Tin* src, long long ss,
                                       int r0, int rows, int tid) {
  using C = Bwd<D>;
  for (int idx = tid; idx < C::BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    dst[r * C::PADR + d] =
        r0 + r < rows ? to_f(src[(long long)(r0 + r) * ss + d]) : 0.f;
  }
}

// The logit tile's P and dS for this thread's R x R entries: s and dp hold
// q . k and dO . v on entry, P and dS on return.  Rows i = q0 + ty R + ii,
// keys j = k0 + tx R + jj.
template <int R>
__device__ __forceinline__ void softmax_grad(float (&s)[R][R],
                                             float (&dp)[R][R],
                                             const float (&lse)[R],
                                             const float (&dl)[R], int q0,
                                             int k0, int ty, int tx, int S,
                                             int T, int off, int causal,
                                             float scale) {
#pragma unroll
  for (int ii = 0; ii < R; ++ii) {
    const int i = q0 + ty * R + ii;
#pragma unroll
    for (int jj = 0; jj < R; ++jj) {
      const int j = k0 + tx * R + jj;
      const bool vis = i < S && j < T && (!causal || j <= i + off);
      const float p = vis ? expf(s[ii][jj] * scale - lse[ii]) : 0.f;
      s[ii][jj] = p;
      dp[ii][jj] = p * (dp[ii][jj] - dl[ii]);
    }
  }
}

// S = Q K^T and dP = dO V^T for this thread's entries, from transposed tiles
template <int D>
__device__ __forceinline__ void two_products(
    float (&s)[Bwd<D>::R][Bwd<D>::R], float (&dp)[Bwd<D>::R][Bwd<D>::R],
    const float* Qt, const float* Kt, const float* Ot, const float* Vt,
    int ty, int tx) {
  using C = Bwd<D>;
  constexpr int R = C::R;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[R], ka[R], oa[R], va[R];
    ldv<R>(&Qt[d * C::PADT + ty * R], qa);
    ldv<R>(&Kt[d * C::PADT + tx * R], ka);
    ldv<R>(&Ot[d * C::PADT + ty * R], oa);
    ldv<R>(&Vt[d * C::PADT + tx * R], va);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
        dp[i][j] = fmaf(oa[i], va[j], dp[i][j]);
      }
  }
}

// ------------------------------------------------------------ Delta
// 16 bytes of a row (4 fp32 or 8 bf16) widened to fp32: o[0..N)
__device__ __forceinline__ void widen16(const float* p, float* o) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x;
  o[1] = t.y;
  o[2] = t.z;
  o[3] = t.w;
}
__device__ __forceinline__ void widen16(const __nv_bfloat16* p, float* o) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// Delta: a row's 16-byte chunks over `lpr` lanes (D * sizeof(Tin) / 16,
// at most 32; a power of two), 32 / lpr rows a warp
template <typename Tin>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta_kernel(const Tin* __restrict__ o, const Tin* __restrict__ dout,
                       float* __restrict__ delta, Str so, Str sd, int H, int S,
                       int D, int lpr, long long rows) {
  constexpr int N = 16 / (int)sizeof(Tin);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = D / N, l = lane % lpr;
  const long long row =
      ((long long)blockIdx.x * (THREADS / 32) + warp) * (32 / lpr) +
      lane / lpr;
  float acc = 0.f;
  if (row < rows) {
    const long long s = row % S, bh = row / S;
    const long long h = bh % H, b = bh / H;
    const Tin* orow = o + b * so.b + h * so.h + s * so.s;
    const Tin* drow = dout + b * sd.b + h * sd.h + s * sd.s;
    for (int c = l; c < chunks; c += lpr) {
      float a[N], d[N];
      widen16(orow + c * N, a);
      widen16(drow + c * N, d);
#pragma unroll
      for (int e = 0; e < N; ++e) acc = fmaf(a[e], d[e], acc);
    }
  }
  for (int w = lpr / 2; w > 0; w >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (row < rows && l == 0) delta[row] = acc;
}

// ------------------------------------------------------------ dK, dV
template <typename Tin, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_kernel(const Tin* __restrict__ q, const Tin* __restrict__ k,
                      const Tin* __restrict__ v, const Tin* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, Tin* __restrict__ dk,
                      Tin* __restrict__ dv, BwdLayout L, int H, int G, int S,
                      int T, int causal, float scale) {
  using C = Bwd<D>;
  constexpr int R = C::R, BQ = C::BQ;
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);  // [D][PADT]
  float* Vt = Kt + C::TT;
  float* Qb = Vt + C::TT;  // Q^T, then Q rows
  float* Ob = Qb + C::TB;  // dO^T, then dO rows
  float* Ps = Ob + C::TB;  // [BQ][PADT]: P[i][j]
  float* Ds = Ps + C::TP;  // dS[i][j]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * C::BK, hk = blockIdx.y, b = blockIdx.z;
  const int off = T - S;
  load_t<Tin, D>(Kt, k + b * L.k.b + hk * L.k.h, L.k.s, k0, T, tid);
  load_t<Tin, D>(Vt, v + b * L.v.b + hk * L.v.h, L.v.s, k0, T, tid);
  float dka[R][C::CPT], dva[R][C::CPT];
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int c = 0; c < C::CPT; ++c) dka[j][c] = dva[j][c] = 0.f;
  // the first query tile with a row that sees key k0
  const int qbeg = causal ? max(0, k0 - off) / BQ * BQ : 0;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const Tin* qh = q + b * L.q.b + h * L.q.h;
    const Tin* dh = dout + b * L.d.b + h * L.d.h;
    const float* lh = lse + ((long long)b * H + h) * S;
    const float* dlh = delta + ((long long)b * H + h) * S;
    for (int q0 = qbeg; q0 < S; q0 += BQ) {
      __syncthreads();  // the previous tile is done with Qb, Ob, Ps, Ds
      load_t<Tin, D>(Qb, qh, L.q.s, q0, S, tid);
      load_t<Tin, D>(Ob, dh, L.d.s, q0, S, tid);
      float lr[R], dl[R];
#pragma unroll
      for (int ii = 0; ii < R; ++ii) {
        const int i = q0 + ty * R + ii;
        lr[ii] = i < S ? lh[i] : 0.f;
        dl[ii] = i < S ? dlh[i] : 0.f;
      }
      __syncthreads();
      float s[R][R], dp[R][R];
      two_products<D>(s, dp, Qb, Kt, Ob, Vt, ty, tx);
      softmax_grad<R>(s, dp, lr, dl, q0, k0, ty, tx, S, T, off, causal,
                      scale);
      __syncthreads();  // every thread is done with Q^T and dO^T
#pragma unroll
      for (int ii = 0; ii < R; ++ii) {
        stv<R>(&Ps[(ty * R + ii) * C::PADT + tx * R], s[ii]);
        stv<R>(&Ds[(ty * R + ii) * C::PADT + tx * R], dp[ii]);
      }
      load_r<Tin, D>(Qb, qh, L.q.s, q0, S, tid);
      load_r<Tin, D>(Ob, dh, L.d.s, q0, S, tid);
      __syncthreads();
      // dV[j] += sum_i P[i][j] dO[i],  dK[j] += sum_i dS[i][j] Q[i]: this
      // thread's keys ty R.., its columns col(cv, tx, e)
      const int imax = min(BQ, S - q0);
#pragma unroll 2
      for (int i = 0; i < imax; ++i) {
        float pj[R], dsj[R];
        ldv<R>(&Ps[i * C::PADT + ty * R], pj);
        ldv<R>(&Ds[i * C::PADT + ty * R], dsj);
#pragma unroll
        for (int cv = 0; cv < C::NV; ++cv) {
          float ov[C::VEC], qv[C::VEC];
          ldc<C::VEC>(&Ob[i * C::PADR + C::col(cv, tx, 0)], ov);
          ldc<C::VEC>(&Qb[i * C::PADR + C::col(cv, tx, 0)], qv);
#pragma unroll
          for (int j = 0; j < R; ++j)
#pragma unroll
            for (int e = 0; e < C::VEC; ++e) {
              dva[j][cv * C::VEC + e] =
                  fmaf(pj[j], ov[e], dva[j][cv * C::VEC + e]);
              dka[j][cv * C::VEC + e] =
                  fmaf(dsj[j], qv[e], dka[j][cv * C::VEC + e]);
            }
        }
      }
    }
  }

  Tin* dkh = dk + b * L.dk.b + hk * L.dk.h;
  Tin* dvh = dv + b * L.dv.b + hk * L.dv.h;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int key = k0 + ty * R + j;
    if (key >= T) break;
#pragma unroll
    for (int cv = 0; cv < C::NV; ++cv)
#pragma unroll
      for (int e = 0; e < C::VEC; ++e) {
        const int c = C::col(cv, tx, e);
        store(&dkh[(long long)key * L.dk.s + c], dka[j][cv * C::VEC + e] * scale);
        store(&dvh[(long long)key * L.dv.s + c], dva[j][cv * C::VEC + e]);
      }
  }
}

// ------------------------------------------------------------ dQ
template <typename Tin, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const Tin* __restrict__ q, const Tin* __restrict__ k,
                    const Tin* __restrict__ v, const Tin* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, Tin* __restrict__ dq,
                    BwdLayout L, int H, int G, int S, int T, int causal,
                    float scale) {
  using C = Bwd<D>;
  constexpr int R = C::R, BK = C::BK;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][PADT]
  float* Ot = Qt + C::TT;                       // dO^T
  float* Vt = Ot + C::TT;
  float* Kb = Vt + C::TT;  // K^T, then K rows
  float* Dt = Kb + C::TB;  // [BK][PADT]: dS[i][j] at Dt[j][i]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::BQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / G;
  const int off = T - S;
  const Tin* kh = k + b * L.k.b + hk * L.k.h;
  const Tin* vh = v + b * L.v.b + hk * L.v.h;
  load_t<Tin, D>(Qt, q + b * L.q.b + h * L.q.h, L.q.s, q0, S, tid);
  load_t<Tin, D>(Ot, dout + b * L.d.b + h * L.d.h, L.d.s, q0, S, tid);
  float lr[R], dl[R];
  const float* lh = lse + ((long long)b * H + h) * S;
  const float* dlh = delta + ((long long)b * H + h) * S;
#pragma unroll
  for (int ii = 0; ii < R; ++ii) {
    const int i = q0 + ty * R + ii;
    lr[ii] = i < S ? lh[i] : 0.f;
    dl[ii] = i < S ? dlh[i] : 0.f;
  }
  float dqa[R][C::CPT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < C::CPT; ++c) dqa[i][c] = 0.f;
  // keys any row of this tile sees
  const int kend = causal ? min(T, q0 + C::BQ + off) : T;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // Q^T, dO^T staged; the last tile is done with Kb, Dt
    load_t<Tin, D>(Kb, kh, L.k.s, k0, T, tid);
    load_t<Tin, D>(Vt, vh, L.v.s, k0, T, tid);
    __syncthreads();
    float s[R][R], dp[R][R];
    two_products<D>(s, dp, Qt, Kb, Ot, Vt, ty, tx);
    softmax_grad<R>(s, dp, lr, dl, q0, k0, ty, tx, S, T, off, causal, scale);
    __syncthreads();  // every thread is done with K^T
#pragma unroll
    for (int jj = 0; jj < R; ++jj) {
      float col[R];
#pragma unroll
      for (int ii = 0; ii < R; ++ii) col[ii] = dp[ii][jj];
      stv<R>(&Dt[(tx * R + jj) * C::PADT + ty * R], col);
    }
    load_r<Tin, D>(Kb, kh, L.k.s, k0, T, tid);
    __syncthreads();
    // dQ[i] += sum_j dS[i][j] K[j]: this thread's rows ty R.., its columns
    const int jmax = min(BK, kend - k0);
#pragma unroll 2
    for (int j = 0; j < jmax; ++j) {
      float dsi[R];
      ldv<R>(&Dt[j * C::PADT + ty * R], dsi);
#pragma unroll
      for (int cv = 0; cv < C::NV; ++cv) {
        float kv[C::VEC];
        ldc<C::VEC>(&Kb[j * C::PADR + C::col(cv, tx, 0)], kv);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int e = 0; e < C::VEC; ++e)
            dqa[i][cv * C::VEC + e] =
                fmaf(dsi[i], kv[e], dqa[i][cv * C::VEC + e]);
      }
    }
  }

  Tin* dqh = dq + b * L.dq.b + h * L.dq.h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = q0 + ty * R + i;
    if (r >= S) break;
#pragma unroll
    for (int cv = 0; cv < C::NV; ++cv)
#pragma unroll
      for (int e = 0; e < C::VEC; ++e)
        store(&dqh[(long long)r * L.dq.s + C::col(cv, tx, e)],
              dqa[i][cv * C::VEC + e] * scale);
  }
}

// ------------------------------------------------------ tensor cores
// bytes of one swizzled row (64 bf16): the TMA box's inner extent
constexpr int SWZ_ROW = 128;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG = -1e30f;     // a masked logit
constexpr float NO_ROW = 1e30f;   // lse * log2 e of a query row past S
// two consumer warpgroups and a producer warpgroup, of which one warp
// loads and three leave at once (setmaxnreg moves registers between whole
// warpgroups); 168 registers a thread at entry (65,536 / 384).  The dK/dV
// producer's lanes also load rows of lse and Delta: at 24 registers they
// spilled, at 40 they do not
constexpr int WG_CONSUMERS = 256;
constexpr int WG_THREADS = WG_CONSUMERS + 128;
constexpr int REGS_CONSUMER = 232, REGS_PRODUCER = 40;

template <int D>
struct Dq {
  static_assert(D == 64 || D == 128, "D");
  static constexpr int NCH = D / 64;
  static constexpr int BQ = 128;  // queries of a CTA, 64 a warpgroup
  static constexpr int BK = 64;   // keys of a stage
  static constexpr int STAGES = D == 128 ? 3 : 4;
  static constexpr int QBYTES = NCH * BQ * SWZ_ROW;  // Q (or dO), resident
  static constexpr int KBYTES = NCH * BK * SWZ_ROW;  // K (or V) of a stage
  static constexpr int SMEM = 1024 + 2 * QBYTES + STAGES * 2 * KBYTES;
  static constexpr int NS = BK / 2;
  static constexpr int NO = D / 2;
};

// 2^x on the SFU (max relative error 2^-22); 2^-1e30 is 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 x = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&x);
}

// acc (64 x N, fp32 accumulator fragment) = A B^T over D: A's 64 rows and
// B's N rows both K-major tiles of TMA's layout (64-column blocks of
// `arows` and `brows` rows), bf16
template <int N, int D>
__device__ __forceinline__ void ss_issue(float* acc, const uint8_t* A,
                                         int arows, const uint8_t* Bt,
                                         int brows) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = hopper::smem_desc(
        A + (kk / 4) * arows * SWZ_ROW + (kk % 4) * 32, 16, 1024);
    const uint64_t db = hopper::smem_desc(
        Bt + (kk / 4) * brows * SWZ_ROW + (kk % 4) * 32, 16, 1024);
    hopper::wgmma_ss<N>(acc, da, db, kk > 0);
  }
}

// acc (64 x D) += A (64 x K, bf16 A fragments from registers) . B (K x D):
// B a tile of K rows in TMA's layout, read MN-major (D contiguous)
template <int D, int K>
__device__ __forceinline__ void rs_issue(float* acc, const uint32_t* a,
                                         const uint8_t* Bt) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    hopper::wgmma_rs<D>(
        acc, a + 4 * kk,
        hopper::smem_desc(Bt + kk * 16 * SWZ_ROW, K * SWZ_ROW, 1024));
}

// dK and dV of 64 keys of one KV head, from the query tiles of the G heads
// of its group that see them, streamed through the ring.  Both
// warpgroups cover the CTA's 64 keys: warpgroup w computes S^T and dP^T
// for query half w of a tile (64 keys x 32 queries), writes P^T and dS^T
// in bf16 to shared memory (TMA's swizzled layout, two buffers), and after
// a barrier of the two, warpgroup 0 accumulates dV += P^T dO and
// warpgroup 1 dK += dS^T Q over the whole tile (SS, B read MN-major): D / 2
// accumulator registers a thread, each product issued once.  (One
// warpgroup holding dK and dV of its own 64 keys took 128 registers a
// thread at D = 128, and ptxas then serialized every wgmma of the kernel.)
// dk = scale dK and dv = dV are written once, in bf16.
template <int D>
struct Dkdv {
  static_assert(D == 64 || D == 128, "D");
  static constexpr int NCH = D / 64;  // 64-column blocks of a row
  static constexpr int BK = 64;       // keys of a CTA
  // queries of a stage, half of them a warpgroup's logits (as many as the
  // shared memory holds: at D = 64 the 64-query stages ran 0.374 ms a
  // call at whisper-tiny's encoder shape)
  static constexpr int BQ = D == 64 ? 128 : 64;
  static constexpr int HQ = BQ / 2;
  static constexpr int STAGES = 3;
  static constexpr int KBYTES = NCH * BK * SWZ_ROW;  // the K (or V) tile
  static constexpr int QBYTES = NCH * BQ * SWZ_ROW;  // Q (or dO) of a stage
  static constexpr int PBYTES = BK * BQ * 2;         // P^T (or dS^T), bf16
  // 1 KB to align the tiles to the swizzle's 1,024-byte atoms; each stage
  // also holds its rows' lse * log2 e and Delta
  static constexpr int SMEM = 1024 + 2 * KBYTES +
                              STAGES * (2 * QBYTES + 2 * BQ * 4) +
                              2 * 2 * PBYTES;
  static constexpr int NS = HQ / 2;  // logits a thread: 64 keys x HQ
  static constexpr int NO = D / 2;   // dV (or dK) values a thread: 64 x D
};

// byte offset of bf16 element (row r, column q) of a 64-column tile in the
// 128-byte swizzle (16-byte chunk q / 8 of the row XOR r % 8)
__device__ __forceinline__ int swz(int r, int q) {
  return r * SWZ_ROW + (((q >> 3) ^ (r & 7)) << 4) + ((q & 7) << 1);
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, Str sdk, Str sdv,
                            int B, int H, int Hkv, int S, int T, int causal,
                            float scale, float scale_log2) {
  using C = Dkdv<D>;
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[C::STAGES], empty[C::STAGES], kvfull;
  uint8_t* Ks = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Vs = Ks + C::KBYTES;
  uint8_t* QO = Vs + C::KBYTES;  // stage s: Q at QO + 2 s QBYTES, dO after
  uint8_t* PD = QO + C::STAGES * 2 * C::QBYTES;  // buffer u: P^T, dS^T
  float* rows = reinterpret_cast<float*>(PD + 2 * 2 * C::PBYTES);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int per = Hkv * B;
  const int kt = blockIdx.x / per;
  const int hk = (blockIdx.x % per) % Hkv, b = (blockIdx.x % per) / Hkv;
  const int G = H / Hkv;
  const int k0 = kt * C::BK, off = T - S;
  const int qbeg = causal ? max(0, k0 - off) / C::BQ * C::BQ : 0;
  const int nq = (S - qbeg + C::BQ - 1) / C::BQ;
  const int ntiles = G * nq;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 8);
    }
    mbar_init(&kvfull, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == WG_CONSUMERS / 128) {
    regs_dealloc<REGS_PRODUCER>();
    if (warp == WG_CONSUMERS / 32) {
      if (lane == 0) {
        tma_prefetch_map(&tq);
        tma_prefetch_map(&tk);
        tma_prefetch_map(&tv);
        tma_prefetch_map(&tdo);
        mbar_expect_tx(&kvfull, 2 * C::KBYTES);
#pragma unroll
        for (int c = 0; c < C::NCH; ++c) {
          tma_load_4d(Ks + c * C::BK * SWZ_ROW, &tk, &kvfull, 64 * c, k0, hk,
                      b);
          tma_load_4d(Vs + c * C::BK * SWZ_ROW, &tv, &kvfull, 64 * c, k0, hk,
                      b);
        }
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % C::STAGES;
        const int h = hk * G + t / nq, q0 = qbeg + (t % nq) * C::BQ;
        mbar_wait(&empty[s], ((t / C::STAGES) & 1) ^ 1);
        float* rw = rows + 2 * s * C::BQ;
        const long long base = ((long long)b * H + h) * S;
        for (int r = lane; r < C::BQ; r += 32) {
          const bool in = q0 + r < S;
          rw[r] = in ? lse[base + q0 + r] * LOG2E : NO_ROW;
          rw[C::BQ + r] = in ? delta[base + q0 + r] : 0.f;
        }
        if (lane == 0) {
          uint8_t* Qs = QO + 2 * s * C::QBYTES;
          mbar_expect_tx(&full[s], 2 * C::QBYTES);
#pragma unroll
          for (int c = 0; c < C::NCH; ++c) {
            tma_load_4d(Qs + c * C::BQ * SWZ_ROW, &tq, &full[s], 64 * c, q0,
                        h, b);
            tma_load_4d(Qs + C::QBYTES + c * C::BQ * SWZ_ROW, &tdo, &full[s],
                        64 * c, q0, h, b);
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup w takes query half w of the logits, and
    // dV (w = 0) or dK (w = 1), for all 64 keys
    regs_alloc<REGS_CONSUMER>();
    const int wg = role;
    const int jr0 = 16 * (warp % 4) + lane / 4;  // this thread's key rows
    const int j0 = k0 + jr0;                     // (and 8 below)
    const int c0 = 2 * (lane % 4);
    float acc[C::NO], st[C::NS], dpt[C::NS];
#pragma unroll
    for (int i = 0; i < C::NO; ++i) acc[i] = 0.f;
    // S^T = K Q^T and dP^T = V dO^T of tile t for query half wg (64 keys x
    // HQ), issued
    auto logits = [&](int t) {
      const int s = t % C::STAGES;
      mbar_wait(&full[s], (t / C::STAGES) & 1);
      const uint8_t* Qs = QO + 2 * s * C::QBYTES;
      wgmma_fence();
      ss_issue<C::HQ, D>(st, Ks, C::BK, Qs + C::HQ * wg * SWZ_ROW, C::BQ);
      ss_issue<C::HQ, D>(dpt, Vs, C::BK, Qs + C::QBYTES + C::HQ * wg * SWZ_ROW,
                         C::BQ);
      wgmma_commit();
    };
    // P^T and dS^T = P^T (dP^T - Delta) of tile t, in bf16 into its buffer,
    // then a barrier of the two warpgroups
    auto softmax = [&](int t) {
      const int s = t % C::STAGES;
      const int q0 = qbeg + (t % nq) * C::BQ;
      const float* rw = rows + 2 * s * C::BQ;
      uint8_t* Pb = PD + (t & 1) * 2 * C::PBYTES;
      const bool edge = causal && q0 + off < k0 + C::BK - 1;
#pragma unroll
      for (int c = 0; c < C::HQ / 8; ++c) {
        const int col = C::HQ * wg + 8 * c + c0;  // query within the tile
        const float2 l2 = *reinterpret_cast<const float2*>(rw + col);
        const float2 dl = *reinterpret_cast<const float2*>(rw + C::BQ + col);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float s0 = st[4 * c + 2 * i], s1 = st[4 * c + 2 * i + 1];
          if (edge) {
            const int j = j0 + 8 * i, qi = q0 + col + off;
            if (j > qi) s0 = NEG;
            if (j > qi + 1) s1 = NEG;
          }
          const float p0 = ex2(fmaf(s0, scale_log2, -l2.x));
          const float p1 = ex2(fmaf(s1, scale_log2, -l2.y));
          const int at =
              (col >> 6) * C::BK * SWZ_ROW + swz(jr0 + 8 * i, col & 63);
          *reinterpret_cast<uint32_t*>(Pb + at) = pack_bf16(p0, p1);
          *reinterpret_cast<uint32_t*>(Pb + C::PBYTES + at) =
              pack_bf16(p0 * (dpt[4 * c + 2 * i] - dl.x),
                        p1 * (dpt[4 * c + 2 * i + 1] - dl.y));
        }
      }
      fence_proxy_async();
      bar_sync(1, WG_CONSUMERS);
    };

    mbar_wait(&kvfull, 0);
    logits(0);
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    softmax(0);
    for (int t = 0; t < ntiles; ++t) {
      // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1) over tile
      // t, and tile t + 1's logits issued behind it
      const int s = t % C::STAGES;
      const uint8_t* Qs = QO + 2 * s * C::QBYTES;
      const uint8_t* Pb = PD + (t & 1) * 2 * C::PBYTES;
      const uint8_t* A = wg ? Pb + C::PBYTES : Pb;
      const uint8_t* Bt = wg ? Qs : Qs + C::QBYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::BQ / 16; ++kk)
        wgmma_ss_mn<D>(
            acc,
            smem_desc(A + (kk / 4) * C::BK * SWZ_ROW + (kk % 4) * 32, 16,
                      1024),
            smem_desc(Bt + kk * 16 * SWZ_ROW, C::BQ * SWZ_ROW, 1024));
      wgmma_commit();
      if (t + 1 < ntiles) logits(t + 1);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(st);
      fence_regs(dpt);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (t + 1 < ntiles) softmax(t + 1);
    }

    // this thread's dV (warpgroup 0) or dK (1): keys j0 (+ 8), features
    // 8 c + c0 (+ 1)
    const float f = wg ? scale : 1.f;
    __nv_bfloat16* out = wg ? dk + b * sdk.b + hk * sdk.h
                            : dv + b * sdv.b + hk * sdv.h;
    const long long rs = wg ? sdk.s : sdv.s;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = j0 + 8 * i;
      if (j >= T) continue;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)j * rs + 8 * c +
                                           c0) =
            __floats2bfloat162_rn(acc[4 * c + 2 * i] * f,
                                  acc[4 * c + 2 * i + 1] * f);
    }
  }
}

// dQ of 128 query rows of one head (two warpgroups of 64), from the K and V
// tiles its rows see, streamed through the ring; dq = scale dQ in bf16
template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const __nv_bfloat16* __restrict__ o,
                          const __nv_bfloat16* __restrict__ dout, Str so,
                          Str sd, float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, Str sdq, int B,
                          int H, int Hkv, int S, int T, int causal,
                          float scale, float scale_log2) {
  using C = Dq<D>;
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[C::STAGES], empty[C::STAGES], qfull;
  uint8_t* Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Os = Qs + C::QBYTES;
  uint8_t* KV = Os + C::QBYTES;  // stage s: K at KV + 2 s KBYTES, V after
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // (query tile, head, b), query tiles in the order of their walks'
  // length (causal: the last tile the longest)
  const int per = H * B;
  const int rank = blockIdx.x / per, h = (blockIdx.x % per) % H,
            b = (blockIdx.x % per) / H;
  const int nqt = (S + C::BQ - 1) / C::BQ;
  const int q0 = (causal ? nqt - 1 - rank : rank) * C::BQ;
  const int hk = h / (H / Hkv), off = T - S;
  const int kend = causal ? min(T, q0 + C::BQ + off) : T;
  const int ntiles = (kend + C::BK - 1) / C::BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init(&qfull, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == WG_CONSUMERS / 128) {
    regs_dealloc<REGS_PRODUCER>();
    if (warp == WG_CONSUMERS / 32 && lane == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      tma_prefetch_map(&tdo);
      mbar_expect_tx(&qfull, 2 * C::QBYTES);
#pragma unroll
      for (int c = 0; c < C::NCH; ++c) {
        tma_load_4d(Qs + c * C::BQ * SWZ_ROW, &tq, &qfull, 64 * c, q0, h, b);
        tma_load_4d(Os + c * C::BQ * SWZ_ROW, &tdo, &qfull, 64 * c, q0, h, b);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % C::STAGES;
        mbar_wait(&empty[s], ((t / C::STAGES) & 1) ^ 1);
        uint8_t* Ks = KV + 2 * s * C::KBYTES;
        mbar_expect_tx(&full[s], 2 * C::KBYTES);
#pragma unroll
        for (int c = 0; c < C::NCH; ++c) {
          tma_load_4d(Ks + c * C::BK * SWZ_ROW, &tk, &full[s], 64 * c,
                      t * C::BK, hk, b);
          tma_load_4d(Ks + C::KBYTES + c * C::BK * SWZ_ROW, &tv, &full[s],
                      64 * c, t * C::BK, hk, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows [q0 + 64 wg, + 64)
    regs_alloc<REGS_CONSUMER>();
    const int wg = role;
    const int qw = q0 + 64 * wg;
    const int r0 = qw + 16 * (warp % 4) + lane / 4;
    const int c0 = 2 * (lane % 4);
    const uint8_t* Qw = Qs + 64 * wg * SWZ_ROW;
    const uint8_t* Ow = Os + 64 * wg * SWZ_ROW;
    // this thread's rows' lse * log2 e, and their Delta = rowsum(dO o):
    // each lane of a quad sums D / 4 columns of both rows, the quad adds
    // them, and lane 0 writes Delta for the dK/dV kernel.  (Summed behind
    // the first tile's products instead, the kernel took 115 against 110
    // us at Qwen3-8B's training shape.)
    float l2[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      const long long at = ((long long)b * H + h) * S + r;
      l2[i] = r < S ? lse[at] * LOG2E : NO_ROW;
      float a = 0.f;
      if (r < S) {
        const int d0 = (lane % 4) * (D / 4);
        const __nv_bfloat16* orow = o + b * so.b + h * so.h + r * so.s + d0;
        const __nv_bfloat16* drow =
            dout + b * sd.b + h * sd.h + r * sd.s + d0;
#pragma unroll
        for (int v = 0; v < D / 32; ++v) {
          float x[8], y[8];
          widen16(orow + 8 * v, x);
          widen16(drow + 8 * v, y);
#pragma unroll
          for (int e = 0; e < 8; ++e) a = fmaf(x[e], y[e], a);
        }
      }
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      dl[i] = a;
      if (r < S && lane % 4 == 0) delta[at] = a;
    }
    float dqa[C::NO];
#pragma unroll
    for (int i = 0; i < C::NO; ++i) dqa[i] = 0.f;
    mbar_wait(&qfull, 0);
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % C::STAGES;
      mbar_wait(&full[s], (t / C::STAGES) & 1);
      const uint8_t* Ks = KV + 2 * s * C::KBYTES;
      const uint8_t* Vs = Ks + C::KBYTES;
      // S = Q K^T, dP = dO V^T (64 queries x BK keys)
      float sc[C::NS], dp[C::NS];
      wgmma_fence();
      ss_issue<C::BK, D>(sc, Qw, C::BQ, Ks, C::BK);
      ss_issue<C::BK, D>(dp, Ow, C::BQ, Vs, C::BK);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      const int k0 = t * C::BK;
      const bool edge =
          k0 + C::BK > T || (causal && k0 + C::BK - 1 > qw + off);
      uint32_t dsf[C::BK / 4];
#pragma unroll
      for (int kk = 0; kk < C::BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int c = 2 * kk + r / 2, i = r % 2;
          float s0 = sc[4 * c + 2 * i], s1 = sc[4 * c + 2 * i + 1];
          if (edge) {
            const int j = k0 + 8 * c + c0, lim = causal ? r0 + 8 * i + off
                                                        : T - 1;
            if (j > lim || j >= T) s0 = NEG;
            if (j + 1 > lim || j + 1 >= T) s1 = NEG;
          }
          const float p0 = ex2(fmaf(s0, scale_log2, -l2[i]));
          const float p1 = ex2(fmaf(s1, scale_log2, -l2[i]));
          dsf[4 * kk + r] = pack_bf16(p0 * (dp[4 * c + 2 * i] - dl[i]),
                                      p1 * (dp[4 * c + 2 * i + 1] - dl[i]));
        }
      // dQ += dS K
      wgmma_fence();
      rs_issue<D, C::BK>(dqa, dsf, Ks);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqa);
      fence_regs(dsf);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    __nv_bfloat16* dqh = dq + b * sdq.b + h * sdq.h;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (r >= S) continue;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(dqh + (long long)r * sdq.s +
                                           8 * c + c0) =
            __floats2bfloat162_rn(dqa[4 * c + 2 * i] * scale,
                                  dqa[4 * c + 2 * i + 1] * scale);
    }
  }
}

// Opt in to the dynamic shared memory an instantiation needs, once.
template <typename Kern>
cudaError_t opt_in(Kern* kern, int smem, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  *done = err == cudaSuccess;
  return err;
}

BwdLayout layout(const long long* st) {
  BwdLayout L;
  Str* s[8] = {&L.q, &L.k, &L.v, &L.o, &L.d, &L.dq, &L.dk, &L.dv};
  for (int i = 0; i < 8; ++i) *s[i] = Str{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  return L;
}

template <typename Tin, int D>
int dkdv_t(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dk, void* dv,
           const BwdLayout& L, int B, int H, int Hkv, int S, int T, int causal,
           float scale, cudaStream_t stream) {
  using C = Bwd<D>;
  static bool done = false;
  cudaError_t err = opt_in(flash_bwd_dkdv_kernel<Tin, D>, C::SMEM_KV, &done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((T + C::BK - 1) / C::BK), (unsigned)Hkv,
                  (unsigned)B);
  flash_bwd_dkdv_kernel<Tin, D><<<grid, THREADS, C::SMEM_KV, stream>>>(
      (const Tin*)q, (const Tin*)k, (const Tin*)v, (const Tin*)dout, lse,
      delta, (Tin*)dk, (Tin*)dv, L, H, H / Hkv, S, T, causal, scale);
  return (int)cudaGetLastError();
}

template <typename Tin, int D>
int dq_t(const void* q, const void* k, const void* v, const void* dout,
         const float* lse, const float* delta, void* dq, const BwdLayout& L,
         int B, int H, int Hkv, int S, int T, int causal, float scale,
         cudaStream_t stream) {
  using C = Bwd<D>;
  static bool done = false;
  cudaError_t err = opt_in(flash_bwd_dq_kernel<Tin, D>, C::SMEM_Q, &done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + C::BQ - 1) / C::BQ), (unsigned)H,
                  (unsigned)B);
  flash_bwd_dq_kernel<Tin, D><<<grid, THREADS, C::SMEM_Q, stream>>>(
      (const Tin*)q, (const Tin*)k, (const Tin*)v, (const Tin*)dout, lse,
      delta, (Tin*)dq, L, H, H / Hkv, S, T, causal, scale);
  return (int)cudaGetLastError();
}

// setmaxnreg moves registers between the warps of the CTA: the launch must
// hold the consumers' and the producer's counts
template <typename Kern>
cudaError_t check_regs(Kern* kern) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * WG_THREADS <
      WG_CONSUMERS * REGS_CONSUMER +
          (WG_THREADS - WG_CONSUMERS) * REGS_PRODUCER)
    return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

// the four tensor maps of q, k, v, dO, boxes of `qrows` query and `krows`
// key positions
bool bwd_maps(CUtensorMap* m, const void* q, const void* k, const void* v,
              const void* dout, const BwdLayout& L, int B, int H, int Hkv,
              int S, int T, int D, int qrows, int krows) {
  return hopper::tensor_map(&m[0], q, D, S, H, B, L.q.s, L.q.h, L.q.b,
                            qrows) &&
         hopper::tensor_map(&m[1], k, D, T, Hkv, B, L.k.s, L.k.h, L.k.b,
                            krows) &&
         hopper::tensor_map(&m[2], v, D, T, Hkv, B, L.v.s, L.v.h, L.v.b,
                            krows) &&
         hopper::tensor_map(&m[3], dout, D, S, H, B, L.d.s, L.d.h, L.d.b,
                            qrows);
}

template <int D>
int dkdv_wgmma_t(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dk, void* dv, const BwdLayout& L, int B, int H,
                 int Hkv, int S, int T, int causal, float scale,
                 cudaStream_t stream) {
  using C = Dkdv<D>;
  static bool done = false;
  cudaError_t err = done ? cudaSuccess
                         : check_regs(flash_bwd_dkdv_wgmma_kernel<D>);
  if (err == cudaSuccess)
    err = opt_in(flash_bwd_dkdv_wgmma_kernel<D>, C::SMEM, &done);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap m[4];
  if (!bwd_maps(m, q, k, v, dout, L, B, H, Hkv, S, T, D, C::BQ, C::BK))
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = (float)((double)scale * 1.4426950408889634);
  const long long ctas = (long long)((T + C::BK - 1) / C::BK) * Hkv * B;
  flash_bwd_dkdv_wgmma_kernel<D><<<(unsigned)ctas, WG_THREADS, C::SMEM,
                                   stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, L.dk, L.dv, B, H, Hkv, S, T, causal, scale,
      scale_log2);
  return (int)cudaGetLastError();
}

template <int D>
int dq_wgmma_t(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               const BwdLayout& L, int B, int H, int Hkv, int S, int T,
               int causal, float scale, cudaStream_t stream) {
  using C = Dq<D>;
  static bool done = false;
  cudaError_t err = done ? cudaSuccess
                         : check_regs(flash_bwd_dq_wgmma_kernel<D>);
  if (err == cudaSuccess)
    err = opt_in(flash_bwd_dq_wgmma_kernel<D>, C::SMEM, &done);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap m[4];
  if (!bwd_maps(m, q, k, v, dout, L, B, H, Hkv, S, T, D, C::BQ, C::BK))
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = (float)((double)scale * 1.4426950408889634);
  const long long ctas = (long long)((S + C::BQ - 1) / C::BQ) * H * B;
  flash_bwd_dq_wgmma_kernel<D><<<(unsigned)ctas, WG_THREADS, C::SMEM,
                                 stream>>>(
      m[0], m[1], m[2], m[3], lse, (const __nv_bfloat16*)o,
      (const __nv_bfloat16*)dout, L.o, L.d, delta, (__nv_bfloat16*)dq, L.dq,
      B, H, Hkv, S, T, causal, scale, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

#define FA_BWD_DISPATCH(CALL)              \
  if (bf16) {                              \
    switch (D) {                           \
      case 16: CALL(__nv_bfloat16, 16);    \
      case 64: CALL(__nv_bfloat16, 64);    \
      case 128: CALL(__nv_bfloat16, 128);  \
      case 256: CALL(__nv_bfloat16, 256);  \
    }                                      \
  } else {                                 \
    switch (D) {                           \
      case 16: CALL(float, 16);            \
      case 64: CALL(float, 64);            \
      case 128: CALL(float, 128);          \
      case 256: CALL(float, 256);          \
    }                                      \
  }

// Delta (B, H, S) fp32, contiguous, from o and dO given by their (b, head,
// position) strides in elements (the last axis contiguous); fp32 (bf16 =
// 0) or bf16 (bf16 = 1).
extern "C" int flash_attention_bwd_delta_launch(
    const void* o, const void* dout, void* delta, long long ob, long long oh,
    long long os, long long db, long long dh, long long ds, int B, int H,
    int S, int D, int bf16, void* stream) {
  const long long rows = (long long)B * H * S;
  const int chunks = D * (bf16 ? 2 : 4) / 16;
  const int lpr = chunks < 32 ? chunks : 32;
  const long long per = (THREADS / 32) * (32 / lpr);
  const dim3 grid((unsigned)((rows + per - 1) / per));
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    flash_bwd_delta_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, (float*)delta,
        Str{ob, oh, os}, Str{db, dh, ds}, H, S, D, lpr, rows);
  else
    flash_bwd_delta_kernel<float><<<grid, THREADS, 0, st>>>(
        (const float*)o, (const float*)dout, (float*)delta, Str{ob, oh, os},
        Str{db, dh, ds}, H, S, D, lpr, rows);
  return (int)cudaGetLastError();
}

// dk, dv (B, Hkv, T, D) of q (B, H, S, D), k, v (B, Hkv, T, D), dO (B, H, S,
// D), lse and Delta (B, H, S) fp32 contiguous.  `strides` holds (b, head,
// position) strides in elements of q, k, v, o, dO, dq, dk, dv (24 values;
// o's and dq's are not read here).  D in {16, 64, 128, 256}; causal needs
// T >= S.  Returns cudaErrorInvalidValue for a D it has no instantiation
// of.
extern "C" int flash_attention_bwd_dkdv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const long long* strides, int B, int H, int Hkv, int S, int T, int D,
    int causal, float scale, int bf16, void* stream) {
  const BwdLayout L = layout(strides);
  cudaStream_t st = (cudaStream_t)stream;
#define FA_DKDV(T_, D_)                                                     \
  return dkdv_t<T_, D_>(q, k, v, dout, (const float*)lse,                   \
                        (const float*)delta, dk, dv, L, B, H, Hkv, S, T,    \
                        causal, scale, st)
  FA_BWD_DISPATCH(FA_DKDV)
#undef FA_DKDV
  return (int)cudaErrorInvalidValue;
}

// dq (B, H, S, D): the arguments of flash_attention_bwd_dkdv_launch with dq
// in place of dk and dv.
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const long long* strides,
    int B, int H, int Hkv, int S, int T, int D, int causal, float scale,
    int bf16, void* stream) {
  const BwdLayout L = layout(strides);
  cudaStream_t st = (cudaStream_t)stream;
#define FA_DQ(T_, D_)                                                      \
  return dq_t<T_, D_>(q, k, v, dout, (const float*)lse, (const float*)delta, \
                      dq, L, B, H, Hkv, S, T, causal, scale, st)
  FA_BWD_DISPATCH(FA_DQ)
#undef FA_DQ
  return (int)cudaErrorInvalidValue;
}

// The tensor-core dK/dV kernel, bf16 at D in {64, 128}: the arguments of
// flash_attention_bwd_dkdv_launch without the type, Delta as the dQ kernel
// wrote it.  Strides of q, k, v and dO (of dims longer than 1) must be
// multiples of 8 elements and their pointers 16-byte aligned, as TMA reads
// them.
extern "C" int flash_attention_bwd_dkdv_wgmma_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const long long* strides, int B, int H, int Hkv, int S, int T, int D,
    int causal, float scale, void* stream) {
  const BwdLayout L = layout(strides);
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 64:
      return dkdv_wgmma_t<64>(q, k, v, dout, (const float*)lse,
                              (const float*)delta, dk, dv, L, B, H, Hkv, S, T,
                              causal, scale, st);
    case 128:
      return dkdv_wgmma_t<128>(q, k, v, dout, (const float*)lse,
                               (const float*)delta, dk, dv, L, B, H, Hkv, S,
                               T, causal, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The tensor-core dQ kernel, bf16 at D in {64, 128}, which also computes
// Delta (B, H, S) fp32 from o and dO and writes it (the tensor-core route
// has no Delta pre-pass: it launches this kernel before the dK/dV one).
// The arguments of flash_attention_bwd_dq_launch without the type, o
// beside dO; strides as flash_attention_bwd_dkdv_wgmma_launch takes them
// (o's rows 16-byte aligned too).
extern "C" int flash_attention_bwd_dq_wgmma_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq,
    const long long* strides, int B, int H, int Hkv, int S, int T, int D,
    int causal, float scale, void* stream) {
  const BwdLayout L = layout(strides);
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 64:
      return dq_wgmma_t<64>(q, k, v, o, dout, (const float*)lse,
                            (float*)delta, dq, L, B, H, Hkv, S, T, causal,
                            scale, st);
    case 128:
      return dq_wgmma_t<128>(q, k, v, o, dout, (const float*)lse,
                             (float*)delta, dq, L, B, H, Hkv, S, T, causal,
                             scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one CTA of the CUDA-core dK/dV kernel (kind 0),
// the CUDA-core dQ kernel (kind 1), the tensor-core dK/dV kernel (kind 2)
// or the tensor-core dQ kernel (kind 3) at head dim D; -1 where there is no
// instantiation.
extern "C" int flash_attention_bwd_smem(int D, int kind) {
  switch (D) {
    case 16: return kind == 0 ? Bwd<16>::SMEM_KV
                  : kind == 1 ? Bwd<16>::SMEM_Q : -1;
    case 64: return kind == 0 ? Bwd<64>::SMEM_KV
                  : kind == 1 ? Bwd<64>::SMEM_Q
                  : kind == 2 ? Dkdv<64>::SMEM : Dq<64>::SMEM;
    case 128: return kind == 0 ? Bwd<128>::SMEM_KV
                   : kind == 1 ? Bwd<128>::SMEM_Q
                   : kind == 2 ? Dkdv<128>::SMEM : Dq<128>::SMEM;
    case 256: return kind == 0 ? Bwd<256>::SMEM_KV
                   : kind == 1 ? Bwd<256>::SMEM_Q : -1;
  }
  return -1;
}
