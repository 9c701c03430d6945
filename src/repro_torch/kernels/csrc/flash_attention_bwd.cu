// The backward of attention (GQA by head groups, a causal mask with the
// (T - S) offset), FA2's design on the CUDA cores, three kernels and no
// float atomics: every output element is written once, by one thread, so
// a call gives the same bits every time.
//
// No TPU kernel precedes it: the JAX package differentiates its jnp
// reference (repro/kernels/ref.py: flash_attention under jax.checkpoint per
// 1,024-query chunk).  It differentiates csrc/flash_attention.cu's prefill,
// which leaves the fp32 log-sum-exp of each query row behind a flag.  For
// q (B, H, S, D), k, v (B, Hkv, T, D), the forward's output o, its lse
// (B, H, S) and the output's gradient dO, query head h reading KV head
// h / G (G = H / Hkv):
//
//     P    = exp(s * scale - lse), s = q . k, 0 where masked     fp32
//     dV_j = sum_i P_ij dO_i                  (over the G heads of a group)
//     dP   = dO . v,  Delta_i = dO_i . o_i
//     dS   = P (dP - Delta)
//     dQ_i = scale sum_j dS_ij k_j,  dK_j = scale sum_i dS_ij q_i
//
// flash_bwd_delta_kernel: Delta, one warp a row.
// flash_bwd_dkdv_kernel: one CTA of 256 threads per (key tile, KV head, b),
//   dK and dV of its keys in registers; it walks the query tiles that see
//   the tile, for each of the G query heads of its group in turn, so GQA
//   sums in one CTA, in a fixed order, with no atomics.
// flash_bwd_dq_kernel: one CTA per (query tile, head, b), dQ of its rows in
//   registers; it walks the key tiles its rows see.  Query tiles start
//   from the last, whose causal work is the largest.
//
// Tiles are BQ = BK = 64 (32 at D = 256) positions.  Each thread holds R x R
// (R = BQ / 16) of the logit tile, rows ty R.. and keys tx R.. of a 16 x 16
// thread grid, and R rows (keys in dkdv) x D / 16 columns of its
// accumulators.  The products along D read transposed tiles ([D][BQ + 4]
// in shared memory); the products along the tile read row tiles
// ([BQ][D + 4]), loaded into the same buffer after the first products are
// done (a second read of the same rows, from L2).  Everything is fp32 in
// shared memory and registers; operands fp32 or bf16, read through their
// (b, head, position) strides, the last axis contiguous; dq, dk, dv are
// written in the operands' type.
//
// Bound on the H100: operations, 5 products of 2 S T D a head (halved where
// causal) on the bf16 tensor cores; these kernels run 7 products (S and dP
// twice) in fp32 on the CUDA cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
template <typename Tin>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta_kernel(const Tin* __restrict__ o, const Tin* __restrict__ dout,
                       float* __restrict__ delta, Str so, Str sd, int H, int S,
                       int D, long long rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * (THREADS / 32) + warp;
  if (row >= rows) return;
  const long long s = row % S, bh = row / S;
  const long long h = bh % H, b = bh / H;
  const Tin* orow = o + b * so.b + h * so.h + s * so.s;
  const Tin* drow = dout + b * sd.b + h * sd.h + s * sd.s;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f(orow[d]), to_f(drow[d]), acc);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) delta[row] = acc;
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
  const long long per = THREADS / 32;
  const dim3 grid((unsigned)((rows + per - 1) / per));
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    flash_bwd_delta_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, (float*)delta,
        Str{ob, oh, os}, Str{db, dh, ds}, H, S, D, rows);
  else
    flash_bwd_delta_kernel<float><<<grid, THREADS, 0, st>>>(
        (const float*)o, (const float*)dout, (float*)delta, Str{ob, oh, os},
        Str{db, dh, ds}, H, S, D, rows);
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

// Dynamic shared memory of one CTA of the dK/dV kernel (kind 0) or the dQ
// kernel (kind 1) at head dim D; -1 where there is no instantiation.
extern "C" int flash_attention_bwd_smem(int D, int kind) {
  switch (D) {
    case 16: return kind ? Bwd<16>::SMEM_Q : Bwd<16>::SMEM_KV;
    case 64: return kind ? Bwd<64>::SMEM_Q : Bwd<64>::SMEM_KV;
    case 128: return kind ? Bwd<128>::SMEM_Q : Bwd<128>::SMEM_KV;
    case 256: return kind ? Bwd<256>::SMEM_Q : Bwd<256>::SMEM_KV;
  }
  return -1;
}
