// Attention with an online softmax over KV tiles, GQA by head groups, a
// causal mask with the (T - S) offset and a kv_valid_len mask.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py
// (flash_attention_pallas, pl.pallas_call at :91), and takes the decode
// case (kv_valid_len) that the JAX package sends to its jnp reference: on
// the card the port has no plain path.  For q (B, H, S, D) and k, v
// (B, Hkv, T, D), query head h reads KV head h / (H / Hkv):
//
//     s   = (q . k) * scale                                   fp32
//     s   = -1e30 where kpos > qpos + (T - S) (causal) or kpos >= kv_valid
//     m   = max(m, rowmax s),  p = exp(s - m),  alpha = exp(m_old - m)
//     l   = alpha l + rowsum p,  acc = alpha acc + p v        fp32
//     out = acc / (l == 0 ? 1 : l)                            in q's type
//
// Operands are fp32 or bf16 (the model path), read through their strides
// (the last axis contiguous, rows and strides on 16-byte boundaries), so
// the model's (B, S, H, D) projections are taken as they are.  KV tiles
// wholly above the causal diagonal or at or past kv_valid are skipped: key
// 0 is visible to every row (T >= S), so m is finite after the first tile
// and a fully masked tile would add exp(-1e30 - m) = 0 with alpha = 1;
// skipping it is exact.  Query tiles start from the last, whose causal
// work is the largest.  Three kernels:
//
// Prefill on the tensor cores (flash_prefill_wgmma_kernel: bf16 at D in
// {64, 128, 256}, the model path).  One CTA per (b, h, 128-query tile):
// two consumer warpgroups of 64 query rows (the M of wgmma) and one
// producer warp (in a warpgroup of its own, whose other warps leave);
// setmaxnreg takes the producers to 24 registers a thread and the
// consumers to 240.  The producer brings the Q tile once, then K and V
// tiles into a ring of shared-memory stages, each stage with a full and
// an empty mbarrier, all by TMA over 4-D tensor maps (D, position, head,
// batch) built on the operands' own strides, with the 128-byte swizzle
// that the wgmma descriptors name; TMA zero-fills rows at or past S and
// kv_valid.  A consumer runs S = Q K^T as an SS wgmma (bf16 in, fp32
// accumulators), keeps (m, l) in the accumulator's row layout and takes
// p = exp2(s * scale * log2 e - m) with the scale multiplied into the fp32
// logits (never into the bf16 q: 1/sqrt(128) is no power of two), then
// O += P V as RS wgmma with P from registers split into hi = bf16(p) and
// lo = bf16(p - hi), two products into one fp32 accumulator (the residual
// is at most 2^-18 p; one bf16 P fails the bf16 check against the fp32
// reference, about one output in ten at S = T = 256).  l sums the fp32 p.
// A warpgroup waits for each product: issuing tile t's S ahead of tile
// t - 1's P V keeps S, P and O live at once, and ptxas then serializes
// the products (measured 1.9-2.3x slower); the two warpgroups' products
// and softmax interleave instead.  128-key tiles at D <= 128; 32-key
// tiles at D = 256, where O alone takes 128 registers a thread.
//
// Prefill on the CUDA cores (flash_prefill_kernel: fp32 operands, and D =
// 16 in either type): one CTA of 256 threads per (b, h, 64-query tile), a
// loop over 64-key tiles inside the CTA.  The tile's queries sit in shared
// memory (transposed), each K tile is staged (transposed) and then its V
// tile in the same buffer: 87 KB at D = 128, 157 KB at D = 256, so every
// instantiation opts in to its size.  Each thread owns 4 query rows x 4
// keys of the logit tile and the same 4 rows x D/16 columns of the
// accumulator; the row reductions are 16-lane shuffles.  The products run
// in fp32 on the CUDA cores.
//
// Decode (S = 1: flash_decode_kernel), one launch.  A CTA of up to 4 warps
// takes (split of the valid keys, KV head, up to 8 query heads of its
// group, b), so that K and V are read once for all the group's heads.
// Each warp walks its own 16-key tiles of the split (the CTA's tiles w,
// w + NW, ...) through its own ring of three stages filled by 16-byte
// cp.async (two tiles in flight beside the one in use), with no barrier
// of the CTA inside the loop: a lane pair takes one key's dot product
// (half of D each) for every head, the lanes then take D/32 output columns
// each for P V, and the warp keeps its own (m, l, acc).  At the end the
// CTA folds its warps in shared memory; with more than one split, each CTA
// writes its (m, l, acc) to fp32 scratch and takes a ticket, and the last
// CTA of its (b, KV head, head group) folds the splits into the output
// and sets the ticket back to 0 for the next launch.  The wrapper chooses
// the splits so that the grid fills whole waves of resident CTAs and each
// warp walks a short chain.  Only the first kv_valid keys are read.
//
// Bound on the H100: operations at prefill (4 B H S T_eff D on the bf16
// tensor cores, T_eff = T / 2 causal: 275 GFLOP at B = 8, H = 32, S = T =
// 2048, D = 128; the P split issues 1.5x those products), bytes at decode
// (K and V of the valid prefix, 68 MB at B = 8, Hkv = 8, T = 2080).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// strides in elements of q, k, v and out along (b, head, position)
struct Layout {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// ------------------------------------------------- prefill, CUDA cores
constexpr int THREADS = 256;  // 16 row groups x 16 lanes
constexpr int BQ = 64;        // queries per CTA
constexpr int BK = 64;        // keys per tile
constexpr int PADQ = BQ + 4;  // row stride of the transposed Q and P tiles
constexpr int PADK = BK + 4;  // row stride of the transposed K tile

template <int D>
struct Prefill {
  static_assert(D % 16 == 0, "D");
  static constexpr int CPT = D / 16;              // accumulator columns
  static constexpr int VEC = D >= 64 ? 4 : 1;     // columns per shared load
  static constexpr int NV = CPT / VEC;
  static constexpr int KV = D * PADK > BK * D ? D * PADK : BK * D;
  static constexpr int SMEM = (D * PADQ + KV + BK * PADQ) * 4;
  static constexpr int MIN_BLOCKS = D <= 128 ? 2 : 1;
  // accumulator column of (group cv, element e) for lane tx
  static __device__ __forceinline__ int col(int cv, int tx, int e) {
    return cv * 16 * VEC + tx * VEC + e;
  }
};

template <typename Tin, int D>
__global__ void __launch_bounds__(THREADS, Prefill<D>::MIN_BLOCKS)
flash_prefill_kernel(const Tin* __restrict__ q, const Tin* __restrict__ k,
                     const Tin* __restrict__ v, Tin* __restrict__ out,
                     float* __restrict__ lse, Layout L, int G, int S, int T,
                     int kv_valid, int causal, float scale) {
  using C = Prefill<D>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [D][PADQ]
  float* KVs = Qs + D * PADQ;                    // K [D][PADK] / V [BK][D]
  float* Ps = KVs + C::KV;                       // [BK][PADQ]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int off = T - S;
  const Tin* qb = q + b * L.qb + h * L.qh;
  const Tin* kb = k + b * L.kb + (h / G) * L.kh;
  const Tin* vb = v + b * L.vb + (h / G) * L.vh;
  // keys any row of this tile can see
  const int kend = causal ? min(kv_valid, q0 + BQ + off) : kv_valid;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    Qs[d * PADQ + r] =
        q0 + r < S ? to_f(qb[(long long)(q0 + r) * L.qs + d]) : 0.f;
  }
  float m[4], l[4], acc[4][C::CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::CPT; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // Q staged; the previous tile is done with KVs and Ps
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int j = idx / D, d = idx % D;
      KVs[d * PADK + j] =
          k0 + j < kend ? to_f(kb[(long long)(k0 + j) * L.ks + d]) : 0.f;
    }
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qs[d * PADQ + ty * 4]);
      const float4 c =
          *reinterpret_cast<const float4*>(&KVs[d * PADK + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }
    // scale, mask, online softmax; a row's 64 logits live on 16 lanes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i + off;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        const bool vis = kpos < kv_valid && (!causal || kpos <= qpos);
        s[i][j] = vis ? s[i][j] * scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float mn = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        sum += s[i][j];
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      const float alpha = expf(m[i] - mn);
      l[i] = alpha * l[i] + sum;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < C::CPT; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Ps[(tx * 4 + j) * PADQ + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();  // every thread is done with the K tile
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int j = idx / D, d = idx % D;
      KVs[j * D + d] =
          k0 + j < kend ? to_f(vb[(long long)(k0 + j) * L.vs + d]) : 0.f;
    }
    __syncthreads();
    const int jmax = min(BK, kend - k0);
#pragma unroll 4
    for (int j = 0; j < jmax; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(&Ps[j * PADQ + ty * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
      const float* vr = &KVs[j * D];
#pragma unroll
      for (int cv = 0; cv < C::NV; ++cv) {
        float vv[C::VEC];
        if constexpr (C::VEC == 4) {
          const float4 t =
              *reinterpret_cast<const float4*>(&vr[C::col(cv, tx, 0)]);
          vv[0] = t.x;
          vv[1] = t.y;
          vv[2] = t.z;
          vv[3] = t.w;
        } else {
          vv[0] = vr[C::col(cv, tx, 0)];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < C::VEC; ++e)
            acc[i][cv * C::VEC + e] =
                fmaf(pv[i], vv[e], acc[i][cv * C::VEC + e]);
      }
    }
  }

  Tin* ob = out + b * L.ob + h * L.oh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) break;
    if (lse != nullptr && tx == 0)
      lse[((long long)b * gridDim.y + h) * S + r] = m[i] + logf(l[i]);
    const float den = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int cv = 0; cv < C::NV; ++cv)
#pragma unroll
      for (int e = 0; e < C::VEC; ++e)
        store(&ob[(long long)r * L.os + C::col(cv, tx, e)],
              acc[i][cv * C::VEC + e] / den);
  }
}

// ------------------------------------------------- prefill, tensor cores
// bytes of one swizzled row (64 bf16): the TMA box's inner extent
constexpr int SWZ_ROW = 128;

template <int D>
struct Wg {
  static_assert(D % 64 == 0 && D <= 256, "D");
  static constexpr int BQ = 128;                  // queries per CTA
  static constexpr int CONSUMERS = 256;  // two warpgroups
  // and a producer warpgroup, of which one warp issues the loads and three
  // leave at once: setmaxnreg moves registers between whole warpgroups
  static constexpr int THREADS = CONSUMERS + 128;
  static constexpr int NCH = D / 64;              // 64-column blocks of a row
  static constexpr int BK = D <= 128 ? 128 : 32;  // keys per KV tile
  static constexpr int STAGES = D == 128 ? 2 : 4;
  static constexpr int QBYTES = NCH * BQ * SWZ_ROW;
  static constexpr int KBYTES = NCH * BK * SWZ_ROW;  // K (or V) of a stage
  // 1 KB to align the tiles to the swizzle's 1,024-byte atoms
  static constexpr int SMEM = 1024 + QBYTES + STAGES * 2 * KBYTES;
  static constexpr int NS = BK / 2;  // logits a consumer thread holds
  static constexpr int NO = D / 2;   // accumulator values a consumer holds
  // 168 a thread at entry (65,536 / 384): the producers give back 144
  static constexpr int REGS_CONSUMER = 240, REGS_PRODUCER = 24;
};

// 2^x on the SFU (max relative error 2^-22); 2^-1e30 is 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Issue S = Q K^T for 64 query rows against a K tile (both K-major, 16
// columns of D a step), and O += P V against a V tile (MN-major: D
// contiguous, 16 keys a step) with P's two bf16 parts; no wait.
template <int D>
__device__ __forceinline__ void qk_issue(float (&sc)[Wg<D>::NS],
                                         const uint8_t* Qw,
                                         const uint8_t* Ks) {
  using C = Wg<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = hopper::smem_desc(
        Qw + (kk / 4) * C::BQ * SWZ_ROW + (kk % 4) * 32, 16, 1024);
    const uint64_t db = hopper::smem_desc(
        Ks + (kk / 4) * C::BK * SWZ_ROW + (kk % 4) * 32, 16, 1024);
    hopper::wgmma_ss<C::BK>(sc, da, db, kk > 0);
  }
}

template <int D>
__device__ __forceinline__ void pv_issue(float (&o)[Wg<D>::NO],
                                         const uint32_t (&phi)[Wg<D>::BK / 4],
                                         const uint32_t (&plo)[Wg<D>::BK / 4],
                                         const uint8_t* Vs) {
  using C = Wg<D>;
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk) {
    const uint64_t dv =
        hopper::smem_desc(Vs + kk * 16 * SWZ_ROW, C::BK * SWZ_ROW, 1024);
    hopper::wgmma_rs<D>(o, phi + 4 * kk, dv);
    hopper::wgmma_rs<D>(o, plo + 4 * kk, dv);
  }
}

template <int D>
__global__ void __launch_bounds__(Wg<D>::THREADS, 1)
flash_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, long long ob,
                           long long oh, long long os, int G, int S, int T,
                           int kv_valid, int causal, float scale_log2) {
  using C = Wg<D>;
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[C::STAGES], empty[C::STAGES], qfull;
  uint8_t* Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* KV = Qs + C::QBYTES;  // stage s: K at KV + 2 s KBYTES, V after
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::BQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / G;
  const int off = T - S;
  // keys any row of this tile can see
  const int kend = causal ? min(kv_valid, q0 + C::BQ + off) : kv_valid;
  const int ntiles = (kend + C::BK - 1) / C::BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive, and the bytes
      mbar_init(&empty[s], 8);  // one arrive from each consumer warp
    }
    mbar_init(&qfull, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup's index from lane 0, so that the compiler sees it
  // uniform and lets setmaxnreg set each branch's register budget
  // (taken from tid alone, every branch stays within the 168 of entry)
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == C::CONSUMERS / 128) {
    // ---- producer: one thread issues every load
    regs_dealloc<C::REGS_PRODUCER>();
    if (warp == C::CONSUMERS / 32 && lane == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      mbar_expect_tx(&qfull, C::QBYTES);
#pragma unroll
      for (int c = 0; c < C::NCH; ++c)
        tma_load_4d(Qs + c * C::BQ * SWZ_ROW, &tq, &qfull, 64 * c, q0, h, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % C::STAGES;
        // the stage's previous tile released (passes at once in round 0)
        mbar_wait(&empty[s], ((t / C::STAGES) & 1) ^ 1);
        uint8_t* Ks = KV + s * 2 * C::KBYTES;
        uint8_t* Vs = Ks + C::KBYTES;
        mbar_expect_tx(&full[s], 2 * C::KBYTES);
#pragma unroll
        for (int c = 0; c < C::NCH; ++c) {
          tma_load_4d(Ks + c * C::BK * SWZ_ROW, &tk, &full[s], 64 * c,
                      t * C::BK, hk, b);
          tma_load_4d(Vs + c * C::BK * SWZ_ROW, &tv, &full[s], 64 * c,
                      t * C::BK, hk, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows [q0 + 64 wg, + 64); the
    // two warpgroups' products and softmax interleave on the SM
    regs_alloc<C::REGS_CONSUMER>();
    const int wg = role;
    // this thread's rows (i = 0; i = 1 is 8 below) and its first column
    // within each 8-column group of the accumulator fragment
    const int r0 = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;
    const int c0 = 2 * (lane % 4);
    const uint8_t* Qw = Qs + 64 * wg * SWZ_ROW;
    float o[C::NO];
#pragma unroll
    for (int i = 0; i < C::NO; ++i) o[i] = 0.f;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
    mbar_wait(&qfull, 0);
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % C::STAGES;
      mbar_wait(&full[s], (t / C::STAGES) & 1);
      const uint8_t* Ks = KV + s * 2 * C::KBYTES;
      float sc[C::NS];
      wgmma_fence();
      qk_issue<D>(sc, Qw, Ks);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // mask; the row max of the raw logits, then of the scaled ones (the
      // scale is positive), in the log2 domain
      const int k0 = t * C::BK;
      if (k0 + C::BK > kv_valid || (causal && k0 + C::BK - 1 > q0 + off)) {
#pragma unroll
        for (int c = 0; c < C::BK / 8; ++c)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int kpos = k0 + 8 * c + c0 + j;
              if (kpos >= kv_valid || (causal && kpos > r0 + 8 * i + off))
                sc[4 * c + 2 * i + j] = NEG;
            }
      }
      float alpha[2], nm[2];  // nm: minus the new max, scaled
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = NEG;
#pragma unroll
        for (int c = 0; c < C::BK / 8; ++c)
          mx = fmaxf(mx, fmaxf(sc[4 * c + 2 * i], sc[4 * c + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[i], mx * scale_log2);
        alpha[i] = exp2f(m[i] - mn);
        m[i] = mn;
        nm[i] = -mn;
        l[i] *= alpha[i];
      }
      if (alpha[0] != 1.f || alpha[1] != 1.f) {  // (x 1 is exact: skipped)
#pragma unroll
        for (int c = 0; c < D / 8; ++c)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            o[4 * c + 2 * i] *= alpha[i];
            o[4 * c + 2 * i + 1] *= alpha[i];
          }
      }
      // p = exp2(s * scale log2 e - m) in fp32, split into the A fragments
      // of P's 16-key steps, two bf16 parts each: register r of step kk
      // holds row i = r % 2 at logit group 2 kk + r / 2
      uint32_t phi[C::BK / 4], plo[C::BK / 4];
#pragma unroll
      for (int kk = 0; kk < C::BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int c = 2 * kk + r / 2, i = r % 2;
          const float p0 = ex2(fmaf(sc[4 * c + 2 * i], scale_log2, nm[i]));
          const float p1 =
              ex2(fmaf(sc[4 * c + 2 * i + 1], scale_log2, nm[i]));
          l[i] += p0 + p1;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          const float2 hf = __bfloat1622float2(hi);
          phi[4 * kk + r] = pack_bf16(hi);
          plo[4 * kk + r] =
              pack_bf16(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
        }

      // O += P V
      wgmma_fence();
      pv_issue<D>(o, phi, plo, Ks + C::KBYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(phi);
      fence_regs(plo);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // a row's l is spread over the 4 lanes of its quad
    __nv_bfloat16* obh = out + b * ob + h * oh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int r = r0 + 8 * i;
      if (r >= S) continue;
      // the row's natural log-sum-exp: m is in the scaled log2 domain
      if (lse != nullptr && lane % 4 == 0)
        lse[((long long)b * gridDim.y + h) * S + r] =
            (m[i] + log2f(l[i])) * 0.6931471805599453f;
      const float den = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(obh + (long long)r * os + 8 * c +
                                           c0) =
            __floats2bfloat162_rn(o[4 * c + 2 * i] / den,
                                  o[4 * c + 2 * i + 1] / den);
    }
  }
}

// 16 bytes of a row (4 fp32 or 8 bf16), widened to fp32
template <typename Tin>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void widen(const float* p, float* o) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    o[0] = t.x;
    o[1] = t.y;
    o[2] = t.z;
    o[3] = t.w;
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void widen(const __nv_bfloat16* p,
                                               float* o) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
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

// E consecutive elements (E * sizeof(Tin) bytes, aligned to that or to
// 16), widened to fp32
template <typename Tin, int E>
__device__ __forceinline__ void load_cols(const Tin* p, float* o) {
  constexpr int BYTES = E * (int)sizeof(Tin);
  Tin t[E];
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i)
      reinterpret_cast<uint4*>(t)[i] = reinterpret_cast<const uint4*>(p)[i];
  } else if constexpr (BYTES == 8) {
    *reinterpret_cast<uint2*>(t) = *reinterpret_cast<const uint2*>(p);
  } else if constexpr (BYTES == 4) {
    *reinterpret_cast<uint32_t*>(t) = *reinterpret_cast<const uint32_t*>(p);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) t[e] = p[e];
  }
#pragma unroll
  for (int e = 0; e < E; ++e) o[e] = to_f(t[e]);
}

constexpr int DEC_KS = 16;     // keys of a warp's tile (one per lane pair)
constexpr int DEC_GC = 8;      // query heads of a CTA
constexpr int DEC_STAGES = 3;  // a warp's ring: two tiles in flight

// query heads a CTA holds, padded: 1, 4 or 8
__host__ __device__ constexpr int heads_padded(int G) {
  return G <= 1 ? 1 : G <= 4 ? 4 : 8;
}

template <typename Tin, int D, int GP>
struct Decode {
  static constexpr int N = Vec16<Tin>::N;  // elements in 16 bytes
  static constexpr int DP = D / 2;         // a lane's half of a dot product
  static_assert(DP % N == 0, "D");
  // K and V rows padded by 16 bytes, so that the 8 lanes of a quarter warp
  // reading 16 bytes of 8 rows hit distinct banks
  static constexpr int ROW = D + N;
  static constexpr int STAGE = 2 * DEC_KS * ROW;  // K then V, elements
  static constexpr int RING = DEC_STAGES * STAGE * (int)sizeof(Tin);
  // warps of a CTA: as many as keep it within ~120 KB (two CTAs an SM)
  static constexpr int NW =
      4 * RING <= 120 * 1024 ? 4 : 2 * RING <= 120 * 1024 ? 2 : 1;
  static constexpr int E = D >= 32 ? D / 32 : 1;  // output columns a lane
  static constexpr int QROW = DP + 4;  // a half row of q in fp32, padded
  static constexpr int QF = GP * 2 * QROW;
  static constexpr int PF = GP * DEC_KS;  // a warp's p, fp32
  static constexpr int SMEM = (QF + NW * PF + 4) * 4 + NW * RING;
  // a warp's (acc, m, l) for the fold reuses its ring
  static_assert(GP * (D + 2) * 4 <= RING, "fold");
  static_assert(((QF + NW * PF + 4) * 4) % 16 == 0, "align");
};

// cp.async a warp's tile: the K and V rows [k0, k0 + 16), rows at or past
// t1 zero-filled (their source is not read); one commit group
template <typename Tin, int D, int GP>
__device__ __forceinline__ void decode_issue(Tin* kd, const Tin* kb,
                                             const Tin* vb, const Layout& L,
                                             int k0, int t1, int lane) {
  using C = Decode<Tin, D, GP>;
  constexpr int VPR = D / C::N;  // 16-byte vectors per row
  Tin* vd = kd + DEC_KS * C::ROW;
  for (int idx = lane; idx < DEC_KS * VPR; idx += 32) {
    const int j = idx / VPR, c = (idx % VPR) * C::N;
    const bool ok = k0 + j < t1;
    const long long row = ok ? k0 + j : 0;
    cp_async16(kd + j * C::ROW + c, kb + row * L.ks + c, ok);
    cp_async16(vd + j * C::ROW + c, vb + row * L.vs + c, ok);
  }
}

template <typename Tin, int D, int GP>
__global__ void __launch_bounds__(Decode<Tin, D, GP>::NW * 32)
flash_decode_kernel(const Tin* __restrict__ q, const Tin* __restrict__ k,
                    const Tin* __restrict__ v, Tin* __restrict__ out,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int* __restrict__ tickets, Layout L, int B, int H, int G,
                    int kv_valid, int chunk, int nsplit, float scale) {
  using C = Decode<Tin, D, GP>;
  constexpr int NW = C::NW, KS = DEC_KS, ST = DEC_STAGES;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [GP][2][QROW]
  float* ps = qs + C::QF;                       // [NW][GP][KS]
  int* last = reinterpret_cast<int*>(ps + NW * C::PF);
  Tin* rings = reinterpret_cast<Tin*>(last + 4);  // [NW][ST][K, V]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, b = blockIdx.z;
  const int ngc = (G + DEC_GC - 1) / DEC_GC;
  const int hk = blockIdx.y / ngc, g0 = (blockIdx.y % ngc) * DEC_GC;
  const int gc = min(DEC_GC, G - g0);
  const int h0 = hk * G + g0;
  const int t0 = split * chunk, t1 = min(kv_valid, t0 + chunk);
  const int ntile = (t1 - t0 + KS - 1) / KS;  // the CTA's tiles
  // this warp's tiles: warp, warp + NW, ...
  const int mine = ntile > warp ? (ntile - warp + NW - 1) / NW : 0;
  const Tin* kb = k + b * L.kb + hk * L.kh;
  const Tin* vb = v + b * L.vb + hk * L.vh;
  Tin* ring = rings + warp * (C::RING / (int)sizeof(Tin));
  float* pw = ps + warp * C::PF;

#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < mine)
      decode_issue<Tin, D, GP>(ring + i * C::STAGE, kb, vb, L,
                               t0 + (warp + i * NW) * KS, t1, lane);
    cp_async_commit();
  }
  // q in fp32, each head's row in two halves (heads past gc zero)
  for (int idx = tid; idx < GP * D; idx += NW * 32) {
    const int g = idx / D, d = idx % D;
    qs[(2 * g + d / C::DP) * C::QROW + d % C::DP] =
        g < gc ? to_f(q[b * L.qb + (h0 + g) * L.qh + d]) : 0.f;
  }
  __syncthreads();

  float m[GP], l[GP], acc[GP][C::E];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < C::E; ++e) acc[g][e] = 0.f;
  }
  const int j = lane % KS, half = lane / KS;
  const bool has_cols = lane * C::E < D;
  for (int i = 0; i < mine; ++i) {
    // the tile ST - 1 ahead goes into the stage tile i - 1 freed
    if (i + ST - 1 < mine)
      decode_issue<Tin, D, GP>(ring + ((i + ST - 1) % ST) * C::STAGE, kb, vb,
                               L, t0 + (warp + (i + ST - 1) * NW) * KS, t1,
                               lane);
    cp_async_commit();
    cp_async_wait<ST - 1>();
    __syncwarp();  // every lane's copies of tile i visible to the warp
    const Tin* kt = ring + (i % ST) * C::STAGE;
    const Tin* vt = kt + KS * C::ROW;
    const int k0 = t0 + (warp + i * NW) * KS;

    // logits: lanes j and j + 16 each take half of key j's dot product
    float s[GP];
#pragma unroll
    for (int g = 0; g < GP; ++g) s[g] = 0.f;
    const float* qh = qs + half * C::QROW;
#pragma unroll 4
    for (int c = 0; c < C::DP; c += C::N) {
      float kk[C::N];
      Vec16<Tin>::widen(kt + j * C::ROW + half * C::DP + c, kk);
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        const float* qg = qh + 2 * g * C::QROW + c;
#pragma unroll
        for (int e = 0; e < C::N; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qg + e);
          s[g] = fmaf(qv.x, kk[e], s[g]);
          s[g] = fmaf(qv.y, kk[e + 1], s[g]);
          s[g] = fmaf(qv.z, kk[e + 2], s[g]);
          s[g] = fmaf(qv.w, kk[e + 3], s[g]);
        }
      }
    }
    const bool valid = k0 + j < t1;
    float alpha[GP];
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      s[g] += __shfl_xor_sync(0xffffffffu, s[g], 16);
      s[g] = valid ? s[g] * scale : NEG;
      float mx = s[g];
#pragma unroll
      for (int w = 1; w < KS; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float mn = fmaxf(m[g], mx);
      alpha[g] = expf(m[g] - mn);
      const float p = expf(s[g] - mn);
      m[g] = mn;
      // lane j (< 16) keeps key j's share of l; the fold sums the lanes
      l[g] = alpha[g] * l[g] + (half == 0 ? p : 0.f);
      if (half == 0) pw[g * KS + j] = p;
    }
    __syncwarp();

    // acc += p v: lane takes columns [lane E, lane E + E)
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int e = 0; e < C::E; ++e) acc[g][e] *= alpha[g];
    if (has_cols) {
#pragma unroll
      for (int jj = 0; jj < KS; jj += 4) {
        float4 pv[GP];
#pragma unroll
        for (int g = 0; g < GP; ++g)
          pv[g] = *reinterpret_cast<const float4*>(pw + g * KS + jj);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float vv[C::E];
          load_cols<Tin, C::E>(vt + (jj + u) * C::ROW + lane * C::E, vv);
#pragma unroll
          for (int g = 0; g < GP; ++g) {
            const float p = u == 0 ? pv[g].x : u == 1 ? pv[g].y
                          : u == 2 ? pv[g].z : pv[g].w;
#pragma unroll
            for (int e = 0; e < C::E; ++e) acc[g][e] = fmaf(p, vv[e], acc[g][e]);
          }
        }
      }
    }
    __syncwarp();  // the stage and pw free again
  }

  // fold the warps: each writes (acc, m, l) over its own ring
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int w = 1; w < 32; w <<= 1)
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], w);
  float* fw = reinterpret_cast<float*>(ring);
  if (has_cols)
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int e = 0; e < C::E; ++e) fw[g * D + lane * C::E + e] = acc[g][e];
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      fw[GP * D + g] = m[g];
      fw[GP * D + GP + g] = l[g];
    }
  __syncthreads();
  const float* f0 = reinterpret_cast<const float*>(rings);
  constexpr int FSTRIDE = C::RING / 4;  // floats between two warps' areas
  const long long srow = ((long long)split * B + b) * H + h0;
  for (int idx = tid; idx < gc * D; idx += NW * 32) {
    const int g = idx / D, d = idx % D;
    float mx = NEG;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, f0[w * FSTRIDE + GP * D + g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float* fx = f0 + w * FSTRIDE;
      const float wt = expf(fx[GP * D + g] - mx);
      den += fx[GP * D + GP + g] * wt;
      num += fx[g * D + d] * wt;
    }
    if (nsplit == 1) {
      store(&out[b * L.ob + (h0 + g) * L.oh + d], num / (den == 0.f ? 1.f : den));
    } else {
      part_acc[(srow + g) * D + d] = num;
      if (d == 0) {
        part_ml[(srow + g) * 2] = mx;
        part_ml[(srow + g) * 2 + 1] = den;
      }
    }
  }
  if (nsplit == 1) return;

  // the last CTA of this (b, KV head, head group) to arrive folds the splits
  __threadfence();
  __syncthreads();
  int* ticket = tickets + (long long)b * gridDim.y + blockIdx.y;
  if (tid == 0) *last = atomicAdd(ticket, 1) == nsplit - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  const long long stride = (long long)B * H;
  const long long row0 = (long long)b * H + h0;
  for (int idx = tid; idx < gc * D; idx += NW * 32) {
    const int g = idx / D, d = idx % D;
    float mx = NEG;
    for (int sp = 0; sp < nsplit; ++sp)
      mx = fmaxf(mx, __ldcg(&part_ml[(sp * stride + row0 + g) * 2]));
    float den = 0.f, num = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) {
      const long long r = sp * stride + row0 + g;
      const float wt = expf(__ldcg(&part_ml[r * 2]) - mx);
      den += __ldcg(&part_ml[r * 2 + 1]) * wt;
      num += __ldcg(&part_acc[r * D + d]) * wt;
    }
    store(&out[b * L.ob + (h0 + g) * L.oh + d], num / (den == 0.f ? 1.f : den));
  }
  if (tid == 0) *ticket = 0;  // ready for the next launch
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

template <typename Tin, int D>
int prefill_t(const void* q, const void* k, const void* v, void* o,
              float* lse, const Layout& L, int B, int H, int G, int S, int T,
              int kv_valid, int causal, float scale, cudaStream_t stream) {
  static bool done = false;
  cudaError_t err =
      opt_in(flash_prefill_kernel<Tin, D>, Prefill<D>::SMEM, &done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  flash_prefill_kernel<Tin, D><<<grid, THREADS, Prefill<D>::SMEM, stream>>>(
      (const Tin*)q, (const Tin*)k, (const Tin*)v, (Tin*)o, lse, L, G, S, T,
      kv_valid, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int prefill_wgmma_t(const void* q, const void* k, const void* v, void* o,
                    float* lse, const Layout& L, int B, int H, int Hkv, int S,
                    int T, int kv_valid, int causal, float scale,
                    cudaStream_t stream) {
  using C = Wg<D>;
  static bool done = false;
  if (!done) {
    // setmaxnreg moves registers between the warps of the CTA: the launch
    // must hold the consumers' and the producer's counts
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, flash_prefill_wgmma_kernel<D>);
    if (err != cudaSuccess) return (int)err;
    if (attr.numRegs * C::THREADS <
        C::CONSUMERS * C::REGS_CONSUMER +
            (C::THREADS - C::CONSUMERS) * C::REGS_PRODUCER)
      return (int)cudaErrorInvalidConfiguration;
  }
  cudaError_t err = opt_in(flash_prefill_wgmma_kernel<D>, C::SMEM, &done);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tk, tv;
  if (!hopper::tensor_map(&tq, q, D, S, H, B, L.qs, L.qh, L.qb, C::BQ) ||
      !hopper::tensor_map(&tk, k, D, kv_valid, Hkv, B, L.ks, L.kh, L.kb,
                          C::BK) ||
      !hopper::tensor_map(&tv, v, D, kv_valid, Hkv, B, L.vs, L.vh, L.vb,
                          C::BK))
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = (float)((double)scale * 1.4426950408889634);
  const dim3 grid((unsigned)((S + C::BQ - 1) / C::BQ), (unsigned)H,
                  (unsigned)B);
  flash_prefill_wgmma_kernel<D><<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, lse, L.ob, L.oh, L.os, H / Hkv, S, T,
      kv_valid, causal, scale_log2);
  return (int)cudaGetLastError();
}

template <typename Tin, int D, int GP>
int decode_t(const void* q, const void* k, const void* v, void* o,
             const Layout& L, int B, int H, int G, int Hkv, int kv_valid,
             int chunk, int nsplit, float scale, float* part_acc,
             float* part_ml, int* tickets, cudaStream_t stream) {
  using C = Decode<Tin, D, GP>;
  static bool done = false;
  cudaError_t err = opt_in(flash_decode_kernel<Tin, D, GP>, C::SMEM, &done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)nsplit,
                  (unsigned)(Hkv * ((G + DEC_GC - 1) / DEC_GC)), (unsigned)B);
  flash_decode_kernel<Tin, D, GP><<<grid, C::NW * 32, C::SMEM, stream>>>(
      (const Tin*)q, (const Tin*)k, (const Tin*)v, (Tin*)o, part_acc, part_ml,
      tickets, L, B, H, G, kv_valid, chunk, nsplit, scale);
  return (int)cudaGetLastError();
}

// (CTAs resident on an SM, warps of a CTA) of one decode instantiation
template <typename Tin, int D, int GP>
int decode_shape_t(int* per_sm, int* warps) {
  using C = Decode<Tin, D, GP>;
  static bool done = false;
  cudaError_t err = opt_in(flash_decode_kernel<Tin, D, GP>, C::SMEM, &done);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, flash_decode_kernel<Tin, D, GP>, C::NW * 32, C::SMEM);
  *warps = C::NW;
  return (int)err;
}

Layout layout(long long qb, long long qh, long long qs, long long kb,
              long long kh, long long ks, long long vb, long long vh,
              long long vs, long long ob, long long oh, long long os) {
  return Layout{qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
}

}  // namespace

// q (B, H, S, D), k and v (B, Hkv, T, D), out (B, H, S, D), each given by
// its (b, head, position) strides in elements with the last axis
// contiguous, 16-byte aligned rows; fp32 (bf16 = 0) or bf16 (bf16 = 1).
// The CUDA-core prefill: D in {16, 64, 128, 256}; keys at or past kv_valid
// (<= T) are masked; causal needs T >= S.  With lse non-null each query
// row's natural log-sum-exp of its scaled logits goes there, fp32 (B, H,
// S) contiguous (what the backward, csrc/flash_attention_bwd.cu, reads);
// serving passes null.  Returns cudaErrorInvalidValue for a D it has no
// instantiation of.
extern "C" int flash_attention_prefill_launch(
    const void* q, const void* k, const void* v, void* o, long long qb,
    long long qh, long long qs, long long kb, long long kh, long long ks,
    long long vb, long long vh, long long vs, long long ob, long long oh,
    long long os, int B, int H, int Hkv, int S, int T, int D, int kv_valid,
    int causal, float scale, int bf16, void* lse, void* stream) {
  const Layout L = layout(qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os);
  const int G = H / Hkv;
  cudaStream_t st = (cudaStream_t)stream;
#define FA_PREFILL(T_, D_)                                                 \
  return prefill_t<T_, D_>(q, k, v, o, (float*)lse, L, B, H, G, S, T,      \
                           kv_valid, causal, scale, st)
#define FA_PREFILL_D(T_)          \
  switch (D) {                    \
    case 16: FA_PREFILL(T_, 16);  \
    case 64: FA_PREFILL(T_, 64);  \
    case 128: FA_PREFILL(T_, 128); \
    case 256: FA_PREFILL(T_, 256); \
  }
  if (bf16) {
    FA_PREFILL_D(__nv_bfloat16)
  } else {
    FA_PREFILL_D(float)
  }
#undef FA_PREFILL_D
#undef FA_PREFILL
  return (int)cudaErrorInvalidValue;
}

// The tensor-core prefill, bf16 only, D in {64, 128, 256}: the arguments of
// flash_attention_prefill_launch without the type.  Strides (of dims longer
// than 1) must be multiples of 8 elements and the pointers 16-byte aligned,
// as TMA reads them.  lse as there.
extern "C" int flash_attention_prefill_wgmma_launch(
    const void* q, const void* k, const void* v, void* o, long long qb,
    long long qh, long long qs, long long kb, long long kh, long long ks,
    long long vb, long long vh, long long vs, long long ob, long long oh,
    long long os, int B, int H, int Hkv, int S, int T, int D, int kv_valid,
    int causal, float scale, void* lse, void* stream) {
  const Layout L = layout(qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os);
  cudaStream_t st = (cudaStream_t)stream;
  float* ls = (float*)lse;
  switch (D) {
    case 64:
      return prefill_wgmma_t<64>(q, k, v, o, ls, L, B, H, Hkv, S, T,
                                 kv_valid, causal, scale, st);
    case 128:
      return prefill_wgmma_t<128>(q, k, v, o, ls, L, B, H, Hkv, S, T,
                                  kv_valid, causal, scale, st);
    case 256:
      return prefill_wgmma_t<256>(q, k, v, o, ls, L, B, H, Hkv, S, T,
                                  kv_valid, causal, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

#define FA_DECODE_DISPATCH(CALL)                                      \
  const int gp = heads_padded(G);                                     \
  switch (D * 16 + gp * 2 + (bf16 ? 1 : 0)) {                         \
    FA_DECODE_CASES(CALL, 16) FA_DECODE_CASES(CALL, 64)               \
    FA_DECODE_CASES(CALL, 128) FA_DECODE_CASES(CALL, 256)             \
  }
#define FA_DECODE_CASES(CALL, D_)                                      \
  case D_ * 16 + 2: CALL(float, D_, 1);                                \
  case D_ * 16 + 3: CALL(__nv_bfloat16, D_, 1);                        \
  case D_ * 16 + 8: CALL(float, D_, 4);                                \
  case D_ * 16 + 9: CALL(__nv_bfloat16, D_, 4);                        \
  case D_ * 16 + 16: CALL(float, D_, 8);                               \
  case D_ * 16 + 17: CALL(__nv_bfloat16, D_, 8);

// The S = 1 case, one launch: q (B, H, 1, D).  The keys [0, kv_valid) are
// cut into nsplit splits of `chunk` keys (a multiple of 16, none empty).
// With nsplit > 1, part_acc (nsplit, B, H, D) and part_ml (nsplit, B, H,
// 2) are fp32 scratch and tickets B x Hkv x ceil(G / 8) ints, zero at
// entry and left zero (launches that share them run in stream order).
extern "C" int flash_attention_decode_launch(
    const void* q, const void* k, const void* v, void* o, long long qb,
    long long qh, long long qs, long long kb, long long kh, long long ks,
    long long vb, long long vh, long long vs, long long ob, long long oh,
    long long os, int B, int H, int Hkv, int D, int kv_valid, int chunk,
    int nsplit, float scale, int bf16, void* part_acc, void* part_ml,
    void* tickets, void* stream) {
  const Layout L = layout(qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os);
  const int G = H / Hkv;
  cudaStream_t st = (cudaStream_t)stream;
#define FA_DECODE(T_, D_, GP_)                                              \
  return decode_t<T_, D_, GP_>(q, k, v, o, L, B, H, G, Hkv, kv_valid, chunk, \
                               nsplit, scale, (float*)part_acc,              \
                               (float*)part_ml, (int*)tickets, st)
  FA_DECODE_DISPATCH(FA_DECODE)
#undef FA_DECODE
  return (int)cudaErrorInvalidValue;
}

// CTAs of the decode instantiation for (D, type, G) resident on one SM
// (what = 0) or its warps (what = 1); negative on error.
extern "C" int flash_attention_decode_shape(int D, int bf16, int G,
                                            int what) {
  int per_sm = 0, warps = 0, err = (int)cudaErrorInvalidValue;
#define FA_SHAPE(T_, D_, GP_)                            \
  err = decode_shape_t<T_, D_, GP_>(&per_sm, &warps);    \
  break
  FA_DECODE_DISPATCH(FA_SHAPE)
#undef FA_SHAPE
  if (err != 0) return -err;
  return what ? warps : per_sm;
}

// Dynamic shared memory of one CTA: the CUDA-core prefill (kind 0), the
// tensor-core prefill (kind 1, bf16) or the decode kernel (kind 2, bf16,
// G = 4); -1 where there is no such instantiation.
extern "C" int flash_attention_smem(int D, int kind) {
  switch (D) {
    case 16: return kind == 0 ? Prefill<16>::SMEM
                  : kind == 2 ? Decode<__nv_bfloat16, 16, 4>::SMEM : -1;
    case 64: return kind == 0 ? Prefill<64>::SMEM
                  : kind == 1 ? Wg<64>::SMEM
                              : Decode<__nv_bfloat16, 64, 4>::SMEM;
    case 128: return kind == 0 ? Prefill<128>::SMEM
                   : kind == 1 ? Wg<128>::SMEM
                               : Decode<__nv_bfloat16, 128, 4>::SMEM;
    case 256: return kind == 0 ? Prefill<256>::SMEM
                   : kind == 1 ? Wg<256>::SMEM
                               : Decode<__nv_bfloat16, 256, 4>::SMEM;
  }
  return -1;
}
