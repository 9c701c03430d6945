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
// (the last axis contiguous), so the model's (B, S, H, D) projections are
// taken as they are; the products, the softmax state and the accumulator
// are fp32 on the CUDA cores, as the TPU kernel's astype(float32) dots.
//
// Prefill (S > 1): one CTA of 256 threads per (b, h, 64-query tile); a loop
// inside the CTA takes the place of the TPU's sequential KV grid axis.  The
// tile's queries sit in shared memory (transposed), each 64-key K tile is
// staged (transposed) and then its V tile in the same buffer, so a CTA holds
// 87 KB at D = 128 and two fit on an SM; D = 256 takes 157 KB, above the 48
// KB a launch gets by default, so every instantiation opts in to its size.
// Each thread owns 4 query rows x 4 keys of the logit tile and the same 4
// rows x D/16 columns of the accumulator, so the row's softmax state stays
// in its registers and the row reductions are 16-lane shuffles.  KV tiles
// wholly above the causal diagonal or at or past kv_valid are skipped: key 0
// is visible to every row (T >= S), so m is finite after the first tile and
// a fully masked tile would add exp(-1e30 - m) = 0 with alpha = 1; skipping
// it is exact.  The ragged S and T edges are masked here (no padding).
// Query tiles start from the last, whose causal work is the largest.
//
// Decode (S = 1): one CTA of 128 threads per (split of the keys, KV head,
// up to 8 query heads of its group, b), so that K and V are read once for
// all the group's heads and B x Hkv pairs still fill 132 SMs; only the first
// kv_valid keys are read.  64-key K and V tiles come in by cp.async, 16
// bytes a thread and the next tile in flight while this one is used, and
// stay in the operands' type in shared memory.  Each split writes its
// (m, l, acc) to a scratch buffer and a second kernel of this file combines
// the splits.
//
// Bound on the H100: operations at prefill (4 B H S T_eff D, T_eff = T / 2
// causal: 275 GFLOP at B = 8, H = 32, S = T = 2048, D = 128), bytes at
// decode (K and V of the valid prefix, 68 MB at B = 8, Hkv = 8, T = 2080).
// This design runs the products in fp32 on the CUDA cores (67 TFLOP/s), not
// on the tensor cores (989 TFLOP/s bf16): wgmma on bf16 operands, TMA
// staging and a ring of K/V tiles are the redesign of a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// ---------------------------------------------------------------- prefill
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
                     Layout L, int G, int S, int T, int kv_valid, int causal,
                     float scale) {
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
    const float den = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int cv = 0; cv < C::NV; ++cv)
#pragma unroll
      for (int e = 0; e < C::VEC; ++e)
        store(&ob[(long long)r * L.os + C::col(cv, tx, e)],
              acc[i][cv * C::VEC + e] / den);
  }
}

// ----------------------------------------------------------------- decode
constexpr int DT = 128;  // threads of a decode CTA
constexpr int BT = 64;   // keys per decode tile (2 per lane of a warp)
constexpr int GC = 8;    // query heads per decode CTA

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

template <typename Tin, int D>
struct Decode {
  static constexpr int N = Vec16<Tin>::N;
  static_assert(D % N == 0 && D <= 2 * DT, "D");
  // K and V tiles stay in the operands' type, rows padded by 16 bytes so
  // that 8 threads reading 16 bytes of 8 rows hit distinct banks
  static constexpr int ROW = D + N;
  static constexpr int TILE = BT * ROW;
  // two stages (the next tile in flight) where they fit
  static constexpr int STAGES = D * (int)sizeof(Tin) <= 512 ? 2 : 1;
  static constexpr int NCOL = (D + DT - 1) / DT;
  static constexpr int FLOATS = GC * D + GC * BT + 3 * GC;
  static constexpr int SMEM =
      FLOATS * 4 + STAGES * 2 * TILE * (int)sizeof(Tin);
  static_assert(FLOATS * 4 % 16 == 0, "align");
};

// cp.async the K and V rows [k0, k0 + BT) of a split (rows at or past t1
// zero-filled) into one stage's buffers
template <typename Tin, int D>
__device__ __forceinline__ void decode_issue(Tin* kd, Tin* vd,
                                             const Tin* kb, const Tin* vb,
                                             const Layout& L, int k0, int t1) {
  using C = Decode<Tin, D>;
  constexpr int VPR = D / C::N;  // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < BT * VPR; idx += DT) {
    const int j = idx / VPR, c = (idx % VPR) * C::N;
    const bool ok = k0 + j < t1;
    const long long row = ok ? k0 + j : 0;
    cp_async16(kd + j * C::ROW + c, kb + row * L.ks + c, ok);
    cp_async16(vd + j * C::ROW + c, vb + row * L.vs + c, ok);
  }
  cp_async_commit();
}

template <typename Tin, int D>
__global__ void __launch_bounds__(DT)
flash_decode_kernel(const Tin* __restrict__ q, const Tin* __restrict__ k,
                    const Tin* __restrict__ v, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, Layout L, int B, int H,
                    int G, int kv_valid, int chunk, float scale) {
  using C = Decode<Tin, D>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [GC][D]
  float* Ss = Qs + GC * D;                      // [GC][BT] logits, then p
  float* ms = Ss + GC * BT;
  float* ls = ms + GC;
  float* as = ls + GC;
  Tin* raw = reinterpret_cast<Tin*>(Qs + C::FLOATS);  // [STAGES][K, V]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, b = blockIdx.z;
  const int ngc = (G + GC - 1) / GC;
  const int hk = blockIdx.y / ngc, g0 = (blockIdx.y % ngc) * GC;
  const int gc = min(GC, G - g0);
  const int h0 = hk * G + g0;
  const int t0 = split * chunk, t1 = min(kv_valid, t0 + chunk);
  const int ntiles = (t1 - t0 + BT - 1) / BT;
  const Tin* kb = k + b * L.kb + hk * L.kh;
  const Tin* vb = v + b * L.vb + hk * L.vh;

  decode_issue<Tin, D>(raw, raw + C::TILE, kb, vb, L, t0, t1);
  for (int idx = tid; idx < gc * D; idx += DT) {
    const int g = idx / D, d = idx % D;
    Qs[g * D + d] = to_f(q[b * L.qb + (h0 + g) * L.qh + d]);
  }
  if (tid < GC) {
    ms[tid] = NEG;
    ls[tid] = 0.f;
  }
  float acc[GC][C::NCOL];
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int c = 0; c < C::NCOL; ++c) acc[g][c] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t0 + t * BT;
    if (C::STAGES == 2) {
      if (t + 1 < ntiles) {  // its stage was freed by the last tile's sync
        Tin* nxt = raw + ((t + 1) & 1) * 2 * C::TILE;
        decode_issue<Tin, D>(nxt, nxt + C::TILE, kb, vb, L, k0 + BT, t1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      if (t > 0) decode_issue<Tin, D>(raw, raw + C::TILE, kb, vb, L, k0, t1);
      cp_async_wait<0>();
    }
    __syncthreads();  // the tile (and Q) visible to every thread
    const Tin* kt = raw + (C::STAGES == 2 ? (t & 1) : 0) * 2 * C::TILE;
    const Tin* vt = kt + C::TILE;
    {
      const int j = tid % BT;
      for (int g = tid / BT; g < gc; g += DT / BT) {
        float dot = 0.f;
#pragma unroll 4
        for (int c = 0; c < D; c += C::N) {
          float kk[C::N];
          Vec16<Tin>::widen(kt + j * C::ROW + c, kk);
#pragma unroll
          for (int e = 0; e < C::N; ++e) dot = fmaf(Qs[g * D + c + e], kk[e], dot);
        }
        Ss[g * BT + j] = k0 + j < t1 ? dot * scale : NEG;
      }
    }
    __syncthreads();
    for (int g = warp; g < gc; g += DT / 32) {
      float a = Ss[g * BT + lane], c = Ss[g * BT + lane + 32];
      float mx = fmaxf(a, c);
#pragma unroll
      for (int w = 1; w < 32; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float mo = ms[g], mn = fmaxf(mo, mx);
      a = expf(a - mn);
      c = expf(c - mn);
      float sum = a + c;
#pragma unroll
      for (int w = 1; w < 32; w <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      Ss[g * BT + lane] = a;
      Ss[g * BT + lane + 32] = c;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(mo - mn);
        ls[g] = alpha * ls[g] + sum;
        ms[g] = mn;
        as[g] = alpha;
      }
    }
    __syncthreads();
    const int jmax = min(BT, t1 - k0);
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (g >= gc) break;
      const float al = as[g];
#pragma unroll
      for (int c = 0; c < C::NCOL; ++c) acc[g][c] *= al;
    }
    for (int j = 0; j < jmax; ++j) {
      float vv[C::NCOL];
#pragma unroll
      for (int c = 0; c < C::NCOL; ++c) {
        const int d = tid + c * DT;
        vv[c] = d < D ? to_f(vt[j * C::ROW + d]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        if (g >= gc) break;
        const float p = Ss[g * BT + j];
#pragma unroll
        for (int c = 0; c < C::NCOL; ++c) acc[g][c] = fmaf(p, vv[c], acc[g][c]);
      }
    }
    __syncthreads();  // this stage's buffers and Ss are free again
  }

  const long long row0 = ((long long)split * B + b) * H + h0;
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (g >= gc) break;
#pragma unroll
    for (int c = 0; c < C::NCOL; ++c) {
      const int d = tid + c * DT;
      if (d < D) part_acc[(row0 + g) * D + d] = acc[g][c];
    }
  }
  if (tid < gc) {
    part_ml[(row0 + tid) * 2] = ms[tid];
    part_ml[(row0 + tid) * 2 + 1] = ls[tid];
  }
}

// one CTA of D threads per (h, b): the splits' (m, l, acc) into the output
template <typename Tin>
__global__ void flash_combine_kernel(const float* __restrict__ part_acc,
                                     const float* __restrict__ part_ml,
                                     Tin* __restrict__ out, Layout L, int B,
                                     int H, int D, int nsplit) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const long long bh = (long long)b * H + h, stride = (long long)B * H;
  float mx = NEG;
  for (int s = 0; s < nsplit; ++s)
    mx = fmaxf(mx, part_ml[(s * stride + bh) * 2]);
  float den = 0.f, num = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float w = expf(part_ml[(s * stride + bh) * 2] - mx);
    den += part_ml[(s * stride + bh) * 2 + 1] * w;
    num += part_acc[(s * stride + bh) * D + d] * w;
  }
  store(&out[b * L.ob + h * L.oh + d], num / (den == 0.f ? 1.f : den));
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
              const Layout& L, int B, int H, int G, int S, int T,
              int kv_valid, int causal, float scale, cudaStream_t stream) {
  static bool done = false;
  cudaError_t err =
      opt_in(flash_prefill_kernel<Tin, D>, Prefill<D>::SMEM, &done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((S + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  flash_prefill_kernel<Tin, D><<<grid, THREADS, Prefill<D>::SMEM, stream>>>(
      (const Tin*)q, (const Tin*)k, (const Tin*)v, (Tin*)o, L, G, S, T,
      kv_valid, causal, scale);
  return (int)cudaGetLastError();
}

template <typename Tin, int D>
int decode_t(const void* q, const void* k, const void* v, void* o,
             const Layout& L, int B, int H, int G, int Hkv, int kv_valid,
             int chunk, int nsplit, float scale, float* part_acc,
             float* part_ml, cudaStream_t stream) {
  static bool done = false;
  cudaError_t err =
      opt_in(flash_decode_kernel<Tin, D>, Decode<Tin, D>::SMEM, &done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)nsplit, (unsigned)(Hkv * ((G + GC - 1) / GC)),
                  (unsigned)B);
  flash_decode_kernel<Tin, D><<<grid, DT, Decode<Tin, D>::SMEM, stream>>>(
      (const Tin*)q, (const Tin*)k, (const Tin*)v, part_acc, part_ml, L, B,
      H, G, kv_valid, chunk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_combine_kernel<Tin><<<dim3((unsigned)H, (unsigned)B), D, 0, stream>>>(
      part_acc, part_ml, (Tin*)o, L, B, H, D, nsplit);
  return (int)cudaGetLastError();
}

Layout layout(long long qb, long long qh, long long qs, long long kb,
              long long kh, long long ks, long long vb, long long vh,
              long long vs, long long ob, long long oh, long long os) {
  return Layout{qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
}

}  // namespace

// q (B, H, S, D), k and v (B, Hkv, T, D), out (B, H, S, D), each given by
// its (b, head, position) strides in elements with the last axis
// contiguous, 16-byte aligned rows; fp32 (bf16 = 0) or bf16 (bf16 = 1).  D in {16, 64, 128,
// 256}; keys at or past kv_valid (<= T) are masked; causal needs T >= S.
// Returns cudaErrorInvalidValue for a D it has no instantiation of.
extern "C" int flash_attention_prefill_launch(
    const void* q, const void* k, const void* v, void* o, long long qb,
    long long qh, long long qs, long long kb, long long kh, long long ks,
    long long vb, long long vh, long long vs, long long ob, long long oh,
    long long os, int B, int H, int Hkv, int S, int T, int D, int kv_valid,
    int causal, float scale, int bf16, void* stream) {
  const Layout L = layout(qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os);
  const int G = H / Hkv;
  cudaStream_t st = (cudaStream_t)stream;
#define FA_PREFILL(T_, D_)                                                 \
  return prefill_t<T_, D_>(q, k, v, o, L, B, H, G, S, T, kv_valid, causal, \
                           scale, st)
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

// The S = 1 case: q (B, H, 1, D).  The keys [0, kv_valid) are cut into
// nsplit splits of `chunk` keys (a multiple of 64, none empty); part_acc
// (nsplit, B, H, D) and part_ml (nsplit, B, H, 2) are fp32 scratch.
extern "C" int flash_attention_decode_launch(
    const void* q, const void* k, const void* v, void* o, long long qb,
    long long qh, long long qs, long long kb, long long kh, long long ks,
    long long vb, long long vh, long long vs, long long ob, long long oh,
    long long os, int B, int H, int Hkv, int D, int kv_valid, int chunk,
    int nsplit, float scale, int bf16, void* part_acc, void* part_ml,
    void* stream) {
  const Layout L = layout(qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os);
  const int G = H / Hkv;
  cudaStream_t st = (cudaStream_t)stream;
#define FA_DECODE(T_, D_)                                                   \
  return decode_t<T_, D_>(q, k, v, o, L, B, H, G, Hkv, kv_valid, chunk,     \
                          nsplit, scale, (float*)part_acc, (float*)part_ml, \
                          st)
#define FA_DECODE_D(T_)          \
  switch (D) {                   \
    case 16: FA_DECODE(T_, 16);  \
    case 64: FA_DECODE(T_, 64);  \
    case 128: FA_DECODE(T_, 128); \
    case 256: FA_DECODE(T_, 256); \
  }
  if (bf16) {
    FA_DECODE_D(__nv_bfloat16)
  } else {
    FA_DECODE_D(float)
  }
#undef FA_DECODE_D
#undef FA_DECODE
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one CTA: prefill (decode = 0) or decode (bf16
// operands).
extern "C" int flash_attention_smem(int D, int decode) {
  switch (D) {
    case 16: return decode ? Decode<__nv_bfloat16, 16>::SMEM : Prefill<16>::SMEM;
    case 64: return decode ? Decode<__nv_bfloat16, 64>::SMEM : Prefill<64>::SMEM;
    case 128: return decode ? Decode<__nv_bfloat16, 128>::SMEM : Prefill<128>::SMEM;
    case 256: return decode ? Decode<__nv_bfloat16, 256>::SMEM : Prefill<256>::SMEM;
  }
  return -1;
}
