// RWKV-6 ("Finch") WKV recurrence with a data-dependent decay.
//
// Replaces the TPU kernel repro/kernels/wkv6.py (wkv6_pallas, pl.pallas_call
// at :69).  For r, k, w (B, H, T, Dk), v (B, H, T, Dv), u (H, Dk) and a state
// S (Dk, Dv) per (b, h), zeros or given:
//
//     y_t = r_t (S + diag(u) k_t^T v_t)  =  r_t S + (sum_k r_k u_k k_k) v_t
//     S   = diag(w_t) S + k_t^T v_t
//
// y is written in r's type or in fp32; the final state in fp32.  Operands r,
// k, v are fp32 or bf16 and w is fp32 (a decay just below 1.0 does not
// survive bf16), all read through their (b, head, position) strides with the
// last axis contiguous and 16-byte rows, so the model's (B, S, H, D)
// projections are taken as they are; u is fp32 or bf16.
//
// The TPU kernel walks time as a sequential grid axis with the state in VMEM
// scratch.  Here one CTA walks all of T in a loop, with the state in
// registers, and nothing carries between CTAs: column j of S and y_j depend
// on no other column, so a CTA owns (b, h, 16 columns) and the grid is
// (Dv / 16, H, B), 128 CTAs at B = 1 and H = 32.  In the CTA, 8 lanes share a
// column: lane l holds the rows k = l + 8 i (i < EPT = Dk / 8, rows past Dk
// zero), so each step is an update of EPT state values per thread and the
// sum over k is EPT adds in order and a 3-level xor-shuffle tree.  The bonus
// a_t = sum_k (r_k u_k) k_k does not depend on the column: one warp per step
// sums it over 32 lanes (rows k = lane + 32 m) for the whole chunk first.
// Chunks of 32 steps of r, k, w and the CTA's v columns are staged in shared
// memory by cp.async, 16 bytes a thread, the next chunk in flight while this
// one is used; rows past Dk and steps past T are zero-filled, so T is any
// length (no padding) and Dk any multiple of 8 (bf16) or 4 (fp32) up to 64.
//
// Every product is rounded before its add (__fmul_rn / __fadd_rn, no fused
// multiply-add) and the sums run in the order above, which the plain version
// (repro_torch/kernels/ref.py::wkv6) repeats op for op: the two agree to the
// bit.
//
// Bound on the H100: operations at prefill (5 Dk Dv per step and (b, h): the
// state update and r S; 10.7 GFLOP at B = 8, H = 32, T = 2048, D = 64, 0.16
// ms at the fp32 rate), bytes at decode (the fp32 state read and written:
// 8.4 MB at B = 8).  This design does 5 unfused operations and 3 shared
// loads per state value and step on the CUDA cores; the chunked form on the
// tensor cores is the redesign of a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;  // 4 warps x (4 columns x 8 lanes)
constexpr int LANES = 8;      // lanes sharing one column
constexpr int CW = 16;        // columns per CTA
constexpr int BT = 32;        // steps per staged chunk
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

struct Args {
  const void *r, *k, *v;
  const float* w;
  const void* u;
  const float* s_in;  // (B, H, Dk, Dv) or null for zeros
  float* s_out;       // (B, H, Dk, Dv) or null; may be s_in
  void* y;
  // strides in elements along (b, head, position)
  long long rb, rh, rt, kb, kh, kt, vb, vh, vt, wb, wh, wt, yb, yh, yt;
  int H, T, Dk, Dv, u_bf16, y_f32;
};

template <typename Tin, int EPT>
struct Cfg {
  static constexpr int DKP = LANES * EPT;          // rows held, padded
  static constexpr int VR = 16 / sizeof(Tin);      // elements per 16 bytes
  static constexpr int RK = BT * DKP * sizeof(Tin);
  static constexpr int WB = BT * DKP * 4;
  static constexpr int VB = BT * CW * sizeof(Tin);
  static constexpr int STAGE = 2 * RK + WB + VB + BT * 4;
  static constexpr int U = DKP * 4;
  static constexpr int SMEM = U + 2 * STAGE;
  static_assert(RK % 16 == 0 && VB % 16 == 0 && STAGE % 16 == 0 &&
                    U % 16 == 0 && DKP % 4 == 0 && CW % VR == 0,
                "align");
};

// cp.async steps [t0, t0 + BT) of r, k, w (all DKP rows) and of the CTA's v
// columns [j0, j0 + CW) into one stage; rows >= Dk, columns >= Dv and steps
// >= T zero-filled
template <typename Tin, int EPT>
__device__ __forceinline__ void stage_chunk(char* st, const Tin* rb,
                                            const Tin* kb, const float* wb,
                                            const Tin* vb, const Args& a,
                                            int t0, int j0) {
  using C = Cfg<Tin, EPT>;
  Tin* rs = reinterpret_cast<Tin*>(st);
  Tin* ks = reinterpret_cast<Tin*>(st + C::RK);
  float* ws = reinterpret_cast<float*>(st + 2 * C::RK);
  Tin* vs = reinterpret_cast<Tin*>(st + 2 * C::RK + C::WB);
  constexpr int UR = C::DKP / C::VR;  // 16-byte units of an r or k row
  for (int idx = threadIdx.x; idx < BT * UR; idx += THREADS) {
    const int tt = idx / UR, c = (idx % UR) * C::VR;
    const bool ok = t0 + tt < a.T && c < a.Dk;
    const long long t = ok ? t0 + tt : 0;
    cp_async16(rs + tt * C::DKP + c, rb + t * a.rt + (ok ? c : 0), ok);
    cp_async16(ks + tt * C::DKP + c, kb + t * a.kt + (ok ? c : 0), ok);
  }
  constexpr int UW = C::DKP / 4;
  for (int idx = threadIdx.x; idx < BT * UW; idx += THREADS) {
    const int tt = idx / UW, c = (idx % UW) * 4;
    const bool ok = t0 + tt < a.T && c < a.Dk;
    const long long t = ok ? t0 + tt : 0;
    cp_async16(ws + tt * C::DKP + c, wb + t * a.wt + (ok ? c : 0), ok);
  }
  constexpr int UV = CW / C::VR;
  for (int idx = threadIdx.x; idx < BT * UV; idx += THREADS) {
    const int tt = idx / UV, c = (idx % UV) * C::VR;
    const bool ok = t0 + tt < a.T && j0 + c < a.Dv;
    const long long t = ok ? t0 + tt : 0;
    cp_async16(vs + tt * CW + c, vb + t * a.vt + (ok ? j0 + c : 0), ok);
  }
  cp_async_commit();
}

template <typename Tin, int EPT>
__global__ void __launch_bounds__(THREADS) wkv6_kernel(const Args a) {
  using C = Cfg<Tin, EPT>;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  float* us = reinterpret_cast<float*>(smem);  // [DKP]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int l8 = lane & (LANES - 1);
  const int jl = warp * (32 / LANES) + lane / LANES;  // column in the CTA
  const int j0 = blockIdx.x * CW, j = j0 + jl;
  const int h = blockIdx.y, b = blockIdx.z;
  const bool col = j < a.Dv;
  const Tin* rb = static_cast<const Tin*>(a.r) + b * a.rb + h * a.rh;
  const Tin* kb = static_cast<const Tin*>(a.k) + b * a.kb + h * a.kh;
  const Tin* vb = static_cast<const Tin*>(a.v) + b * a.vb + h * a.vh;
  const float* wb = a.w + b * a.wb + h * a.wh;
  const long long yoff = b * a.yb + h * a.yh + j;
  const long long soff = ((long long)b * a.H + h) * a.Dk * a.Dv + j;

  const int nchunks = (a.T + BT - 1) / BT;
  stage_chunk<Tin, EPT>(smem + C::U, rb, kb, wb, vb, a, 0, j0);
  for (int i = tid; i < C::DKP; i += THREADS) {
    float x = 0.f;
    if (i < a.Dk)
      x = a.u_bf16
              ? __bfloat162float(
                    static_cast<const __nv_bfloat16*>(a.u)[h * a.Dk + i])
              : static_cast<const float*>(a.u)[h * a.Dk + i];
    us[i] = x;
  }
  float S[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int k = l8 + LANES * i;
    S[i] = a.s_in != nullptr && col && k < a.Dk
               ? a.s_in[soff + (long long)k * a.Dv]
               : 0.f;
  }

  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {  // its stage was freed by the last chunk's sync
      stage_chunk<Tin, EPT>(smem + C::U + ((c + 1) & 1) * C::STAGE, rb, kb,
                            wb, vb, a, (c + 1) * BT, j0);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c (and u) visible to every thread
    char* st = smem + C::U + (c & 1) * C::STAGE;
    const Tin* rs = reinterpret_cast<const Tin*>(st);
    const Tin* ks = reinterpret_cast<const Tin*>(st + C::RK);
    const float* ws = reinterpret_cast<const float*>(st + 2 * C::RK);
    const Tin* vs = reinterpret_cast<const Tin*>(st + 2 * C::RK + C::WB);
    float* as = reinterpret_cast<float*>(st + 2 * C::RK + C::WB + C::VB);
    // the bonus a_t of every step of the chunk: one warp per step
    for (int tt = warp; tt < BT; tt += THREADS / 32) {
      float x = 0.f;
#pragma unroll
      for (int m = 0; m * 32 < C::DKP; ++m) {
        const int k = lane + 32 * m;
        if (k < C::DKP) {
          const float p = __fmul_rn(
              __fmul_rn(to_f(rs[tt * C::DKP + k]), us[k]),
              to_f(ks[tt * C::DKP + k]));
          x = m == 0 ? p : __fadd_rn(x, p);
        }
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
        x = __fadd_rn(x, __shfl_xor_sync(FULL, x, off));
      if (lane == 0) as[tt] = x;
    }
    __syncthreads();
    const int t0 = c * BT, nt = min(BT, a.T - t0);
    for (int tt = 0; tt < nt; ++tt) {
      const float vj = to_f(vs[tt * CW + jl]);
      const Tin* rr = rs + tt * C::DKP;
      const Tin* kr = ks + tt * C::DKP;
      const float* wr = ws + tt * C::DKP;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        const int k = l8 + LANES * i;
        const float p = __fmul_rn(to_f(rr[k]), S[i]);
        part = i == 0 ? p : __fadd_rn(part, p);
        S[i] = __fadd_rn(__fmul_rn(wr[k], S[i]), __fmul_rn(to_f(kr[k]), vj));
      }
#pragma unroll
      for (int off = 1; off < LANES; off <<= 1)
        part = __fadd_rn(part, __shfl_xor_sync(FULL, part, off));
      if (l8 == 0 && col) {
        const float y = __fadd_rn(part, __fmul_rn(vj, as[tt]));
        const long long at = yoff + (long long)(t0 + tt) * a.yt;
        if (a.y_f32)
          static_cast<float*>(a.y)[at] = y;
        else
          store(static_cast<Tin*>(a.y) + at, y);
      }
    }
    __syncthreads();  // this stage is free again
  }

  if (a.s_out != nullptr && col) {
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int k = l8 + LANES * i;
      if (k < a.Dk) a.s_out[soff + (long long)k * a.Dv] = S[i];
    }
  }
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

template <typename Tin, int EPT>
int launch_t(const Args& a, int B, cudaStream_t stream) {
  static bool done = false;
  cudaError_t err = opt_in(wkv6_kernel<Tin, EPT>, Cfg<Tin, EPT>::SMEM, &done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((a.Dv + CW - 1) / CW), (unsigned)a.H,
                  (unsigned)B);
  wkv6_kernel<Tin, EPT>
      <<<grid, THREADS, Cfg<Tin, EPT>::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, w (B, H, T, Dk), v (B, H, T, Dv) and y (B, H, T, Dv), each given by
// its (b, head, position) strides in elements, the last axis contiguous and
// rows on 16-byte boundaries; r, k, v fp32 (bf16 = 0) or bf16 (bf16 = 1), w
// fp32; u (H, Dk) contiguous, fp32 or bf16 (u_bf16); y in r's type or fp32
// (y_f32); s_in and s_out contiguous (B, H, Dk, Dv) fp32, either null (zeros
// in, no state out), and s_out may be s_in.  Dk <= 64 with Dk * size a
// multiple of 16 bytes, and so Dv; returns cudaErrorInvalidValue for a Dk
// past the instantiations.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s_in,
                           void* s_out, void* y, long long rb, long long rh,
                           long long rt, long long kb, long long kh,
                           long long kt, long long vb, long long vh,
                           long long vt, long long wb, long long wh,
                           long long wt, long long yb, long long yh,
                           long long yt, int B, int H, int T, int Dk, int Dv,
                           int bf16, int u_bf16, int y_f32, void* stream) {
  const Args a{r,  k,  v,  (const float*)w, u,  (const float*)s_in,
               (float*)s_out,   y,  rb, rh, rt, kb, kh, kt, vb, vh,
               vt, wb, wh, wt,  yb, yh, yt, H,  T,  Dk, Dv, u_bf16,
               y_f32};
  cudaStream_t st = (cudaStream_t)stream;
#define WKV_EPT(T_)                                    \
  if (Dk <= 16) return launch_t<T_, 2>(a, B, st);      \
  if (Dk <= 32) return launch_t<T_, 4>(a, B, st);      \
  if (Dk <= 64) return launch_t<T_, 8>(a, B, st);
  if (bf16) {
    WKV_EPT(__nv_bfloat16)
  } else {
    WKV_EPT(float)
  }
#undef WKV_EPT
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one CTA for a Dk (bf16 or fp32 operands).
extern "C" int wkv6_smem(int Dk, int bf16) {
  if (Dk <= 16)
    return bf16 ? Cfg<__nv_bfloat16, 2>::SMEM : Cfg<float, 2>::SMEM;
  if (Dk <= 32)
    return bf16 ? Cfg<__nv_bfloat16, 4>::SMEM : Cfg<float, 4>::SMEM;
  if (Dk <= 64)
    return bf16 ? Cfg<__nv_bfloat16, 8>::SMEM : Cfg<float, 8>::SMEM;
  return -1;
}
