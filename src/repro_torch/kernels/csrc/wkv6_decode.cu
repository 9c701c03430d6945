// RWKV-6 ("Finch") WKV recurrence at T = 1: one decode step, state in and
// out.
//
// Replaces the TPU kernel repro/kernels/wkv6.py (wkv6_pallas, pl.pallas_call
// at :69) at T = 1, the call every decode step makes per layer.  For r, k, w
// (B, H, 1, Dk), v (B, H, 1, Dv), u (H, Dk) and the state S (Dk, Dv) of each
// (b, h):
//
//     y = r (S + diag(u) k^T v)  =  r S + (sum_k r_k u_k k_k) v
//     S = diag(w) S + k^T v
//
// Bound on the H100: bytes.  The fp32 state is read and written once, 8.4
// MB at B = 8, H = 32, Dk = Dv = 64 (2.5 us at 3.35 TB/s); r, k, w, u, v
// and y are 0.3 MB.  The recurrent kernel (wkv6.cu), built for prefill,
// spends a decode step zero-filling a 32-step stage, summing 32 bonuses
// and crossing three barriers in 34.5 KB of shared memory (two waves of
// CTAs), and reads the state 16 bytes per row per warp.  Here nothing is
// staged: no shared memory, no barrier.  Each thread owns 4 adjacent
// columns of the rows k = l + 8 i (i < EPT), issues its EPT 16-byte state
// loads at once, and stores the new rows the same way; the 4 threads of a
// row class hold 64 contiguous bytes of a row, so a warp's load covers
// whole 32-byte sectors.  Every CTA of the grid (Dv / 64, H, B) is
// resident at once (256 CTAs of 128 threads at B = 8, H = 32), so the
// whole state is in flight together.
//
// Order of the sums: the plain version's (repro_torch/kernels/ref.py::wkv6)
// and the recurrent kernel's, so the three agree to the bit:
//   y_j    lane l of a column adds r_k S_kj over its rows k = l + 8 i in
//          order; the 8 lanes meet in the pairwise tree (xor shuffles over
//          the lane bits that hold l: 4, 8, 16, i.e. l's bits 0, 1, 2);
//   bonus  a = sum_k (r_k u_k) k_k as 32 lanes of rows lane + 32 m, then
//          the 32-lane xor tree; every warp sums it for itself (the same
//          bits), which spares a barrier;
//   y_j    = part_j + v_j a;  S_kj = w_k S_kj + k_k v_j;
// every product rounded before its add (__fmul_rn / __fadd_rn).  Rows past
// Dk up to 8 EPT are zeros, as the recurrent kernel's zero-filled stage.
//
// r, k, v fp32 or bf16, w fp32, u fp32 or bf16, read through their (b, head)
// strides (last axis contiguous, rows on 16-byte boundaries); y in r's type
// or fp32; the state fp32 contiguous, s_out may be s_in (each thread reads
// its elements before it writes them, and no other thread touches them).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 128;  // 4 warps x (8 row classes x 4 column quads)
constexpr int LANES = 8;      // row classes: lane l holds rows k = l + 8 i
constexpr int QUADS = 4;      // column quads per warp
constexpr int CW = THREADS / 32 * QUADS * 4;  // 64 columns per CTA
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// four consecutive values from a 16-byte (fp32) or 8-byte (bf16) boundary
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);  // exact upcasts
  return make_float4(__uint_as_float(q.x << 16),
                     __uint_as_float(q.x & 0xffff0000u),
                     __uint_as_float(q.y << 16),
                     __uint_as_float(q.y & 0xffff0000u));
}
__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&x)[4]) {
  uint2 q;
  q.x = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(x[0])) |
        ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(x[1])) << 16);
  q.y = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(x[2])) |
        ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(x[3])) << 16);
  *reinterpret_cast<uint2*>(p) = q;
}

struct Args {
  const void *r, *k, *v;
  const float* w;
  const void* u;
  const float* s_in;  // (B, H, Dk, Dv) or null for zeros
  float* s_out;       // (B, H, Dk, Dv) or null; may be s_in
  void* y;
  // strides in elements along (b, head)
  long long rb, rh, kb, kh, vb, vh, wb, wh, yb, yh;
  int H, Dk, Dv, u_bf16, y_f32;
};

template <typename Tin, int EPT>
__global__ void __launch_bounds__(THREADS) wkv6_decode_kernel(const Args a) {
  constexpr int DKP = LANES * EPT;  // rows held, padded
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int l = lane >> 2;  // row class, on lane bits 2..4
  const int j = blockIdx.x * CW + (warp * QUADS + (lane & 3)) * 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const bool col = j < a.Dv;  // Dv % 4 == 0: a quad is in or out whole
  const Tin* r = static_cast<const Tin*>(a.r) + b * a.rb + h * a.rh;
  const Tin* kp = static_cast<const Tin*>(a.k) + b * a.kb + h * a.kh;
  const float* w = a.w + b * a.wb + h * a.wh;
  const long long sbase = ((long long)b * a.H + h) * a.Dk * a.Dv + j;

  // the state's rows first, every load in flight at once
  float4 S[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int k = l + LANES * i;
    S[i] = a.s_in != nullptr && col && k < a.Dk
               ? __ldcs(reinterpret_cast<const float4*>(
                     a.s_in + sbase + (long long)k * a.Dv))
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float4 v4 = col ? load4(static_cast<const Tin*>(a.v) + b * a.vb +
                                h * a.vh + j)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  const float vj[4] = {v4.x, v4.y, v4.z, v4.w};
  float rr[EPT], kr[EPT], wr[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int k = l + LANES * i;
    const bool in = k < a.Dk;
    rr[i] = in ? to_f(r[k]) : 0.f;
    kr[i] = in ? to_f(kp[k]) : 0.f;
    wr[i] = in ? w[k] : 0.f;
  }

  // the bonus, in every warp: lanes over rows lane + 32 m, then the tree
  float bonus = 0.f;
#pragma unroll
  for (int m = 0; m * 32 < DKP; ++m) {
    const int k = lane + 32 * m;
    if (k < DKP) {
      float uk = 0.f, rk = 0.f, kk = 0.f;
      if (k < a.Dk) {
        uk = a.u_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(
                            a.u)[h * a.Dk + k])
                      : static_cast<const float*>(a.u)[h * a.Dk + k];
        rk = to_f(r[k]);
        kk = to_f(kp[k]);
      }
      const float p = __fmul_rn(__fmul_rn(rk, uk), kk);
      bonus = m == 0 ? p : __fadd_rn(bonus, p);
    }
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1)
    bonus = __fadd_rn(bonus, __shfl_xor_sync(FULL, bonus, off));

  // y: this lane's rows in order, then the tree over the 8 row classes
  float part[4], yv[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const float s = c == 0 ? S[i].x : c == 1 ? S[i].y : c == 2 ? S[i].z
                                                                 : S[i].w;
      const float p = __fmul_rn(rr[i], s);
      part[c] = i == 0 ? p : __fadd_rn(part[c], p);
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      part[c] = __fadd_rn(part[c], __shfl_xor_sync(FULL, part[c], off));
    yv[c] = __fadd_rn(part[c], __fmul_rn(vj[c], bonus));
  }
  if (l == 0 && col) {
    const long long at = b * a.yb + h * a.yh + j;
    if (a.y_f32)
      store4(static_cast<float*>(a.y) + at, yv);
    else
      store4(static_cast<Tin*>(a.y) + at, yv);
  }

  // the new state, 16 bytes a row
  if (a.s_out != nullptr && col) {
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int k = l + LANES * i;
      if (k < a.Dk) {
        float4 o;
        o.x = __fadd_rn(__fmul_rn(wr[i], S[i].x), __fmul_rn(kr[i], vj[0]));
        o.y = __fadd_rn(__fmul_rn(wr[i], S[i].y), __fmul_rn(kr[i], vj[1]));
        o.z = __fadd_rn(__fmul_rn(wr[i], S[i].z), __fmul_rn(kr[i], vj[2]));
        o.w = __fadd_rn(__fmul_rn(wr[i], S[i].w), __fmul_rn(kr[i], vj[3]));
        __stcs(reinterpret_cast<float4*>(a.s_out + sbase +
                                         (long long)k * a.Dv),
               o);
      }
    }
  }
}

template <typename Tin, int EPT>
int launch_t(const Args& a, int B, cudaStream_t stream) {
  const dim3 grid((unsigned)((a.Dv + CW - 1) / CW), (unsigned)a.H,
                  (unsigned)B);
  wkv6_decode_kernel<Tin, EPT><<<grid, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, w (B, H, 1, Dk), v (B, H, 1, Dv) and y (B, H, 1, Dv), each given by
// its (b, head) strides in elements, the last axis contiguous and rows on
// 16-byte boundaries; r, k, v fp32 (bf16 = 0) or bf16 (bf16 = 1), w fp32;
// u (H, Dk) contiguous, fp32 or bf16 (u_bf16); y in r's type or fp32
// (y_f32); s_in and s_out contiguous (B, H, Dk, Dv) fp32, either null
// (zeros in, no state out), and s_out may be s_in.  Dk <= 64 and Dv a
// multiple of 4; returns cudaErrorInvalidValue otherwise.
extern "C" int wkv6_decode_launch(const void* r, const void* k, const void* v,
                                  const void* w, const void* u,
                                  const void* s_in, void* s_out, void* y,
                                  long long rb, long long rh, long long kb,
                                  long long kh, long long vb, long long vh,
                                  long long wb, long long wh, long long yb,
                                  long long yh, int B, int H, int Dk, int Dv,
                                  int bf16, int u_bf16, int y_f32,
                                  void* stream) {
  const Args a{r,  k,  v,  (const float*)w, u,  (const float*)s_in,
               (float*)s_out,   y,  rb, rh, kb, kh, vb, vh, wb, wh,
               yb, yh, H,  Dk, Dv, u_bf16, y_f32};
  cudaStream_t st = (cudaStream_t)stream;
  if (Dv % 4 != 0) return (int)cudaErrorInvalidValue;
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
