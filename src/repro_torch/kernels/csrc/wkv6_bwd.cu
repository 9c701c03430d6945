// RWKV-6 WKV recurrence, backward.
//
// Replaces no TPU kernel: the JAX package differentiates its recurrence with
// jax.value_and_grad (repro/train/train_step.py:67 through
// repro/models/layers.py::gla_chunked), and no Pallas backward exists to
// follow.  It is the gradient of csrc/wkv6.cu's function, which training
// needs on the card.  For the forward
//
//     y_t = r_t (S_{t-1} + diag(u) k_t^T v_t),   S_t = diag(w_t) S_{t-1} + k_t^T v_t
//
// from S_0 (zeros or given) and the gradients dy (B, H, T, Dv) and dS_T
// (zeros or given), it walks t = T-1 ... 0 carrying G = dL/dS_t in fp32:
//
//     c_t = v_t . dy_t,  a_t = r_t . (u * k_t)
//     dr_t = S_{t-1} dy_t + c_t (u * k_t)      dk_t = G v_t + c_t (u * r_t)
//     dv_t = G^T k_t + a_t dy_t                 dw_t[i] = sum_j G[i,j] S_{t-1}[i,j]
//     du  += c_t (r_t * k_t)                    G <- diag(w_t) G + r_t^T dy_t
//
// and writes G as dS_0 at the end.  dr, dk, dv are written in r's type, dw
// and dS_0 in fp32, du in u's type; every sum is fp32.
//
// S_{t-1} in reverse time: inverting the update, S_{t-1} = (S_t - k v)/w,
// would amplify the rounding by 1/w a step (w = 1e-6 is a legal decay).  So
// a forward sweep first keeps the state at the start of every chunk of C
// steps in global scratch (ck), and the backward sweep recomputes each
// chunk's C states from its checkpoint into shared memory before walking
// the chunk backward.
//
// One CTA per (b, h) holds the whole state, so every sum over the state's
// columns (dr, dk, dw) and rows (dv) stays in the CTA, and no float atomic
// is used: a second call gives the same bits.  The state is padded to DKP
// rows x DVP = CPT * TC columns; thread (row i, lane group g) holds columns
// [g CPT, (g + 1) CPT) of row i, TC lanes share a row and a warp holds
// RPW = 32 / TC rows.  A column sum is CPT adds in order in the thread,
// then an xor-shuffle tree over the TC lanes; a row sum (G^T k) an
// xor-shuffle tree over the warp's RPW rows, then the warps in order
// through shared memory after each chunk.  a_t and c_t are summed by one
// warp a step (32 lanes, then a tree), du by each row's thread over t from
// T - 1 down, then over b in order by a second launch.  Every product is
// rounded before its add (__fmul_rn / __fadd_rn, no fused multiply-add):
// the plain version (repro_torch/kernels/ref.py::wkv6_backward) repeats
// this order op for op, so the two agree to the bit.
//
// r, k, v, dy and the outputs dr, dk, dv, dw are read and written through
// their (b, head, position) strides with the last axis contiguous, so the
// model's (B, T, H, D) projections and autograd's dy go in as they are.
//
// Bound on the H100: bytes at the model's shapes (r, k, v, w, dy read, dr,
// dk, dv, dw written: ~14 Dk Dv operations a step and head against
// ~(5 Dk + 2 Dv) elements).  This first design runs on the CUDA cores,
// recomputes the forward twice (the checkpoint sweep, then each chunk) and
// does its sums by shuffles a step; one CTA a head leaves B * H CTAs (128
// at rwkv6-1.6b's training microbatch).  The chunked form on the tensor
// cores is a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
// operands with (b, head, position) strides, in this order
enum { R_, K_, V_, W_, DY_, DR_, DK_, DV_, DW_, NOPS };

struct Args {
  const void *r, *k, *v;
  const float* w;
  const void* u;
  const float* s0;   // (B, H, Dk, Dv) or null for zeros
  const void* dy;
  const float* dsT;  // (B, H, Dk, Dv) or null for zeros
  void *dr, *dk, *dv;
  float* dw;
  float* dup;  // (B, H, Dk): du summed over t, per (b, h)
  float* ds0;  // (B, H, Dk, Dv)
  float* ck;   // (B, H, nc, DKP * DVP): the state at each chunk's start
  long long st[3 * NOPS];
  int H, T, Dk, Dv, bf16, u_bf16, dy_bf16;
};

__device__ __forceinline__ float ld(const void* p, long long i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}
__device__ __forceinline__ void put(void* p, long long i, float x,
                                    bool bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(p)[i] = x;
}

template <int DKP, int CPT, int TC>
struct Tile {
  static constexpr int DVP = CPT * TC;
  static constexpr int NT = DKP * TC;
  static constexpr int RPW = 32 / TC;
  static constexpr int NW = NT / 32;
  static constexpr int STATE = DKP * DVP;  // floats
  // steps a chunk: its states in 64 KB (DKP = 16: many heads, several
  // CTAs an SM) or 128 KB (DKP = 64) of shared memory, at most 32
  static constexpr int BUDGET = DKP == 64 ? 32768 : 16384;
  static constexpr int C = BUDGET / STATE < 32 ? BUDGET / STATE : 32;
  // shared memory layout, in floats
  static constexpr int O_ST = 0;  // C states, thread-private
  static constexpr int O_U = O_ST + C * STATE;
  static constexpr int O_R = O_U + DKP;  // the chunk's r, k, w
  static constexpr int O_K = O_R + C * DKP;
  static constexpr int O_W = O_K + C * DKP;
  static constexpr int O_V = O_W + C * DKP;  // its v, dy
  static constexpr int O_DY = O_V + C * DVP;
  static constexpr int O_A = O_DY + C * DVP;  // a_t, c_t
  static constexpr int O_C = O_A + C;
  static constexpr int O_P = O_C + C;  // each warp's row sums of G^T k
  static constexpr int O_OR = O_P + C * NW * DVP;  // dr, dk, dw
  static constexpr int O_OK = O_OR + C * DKP;
  static constexpr int O_OW = O_OK + C * DKP;
  static constexpr int SMEM = (O_OW + C * DKP) * 4;
  static_assert(NT % 32 == 0 && DKP % RPW == 0 && C >= 1, "tile");
};

template <int DKP, int CPT, int TC>
__global__ void __launch_bounds__(DKP* TC) wkv6_bwd_kernel(const Args a) {
  using P = Tile<DKP, CPT, TC>;
  constexpr int C = P::C, DVP = P::DVP, NT = P::NT, NW = P::NW,
                RPW = P::RPW;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane % TC, rw = lane / TC;
  const int i = warp * RPW + rw;  // this thread's row
  const int j0 = g * CPT;         // its first column
  const int h = blockIdx.x, b = blockIdx.y;
  const long long bh = (long long)b * a.H + h;
  const bool row = i < a.Dk;
  const int nc = (a.T + C - 1) / C;
  long long base[NOPS];
#pragma unroll
  for (int q = 0; q < NOPS; ++q)
    base[q] = b * a.st[3 * q] + h * a.st[3 * q + 1];
  float* ckb = a.ck + bh * nc * (long long)P::STATE;

  for (int x = tid; x < DKP; x += NT)
    sm[P::O_U + x] = x < a.Dk ? ld(a.u, (long long)h * a.Dk + x, a.u_bf16)
                              : 0.f;
  __syncthreads();  // u visible (the forward sweep may have no sync)
  // steps [t0, t0 + len) of k, w, v (and r, dy with back) into shared
  // memory as fp32, rows past Dk, columns past Dv and steps past len zero
  auto stage = [&](int t0, int len, bool back) {
    for (int x = tid; x < C * DKP; x += NT) {
      const int s = x / DKP, c = x % DKP;
      const bool ok = s < len && c < a.Dk;
      const long long t = t0 + s;
      sm[P::O_K + x] =
          ok ? ld(a.k, base[K_] + t * a.st[3 * K_ + 2] + c, a.bf16) : 0.f;
      sm[P::O_W + x] = ok ? a.w[base[W_] + t * a.st[3 * W_ + 2] + c] : 0.f;
      if (back)
        sm[P::O_R + x] =
            ok ? ld(a.r, base[R_] + t * a.st[3 * R_ + 2] + c, a.bf16) : 0.f;
    }
    for (int x = tid; x < C * DVP; x += NT) {
      const int s = x / DVP, c = x % DVP;
      const bool ok = s < len && c < a.Dv;
      const long long t = t0 + s;
      sm[P::O_V + x] =
          ok ? ld(a.v, base[V_] + t * a.st[3 * V_ + 2] + c, a.bf16) : 0.f;
      if (back)
        sm[P::O_DY + x] =
            ok ? ld(a.dy, base[DY_] + t * a.st[3 * DY_ + 2] + c, a.dy_bf16)
               : 0.f;
    }
  };
  // S <- diag(w_s) S + k_s^T v_s, this thread's part, step s of the stage
  auto advance = [&](float* S, int s) {
    const float kk = sm[P::O_K + s * DKP + i], ww = sm[P::O_W + s * DKP + i];
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      S[c] = __fadd_rn(__fmul_rn(ww, S[c]),
                       __fmul_rn(kk, sm[P::O_V + s * DVP + j0 + c]));
  };

  // forward sweep: the state at the start of every chunk into ck
  {
    float S[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = j0 + c;
      S[c] = a.s0 != nullptr && row && j < a.Dv
                 ? a.s0[(bh * a.Dk + i) * a.Dv + j]
                 : 0.f;
    }
    for (int ch = 0; ch < nc; ++ch) {
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        ckb[((long long)ch * CPT + c) * NT + tid] = S[c];
      if (ch + 1 == nc) break;
      __syncthreads();  // the last chunk's stage is read
      stage(ch * C, C, false);
      __syncthreads();
      for (int s = 0; s < C; ++s) advance(S, s);
    }
  }

  // backward sweep, a chunk at a time from the last
  float G[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int j = j0 + c;
    G[c] = a.dsT != nullptr && row && j < a.Dv
               ? a.dsT[(bh * a.Dk + i) * a.Dv + j]
               : 0.f;
  }
  const float ui = sm[P::O_U + i];  // visible: syncs since it was staged
  float du = 0.f;
  for (int ch = nc - 1; ch >= 0; --ch) {
    const int t0 = ch * C, len = min(C, a.T - t0);
    __syncthreads();  // the last chunk's shared memory is read
    stage(t0, len, true);
    __syncthreads();
    // a_t and c_t, one warp a step
    for (int s = warp; s < C; s += NW) {
      float x = 0.f, y = 0.f;
#pragma unroll
      for (int m = 0; m * 32 < DKP; ++m) {
        const int c = lane + 32 * m;
        if (c < DKP) {
          const float p = __fmul_rn(
              __fmul_rn(sm[P::O_R + s * DKP + c], sm[P::O_U + c]),
              sm[P::O_K + s * DKP + c]);
          x = m == 0 ? p : __fadd_rn(x, p);
        }
      }
#pragma unroll
      for (int m = 0; m * 32 < DVP; ++m) {
        const int c = lane + 32 * m;
        if (c < DVP) {
          const float p =
              __fmul_rn(sm[P::O_V + s * DVP + c], sm[P::O_DY + s * DVP + c]);
          y = m == 0 ? p : __fadd_rn(y, p);
        }
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        x = __fadd_rn(x, __shfl_xor_sync(FULL, x, off));
        y = __fadd_rn(y, __shfl_xor_sync(FULL, y, off));
      }
      if (lane == 0) {
        sm[P::O_A + s] = x;
        sm[P::O_C + s] = y;
      }
    }
    // the chunk's states S_{t-1}, recomputed from its checkpoint
    {
      float S[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        S[c] = ckb[((long long)ch * CPT + c) * NT + tid];
      for (int s = 0; s < len; ++s) {
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          sm[P::O_ST + (s * CPT + c) * NT + tid] = S[c];
        if (s + 1 < len) advance(S, s);
      }
    }
    __syncthreads();  // a_t, c_t visible
    for (int s = len - 1; s >= 0; --s) {
      const float rr = sm[P::O_R + s * DKP + i];
      const float kk = sm[P::O_K + s * DKP + i];
      const float ww = sm[P::O_W + s * DKP + i];
      float sr = 0.f, sk = 0.f, sw = 0.f, col[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float sp = sm[P::O_ST + (s * CPT + c) * NT + tid];
        const float dyj = sm[P::O_DY + s * DVP + j0 + c];
        const float pr = __fmul_rn(sp, dyj);
        const float pk = __fmul_rn(G[c], sm[P::O_V + s * DVP + j0 + c]);
        const float pw = __fmul_rn(G[c], sp);
        sr = c == 0 ? pr : __fadd_rn(sr, pr);
        sk = c == 0 ? pk : __fadd_rn(sk, pk);
        sw = c == 0 ? pw : __fadd_rn(sw, pw);
        col[c] = __fmul_rn(G[c], kk);
        G[c] = __fadd_rn(__fmul_rn(ww, G[c]), __fmul_rn(rr, dyj));
      }
#pragma unroll
      for (int off = 1; off < TC; off <<= 1) {
        sr = __fadd_rn(sr, __shfl_xor_sync(FULL, sr, off));
        sk = __fadd_rn(sk, __shfl_xor_sync(FULL, sk, off));
        sw = __fadd_rn(sw, __shfl_xor_sync(FULL, sw, off));
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
#pragma unroll
        for (int off = TC; off < 32; off <<= 1)
          col[c] = __fadd_rn(col[c], __shfl_xor_sync(FULL, col[c], off));
        if (c % RPW == rw)
          sm[P::O_P + (s * NW + warp) * DVP + j0 + c] = col[c];
      }
      if (g == 0) {
        const float ct = sm[P::O_C + s];
        sm[P::O_OR + s * DKP + i] =
            __fadd_rn(sr, __fmul_rn(ct, __fmul_rn(ui, kk)));
        sm[P::O_OK + s * DKP + i] =
            __fadd_rn(sk, __fmul_rn(ct, __fmul_rn(ui, rr)));
        sm[P::O_OW + s * DKP + i] = sw;
        du = __fadd_rn(du, __fmul_rn(ct, __fmul_rn(rr, kk)));
      }
    }
    __syncthreads();  // the chunk's outputs and row sums complete
    for (int x = tid; x < len * DKP; x += NT) {
      const int s = x / DKP, c = x % DKP;
      if (c < a.Dk) {
        const long long t = t0 + s;
        put(a.dr, base[DR_] + t * a.st[3 * DR_ + 2] + c, sm[P::O_OR + x],
            a.bf16);
        put(a.dk, base[DK_] + t * a.st[3 * DK_ + 2] + c, sm[P::O_OK + x],
            a.bf16);
        a.dw[base[DW_] + t * a.st[3 * DW_ + 2] + c] = sm[P::O_OW + x];
      }
    }
    for (int x = tid; x < len * DVP; x += NT) {
      const int s = x / DVP, c = x % DVP;
      if (c < a.Dv) {
        float y = sm[P::O_P + s * NW * DVP + c];
        for (int q = 1; q < NW; ++q)
          y = __fadd_rn(y, sm[P::O_P + (s * NW + q) * DVP + c]);
        y = __fadd_rn(y, __fmul_rn(sm[P::O_A + s], sm[P::O_DY + x]));
        put(a.dv, base[DV_] + (long long)(t0 + s) * a.st[3 * DV_ + 2] + c, y,
            a.bf16);
      }
    }
  }

#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int j = j0 + c;
    if (row && j < a.Dv) a.ds0[(bh * a.Dk + i) * a.Dv + j] = G[c];
  }
  if (g == 0 && row) a.dup[bh * a.Dk + i] = du;
}

// du[h, i] = sum over b of dup[b, h, i], in order of b
__global__ void wkv6_bwd_du_kernel(const float* dup, void* du, int B, int H,
                                   int Dk, int u_bf16) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= H * Dk) return;
  float y = dup[x];
  for (int b = 1; b < B; ++b)
    y = __fadd_rn(y, dup[(long long)b * H * Dk + x]);
  put(du, x, y, u_bf16);
}

template <int DKP, int CPT, int TC>
int launch_t(const Args& a, int B, cudaStream_t stream) {
  using P = Tile<DKP, CPT, TC>;
  static bool done = false;
  if (!done) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_bwd_kernel<DKP, CPT, TC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
    if (err != cudaSuccess) return (int)err;
    done = true;
  }
  wkv6_bwd_kernel<DKP, CPT, TC>
      <<<dim3((unsigned)a.H, (unsigned)B), P::NT, P::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

// the instantiations, by (DKP, CPT, TC): repro_torch/kernels/ref.py::
// wkv6_bwd_tile picks one for a (Dk, Dv)
#define WKV_BWD_TILES(X) \
  X(16, 4, 4) X(16, 16, 4) X(16, 16, 8) X(64, 4, 4) X(64, 16, 4) X(64, 16, 8)

}  // namespace

// Steps a chunk (the checkpoint interval) of an instantiation, 0 if none.
extern "C" int wkv6_bwd_chunk(int dkp, int cpt, int tc) {
#define WKV_BWD_C(D, P_, T_) \
  if (dkp == D && cpt == P_ && tc == T_) return Tile<D, P_, T_>::C;
  WKV_BWD_TILES(WKV_BWD_C)
#undef WKV_BWD_C
  return 0;
}

// Dynamic shared memory of one CTA of an instantiation, 0 if none.
extern "C" int wkv6_bwd_smem(int dkp, int cpt, int tc) {
#define WKV_BWD_S(D, P_, T_) \
  if (dkp == D && cpt == P_ && tc == T_) return Tile<D, P_, T_>::SMEM;
  WKV_BWD_TILES(WKV_BWD_S)
#undef WKV_BWD_S
  return 0;
}

// r, k, w (B, H, T, Dk), v and dy (B, H, T, Dv), dr, dk, dw (B, H, T, Dk)
// and dv (B, H, T, Dv), each given by its (b, head, position) strides in
// elements (strides: 27 values, the order of the enum above), the last
// axis contiguous; r, k, v and dr, dk, dv fp32 (bf16 = 0) or bf16, dy fp32
// or bf16 (dy_bf16), w and dw fp32; u (H, Dk) and du (H, Dk) contiguous in
// u's type (u_bf16); s0, dsT and ds0 contiguous (B, H, Dk, Dv) fp32, s0 and
// dsT null for zeros; dup (B, H, Dk) and ck (B, H, ceil(T / C), DKP * DVP)
// fp32 scratch, C = wkv6_bwd_chunk.  Two launches: the scan, one CTA per
// (b, h), then du's sum over b.  Returns cudaErrorInvalidValue for a tile
// that has no instantiation.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* s0,
                               const void* dy, const void* dsT, void* dr,
                               void* dk, void* dv, void* dw, void* du,
                               void* ds0, void* dup, void* ck,
                               const long long* strides, int B, int H, int T,
                               int Dk, int Dv, int dkp, int cpt, int tc,
                               int bf16, int u_bf16, int dy_bf16,
                               void* stream) {
  Args a{r,           k,           v,          (const float*)w,
         u,           (const float*)s0,        dy,
         (const float*)dsT,        dr,         dk,
         dv,          (float*)dw,  (float*)dup, (float*)ds0,
         (float*)ck,  {},          H,          T,
         Dk,          Dv,          bf16,       u_bf16,
         dy_bf16};
  for (int q = 0; q < 3 * NOPS; ++q) a.st[q] = strides[q];
  cudaStream_t st = (cudaStream_t)stream;
  int err = (int)cudaErrorInvalidValue;
#define WKV_BWD_L(D, P_, T_) \
  if (dkp == D && cpt == P_ && tc == T_) err = launch_t<D, P_, T_>(a, B, st);
  WKV_BWD_TILES(WKV_BWD_L)
#undef WKV_BWD_L
  if (err != 0) return err;
  const int n = H * Dk;
  wkv6_bwd_du_kernel<<<(n + 127) / 128, 128, 0, st>>>((const float*)dup, du,
                                                      B, H, Dk, u_bf16);
  return (int)cudaGetLastError();
}
