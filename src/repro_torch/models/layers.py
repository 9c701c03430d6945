"""Shared LM building blocks (counterpart of ``repro.models.layers``).

Pure functions of (params, inputs), as there.  Parameters of the stacked
layers carry a leading layer axis; the per-layer functions here see one
layer's slice.  Compute dtype is bf16; the norms, the rope angles and the
attention's softmax and accumulation are fp32.

The q/k/v/o projections, the MLP and the MoE's router, dispatch, expert
and combine products are plain ``torch.matmul`` / ``torch.einsum`` in
bf16, as the JAX package leaves them to XLA; attention goes through
:func:`repro_torch.kernels.ops.flash_attention` and the gated linear
attention of the hybrid's Mamba layers through
:func:`repro_torch.kernels.ops.wkv6` (the hand-written kernels on the
card, their plain versions on the CPU).  There is no activation sharding
(``shard`` / ``h_spec``): this runs on one card.

Departures from the JAX package: a cache passed to :func:`attention` is
written in place at ``[..., pos:pos + S, :]`` (JAX writes the same values
by ``dynamic_update_slice`` into a new array); :func:`gla_chunked` runs
the recurrence, not the JAX package's clipped chunked form.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

COMPUTE_DTYPE = torch.bfloat16

def cast(x: torch.Tensor) -> torch.Tensor:
    return x.to(COMPUTE_DTYPE)


#: set by :func:`masters`
_MASTERS = False


@contextlib.contextmanager
def masters():
    """Within the block, every ``init_params`` draw keeps its fp32 values
    (training's master parameters, the JAX ``init_params`` tree) instead of
    casting each stack to the compute dtype as soon as it is drawn
    (serving's parameters).  One draw, the same values: the serving
    parameters are :func:`serving_view` of the masters."""
    global _MASTERS
    prev, _MASTERS = _MASTERS, True
    try:
        yield
    finally:
        _MASTERS = prev


def drawn(x):
    """What an ``init_params`` draw keeps of the fp32 stack(s) ``x``:
    ``x`` itself under :func:`masters`, else :func:`cast_stacks` of it."""
    return x if _MASTERS else cast_stacks(x)


def drawn_leaf(x: torch.Tensor) -> torch.Tensor:
    """What a draw keeps of ``emb`` / ``head``: fp32 under :func:`masters`,
    else the compute dtype."""
    return x if _MASTERS else cast(x)


def serving_view(params: dict) -> dict:
    """The serving parameters of a master tree (fp32, :func:`masters`), as
    the JAX package casts its masters at every call (and as
    ``convert.params_from_jax`` casts a JAX tree): every sub-tree's stacks
    by :func:`cast_stacks`, ``emb`` and ``head`` by :func:`cast`, the other
    top-level leaves as they are.  The casts are differentiable: the
    masters' gradients flow back through them in fp32."""
    out = {}
    for name, val in params.items():
        if isinstance(val, dict):
            out[name] = cast_stacks(val)
        elif name in ("emb", "head"):
            out[name] = cast(val)
        else:
            out[name] = val
    return out


def embed(emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows ``tokens`` of the embedding table in the compute dtype.  Through
    ``F.embedding``, whose backward on CUDA sums each row's gradients in a
    fixed order (a scatter by index with atomics would not)."""
    return F.embedding(tokens.long(), cast(emb))


def run_layer(cfg, fn, *args):
    """``fn(*args)``; while grad is enabled and ``cfg.remat`` is set, under
    ``torch.utils.checkpoint`` (non-reentrant): the layer's activations are
    recomputed in the backward, the counterpart of the JAX package's
    ``jax.checkpoint`` around each scanned layer.  A ``remat_policy`` other
    than ``"full"`` names activations to keep for the tensor-parallel
    collectives, which this one-card port does not have: it raises."""
    if cfg.remat and torch.is_grad_enabled():
        if cfg.remat_policy != "full":
            raise NotImplementedError(
                f"remat_policy {cfg.remat_policy!r}: the port runs "
                "remat_policy 'full' only; the named policies serve the "
                "tensor-parallel collectives of ROADMAP item 15")
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def tree_map(fn, tree):
    """``fn`` of every leaf of a (nested) parameter dict, the nesting kept."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, val) for key, val in tree.items()}
    return fn(tree)


def slice_layer(tree, i: int):
    """Layer ``i``'s slice of every stack of a (nested) parameter dict."""
    return tree_map(lambda t: t[i], tree)


def tree_leaves(tree) -> list:
    """The leaves of a (nested) parameter dict, in its order."""
    out = []
    tree_map(out.append, tree)
    return out


def cast_stacks(tree):
    """Stacked weight matrices (ndim ≥ 3, fp32) in the compute dtype; norm
    scales and other 1D/2D leaves stay as they are."""
    return tree_map(lambda t: t.to(COMPUTE_DTYPE)
                    if t.dim() >= 3 and t.dtype == torch.float32 else t, tree)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, in_axis: int = -2, *,
               device=None) -> torch.Tensor:
    """fp32 normal / √fan_in, drawn from ``gen`` (on its device)."""
    fan_in = shape[in_axis]
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device or gen.device)
            / math.sqrt(max(fan_in, 1)))


def stack_init(gen: torch.Generator, L: int, shape, in_axis: int = -2, *,
               device=None) -> torch.Tensor:
    return dense_init(gen, (L, *shape), in_axis=in_axis, device=device)


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + scale)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (B, S, H, hd), positions: (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs                  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA / MQA / qk-norm / KV cache)
# ---------------------------------------------------------------------------


def attention_params(gen: torch.Generator, cfg, L: int, *,
                     cross: bool = False, device=None) -> dict:
    """Serving parameters: each stack drawn in fp32 and cast at once
    (:func:`cast_stacks`), so fp32 never holds more than one stack.  A
    cross-attention block (``cross``) has no q/k norms."""
    d, H, Kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dev = device or gen.device
    p = {
        "wq": drawn(stack_init(gen, L, (d, H * hd), device=dev)),
        "wk": drawn(stack_init(gen, L, (d, Kv * hd), device=dev)),
        "wv": drawn(stack_init(gen, L, (d, Kv * hd), device=dev)),
        "wo": drawn(stack_init(gen, L, (H * hd, d), device=dev)),
        "ln": torch.zeros((L, d), dtype=torch.float32, device=dev),
    }
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.zeros((L, hd), dtype=torch.float32, device=dev)
        p["k_norm"] = torch.zeros((L, hd), dtype=torch.float32, device=dev)
    return p


def attention(p: dict, x: torch.Tensor, cfg, *, mode: str = "train",
              causal: bool = True, use_rope: bool = True,
              cache: Optional[dict] = None, cache_pos: Optional[int] = None,
              kv_src: Optional[torch.Tensor] = None, kv_valid_len=None,
              ) -> tuple[torch.Tensor, Optional[dict]]:
    """Pre-norm attention block.  Returns (residual_delta, cache).

    mode:
      "train"        — fresh K/V, no cache.
      "prefill"      — fresh K/V, attend them, and write them into
                       cache[0:S_kv].
      "decode"       — write K/V at cache_pos, attend the cache with a
                       kv_valid_len = cache_pos + S mask.
      "cross_decode" — attend an already-filled cross-attention cache
                       under ``kv_valid_len``.
    kv_src: the cross-attention source (encoder-decoder): K/V are its
    projections (not normalised by this block's norm), with no rope and
    no causal mask.  ``causal`` and ``use_rope`` apply to self-attention.
    cache: {"k": (B, Kv, T, hd), "v": ...}, written in place; cache_pos and
    kv_valid_len host ints.
    """
    if mode not in ("train", "prefill", "decode", "cross_decode"):
        raise ValueError(mode)
    B, S, d = x.shape
    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    src = h if kv_src is None else cast(kv_src)
    is_cross = kv_src is not None or mode == "cross_decode"
    q = (cast(h) @ cast(p["wq"])).reshape(B, S, H, hd)
    k = v = None
    if mode != "cross_decode":
        Skv = src.shape[1]
        k = (src @ cast(p["wk"])).reshape(B, Skv, Kv, hd)
        v = (src @ cast(p["wv"])).reshape(B, Skv, Kv, hd)

    if cfg.qk_norm and "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        if k is not None:
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)

    base = 0 if cache_pos is None else int(cache_pos)
    if use_rope and not is_cross:
        pos = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
        q = rope(q, (base + pos).expand(B, S), cfg.rope_theta)
        kbase = 0 if mode == "prefill" else base
        k = rope(k, (kbase + pos).expand(B, S), cfg.rope_theta)

    if cache is not None and k is not None:
        wpos = 0 if mode == "prefill" else base
        cache["k"][:, :, wpos:wpos + k.shape[1]] = k.transpose(1, 2)
        cache["v"][:, :, wpos:wpos + k.shape[1]] = v.transpose(1, 2)

    qh = q.transpose(1, 2)                                      # (B, H, S, hd)
    if mode in ("train", "prefill"):
        o = kops.flash_attention(qh, k.transpose(1, 2), v.transpose(1, 2),
                                 causal=causal and not is_cross)
    elif mode == "decode":
        o = kops.flash_attention(qh, cache["k"], cache["v"], causal=False,
                                 kv_valid_len=base + S)
    else:
        o = kops.flash_attention(qh, cache["k"], cache["v"], causal=False,
                                 kv_valid_len=kv_valid_len)
    o = o.transpose(1, 2).reshape(B, S, H * hd)
    return cast(o) @ cast(p["wo"]), cache


# ---------------------------------------------------------------------------
# dense MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def mlp_params(gen: torch.Generator, cfg, L: int, *, ff: int | None = None,
               device=None) -> dict:
    """Serving parameters, each stack cast as soon as it is drawn."""
    d, ff = cfg.d_model, ff or cfg.d_ff
    dev = device or gen.device
    return {
        "w_gate": drawn(stack_init(gen, L, (d, ff), device=dev)),
        "w_up": drawn(stack_init(gen, L, (d, ff), device=dev)),
        "w_down": drawn(stack_init(gen, L, (ff, d), device=dev)),
        "ln": torch.zeros((L, d), dtype=torch.float32, device=dev),
    }


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh") if kind == "gelu" else F.silu(x)


def mlp(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    h = cast(rms_norm(x, p["ln"], cfg.norm_eps))
    g = _act(h @ cast(p["w_gate"]), cfg.gate_fn)
    u = h @ cast(p["w_up"])
    return (g * u) @ cast(p["w_down"])


# ---------------------------------------------------------------------------
# MoE with capacity-based dispatch (GShard one-hot masks, or the sort)
# ---------------------------------------------------------------------------


def drawn_stack(gen: torch.Generator, L: int, shape, device
                ) -> torch.Tensor:
    """A (L, *shape) stack drawn one layer at a time (normal / √fan_in),
    each layer cast to the compute dtype as soon as it is drawn (fp32 never
    holds more than one layer: deepseek-moe-16b's whole expert stack would
    be 20.7 GB)."""
    out = torch.empty((L, *shape), dtype=torch.float32 if _MASTERS
                      else COMPUTE_DTYPE, device=device)
    for l in range(L):
        out[l] = drawn_leaf(dense_init(gen, shape, device=device))
    return out


def moe_params(gen: torch.Generator, cfg, L: int, *, device=None) -> dict:
    """Serving parameters of the MoE block (the JAX tree: ``router``,
    ``experts`` {w_gate, w_up, w_down}, ``ln``, and ``shared`` — the
    always-on experts as one MLP of width n_shared·d_ff, sharing the block
    norm), each stack in the compute dtype."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    dev = device or gen.device
    p = {
        "router": drawn(stack_init(gen, L, (d, E), device=dev)
                        * (0.02 * math.sqrt(d))),
        "experts": {
            "w_gate": drawn_stack(gen, L, (E, d, ff), dev),
            "w_up": drawn_stack(gen, L, (E, d, ff), dev),
            "w_down": drawn_stack(gen, L, (E, ff, d), dev),
        },
        "ln": torch.zeros((L, d), dtype=torch.float32, device=dev),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_params(gen, cfg, L,
                                 ff=cfg.n_shared_experts * ff, device=dev)
        del p["shared"]["ln"]  # share the block norm
    return p


def capacity(cfg, tokens: int) -> int:
    """Slots per expert for a group of ``tokens``: ⌈cf · tokens · K / E⌉
    rounded up to a multiple of 4, at least 4 (the JAX package's C)."""
    C = int(cfg.moe_capacity_factor * tokens * cfg.experts_per_token
            / cfg.n_experts)
    return max(4, -(-C // 4) * 4)


def top_k(probs: torch.Tensor, K: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The K largest of the last axis, ties to the lower index (as
    ``jax.lax.top_k``; ``torch.topk`` promises no order among ties, and
    bf16 router logits tie often): a stable descending sort, cut at K."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :K], idx[..., :K]


def _dispatch_group(hf, top_w, top_e, E: int, K: int, C: int):
    """Capacity dispatch for ONE token group (sort formulation).
    hf: (N, d); returns (buf (E, C, d), ts, ws, keep, slot): the (token,
    k) assignments sorted stably by expert, an assignment kept while its
    rank within its expert is below C, kept ones at slot e·C + rank, the
    dropped ones at the trash slot E·C."""
    N, d = hf.shape
    e_flat = top_e.reshape(-1)                                   # (N·K,)
    w_flat = top_w.reshape(-1)
    t_flat = torch.arange(N, device=hf.device).repeat_interleave(K)
    order = torch.sort(e_flat, stable=True).indices
    es, ts, ws = e_flat[order], t_flat[order], w_flat[order]
    counts = torch.bincount(es, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(N * K, device=hf.device) - starts[es]
    keep = pos_in_e < C
    slot = torch.where(keep, es * C + pos_in_e, E * C)          # E*C = trash
    buf = torch.zeros((E * C + 1, d), dtype=COMPUTE_DTYPE, device=hf.device)
    buf[slot] = hf[ts].to(COMPUTE_DTYPE)
    return buf[:E * C].reshape(E, C, d), ts, ws, keep, slot


def _combine_group(out, ts, ws, keep, slot, N: int):
    """The sort formulation's combine: each kept assignment's expert output
    times its router weight, summed into its token's row."""
    E, C, d = out.shape
    out_flat = out.reshape(E * C, d)
    contrib = torch.where(keep[:, None],
                          out_flat[torch.clamp_max(slot, E * C - 1)]
                          * ws[:, None].to(COMPUTE_DTYPE), 0.0)
    return torch.zeros((N, d), dtype=COMPUTE_DTYPE,
                       device=out.device).index_add_(0, ts, contrib)


def _ranks(e_flat: torch.Tensor, E: int) -> torch.Tensor:
    """Each assignment's rank among its expert's in flattened (token, k)
    order: e_flat (..., g·K) → (..., g·K) int64."""
    oh = F.one_hot(e_flat, E).to(torch.int32)                     # (…, g·K, E)
    pos = torch.cumsum(oh, dim=-2, dtype=torch.int32) - oh        # rank per e
    return torch.gather(pos, -1, e_flat[..., None])[..., 0].long()


def _onehot_masks(top_w, top_e, E: int, K: int, C: int):
    """GShard dispatch/combine masks for token groups.
    top_w/top_e: (..., g, K).  Returns dispatch (..., g, E, C) {0,1} and
    combine (..., g, E, C) with router weights, in the compute dtype: an
    assignment's rank is its position among its expert's assignments in
    flattened (token, k) order, and ranks ≥ C are dropped.

    The JAX package forms each assignment's (E, C) one-hot product and sums
    over k; the port writes each assignment's one entry into the (g, E, C)
    masks instead, which gives the same values (a token's K experts are
    distinct, so no two assignments share an entry) without the (g·K, E, C)
    intermediate — 6.6 GB a layer at deepseek-moe-16b's prefill with no
    drops."""
    *lead, g, _ = top_e.shape
    e_flat = top_e.reshape(-1, g * K).long()                      # (L, g·K)
    pos_t = _ranks(e_flat, E)
    keep = (pos_t < C).to(COMPUTE_DTYPE)
    n = e_flat.shape[0]
    tok = torch.arange(g, device=e_flat.device).repeat_interleave(K)
    at = (tok * E + e_flat) * C + torch.clamp_max(pos_t, C - 1)  # (L, g·K)
    disp = torch.zeros((n, g * E * C), dtype=COMPUTE_DTYPE,
                       device=e_flat.device)
    comb = torch.zeros_like(disp)
    disp.scatter_(1, at, keep)
    comb.scatter_(1, at, keep * top_w.reshape(n, g * K).to(COMPUTE_DTYPE))
    return disp.reshape(*lead, g, E, C), comb.reshape(*lead, g, E, C)


def groups(cfg, B: int, S: int) -> tuple[int, int]:
    """(G, gsz) of the one-hot dispatch: groups of ``moe_group_size``
    tokens of a sequence, or of the batch where S = 1 (decode).  Raises
    ``ValueError`` where G·gsz ≠ B·S (the JAX package's assert)."""
    gsz = (min(cfg.moe_group_size, S) if S > 1
           else min(cfg.moe_group_size, B))
    N = B * S
    G = max(1, N // gsz)
    gsz = N // G
    if G * gsz != N:
        raise ValueError(f"{N} tokens do not split into {G} dispatch groups "
                         f"of {gsz} (moe_group_size={cfg.moe_group_size})")
    return G, gsz


def route(p: dict, hc: torch.Tensor, cfg) -> tuple[torch.Tensor,
                                                   torch.Tensor,
                                                   torch.Tensor]:
    """The router: fp32 logits of the bf16 product, the softmax's top K
    (ties to the lower index) and their weights renormalised to sum 1.
    Returns (logits, top_w, top_e).

    The product of the bf16 operands is summed in fp32 and rounded once to
    bf16, as the JAX package's bf16 dot is: a bf16 GEMM on the card may
    also reduce in bf16 (torch's ``allow_bf16_reduced_precision_reduction``),
    which moves a logit by more than its last bit and so a route."""
    kref.exact_fp32(hc)
    logits = cast(hc.float() @ cast(p["router"]).float()).float()  # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = top_k(probs, cfg.experts_per_token)            # (B, S, K)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    return logits, top_w, top_e


#: set by :func:`route_hook`
_ROUTE_HOOK = None


@contextlib.contextmanager
def route_hook(fn):
    """Within the block, every :func:`moe` call hands its router's input and
    output to ``fn(p, hc, cfg, (logits, top_w, top_e))``, which returns the
    ``(top_w, top_e)`` the call dispatches: where a check reads the routes
    a run took, and where it gives a run another run's routes."""
    global _ROUTE_HOOK
    prev, _ROUTE_HOOK = _ROUTE_HOOK, fn
    try:
        yield
    finally:
        _ROUTE_HOOK = prev


def kept_assignments(cfg, top_e: torch.Tensor) -> torch.Tensor:
    """How many of the (token, k) assignments ``top_e`` (B, S, K) of one
    :func:`moe` call find a capacity slot (a 0-d tensor): ranks below C
    in the groups of ``cfg.moe_impl`` (a sequence for the sort, the
    one-hot dispatch's groups otherwise)."""
    B, S, K = top_e.shape
    G, gsz = (B, S) if cfg.moe_impl == "sort" else groups(cfg, B, S)
    C = capacity(cfg, gsz)
    return torch.sum(_ranks(top_e.reshape(G, gsz * K).long(),
                            cfg.n_experts) < C)


def _experts(we: dict, buf: torch.Tensor, cfg) -> torch.Tensor:
    """Every expert's SwiGLU/GeGLU on its capacity slots: buf (..., E, C,
    d) → (..., E, C, d), the batched products in bf16."""
    gate = _act(torch.einsum("...ecd,edf->...ecf", buf, cast(we["w_gate"])),
                cfg.gate_fn)
    up = torch.einsum("...ecd,edf->...ecf", buf, cast(we["w_up"]))
    return torch.einsum("...ecf,efd->...ecd", gate * up, cast(we["w_down"]))


def moe(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Top-k routed experts + optional always-on shared experts.

    ``moe_impl="onehot"`` (the default): GShard one-hot dispatch over
    groups of ``moe_group_size`` tokens — dispatch and combine are einsums
    against (G, g, E, C) masks.  ``"sort"``: per sequence, the assignments
    sorted stably by expert and scattered into capacity slots.  Both drop
    the same assignments (an expert's rank ≥ C in (token, k) order).
    """
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    hc = cast(h)
    routed = route(p, hc, cfg)
    _, top_w, top_e = routed
    if _ROUTE_HOOK is not None:
        top_w, top_e = _ROUTE_HOOK(p, hc, cfg, routed)

    we = p["experts"]
    if cfg.moe_impl == "sort":
        C = capacity(cfg, S)
        ys = []
        for b in range(B):
            buf, ts, ws, keep, slot = _dispatch_group(hc[b], top_w[b],
                                                      top_e[b], E, K, C)
            ys.append(_combine_group(_experts(we, buf, cfg), ts, ws, keep,
                                     slot, S))
        y = torch.stack(ys)
    else:
        G, gsz = groups(cfg, B, S)
        C = capacity(cfg, gsz)
        xg = hc.reshape(G, gsz, d)
        disp, comb = _onehot_masks(top_w.reshape(G, gsz, K),
                                   top_e.reshape(G, gsz, K), E, K, C)
        buf = torch.einsum("gtec,gtd->gecd", disp, xg)            # (G,E,C,d)
        out = _experts(we, buf, cfg)                              # (G,E,C,d)
        y = torch.einsum("gtec,gecd->gtd", comb, out).reshape(B, S, d)

    if "shared" in p:
        sp = p["shared"]
        g = _act(hc @ cast(sp["w_gate"]), cfg.gate_fn)
        u = hc @ cast(sp["w_up"])
        y = y + ((g * u) @ cast(sp["w_down"])).reshape(B, S, d)
    return y


# ---------------------------------------------------------------------------
# Gated linear attention (Jamba's Mamba layers) and the causal conv
# ---------------------------------------------------------------------------


def gla_chunked(r, k, v, w_log, u=None, *, chunk: int = 64, state_out=None):
    """The counterpart of ``repro.models.layers.gla_chunked``:
        y_t = r_t @ (S_{t-1} + diag(u) k_t^T v_t)
        S_t = diag(w_t) S_{t-1} + k_t^T v_t
    from a zero state, with per-channel log-decay ``w_log`` = log w ∈
    (-inf, 0].  Shapes: (B, H, T, Dk) for r/k/w_log, (B, H, T, Dv) for v,
    (H, Dk) for u (None: no bonus term, ``y_t = r_t S_{t-1}``).  Returns
    ``y`` in ``r.dtype`` and the final state (fp32), written into
    ``state_out`` when given.

    It runs the recurrence through :func:`repro_torch.kernels.ops.wkv6`
    (u = 0 where None, which gives ``r_t S_{t-1}`` exactly, and takes no
    gradient), over any T; on the card its gradient comes from the
    ``wkv6`` backward kernel.
    The JAX function's chunked form is a TPU adaptation that clips its
    decay factorisation at exp(±30) from each chunk's start, and parts
    from the recurrence where the decay is strong (ROADMAP queue 3);
    ``chunk`` is taken for its signature and not used."""
    del chunk
    if u is None:
        u = torch.zeros((r.shape[1], r.shape[3]), dtype=r.dtype,
                        device=r.device)
    return kops.wkv6(r, k, v, torch.exp(w_log.float()), u, None,
                     state_out=state_out)


def gla_step(r, k, v, w, u, state, *, state_out=None):
    """Single-token recurrent step (decode), the counterpart of
    ``repro.models.layers.gla_step``: r/k/w (B, H, Dk), v (B, H, Dv), u
    (H, Dk) or None, state (B, H, Dk, Dv) fp32.  Returns y (B, H, Dv) fp32
    and the new state, written into ``state_out`` when given (it may be
    ``state``: an update in place), through ``ops.wkv6`` at T = 1."""
    if u is None:
        u = torch.zeros((r.shape[1], r.shape[2]), dtype=r.dtype,
                        device=r.device)
    y, new_state = kops.wkv6(r[:, :, None], k[:, :, None], v[:, :, None],
                             w[:, :, None].float(), u, state,
                             state_out=state_out, out_dtype=torch.float32)
    return y[:, :, 0], new_state


def conv1d_causal(x: torch.Tensor, w: torch.Tensor, cache=None):
    """Depthwise causal conv, width W. x: (B, S, d), w: (W, d).
    cache: (B, W-1, d) trailing context for decode.  Returns (out,
    new_cache); the taps are summed in the JAX function's order, in the
    type of their products."""
    W, S = w.shape[0], x.shape[1]
    if cache is not None:
        xx = torch.cat([cache.to(x.dtype), x], dim=1)
        new_cache = xx[:, -(W - 1):, :] if W > 1 else cache
    else:
        xx = F.pad(x, (0, 0, W - 1, 0))
        new_cache = None
    out = sum(xx[:, i:i + S, :] * w[i] for i in range(W))
    return out, new_cache
