"""Shared LM building blocks (counterpart of ``repro.models.layers``).

Pure functions of (params, inputs), as there.  Parameters of the stacked
layers carry a leading layer axis; the per-layer functions here see one
layer's slice.  Compute dtype is bf16; the norms, the rope angles and the
attention's softmax and accumulation are fp32.

The q/k/v/o projections and the MLP are plain ``torch.matmul`` in bf16, as
the JAX package leaves them to XLA; attention goes through
:func:`repro_torch.kernels.ops.flash_attention` (the hand-written kernel on
the card, its plain version on the CPU).  There is no activation sharding
(``shard`` / ``h_spec``): this runs on one card.

Departure from the JAX package: a cache passed to :func:`attention` is
written in place at ``[..., pos:pos + S, :]`` (JAX writes the same values
by ``dynamic_update_slice`` into a new array).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops

COMPUTE_DTYPE = torch.bfloat16

_ENCDEC = "ROADMAP queue 1 item 14 (the encoder-decoder family)"


def cast(x: torch.Tensor) -> torch.Tensor:
    return x.to(COMPUTE_DTYPE)


def cast_stacks(tree):
    """Stacked weight matrices (ndim ≥ 3, fp32) in the compute dtype; norm
    scales and other 1D/2D leaves stay as they are."""
    if isinstance(tree, dict):
        return {key: cast_stacks(val) for key, val in tree.items()}
    if tree.dim() >= 3 and tree.dtype == torch.float32:
        return tree.to(COMPUTE_DTYPE)
    return tree


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


def attention_params(gen: torch.Generator, cfg, L: int, *, device=None
                     ) -> dict:
    """Serving parameters: each stack drawn in fp32 and cast at once
    (:func:`cast_stacks`), so fp32 never holds more than one stack."""
    d, H, Kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dev = device or gen.device
    p = {
        "wq": cast_stacks(stack_init(gen, L, (d, H * hd), device=dev)),
        "wk": cast_stacks(stack_init(gen, L, (d, Kv * hd), device=dev)),
        "wv": cast_stacks(stack_init(gen, L, (d, Kv * hd), device=dev)),
        "wo": cast_stacks(stack_init(gen, L, (H * hd, d), device=dev)),
        "ln": torch.zeros((L, d), dtype=torch.float32, device=dev),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((L, hd), dtype=torch.float32, device=dev)
        p["k_norm"] = torch.zeros((L, hd), dtype=torch.float32, device=dev)
    return p


def attention(p: dict, x: torch.Tensor, cfg, *, mode: str = "train",
              cache: Optional[dict] = None, cache_pos: Optional[int] = None,
              kv_src: Optional[torch.Tensor] = None,
              ) -> tuple[torch.Tensor, Optional[dict]]:
    """Pre-norm attention block.  Returns (residual_delta, cache).

    mode:
      "train"   — fresh K/V, no cache.
      "prefill" — fresh K/V, attend them, and write them into cache[0:S].
      "decode"  — write K/V at cache_pos, attend the cache with a
                  kv_valid_len = cache_pos + S mask.
    cache: {"k": (B, Kv, T, hd), "v": ...}, written in place; cache_pos a
    host int.  Causal, with rope: the dense family's setting.
    "cross_decode" and ``kv_src`` (the encoder-decoder family, with its
    non-causal and rope-free attention) raise :class:`NotImplementedError`.
    """
    if mode == "cross_decode" or kv_src is not None:
        raise NotImplementedError(f"cross-attention is not ported yet: "
                                  f"{_ENCDEC}")
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(mode)
    B, S, d = x.shape
    H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = (cast(h) @ cast(p["wq"])).reshape(B, S, H, hd)
    k = (h @ cast(p["wk"])).reshape(B, S, Kv, hd)
    v = (h @ cast(p["wv"])).reshape(B, S, Kv, hd)

    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)

    base = 0 if cache_pos is None else int(cache_pos)
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    q = rope(q, (base + pos).expand(B, S), cfg.rope_theta)
    kbase = 0 if mode == "prefill" else base
    k = rope(k, (kbase + pos).expand(B, S), cfg.rope_theta)

    if cache is not None:
        wpos = 0 if mode == "prefill" else base
        cache["k"][:, :, wpos:wpos + S] = k.transpose(1, 2)
        cache["v"][:, :, wpos:wpos + S] = v.transpose(1, 2)

    qh = q.transpose(1, 2)                                      # (B, H, S, hd)
    if mode in ("train", "prefill"):
        o = kops.flash_attention(qh, k.transpose(1, 2), v.transpose(1, 2),
                                 causal=True)
    else:
        o = kops.flash_attention(qh, cache["k"], cache["v"], causal=False,
                                 kv_valid_len=base + S)
    o = o.transpose(1, 2).reshape(B, S, H * hd)
    return cast(o) @ cast(p["wo"]), cache


# ---------------------------------------------------------------------------
# dense MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def mlp_params(gen: torch.Generator, cfg, L: int, *, device=None) -> dict:
    """Serving parameters, each stack cast as soon as it is drawn."""
    d, ff = cfg.d_model, cfg.d_ff
    dev = device or gen.device
    return {
        "w_gate": cast_stacks(stack_init(gen, L, (d, ff), device=dev)),
        "w_up": cast_stacks(stack_init(gen, L, (d, ff), device=dev)),
        "w_down": cast_stacks(stack_init(gen, L, (ff, d), device=dev)),
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
