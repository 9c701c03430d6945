"""Jamba-style hybrid: Mamba + attention 1:7 interleave, MoE every other
layer (counterpart of ``repro.models.hybrid``).

Layer layout per period of ``attn_period`` (= 8) layers:
  indices 0..6 → Mamba mixer, index 7 → GQA attention;
  odd indices → MoE FFN (``layers.moe``), even → dense FFN.
The parameter tree is the JAX package's: ``periods`` holds stacks with a
leading period axis and a layer axis within the period (``(P, n, ...)``);
the model runs as a Python loop over the periods and their layers.

A Mamba layer is the SSD/Mamba-2 scalar-per-head-decay linear attention
h_t = a_t·h_{t-1} + k_t^T v_t with a_t = exp(-softplus(dt_t)·exp(A_log)),
d_state = 16.  Its scan is :func:`repro_torch.kernels.ops.wkv6` with u = 0
(``layers.gla_chunked`` for a prompt, ``layers.gla_step`` at T = 1): r, k
and w are (B, H, T, d_state), v (B, H, T, hd), so at jamba-1.5-large's
width H = 128 heads of a 16 × 128 state; T > 1 takes the recurrent kernel
and T = 1 the decode kernel.

Three deliberate departures from the JAX package:

* **The recurrence for prefill and forward.**  JAX pads the prompt to
  64-step chunks and runs ``layers.gla_chunked``, whose decay
  factorisation is clipped at exp(±30) from each chunk's start: at the
  decay of the model's init (a ≈ 0.5 a step) it parts from the recurrence
  from about step 44 of a chunk (ROADMAP queue 3).  The port follows the
  recurrence, as its RWKV-6 does, and needs no padding (zero steps with
  decay 1 leave y and the state as they are).
* **Weights are cast once**: the serving parameters hold in bf16 what
  ``cast_stacks`` turns to bf16 at every JAX call — every leaf of
  ``periods`` (each has the period and layer axes, so the Mamba's
  ``ln``, ``dt_bias``, ``A_log`` and ``D`` and the blocks' norm scales
  too), and ``emb`` and ``head``; ``final_ln`` stays fp32.
* **The caches are updated in place**: the attention layer's K/V, each
  Mamba layer's conv tail (by slice assignment) and its fp32 state
  (written by the kernel), so a decode step copies no cache; the dict
  passed to :func:`prefill` / :func:`decode_step` is the one returned.
  ``cache["pos"]`` is a host int.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import layers as L

CONV_W = 4


def _dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.hd          # mamba heads
    return d_in, H, cfg.ssm_state_dim


def mamba_params(gen: torch.Generator, cfg, n: int, *, device=None) -> dict:
    """``n`` Mamba layers' parameters (the JAX tree), the projections drawn
    one layer at a time and cast as they are drawn."""
    d = cfg.d_model
    d_in, H, ds = _dims(cfg)
    dev = device or gen.device
    return {
        "ln": torch.zeros((n, d), dtype=torch.float32, device=dev),
        "in_proj": L.drawn_stack(gen, n, (d, 2 * d_in), dev),
        "conv_w": L.drawn_leaf(0.1 * torch.randn((n, CONV_W, d_in),
                                                 generator=gen, device=dev)),
        "w_bc": L.drawn_stack(gen, n, (d_in, 2 * H * ds), dev),  # B, C proj
        "w_dt": L.drawn_stack(gen, n, (d_in, H), dev),
        "dt_bias": torch.zeros((n, H), dtype=torch.float32, device=dev),
        "A_log": torch.zeros((n, H), dtype=torch.float32, device=dev),
        "D": torch.ones((n, H), dtype=torch.float32, device=dev),
        "out_proj": {"wo": L.drawn_stack(gen, n, (d_in, d), dev)},
    }


def _mamba(pl, cfg, x, conv_cache=None, state=None, *, state_out=None):
    """One Mamba layer.  ``state`` None: a prompt (or forward) from a zero
    state; else one decode step from ``state``.  The final state goes into
    ``state_out`` when given (it may be ``state``).  Returns the residual
    delta, the conv tail (None without ``conv_cache``) and the state."""
    B, S, d = x.shape
    d_in, H, ds = _dims(cfg)
    hd = cfg.hd
    h = L.rms_norm(x, pl["ln"], cfg.norm_eps)
    xz = L.cast(h) @ L.cast(pl["in_proj"])
    xp, z = xz[..., :d_in], xz[..., d_in:]
    xp, new_conv = L.conv1d_causal(xp, pl["conv_w"], cache=conv_cache)
    xp = F.silu(xp)

    bc = xp @ L.cast(pl["w_bc"])
    b = bc[..., :H * ds].reshape(B, S, H, ds).transpose(1, 2)   # k-like
    c = bc[..., H * ds:].reshape(B, S, H, ds).transpose(1, 2)   # q-like
    v = xp.reshape(B, S, H, hd).transpose(1, 2)                 # v
    dt = F.softplus((xp @ L.cast(pl["w_dt"])).float()
                    + pl["dt_bias"])                            # (B, S, H)
    a_log = -dt * torch.exp(pl["A_log"])                        # ≤ 0
    w_log = a_log.transpose(1, 2)[..., None].expand(B, H, S, ds)
    # discretised input scale: dt folded into v (SSD convention)
    v = v * dt.transpose(1, 2)[..., None].to(v.dtype)

    if state is None:
        # y in r's type, as the JAX package's chunked prefill
        y, new_state = L.gla_chunked(c, b, v, w_log, None,
                                     state_out=state_out)
    else:
        # y in fp32, as its decode step (layers.gla_step)
        y, new_state = L.gla_step(c[:, :, 0], b[:, :, 0], v[:, :, 0],
                                  torch.exp(w_log[:, :, 0]), None, state,
                                  state_out=state_out)
        y = y[:, :, None, :]

    y = y.transpose(1, 2).reshape(B, S, d_in)
    y = y + xp * torch.repeat_interleave(pl["D"], hd)[None, None, :]
    y = y * F.silu(z)
    return L.cast(y) @ L.cast(pl["out_proj"]["wo"]), new_conv, new_state


def _stack_periods(trees: list):
    """Per-period parameter trees stacked on a leading period axis (a view
    where there is one period), then cast as the JAX package's
    ``cast_stacks`` casts the (P, n, ...) stacks: every fp32 leaf, now of
    three or more axes, to bf16."""
    if isinstance(trees[0], dict):
        return {key: _stack_periods([t[key] for t in trees])
                for key in trees[0]}
    return L.drawn(trees[0][None] if len(trees) == 1
                   else torch.stack(trees))


def init_params(cfg, generator: Optional[torch.Generator] = None,
                device="cuda", seed: int = 0) -> dict:
    """Serving parameters drawn as the JAX ``init_params`` draws its masters
    (normal / √fan_in, the conv taps 0.1·N(0, 1), the router × 0.02·√d,
    the constant leaves), from ``generator`` (a fresh one seeded with
    ``seed`` on ``device`` when None), the large stacks cast as they are
    drawn."""
    if cfg.n_layers % cfg.attn_period:
        raise ValueError(f"{cfg.n_layers} layers are not whole periods of "
                         f"{cfg.attn_period}")
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    P = cfg.n_layers // cfg.attn_period          # periods
    per = cfg.attn_period
    n_moe = per // cfg.moe_period
    d, V = cfg.d_model, cfg.padded_vocab
    return {
        "emb": L.drawn_leaf(L.dense_init(gen, (V, d), in_axis=-1,
                                         device=dev)),
        "periods": {
            "mamba": _stack_periods([mamba_params(gen, cfg, per - 1,
                                                  device=dev)
                                     for _ in range(P)]),
            "attn": _stack_periods([L.attention_params(gen, cfg, 1,
                                                       device=dev)
                                    for _ in range(P)]),
            "moe": _stack_periods([L.moe_params(gen, cfg, n_moe, device=dev)
                                   for _ in range(P)]),
            "mlp": _stack_periods([L.mlp_params(gen, cfg, per - n_moe,
                                                device=dev)
                                   for _ in range(P)]),
        },
        "final_ln": torch.zeros((d,), dtype=torch.float32, device=dev),
        "head": L.drawn_leaf(L.dense_init(gen, (d, V), device=dev)),
    }


def _period(cfg, h, pp, mode="train", caches=None, cache_pos=None):
    """One period: ``attn_period`` layers.  caches: the period's slices of
    the attention K/V and of the Mamba conv and state stacks, updated in
    place (the prefill reads the conv tails it is given and starts each
    state at zero, as the JAX package)."""
    per = cfg.attn_period
    mi = di = ei = 0
    for i in range(per):
        if i == per - 1:      # attention layer
            cl = None if caches is None else {"k": caches["k"],
                                              "v": caches["v"]}
            a, _ = L.attention(L.slice_layer(pp["attn"], 0), h, cfg,
                               mode=mode if caches is not None else "train",
                               cache=cl, cache_pos=cache_pos)
        else:                 # mamba layer
            pm = L.slice_layer(pp["mamba"], mi)
            if caches is None:
                a, _, _ = _mamba(pm, cfg, h)
            else:
                conv, st = caches["conv"][mi], caches["state"][mi]
                a, nconv, _ = _mamba(
                    pm, cfg, h, conv_cache=conv,
                    state=st if mode == "decode" else None, state_out=st)
                conv.copy_(nconv)
            mi += 1
        h = h + a
        if (i % cfg.moe_period) == cfg.moe_period - 1:
            h = h + L.moe(L.slice_layer(pp["moe"], ei), h, cfg)
            ei += 1
        else:
            h = h + L.mlp(L.slice_layer(pp["mlp"], di), h, cfg)
            di += 1
    return h


def _periods(params, cfg):
    return [L.slice_layer(params["periods"], p)
            for p in range(cfg.n_layers // cfg.attn_period)]


def forward(params, cfg, tokens, embeds=None):
    """Full-sequence forward.  Returns (B, S, padded_vocab) logits."""
    del embeds
    h = L.embed(params["emb"], tokens)
    for pp in _periods(params, cfg):
        h = L.run_layer(cfg, lambda h, p: _period(cfg, h, p), h, pp)
    h = L.rms_norm(h, params["final_ln"], cfg.norm_eps)
    return L.cast(h) @ L.cast(params["head"])


def init_cache(cfg, B, T, dtype=torch.bfloat16, device="cuda"):
    dev = resolve_device(device)
    P = cfg.n_layers // cfg.attn_period
    n_mamba = cfg.attn_period - 1
    d_in, H, ds = _dims(cfg)
    kv = (P, B, cfg.n_kv_heads, T, cfg.hd)
    return {
        "k": torch.zeros(kv, dtype=dtype, device=dev),
        "v": torch.zeros(kv, dtype=dtype, device=dev),
        "conv": torch.zeros((P, n_mamba, B, CONV_W - 1, d_in), dtype=dtype,
                            device=dev),
        "state": torch.zeros((P, n_mamba, B, H, ds, cfg.hd),
                             dtype=torch.float32, device=dev),
        "pos": 0,
    }


def _run_cached(params, cfg, cache, tokens, mode):
    h = L.embed(params["emb"], tokens)
    pos = int(cache["pos"])
    for p, pp in enumerate(_periods(params, cfg)):
        caches = {name: cache[name][p]
                  for name in ("k", "v", "conv", "state")}
        h = _period(cfg, h, pp, mode=mode, caches=caches, cache_pos=pos)
    h = L.rms_norm(h[:, -1:] if mode == "prefill" else h,
                   params["final_ln"], cfg.norm_eps)
    cache["pos"] = pos + tokens.shape[1]
    return L.cast(h) @ L.cast(params["head"]), cache


def prefill(params, cfg, tokens, cache, embeds=None):
    """Run the prompt, filling the cache in place (every Mamba state from
    zero, whatever the cache held).  Returns the last position's logits
    (B, 1, V) and the cache."""
    del embeds
    return _run_cached(params, cfg, cache, tokens, "prefill")


def decode_step(params, cfg, cache, tokens):
    """One token per sequence (B, 1) from the cache (updated in place).
    Returns (B, 1, V) logits and the cache."""
    return _run_cached(params, cfg, cache, tokens, "decode")
