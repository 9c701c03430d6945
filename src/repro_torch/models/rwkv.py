"""RWKV-6 "Finch" — attention-free LM with data-dependent decay
(counterpart of ``repro.models.rwkv``).

Time-mix: token-shift interpolation feeds r/k/v/g projections and the
low-rank *data-dependent* decay
    w_t = exp(-exp(w0 + tanh(x̃ W_a) W_b))  ∈ (0, 1) per channel,
kept in fp32 end to end (just below 1.0, bf16's spacing would round it);
the WKV recurrence runs through :func:`repro_torch.kernels.ops.wkv6` in
every mode, one launch per layer and call.  Channel-mix: squared-ReLU MLP.
The same parameter tree and functions as the JAX package, run as a Python
loop over the layers.

Three deliberate departures from the JAX package:

* **The recurrent form for prefill too.**  JAX runs prefill and forward
  through the chunked parallel form (``layers.gla_chunked``: padding to
  64-token chunks, masked intra-chunk matmuls, a scan across chunks), a
  TPU adaptation; here the WKV kernel walks any T in one launch, reading
  r/k/v/w once and keeping the state on chip.  Both compute the same
  recurrence (their sums run in other orders).
* **Weights are cast once**, as in :mod:`repro_torch.models.transformer`:
  the serving parameters hold in bf16 what ``cast_stacks`` / ``cast`` turn
  to bf16 at every JAX call (every stack of ndim ≥ 3 — ``mu``, ``mu_c``,
  ``u``, the projections, ``w_decay_a/b`` — and ``emb``, ``head``); ``ln1``,
  ``ln2``, ``w0``, ``wkv_ln`` and ``final_ln`` stay fp32.
* **The cache is updated in place**: each layer's WKV state
  ``(B, H, hd, hd)`` fp32 slice of ``cache["state"]`` is written by the
  kernel, and the shift caches by slice assignment, so a decode step copies
  no cache; the dict passed to :func:`prefill` / :func:`decode_step` is the
  one returned.  ``cache["pos"]`` is a host int.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L

DECAY_RANK = 64


def _d_att(cfg):
    return cfg.n_heads * cfg.rwkv_head_dim


def init_params(cfg, generator: Optional[torch.Generator] = None,
                device="cuda", seed: int = 0) -> dict:
    """Serving parameters drawn as the JAX ``init_params`` draws its masters
    (normal / √fan_in, ``w_decay_b`` × 0.1, the constant leaves), from
    ``generator`` (a fresh one seeded with ``seed`` on ``device`` when
    None), each stack cast to the compute dtype as soon as it is drawn."""
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    Lz, d, V = cfg.n_layers, cfg.d_model, cfg.padded_vocab
    da, H, hd = _d_att(cfg), cfg.n_heads, cfg.rwkv_head_dim

    def stack(shape, scale=None):
        x = L.stack_init(gen, Lz, shape, device=dev)
        return L.drawn(x if scale is None else x * scale)

    def const(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    return {
        "emb": L.drawn_leaf(L.dense_init(gen, (V, d), in_axis=-1,
                                         device=dev)),
        "blocks": {
            "ln1": const((Lz, d), 0.0),
            "ln2": const((Lz, d), 0.0),
            # token-shift mix ratios for r/k/v/g/w
            "mu": L.drawn(const((Lz, 5, d), 0.5)),
            "w_r": stack((d, da)),
            "w_k": stack((d, da)),
            "w_v": stack((d, da)),
            "w_g": stack((d, da)),
            "wo": stack((da, d)),
            "w0": const((Lz, da), -6.0),
            "w_decay_a": stack((d, DECAY_RANK)),
            "w_decay_b": stack((DECAY_RANK, da), 0.1),
            "u": L.drawn(const((Lz, H, hd), 0.1)),
            "wkv_ln": const((Lz, da), 0.0),
            # channel mix
            "mu_c": L.drawn(const((Lz, 2, d), 0.5)),
            "w_in": stack((d, cfg.d_ff)),
            "w_out": stack((cfg.d_ff, d)),
            "w_rc": stack((d, d)),
        },
        "final_ln": const((d,), 0.0),
        "head": L.drawn_leaf(L.dense_init(gen, (d, V), device=dev)),
    }


def _shift(x, prev=None):
    """Token shift: x_{t-1} (zeros / supplied state at t=0)."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1, :]
    return torch.cat([prev, x], dim=1)[:, :-1, :]


def _decay_log(pl, xw):
    """log w_t = -exp(w0 + tanh(xw A) B), guaranteed < 0 (fp32: w0 is)."""
    lowrank = torch.tanh(xw @ pl["w_decay_a"]) @ pl["w_decay_b"]
    return -torch.exp(pl["w0"] + lowrank)


def _time_mix(pl, cfg, x, prev_shift=None, state=None, state_out=None):
    """One layer's time mix.  ``state`` None: prefill / forward, the WKV
    state starting at zero; else decode, from ``state``.  The final state
    goes into ``state_out`` when given (it may be ``state``).  Returns the
    residual delta, the shift state ``h[:, -1:]`` and the final WKV state."""
    B, S, d = x.shape
    H, hd = cfg.n_heads, cfg.rwkv_head_dim
    h = L.rms_norm(x, pl["ln1"], cfg.norm_eps)
    hs = _shift(h, prev_shift)
    mu = pl["mu"]
    xr, xk, xv, xg, xw = (h + (hs - h) * mu[i] for i in range(5))

    def heads(y):
        return y.reshape(B, S, H, hd).transpose(1, 2)

    r = heads(xr @ pl["w_r"])
    k = heads(xk @ pl["w_k"])
    v = heads(xv @ pl["w_v"])
    g = F.silu(xg @ pl["w_g"])
    w = heads(torch.exp(_decay_log(pl, xw)))
    # JAX's decode step (layers.gla_step) leaves y in fp32, its chunked
    # prefill in r's type
    y, new_state = kops.wkv6(r, k, v, w, pl["u"], state, state_out=state_out,
                             out_dtype=None if state is None
                             else torch.float32)

    y = y.transpose(1, 2).reshape(B, S, H * hd)
    y = L.rms_norm(y, pl["wkv_ln"], cfg.norm_eps) * g
    out = (L.cast(y) @ L.cast(pl["wo"])).to(L.COMPUTE_DTYPE)
    return out, h[:, -1:, :], new_state


def _channel_mix(pl, cfg, x, prev_shift=None):
    h = L.rms_norm(x, pl["ln2"], cfg.norm_eps)
    hs = _shift(h, prev_shift)
    mu = pl["mu_c"]
    xk = h + (hs - h) * mu[0]
    xr = h + (hs - h) * mu[1]
    kk = torch.square(torch.relu(L.cast(xk) @ L.cast(pl["w_in"])))
    rr = torch.sigmoid(xr @ pl["w_rc"]).to(kk.dtype)
    out = rr * (kk @ L.cast(pl["w_out"]))
    return out.to(L.COMPUTE_DTYPE), h[:, -1:, :]


def _layer(params: dict, l: int) -> dict:
    return {key: val[l] for key, val in params["blocks"].items()}


def _embed(params, tokens):
    return L.embed(params["emb"], tokens)                 # (B, S, d)


def _head(params, cfg, h):
    h = L.rms_norm(h, params["final_ln"], cfg.norm_eps)
    return L.cast(h) @ L.cast(params["head"])


def forward(params, cfg, tokens, embeds=None):
    """Full-sequence forward.  Returns (B, S, padded_vocab) logits."""
    del embeds
    def layer(h, pl):
        h = h + _time_mix(pl, cfg, h)[0]
        return h + _channel_mix(pl, cfg, h)[0]

    h = _embed(params, tokens)
    for l in range(cfg.n_layers):
        h = L.run_layer(cfg, layer, h, _layer(params, l))
    return _head(params, cfg, h)


def init_cache(cfg, B, T, dtype=torch.bfloat16, device="cuda"):
    """Recurrent state — constant-size in T (the sub-quadratic family)."""
    del T
    dev = resolve_device(device)
    Lz, d = cfg.n_layers, cfg.d_model
    H, hd = cfg.n_heads, cfg.rwkv_head_dim
    return {
        "state": torch.zeros((Lz, B, H, hd, hd), dtype=torch.float32,
                             device=dev),
        "shift_t": torch.zeros((Lz, B, 1, d), dtype=dtype, device=dev),
        "shift_c": torch.zeros((Lz, B, 1, d), dtype=dtype, device=dev),
        "pos": 0,
    }


def _steps(params, cfg, cache, tokens):
    """The recurrent pass from the cache's state over ``tokens`` (B, S),
    the cache updated in place.  Returns (B, S, V) logits and the cache."""
    h = _embed(params, tokens)
    for l in range(cfg.n_layers):
        pl = _layer(params, l)
        st = cache["state"][l]
        a, sh_t, _ = _time_mix(pl, cfg, h,
                               prev_shift=L.cast(cache["shift_t"][l]),
                               state=st, state_out=st)
        h = h + a
        c, sh_c = _channel_mix(pl, cfg, h,
                               prev_shift=L.cast(cache["shift_c"][l]))
        h = h + c
        cache["shift_t"][l] = sh_t
        cache["shift_c"][l] = sh_c
    cache["pos"] = int(cache["pos"]) + tokens.shape[1]
    return _head(params, cfg, h), cache


def prefill(params, cfg, tokens, cache, embeds=None):
    """Run the prompt from a zero state (the cache's incoming state is not
    read, as in the JAX package), filling the cache in place.  Returns the
    last position's logits (B, 1, V) and the cache."""
    del embeds
    h = _embed(params, tokens)
    for l in range(cfg.n_layers):
        pl = _layer(params, l)
        a, sh_t, _ = _time_mix(pl, cfg, h, state_out=cache["state"][l])
        h = h + a
        c, sh_c = _channel_mix(pl, cfg, h)
        h = h + c
        cache["shift_t"][l] = sh_t
        cache["shift_c"][l] = sh_c
    cache["pos"] = int(cache["pos"]) + tokens.shape[1]
    return _head(params, cfg, h[:, -1:]), cache


def decode_step(params, cfg, cache, tokens):
    return _steps(params, cfg, cache, tokens)
