"""Decoder-only transformer LM for the dense, MoE and VLM families
(counterpart of ``repro.models.transformer``).

``init_params``, ``forward``, ``init_cache``, ``prefill`` and
``decode_step`` with the JAX package's signatures and parameter tree
(``emb``, ``attn``, ``mlp`` or ``moe``, ``final_ln``, ``head``; stacks with
a leading layer axis), run as a Python loop over the layers; ``forward``
runs each layer under ``layers.run_layer`` (``cfg.remat``: recomputed in
the backward, as ``jax.checkpoint`` per scanned layer there).  The VLM family prepends ``embeds``, the frontend's
precomputed patch embeddings (a stub there too), to the token embeddings:
rope positions count them, and decode starts at ``frontend_tokens + S``.

Two deliberate departures from the JAX package:

* **Weights are cast once.**  The serving parameters hold in bf16 what
  ``cast_stacks`` / ``cast`` turn to bf16 at every JAX call — the stacks of
  ndim ≥ 3, ``emb`` and ``head``; the norm scales stay fp32.  These are the
  same bits, and recasting 33 GB of fp32 masters at every decode step would
  be the largest cost of serving.  :func:`init_params` draws fp32 and casts
  one stack at a time (``layers.attention_params`` / ``mlp_params``; the
  MoE's expert stacks one layer at a time, ``layers.moe_params``);
  ``convert.params_from_jax`` does the same for a JAX parameter tree.
* **The KV cache is written in place** at ``[..., pos:pos + S, :]`` of each
  layer (JAX's ``dynamic_update_slice`` gives the same values in a new
  array), so a decode step copies no cache; the cache dict passed to
  :func:`prefill` / :func:`decode_step` is the one returned, updated.
  ``cache["pos"]`` is a host int, so the attention's ``kv_valid_len`` costs
  no device read.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L

def init_params(cfg, generator: Optional[torch.Generator] = None,
                device="cuda", seed: int = 0) -> dict:
    """Serving parameters drawn as the JAX ``init_params`` draws its masters
    (normal / √fan_in, zero norm scales), from ``generator`` (a fresh one
    seeded with ``seed`` on ``device`` when None), each stack cast to the
    compute dtype as soon as it is drawn."""
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    d, V = cfg.d_model, cfg.padded_vocab
    return {
        "emb": L.drawn_leaf(L.dense_init(gen, (V, d), in_axis=-1,
                                         device=dev)),
        "attn": L.attention_params(gen, cfg, cfg.n_layers, device=dev),
        "final_ln": torch.zeros((d,), dtype=torch.float32, device=dev),
        "head": L.drawn_leaf(L.dense_init(gen, (d, V), device=dev)),
        **({"moe": L.moe_params(gen, cfg, cfg.n_layers, device=dev)}
           if cfg.is_moe else
           {"mlp": L.mlp_params(gen, cfg, cfg.n_layers, device=dev)}),
    }


def _layer(params: dict, l: int) -> dict:
    ffn = "moe" if "moe" in params else "mlp"
    return {"attn": L.slice_layer(params["attn"], l),
            ffn: L.slice_layer(params[ffn], l)}


def _block(cfg, h, pl, mode="train", cache_l=None, cache_pos=None):
    a, cache_l = L.attention(pl["attn"], h, cfg, mode=mode, cache=cache_l,
                             cache_pos=cache_pos)
    h = h + a
    if cfg.is_moe:
        return h + L.moe(pl["moe"], h, cfg), cache_l
    return h + L.mlp(pl["mlp"], h, cfg), cache_l


def _embed(params, cfg, tokens, embeds):
    x = L.embed(params["emb"], tokens)                    # (B, S, d)
    if embeds is not None:                              # vlm: prepend patches
        x = torch.cat([L.cast(embeds), x], dim=1)
    return x


def forward(params, cfg, tokens, embeds=None):
    """Full-sequence causal forward.  Returns (B, F + S, padded_vocab)
    logits, F the patch embeddings prepended (0 without ``embeds``)."""
    h = _embed(params, cfg, tokens, embeds)
    for l in range(cfg.n_layers):
        h = L.run_layer(cfg, lambda h, pl: _block(cfg, h, pl)[0], h,
                        _layer(params, l))
    h = L.rms_norm(h, params["final_ln"], cfg.norm_eps)
    return L.cast(h) @ L.cast(params["head"])


def init_cache(cfg, B, T, dtype=torch.bfloat16, device="cuda"):
    dev = resolve_device(device)
    shape = (cfg.n_layers, B, cfg.n_kv_heads, T, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev), "pos": 0}


def prefill(params, cfg, tokens, cache, embeds=None):
    """Run the prompt through the model, filling the KV cache (in place).
    Returns the last position's logits (B, 1, V) and the cache."""
    h = _embed(params, cfg, tokens, embeds)
    S = h.shape[1]
    for l in range(cfg.n_layers):
        h, _ = _block(cfg, h, _layer(params, l), mode="prefill",
                      cache_l={"k": cache["k"][l], "v": cache["v"][l]},
                      cache_pos=0)
    h = L.rms_norm(h, params["final_ln"], cfg.norm_eps)
    logits = L.cast(h[:, -1:]) @ L.cast(params["head"])
    cache["pos"] = S
    return logits, cache


def decode_step(params, cfg, cache, tokens):
    """One token per sequence (B, 1) against the KV cache (written in
    place).  Returns (B, 1, V) logits and the cache."""
    h = _embed(params, cfg, tokens, None)
    pos = int(cache["pos"])
    for l in range(cfg.n_layers):
        h, _ = _block(cfg, h, _layer(params, l), mode="decode",
                      cache_l={"k": cache["k"][l], "v": cache["v"][l]},
                      cache_pos=pos)
    h = L.rms_norm(h, params["final_ln"], cfg.norm_eps)
    logits = L.cast(h) @ L.cast(params["head"])
    cache["pos"] = pos + 1
    return logits, cache
