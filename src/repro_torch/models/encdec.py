"""Whisper-style encoder-decoder backbone (counterpart of
``repro.models.encdec``; the audio frontend is a stub there too: the
caller passes precomputed frame embeddings).

Encoder: non-causal self-attention stack over frame embeddings plus a
learned position table (8,192 rows, tiled past that).  Decoder: causal
self-attention, cross-attention to the encoder output, MLP.  Serving: the
decoder's self-attention KV cache and a cross-attention cache filled once
at prefill, attended under ``kv_valid_len = enc_len`` at each decode step.
Every attention goes through :func:`repro_torch.kernels.ops.flash_attention`.

Departures from the JAX package, as in :mod:`repro_torch.models.transformer`:
weights are cast once (the stacks of ``encoder`` and ``decoder``, ``emb``
and ``head`` in bf16; the norm scales and ``enc_pos`` fp32, the table
cast at use as there), and the caches are written in place;
``cache["pos"]`` and ``cache["enc_len"]`` are host ints.  A prompt with
more frames than the cross cache has slots raises ``ValueError`` (the
JAX package's ``dynamic_update_slice`` would clamp the write).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L

ENC_POS = 8192     # rows of the encoder's position table


def init_params(cfg, generator: Optional[torch.Generator] = None,
                device="cuda", seed: int = 0) -> dict:
    """Serving parameters drawn as the JAX ``init_params`` draws its masters
    (normal / √fan_in, ``enc_pos`` 0.02·N(0, 1), zero norm scales), from
    ``generator`` (a fresh one seeded with ``seed`` on ``device`` when
    None), each stack cast as soon as it is drawn."""
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    Le, Ld, d, V = cfg.encoder_layers, cfg.n_layers, cfg.d_model, \
        cfg.padded_vocab
    return {
        "emb": L.drawn_leaf(L.dense_init(gen, (V, d), in_axis=-1,
                                         device=dev)),
        "enc_pos": 0.02 * torch.randn((ENC_POS, d), generator=gen,
                                      device=dev),
        "encoder": {
            "attn": L.attention_params(gen, cfg, Le, device=dev),
            "mlp": L.mlp_params(gen, cfg, Le, device=dev),
        },
        "decoder": {
            "attn": L.attention_params(gen, cfg, Ld, device=dev),
            "cross": L.attention_params(gen, cfg, Ld, cross=True,
                                        device=dev),
            "mlp": L.mlp_params(gen, cfg, Ld, device=dev),
        },
        "enc_ln": torch.zeros((d,), dtype=torch.float32, device=dev),
        "final_ln": torch.zeros((d,), dtype=torch.float32, device=dev),
        "head": L.drawn_leaf(L.dense_init(gen, (d, V), device=dev)),
    }


def enc_positions(params, S: int) -> torch.Tensor:
    """The first S rows of the position table, tiled past its length."""
    pos = params["enc_pos"]
    if S > pos.shape[0]:
        pos = pos.repeat(-(-S // pos.shape[0]), 1)
    return pos[:S]


def encode(params, cfg, frames):
    """frames: (B, S_enc, d) stub frontend output (conv-downsampled mel)."""
    h = L.cast(frames) + L.cast(enc_positions(params, frames.shape[1]))[None]

    def layer(h, pl):
        h = h + L.attention(pl["attn"], h, cfg, mode="train",
                            causal=False)[0]
        return h + L.mlp(pl["mlp"], h, cfg)

    for l in range(cfg.encoder_layers):
        h = L.run_layer(cfg, layer, h, L.slice_layer(params["encoder"], l))
    return L.rms_norm(h, params["enc_ln"], cfg.norm_eps)


def _decoder_block(cfg, h, pl, enc_out, mode="train", caches=None,
                   cache_pos=None):
    self_c = cross_c = None
    if caches is not None:
        self_c = {"k": caches["k"], "v": caches["v"]}
        cross_c = {"k": caches["xk"], "v": caches["xv"]}
    a, _ = L.attention(pl["attn"], h, cfg, mode=mode, cache=self_c,
                       cache_pos=cache_pos)
    h = h + a
    if mode == "decode":
        x, _ = L.attention(pl["cross"], h, cfg, mode="cross_decode",
                           cache=cross_c, kv_valid_len=caches["enc_len"])
    else:
        x, _ = L.attention(pl["cross"], h, cfg,
                           mode="prefill" if caches is not None else "train",
                           kv_src=enc_out, cache=cross_c, cache_pos=0)
    h = h + x
    return h + L.mlp(pl["mlp"], h, cfg)


def _frames(embeds):
    if embeds is None:
        raise ValueError("the encoder-decoder family needs frame embeddings "
                         "(embeds)")
    return embeds


def forward(params, cfg, tokens, embeds=None):
    """Teacher-forced decode over ``tokens`` given ``embeds`` frames.
    Returns (B, S, padded_vocab) logits."""
    enc_out = encode(params, cfg, _frames(embeds))
    h = L.embed(params["emb"], tokens)
    for l in range(cfg.n_layers):
        h = L.run_layer(cfg, lambda h, pl: _decoder_block(cfg, h, pl,
                                                          enc_out),
                        h, L.slice_layer(params["decoder"], l))
    h = L.rms_norm(h, params["final_ln"], cfg.norm_eps)
    return L.cast(h) @ L.cast(params["head"])


def init_cache(cfg, B, T, dtype=torch.bfloat16, device="cuda",
               enc_len: Optional[int] = None):
    """The decoder's self-attention cache of T slots and its cross cache of
    ``enc_len`` slots (T when None, as the JAX package)."""
    dev = resolve_device(device)
    enc_len = enc_len or T
    kv = (cfg.n_layers, B, cfg.n_kv_heads, T, cfg.hd)
    xkv = (cfg.n_layers, B, cfg.n_kv_heads, enc_len, cfg.hd)
    return {"k": torch.zeros(kv, dtype=dtype, device=dev),
            "v": torch.zeros(kv, dtype=dtype, device=dev),
            "xk": torch.zeros(xkv, dtype=dtype, device=dev),
            "xv": torch.zeros(xkv, dtype=dtype, device=dev),
            "enc_len": 0, "pos": 0}


def _run_cached(params, cfg, cache, tokens, enc_out, mode):
    h = L.embed(params["emb"], tokens)
    pos = int(cache["pos"])
    for l in range(cfg.n_layers):
        caches = {"k": cache["k"][l], "v": cache["v"][l],
                  "xk": cache["xk"][l], "xv": cache["xv"][l],
                  "enc_len": cache["enc_len"]}
        h = _decoder_block(cfg, h, L.slice_layer(params["decoder"], l),
                           enc_out, mode=mode, caches=caches, cache_pos=pos)
    h = L.rms_norm(h[:, -1:] if mode == "prefill" else h,
                   params["final_ln"], cfg.norm_eps)
    cache["pos"] = pos + tokens.shape[1]
    return L.cast(h) @ L.cast(params["head"]), cache


def prefill(params, cfg, tokens, cache, embeds=None):
    """Encode the frames, fill the cross cache with their K/V and the self
    cache with the prompt's (in place); ``enc_len`` becomes the frame
    count.  Returns the last position's logits (B, 1, V) and the cache."""
    frames = _frames(embeds)
    slots = cache["xk"].shape[3]
    if frames.shape[1] > slots:
        raise ValueError(
            f"{frames.shape[1]} frames do not fit the cross cache's {slots} "
            f"slots: init_cache's enc_len (T when None; make_serve_fns' "
            f"cache_len) must be at least the frame count")
    enc_out = encode(params, cfg, frames)
    cache["enc_len"] = frames.shape[1]
    return _run_cached(params, cfg, cache, tokens, enc_out, "prefill")


def decode_step(params, cfg, cache, tokens):
    """One token per sequence (B, 1): self-attention over the cache,
    cross-attention over the first ``enc_len`` cross slots.  Returns (B,
    1, V) logits and the cache (updated in place)."""
    return _run_cached(params, cfg, cache, tokens, None, "decode")
