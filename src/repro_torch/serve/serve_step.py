"""LM decode serving: batched prefill + decode drivers over the model API
(counterpart of ``repro.serve.serve_step``).

``make_serve_fns`` returns plain callables: PyTorch runs eagerly, so there
is nothing to compile once per closure.  :func:`greedy_generate` keeps the
next token on the card: no host read per step (the cache position is a
host int that the drivers count themselves).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import get_model


def make_serve_fns(cfg, cache_len: int):
    """Returns (prefill_fn, decode_fn) for this configuration and cache
    length; the cache is made on the device of the parameters, with
    ``frontend_tokens`` more slots for the VLM family (its patch
    embeddings)."""
    model = get_model(cfg)

    def prefill_fn(params, tokens, embeds=None):
        B = tokens.shape[0]
        extra = cfg.frontend_tokens if cfg.family == "vlm" else 0
        cache = model.init_cache(cfg, B, cache_len + extra,
                                 device=params["emb"].device)
        return model.prefill(params, cfg, tokens, cache, embeds=embeds)

    def decode_fn(params, cache, tokens):
        return model.decode_step(params, cfg, cache, tokens)

    return prefill_fn, decode_fn


def next_token(logits: torch.Tensor) -> torch.Tensor:
    """(B, 1) int32 greedy pick of the last position over the padded vocab;
    ties go to the first maximum, as ``jnp.argmax``."""
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]


def greedy_generate(cfg, params, prompt: torch.Tensor, n_new: int,
                    cache_len: Optional[int] = None, embeds=None
                    ) -> torch.Tensor:
    """Greedy decoding of n_new tokens for a (B, S) prompt batch."""
    B, S = prompt.shape
    cache_len = cache_len or (S + n_new)
    prefill_fn, decode_fn = make_serve_fns(cfg, cache_len)
    logits, cache = prefill_fn(params, prompt, embeds)
    tok = next_token(logits)
    out = [tok]
    for _ in range(n_new - 1):
        logits, cache = decode_fn(params, cache, tok)
        tok = next_token(logits)
        out.append(tok)
    return torch.cat(out, dim=1)
