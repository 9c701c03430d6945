"""Model registry: ``ModelConfig.family`` → implementation module
(counterpart of ``repro.models.registry``).

Uniform API of a ported family:
  init_params(cfg, generator, device)               -> params dict
  forward(params, cfg, tokens, embeds=None)         -> (B, S, V) logits
  init_cache(cfg, B, T, device=...)                 -> serving cache dict
  prefill(params, cfg, tokens, cache, embeds=None)  -> (logits, cache)
  decode_step(params, cfg, cache, tokens)           -> (logits, cache)

Every family of the JAX registry is ported: the dense transformer, MoE
(the same transformer with ``layers.moe`` for its MLP) and the VLM (the
same with prepended patch embeddings), RWKV-6 (``"ssm"``), the hybrid and
the encoder-decoder.
"""
from __future__ import annotations

import types

from repro_torch.models import encdec, hybrid, rwkv, transformer


def get_model(cfg) -> types.ModuleType:
    families = {"dense": transformer, "moe": transformer, "vlm": transformer,
                "ssm": rwkv, "hybrid": hybrid, "encdec": encdec}
    if cfg.family not in families:
        raise KeyError(f"unknown model family {cfg.family!r}")
    return families[cfg.family]
