"""Model registry: ``ModelConfig.family`` → implementation module
(counterpart of ``repro.models.registry``).

Uniform API of a ported family:
  init_params(cfg, generator, device)               -> params dict
  forward(params, cfg, tokens, embeds=None)         -> (B, S, V) logits
  init_cache(cfg, B, T, device=...)                 -> serving cache dict
  prefill(params, cfg, tokens, cache, embeds=None)  -> (logits, cache)
  decode_step(params, cfg, cache, tokens)           -> (logits, cache)

The port runs the dense family and RWKV-6 (``"ssm"``); the other
families raise :class:`NotImplementedError` naming the item that brings
them.
"""
from __future__ import annotations

import types

from repro_torch.models import rwkv, transformer

_UNPORTED = {
    "moe": "MoE layers (layers.moe)",
    "vlm": "the VLM frontend",
    "hybrid": "the hybrid family (models/hybrid.py)",
    "encdec": "the encoder-decoder family (models/encdec.py)",
}


def get_model(cfg) -> types.ModuleType:
    if cfg.family == "dense":
        return transformer
    if cfg.family == "ssm":
        return rwkv
    if cfg.family in _UNPORTED:
        raise NotImplementedError(f"{_UNPORTED[cfg.family]} is not ported "
                                  f"yet: ROADMAP queue 1 item 14")
    raise KeyError(f"unknown model family {cfg.family!r}")
