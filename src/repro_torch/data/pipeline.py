"""Deterministic synthetic LM data (counterpart of
``repro.data.pipeline``).

Batches are a pure function of (seed, step): the same NumPy draws as the
JAX package (a Zipfian unigram model with short-range repeats), handed out
as tensors on the requested device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend: Optional[str] = None       # "audio"/"vision" → also emit embeds
    frontend_tokens: int = 0
    d_model: int = 0


def _zipf_probs(vocab: int, alpha: float = 1.1) -> np.ndarray:
    r = np.arange(1, vocab + 1, dtype=np.float64)
    p = r ** (-alpha)
    return (p / p.sum()).astype(np.float64)


class SyntheticLM:
    def __init__(self, cfg: DataConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.probs = _zipf_probs(cfg.vocab_size)

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        toks = rng.choice(cfg.vocab_size, size=(cfg.global_batch, cfg.seq_len),
                          p=self.probs)
        # short-range structure: repeat previous token with p=0.3
        rep = rng.random((cfg.global_batch, cfg.seq_len)) < 0.3
        for s in range(1, cfg.seq_len):
            toks[:, s] = np.where(rep[:, s], toks[:, s - 1], toks[:, s])
        out = {"tokens": torch.as_tensor(toks.astype(np.int32),
                                         device=self.device)}
        if cfg.frontend:
            P = cfg.frontend_tokens if cfg.frontend == "vision" else cfg.seq_len
            emb = rng.standard_normal((cfg.global_batch, P, cfg.d_model),
                                      np.float32) * 0.02
            out["embeds"] = torch.as_tensor(emb, device=self.device)
        return out

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def batch_for(cfg, shape, seed: int = 0, step: int = 0, device="cuda"
              ) -> dict:
    """One batch matching a (ModelConfig, ShapeConfig) cell."""
    dcfg = DataConfig(
        vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
        global_batch=shape.global_batch, seed=seed,
        frontend=cfg.frontend, frontend_tokens=cfg.frontend_tokens,
        d_model=cfg.d_model)
    return SyntheticLM(dcfg, device).batch(step)
