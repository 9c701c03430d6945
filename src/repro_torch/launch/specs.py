"""Abstract inputs of every dry-run cell (the port's counterpart of
``repro.launch.specs``).

No memory is allocated here: parameters, optimizer state, caches and
batches are tensors without data, made by running the models' own
``init_params``, ``init_train_state`` and ``init_cache`` on them, as
``jax.eval_shape`` runs the JAX package's.  On the card's path
(``device="cuda"``) they are ``meta`` tensors (``device.dry_card``), on
which every kernel wrapper takes its dry branch; on the plain path
(``device="cpu"``) ``FakeTensorMode`` CPU tensors.  Run both the specs and
the call they feed inside one :func:`abstract` context.  The draws take a
CPU generator: a meta tensor has no generator of its own.

The production meshes and their shardings are ROADMAP item 15: any mesh
raises ``NotImplementedError``.
"""
from __future__ import annotations

import contextlib
from typing import Any

import torch

from repro_torch.device import dry_card, resolve_device
from repro_torch.models import get_model
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts_lib


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "the production meshes and their shardings (2x16x16, 16x16) "
            "come with multi-GPU, ROADMAP item 15; the dry run counts one "
            "card (mesh '1')")


@contextlib.contextmanager
def abstract(device: str = "cuda"):
    """The context the abstract inputs and their call run in: the card's
    ``meta`` stand-in for ``"cuda"``, a ``FakeTensorMode`` for
    ``"cpu"``."""
    if torch.device(device).type == "cpu":
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            yield
    else:
        with dry_card():
            yield


def _gen() -> torch.Generator:
    g = torch.Generator()
    g.manual_seed(0)
    return g


def abstract_params(cfg, mesh=None, device: str = "cuda") -> dict:
    """The serving parameters of ``cfg`` (call inside :func:`abstract`)."""
    _no_mesh(mesh)
    return get_model(cfg).init_params(cfg, _gen(),
                                      device=resolve_device(device))


def abstract_train_state(cfg, opt_cfg, mesh=None,
                         device: str = "cuda") -> dict:
    """The fp32 masters and AdamW moments of ``cfg``."""
    _no_mesh(mesh)
    return ts_lib.init_train_state(cfg, opt_cfg, _gen(),
                                   device=resolve_device(device))


def abstract_cache(cfg, B: int, T: int, mesh=None,
                   device: str = "cuda") -> dict:
    """The serving cache of ``B`` sequences of ``T`` slots (and the VLM's
    patch slots)."""
    _no_mesh(mesh)
    extra = cfg.frontend_tokens if cfg.family == "vlm" else 0
    return get_model(cfg).init_cache(cfg, B, T + extra,
                                     device=resolve_device(device))


def input_specs(cfg, shape, mesh=None, *, opt_cfg=None,
                device: str = "cuda") -> dict:
    """Abstract inputs for one (arch × shape) cell.

    train:   {"state", "batch"}             for train_step(state, batch)
    prefill: {"params", "tokens", "embeds"} for prefill_step
    decode:  {"params", "cache", "tokens"}  for decode_step: one new token
             at the last slot of a ``seq_len`` cache (``pos`` = its slots
             − 1; the encoder-decoder's cross cache full)
    """
    _no_mesh(mesh)
    dev = resolve_device(device)
    B, S = shape.global_batch, shape.seq_len
    out: dict[str, Any] = {}

    def tokens(n):
        return torch.zeros((B, n), dtype=torch.int32, device=dev)

    def embeds(S_emb):
        P_ = cfg.frontend_tokens if cfg.family == "vlm" else S_emb
        return torch.empty((B, P_, cfg.d_model), dtype=torch.float32,
                           device=dev)

    if shape.kind == "train":
        opt_cfg = opt_cfg or opt_lib.OptConfig(moment_dtype=cfg.moment_dtype)
        out["state"] = abstract_train_state(cfg, opt_cfg, device=device)
        out["batch"] = {"tokens": tokens(S)}
        if cfg.frontend:
            out["batch"]["embeds"] = embeds(S)
    elif shape.kind == "prefill":
        out["params"] = abstract_params(cfg, device=device)
        out["tokens"] = tokens(S)
        if cfg.frontend:
            out["embeds"] = embeds(S)
    else:
        out["params"] = abstract_params(cfg, device=device)
        cache = abstract_cache(cfg, B, S, device=device)
        slots = cache["k"].shape[3] if "k" in cache else S
        cache["pos"] = slots - 1
        if "enc_len" in cache:
            cache["enc_len"] = cache["xk"].shape[3]
        out["cache"] = cache
        out["tokens"] = tokens(1)
    return out
