"""The LM train step: microbatched gradient accumulation + AdamW
(counterpart of ``repro.train.train_step``).

Every registered family trains through its ``forward``; the masters are
fp32 (``init_train_state`` draws them under ``layers.masters``: the same
draw as the serving parameters, not cast), and each microbatch's forward
runs on ``layers.serving_view`` of them — the casts the JAX package makes
at every call — so their gradients come back through the casts in fp32.
Each layer runs under ``layers.run_layer`` (``cfg.remat``).

On the card attention's and ``wkv6``'s gradients come from their
hand-written backward kernels (``ops.flash_attention``, ``ops.wkv6``), so
every family trains there, RWKV-6 and the hybrid included.  The
embedding's gradient is summed by ``F.embedding``'s backward
(``layers.embed``), whose CUDA kernel sums each row in a fixed order, and
no other op of the path accumulates with atomics: a step is a function of
its state and batch, bit for bit, which checkpoint resume relies on.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.train import optimizer as opt_lib


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
            loss_mask: Optional[torch.Tensor] = None,
            vocab_size: Optional[int] = None) -> torch.Tensor:
    """Next-token CE.  logits: (B, S', V) with S' = S + prefix; labels are
    tokens shifted left (prefix positions are unsupervised).  vocab_size
    masks padded-vocab logits out of the partition function."""
    B, Sp, V = logits.shape
    S = tokens.shape[1]
    off = Sp - S
    lg = logits[:, off:Sp - 1 + off][:, :S - 1].float()
    if vocab_size is not None and vocab_size < V:
        keep = torch.arange(V, device=lg.device) < vocab_size
        lg = torch.where(keep, lg, -1e30)
    labels = tokens[:, 1:].long()
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels[..., None])[..., 0]
    nll = logz - gold
    if loss_mask is not None:
        m = loss_mask[:, 1:].float()
        return torch.sum(nll * m) / torch.clamp_min(torch.sum(m), 1.0)
    return torch.mean(nll)


def init_train_state(cfg, opt_cfg: opt_lib.OptConfig, key=0,
                     device="cuda") -> dict:
    """fp32 master parameters drawn from ``key`` (an int seed or a
    ``torch.Generator``) on ``device``, and zero AdamW moments."""
    dev = resolve_device(device)
    model = get_model(cfg)
    gen = key if isinstance(key, torch.Generator) else None
    seed = 0 if gen is not None else int(key)
    with L.masters():
        params = model.init_params(cfg, gen, device=dev, seed=seed)
    return {"params": params, "opt": opt_lib.init_opt_state(opt_cfg, params)}


def make_train_step(cfg, opt_cfg: opt_lib.OptConfig):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    batch: {"tokens": (B, S) int32, optional "embeds": (B, P, d)}.  B is
    split into ``cfg.microbatches`` along dim 0; each microbatch's
    gradients are summed into fp32 in order, then ``loss / n_micro`` and
    ``g / n_micro`` as in the JAX package (one microbatch: no division).
    The state is updated in place and returned (the JAX step donates it);
    metrics are 0-d tensors ``loss``, ``grad_norm``, ``lr``.  A list
    given as ``keep_grads`` receives the step's gradient leaves (in the
    JAX tree's order, after the division), where a check reads them."""
    model = get_model(cfg)
    n_micro = max(cfg.microbatches, 1)

    def loss_fn(params, tokens, embeds):
        logits = model.forward(L.serving_view(params), cfg, tokens,
                               embeds=embeds)
        return lm_loss(logits, tokens, vocab_size=cfg.vocab_size)

    def train_step(state: dict, batch: dict, *, keep_grads=None
                   ) -> tuple[dict, dict]:
        tokens = batch["tokens"]
        embeds = batch.get("embeds")
        B = tokens.shape[0]
        if B % n_micro:
            raise ValueError(f"batch {B} does not split into {n_micro} "
                             "microbatches")
        params = state["params"]
        leaves = opt_lib.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        mb = B // n_micro
        loss_acc = None
        try:
            with torch.enable_grad():
                for i in range(n_micro):
                    sl = slice(i * mb, (i + 1) * mb)
                    loss = loss_fn(params, tokens[sl],
                                   None if embeds is None else embeds[sl])
                    loss.backward()
                    loss = loss.detach()
                    loss_acc = loss if n_micro == 1 else (
                        (0.0 if loss_acc is None else loss_acc) + loss)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = opt_lib.tree_map(lambda p: _take_grad(p), params)
        if n_micro > 1:
            loss_acc = loss_acc / n_micro
            for g in opt_lib.tree_leaves(grads):
                g.div_(n_micro)
        if keep_grads is not None:
            keep_grads.extend(opt_lib.tree_leaves(grads))
        params, opt_state, aux = opt_lib.apply_updates(
            opt_cfg, params, grads, state["opt"])
        del grads
        return {"params": params, "opt": opt_state}, {"loss": loss_acc,
                                                      **aux}

    return train_step


def _take_grad(p: torch.Tensor) -> torch.Tensor:
    """``p``'s accumulated gradient, detached from it (zeros where no
    microbatch reached ``p``, as a JAX gradient of an unused leaf)."""
    g = p.grad
    p.grad = None
    if g is None:
        return torch.zeros_like(p)
    return g
