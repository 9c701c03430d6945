"""AdamW with a configurable moment dtype and a warmup + cosine schedule
(counterpart of ``repro.train.optimizer``).

The same arithmetic as the JAX package, in its order: the schedule, the
bias corrections and the update in fp32, the moments kept in
``moment_dtype`` (rounded to nearest even, as ``astype`` rounds), the
global norm a sum of per-leaf sums in the JAX tree's leaf order
(:func:`tree_leaves`: dict keys sorted).  Parameters and moments are
updated in place (the JAX step donates its state), one leaf at a time.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    clip_norm: float = 1.0
    moment_dtype: str = "bfloat16"


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a JAX dtype name (``"bfloat16"``, ``"float32"``)."""
    return getattr(torch, name)


def tree_leaves(tree: Any) -> list:
    """The leaves of a nested dict in ``jax.tree_util.tree_flatten``'s
    order: keys sorted at every level."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in tree_leaves(tree[key])]
    return [tree]


def tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {key: tree_map(fn, val) for key, val in tree.items()}
    return fn(tree)


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), fp32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init_opt_state(cfg: OptConfig, params: Any) -> dict:
    dt = dtype_of(cfg.moment_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    device = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def apply_updates(cfg: OptConfig, params: Any, grads: Any,
                  opt_state: dict) -> tuple[Any, dict, dict]:
    """One AdamW step with global-norm clipping, in place.  Returns
    ``(params, opt_state, {"grad_norm", "lr"})``: ``params`` and the
    moments are the trees passed in, updated; ``step`` a new tensor."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / (gnorm + 1e-9), 1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)
    dt = dtype_of(cfg.moment_dtype)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state["mu"]),
                          tree_leaves(opt_state["nu"])):
        # the JAX package's expressions, one rounding an operation in its
        # order, computed in place on three fp32 temporaries
        g = g.float() * scale                          # g
        m32 = m.to(torch.float32, copy=True).mul_(b1)  # b1 m
        t = torch.mul(g, 1 - b1)                       # (1 - b1) g
        m32.add_(t)                                    # m32
        v32 = v.to(torch.float32, copy=True).mul_(b2)  # b2 v
        torch.mul(g, 1 - b2, out=t).mul_(g)            # (1 - b2) g g
        v32.add_(t)                                    # v32
        del g
        m.copy_(m32)
        v.copy_(v32)
        torch.div(v32, bc2, out=t).sqrt_().add_(cfg.eps)   # √vhat + eps
        del v32
        m32.div_(bc1).div_(t)                          # mhat / (√vhat + eps)
        torch.mul(p.float(), cfg.weight_decay, out=t)  # wd p
        m32.add_(t).mul_(lr)                           # lr · delta
        del t
        if p.dtype == torch.float32:
            p.sub_(m32)
        else:
            p.copy_((p.float() - m32).to(p.dtype))
    return params, {"mu": opt_state["mu"], "nu": opt_state["nu"],
                    "step": step}, {"grad_norm": gnorm, "lr": lr}
