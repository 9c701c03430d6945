"""LM training launcher (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
        [--steps N] [--seq L] [--batch B] [--lr LR] [--reduced] \
        [--ckpt-dir DIR] [--resume] [--seed S] [--device cuda|cpu]

Every flag of the JAX launcher keeps its name and default; ``--device``
picks the card (the default; no fallback) or the CPU's plain versions.
``--reduced`` trains the architecture's smoke-scale config.  The printed
lines are the JAX launcher's: ``step … loss … gnorm … lr …`` at the first
step and every tenth, ``[straggler-flag]`` on a step slower than 3× the
window's median, ``resumed from step N`` after ``--resume``.

Batches are a function of (seed, step) and a step a function of its state
and batch to the bit, so a run resumed from a step checkpoint (every 25
steps, the last 3 kept) equals the uninterrupted run.  ``--use-mesh`` and
``--multi-pod`` (the production mesh, tensor- and data-parallel) are not
ported: they raise ``NotImplementedError`` (ROADMAP item 15).  On the card
RWKV-6 and the hybrid raise ``NotImplementedError`` at their first
backward (no ``wkv6`` backward kernel yet).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts_lib
from repro_torch.train.fault_tolerance import (CheckpointManager,
                                               StragglerMonitor)

MESH_ITEM = ("the production mesh (tensor and data parallelism across "
             "cards) is ROADMAP item 15, not ported")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--use-mesh", action="store_true",
                    help="build the production mesh (needs matching devices)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def run(args: argparse.Namespace, state: dict | None = None) -> dict:
    """Train as the flags say; ``state`` (e.g. ``convert.
    train_state_from_jax`` of the JAX launcher's initial state) replaces
    the initial draw.  Returns {"state", "metrics": one dict of floats a
    step run}."""
    if args.use_mesh or args.multi_pod:
        raise NotImplementedError(f"--use-mesh / --multi-pod: {MESH_ITEM}")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    opt_cfg = opt_lib.OptConfig(lr=args.lr, total_steps=args.steps,
                                moment_dtype=cfg.moment_dtype)
    if state is None:
        state = ts_lib.init_train_state(cfg, opt_cfg, args.seed, device=dev)
    step_fn = ts_lib.make_train_step(cfg, opt_cfg)
    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed,
        frontend=cfg.frontend, frontend_tokens=cfg.frontend_tokens,
        d_model=cfg.d_model), device=dev)

    start = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, every_steps=25, keep=3)
        if args.resume:
            restored, start = mgr.restore_latest(state)
            if restored is not None:
                state = restored
                print(f"resumed from step {start}")

    mon = StragglerMonitor()
    history = []
    for step in range(start, args.steps):
        mon.start()
        state, metrics = step_fn(state, data.batch(step))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        slow = mon.stop()
        history.append({k: float(v) for k, v in metrics.items()})
        if mgr:
            mgr.maybe_save(step + 1, state)
        if (step + 1) % 10 == 0 or step == start:
            m = history[-1]
            print(f"step {step + 1:5d} loss {m['loss']:.4f} "
                  f"gnorm {m['grad_norm']:.3f} "
                  f"lr {m['lr']:.2e}"
                  + ("  [straggler-flag]" if slow else ""), flush=True)
    return {"state": state, "metrics": history}


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
