"""End-to-end driver: submodular data selection → LM pretraining
(counterpart of ``examples/train_lm_with_selection.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_lm_with_selection \
        [--arch gemma-2b] [--steps 200] [--d-model 256] [--layers 8] \
        [--seq 128] [--batch 16] [--device cuda|cpu]

The production path of the paper inside an LM framework, on one device
(the card unless ``--device cpu``):
  1. a candidate pool of 512 token sequences (SyntheticLM),
  2. their mean-pooled embedding rows, and TREE compression under capacity
     128 picking the 64 most representative (exemplar clustering),
  3. a ~100M-parameter-class model of the family trained on the selected
     mixture, with step checkpoints, against a random-selection control.
The same flags, data and printed lines as the JAX example.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.data.selection import (SelectionConfig, mean_pool_embeddings,
                                        select_coreset)
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts_lib
from repro_torch.train.fault_tolerance import CheckpointManager


def main(device="cuda", *, arch: str = "gemma-2b", steps: int = 200,
         d_model: int = 256, layers: int = 8, seq: int = 128,
         batch: int = 16, feature_params=None, plan=None, rnd_idx=None,
         init_state=None) -> dict:
    """Runs the example; returns {"selected", "random": each run's
    per-step losses, "idx", "rnd_idx", "value"}.  For parity the tests
    give the JAX example's draws: ``feature_params`` (a tree with the fp32
    ``emb`` of its ``init_params(cfg, PRNGKey(0))``), ``plan`` (the TREE's
    round plan and eval indices), ``rnd_idx`` (the control's 64 rows) and
    ``init_state`` (a function giving a fresh train state: its
    ``init_train_state(cfg, opt, PRNGKey(2))``); by default each is drawn
    here from the same seeds."""
    dev = resolve_device(device)
    # ~100M-class config of the selected family (CPU-trainable scale)
    cfg = dataclasses.replace(
        get_config(arch),
        n_layers=layers, d_model=d_model,
        n_heads=max(4, d_model // 64), n_kv_heads=1,
        head_dim=64, d_ff=d_model * 4, vocab_size=8_192,
        microbatches=1, n_experts=0, experts_per_token=0,
        n_shared_experts=0)
    model = get_model(cfg)
    n_params_cfg = cfg.param_count()
    print(f"arch={cfg.name} family={cfg.family} "
          f"params≈{n_params_cfg/1e6:.0f}M")

    # ---- 1) candidate pool --------------------------------------------
    pool_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                          global_batch=512, seed=0)
    pool = SyntheticLM(pool_cfg, dev).batch(0)["tokens"]      # (512, seq)

    # ---- 2) submodular selection over embeddings ----------------------
    if feature_params is None:
        with L.masters():
            feature_params = model.init_params(cfg, device=dev, seed=0)
    feats = mean_pool_embeddings(feature_params, pool)        # (512, d)
    idx, res = select_coreset(
        feats, SelectionConfig(k=64, capacity=128, n_eval=256, seed=0),
        device=dev, plan=plan)
    print(f"selected {len(idx)} sequences in {res.rounds} tree rounds "
          f"(f={res.value:.4f})")
    if rnd_idx is None:
        rnd_idx = torch.randperm(
            512, generator=torch.Generator().manual_seed(1))[:64].numpy()

    # ---- 3) train on the selected mixture vs random control -----------
    def train(sel, tag):
        opt_cfg = opt_lib.OptConfig(lr=1e-3, warmup_steps=20,
                                    total_steps=steps,
                                    moment_dtype="float32")
        state = (ts_lib.init_train_state(cfg, opt_cfg, 2, device=dev)
                 if init_state is None else init_state())
        step_fn = ts_lib.make_train_step(cfg, opt_cfg)
        mix = pool[torch.as_tensor(np.array(sel), device=dev)]
        rng = np.random.default_rng(0)
        losses = []
        with tempfile.TemporaryDirectory() as ckpt_dir:
            mgr = CheckpointManager(ckpt_dir, every_steps=50, keep=2)
            for step in range(steps):
                rows = rng.choice(len(sel), batch)
                b = {"tokens": mix[torch.as_tensor(rows, device=dev)]}
                if cfg.frontend:
                    b["embeds"] = torch.zeros((batch, seq, cfg.d_model),
                                              dtype=torch.float32,
                                              device=dev)
                state, metrics = step_fn(state, b)
                losses.append(float(metrics["loss"]))
                mgr.maybe_save(step + 1, state)
                if (step + 1) % 50 == 0:
                    print(f"  [{tag}] step {step+1:4d} "
                          f"loss {np.mean(losses[-20:]):.4f} "
                          f"lr {float(metrics['lr']):.2e}")
        return losses

    print("training on submodular-selected mixture:")
    sel_losses = train(idx, "selected")
    print("training on random mixture (control):")
    rnd_losses = train(rnd_idx, "random")
    print(f"final-20 loss: selected={np.mean(sel_losses[-20:]):.4f} "
          f"random={np.mean(rnd_losses[-20:]):.4f}")
    return {"selected": sel_losses, "random": rnd_losses,
            "idx": np.asarray(idx), "rnd_idx": np.asarray(rnd_idx),
            "value": float(res.value)}


def _cli(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(argv)
    return main(a.device, arch=a.arch, steps=a.steps, d_model=a.d_model,
                layers=a.layers, seq=a.seq, batch=a.batch)


if __name__ == "__main__":
    _cli()
