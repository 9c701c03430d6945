"""The port's training launcher and its select-then-train example against
the JAX package's on the CPU, lines held field by field.

``repro.launch.train.main`` runs with ``sys.argv`` patched and its stdout
captured, at ``--reduced``; ``repro_torch.launch.train.run`` runs the same
flags (``--device cpu``) from the JAX launcher's initial state
(``convert.train_state_from_jax``) with step checkpoints, then again with
``--resume`` (the JAX launcher's own resume fails, ROADMAP queue 3).  Both straggler monitors read one
injected clock (one slow step), so the ``[straggler-flag]`` marks do not
hang on the host's timing.  ``examples/train_lm_with_selection.py`` runs
in process (``runpy``) at a few steps, and the port's ``main`` on its
draws: the features' embedding table, the TREE's round plan and eval
indices, the control's rows and the initial train state.  Both packages
compute in fp32 (``COMPUTE_DTYPE``), so the printed numbers agree within
``testing.TRAIN_STEP_TOL`` plus one unit of their last printed digit.
"""
import contextlib
import dataclasses
import io
import re
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import repro.launch.train as jlaunch
from repro.configs import get_config as jax_config
from repro.core import tree as jtree
from repro.models import get_model as jax_model
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import testing
from repro_torch.convert import ArrayPlan, train_state_from_jax
from repro_torch.configs import get_config
from repro_torch.launch import train as tlaunch
from repro_torch.train import fault_tolerance as tft
from repro_torch.train import optimizer as topt
from repro_torch.examples import train_lm_with_selection as tex

from _torch_parity import compute_dtype, jax_train_init, jax_tree_plan

import torch

ROOT = Path(__file__).resolve().parents[1]
NUM = re.compile(r"[-+]?\d+\.\d+(?:e[-+]\d+)?|[-+]?\d+")
TOL = testing.TRAIN_STEP_TOL[torch.float32]


def _fields_agree(got: list[str], want: list[str], rel: float) -> None:
    """Each line the same words, and each number within ``rel`` of the
    reference's plus one unit of its last printed digit."""
    assert len(got) == len(want), (got, want)
    for a, b in zip(got, want):
        assert NUM.sub("#", a) == NUM.sub("#", b), (a, b)
        for x, y in zip(NUM.findall(a), NUM.findall(b)):
            unit = (10.0 ** -len(y.split(".")[1].split("e")[0])
                    if "." in y else 0.0)
            if "e" in y:
                unit *= 10.0 ** int(y.split("e")[1])
            assert abs(float(x) - float(y)) <= rel * abs(float(y)) + unit, (
                a, b)


def _clock(slow_step: int):
    """A fresh fake clock per monitor: steps of 1 s, step ``slow_step`` 10 s."""
    state = {"t": 0.0, "calls": 0}

    def clock():
        step, stop = divmod(state["calls"], 2)
        state["calls"] += 1
        if stop:
            state["t"] += 10.0 if step == slow_step else 1.0
        return state["t"]

    return clock


def _capture(fn) -> list[str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn()
    return [line for line in out.getvalue().splitlines() if line.strip()]


def test_launcher_lines_match_jax(tmp_path, monkeypatch):
    """The uninterrupted run's lines against the JAX launcher's; the
    port's run resumed from its step-10 checkpoint (its manager saving
    every 5 steps here, not 25) ends in the same state, bit for bit.  (The JAX launcher's
    own ``--resume`` fails with bf16 moments: its ``restore`` hands the
    raw two-byte records to ``jit``; ROADMAP queue 3.)"""
    arch, steps = "qwen3-8b", 12
    flags = ["--arch", arch, "--reduced", "--steps", str(steps), "--seq",
             "16", "--batch", "4"]

    class JaxMonitor(jlaunch.StragglerMonitor):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.clock = _clock(9)

        def start(self):
            self._t0 = self.clock()

        def stop(self):
            dt = self.clock() - self._t0
            self.times = (self.times + [dt])[-self.window:]
            med = sorted(self.times)[len(self.times) // 2]
            return dt > self.factor * med and len(self.times) >= 5

    monkeypatch.setattr(jlaunch, "StragglerMonitor", JaxMonitor)
    monkeypatch.setattr(tlaunch, "StragglerMonitor",
                        lambda: tft.StragglerMonitor(clock=_clock(9)))
    monkeypatch.setattr(tlaunch, "CheckpointManager",
                        lambda d, every_steps, keep: tft.CheckpointManager(
                            d, every_steps=5, keep=keep))
    init = jax_train_init(arch)
    cfg = get_config(arch).reduced()
    port = flags + ["--ckpt-dir", str(tmp_path / "port"), "--device", "cpu"]
    with compute_dtype("fp32"):
        monkeypatch.setattr(sys, "argv", ["train"] + flags)
        want = _capture(jlaunch.main)
        out = {}
        got = _capture(lambda: out.update(first=tlaunch.run(
            tlaunch.parse_args(port),
            state=train_state_from_jax(init, cfg, "cpu"))))
        resumed = _capture(lambda: out.update(resumed=tlaunch.run(
            tlaunch.parse_args(port + ["--resume"]),
            state=train_state_from_jax(init, cfg, "cpu"))))
    _fields_agree(got, want, TOL["loss"])
    assert "[straggler-flag]" in got[1] and "[straggler-flag]" in want[1]
    assert resumed[0] == "resumed from step 10"
    assert len(resumed) == 2 and resumed[1].startswith("step    11 ")
    a = out["first"]["state"]
    b = out["resumed"]["state"]
    for x, y in zip(topt.tree_leaves(a), topt.tree_leaves(b)):
        assert torch.equal(x, y)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "step_00000005", "step_00000010"]


def test_launcher_refuses_the_mesh():
    for flag in ("--use-mesh", "--multi-pod"):
        args = tlaunch.parse_args(["--arch", "qwen3-8b", "--reduced", flag,
                                   "--device", "cpu"])
        with pytest.raises(NotImplementedError, match="item 15"):
            tlaunch.run(args)
    defaults = vars(tlaunch.parse_args(["--arch", "x"]))
    assert defaults == dict(arch="x", steps=100, seq=128, batch=8, lr=3e-4,
                            reduced=False, multi_pod=False, use_mesh=False,
                            ckpt_dir=None, resume=False, seed=0,
                            device="cuda")


def test_example_matches_jax(monkeypatch):
    """``examples/train_lm_with_selection.py`` at 3 steps, d_model 64 and
    2 layers, against the port's ``main`` on its draws."""
    argv = dict(arch="gemma-2b", steps=3, d_model=64, layers=2, seq=32,
                batch=4)
    cfg = dataclasses.replace(
        jax_config(argv["arch"]), n_layers=argv["layers"],
        d_model=argv["d_model"], n_heads=4, n_kv_heads=1, head_dim=64,
        d_ff=argv["d_model"] * 4, vocab_size=8_192, microbatches=1,
        n_experts=0, experts_per_token=0, n_shared_experts=0)
    params = jax_model(cfg).init_params(cfg, jax.random.PRNGKey(0))
    runs = []
    real_tree = jtree.tree_maximize

    def recording(*a, **kw):
        runs.append(real_tree(*a, **kw))
        return runs[-1]

    monkeypatch.setattr(jtree, "tree_maximize", recording)
    import repro.data.selection as jsel
    monkeypatch.setattr(jsel, "tree_maximize", recording)
    script = ROOT / "examples" / "train_lm_with_selection.py"
    monkeypatch.setattr(sys, "argv", [str(script)] + [
        x for key, val in argv.items()
        for x in (f"--{key.replace('_', '-')}", str(val))])
    with compute_dtype("fp32"):
        want = _capture(lambda: runpy.run_path(str(script),
                                               run_name="__main__"))
        (res,) = runs
        key = jax.random.PRNGKey(0)
        ev = np.asarray(jax.random.choice(key, 512, (256,), replace=False))
        plan = jax_tree_plan(0, 128, res.machines_per_round)
        opt = jopt.OptConfig(lr=1e-3, warmup_steps=20, total_steps=3,
                             moment_dtype="float32")
        tcfg = tex.get_config(argv["arch"])
        got = _capture(lambda: tex.main(
            "cpu", **argv,
            feature_params={"emb": torch.from_numpy(
                np.array(params["emb"]))},
            plan=ArrayPlan(plan.perms, eval_idx=ev),
            rnd_idx=np.asarray(jax.random.choice(
                jax.random.PRNGKey(1), 512, (64,), replace=False)),
            init_state=lambda: train_state_from_jax(
                jts.init_train_state(cfg, opt, jax.random.PRNGKey(2)), tcfg,
                "cpu")))
    _fields_agree(got, want, TOL["loss"])
