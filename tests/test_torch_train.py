"""The port's training substrate against the JAX package on the CPU: the
AdamW schedule and update on random trees (bf16 and fp32 moments), the LM
loss with a prefix, a padded vocabulary and a loss mask, the autograd of
``ops.flash_attention`` against ``jax.grad`` of the JAX reference,
checkpoint files in both directions (a JAX file read by the port, the
port's file read by JAX ``restore``; bf16 leaves as the JAX package stores
them), keep-k rotation and an interrupted save, and the straggler monitor
on an injected clock; then ``make_train_step`` for the RWKV-6 and hybrid
families (the others are in ``test_torch_train_step.py``).

Tolerances (``repro_torch.testing``): the optimizer runs the JAX package's
fp32 arithmetic in its order, so its results agree to the last bit or to
one unit of a transcendental (``cos``, ``pow``) — fp32 within RTOL, bf16
moments within one bf16 ulp; attention gradients within
``ATTN_GRAD_TOL``; train steps within ``TRAIN_STEP_TOL``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.train import checkpoint as jckpt
from repro.train import fault_tolerance as jft
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch import testing
from repro_torch.kernels import ops
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import fault_tolerance as tft
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

from _torch_parity import step_parity


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tree(seed, moment_dtype):
    """A small nested tree of fp32 params, grads and moments (JAX and
    port), keys out of sorted order."""
    r = np.random.default_rng(seed)
    shapes = {"w": (5, 7), "b": {"z": (3,), "a": (2, 3, 4)}, "emb": (11, 2)}

    def draw(scale):
        return _map(shapes, lambda s: (r.standard_normal(s)
                                       * scale).astype(np.float32))

    p, g = draw(1.0), draw(0.3)
    m = draw(0.01)
    v = _map(draw(0.01), np.abs)
    tdt = topt.dtype_of(moment_dtype)
    jdt = jnp.dtype(moment_dtype)
    jtree = (_map(p, jnp.asarray), _map(g, jnp.asarray),
             {"mu": _map(m, lambda x: jnp.asarray(x, jdt)),
              "nu": _map(v, lambda x: jnp.asarray(x, jdt)),
              "step": jnp.int32(2)})
    ttree = (_map(p, torch.from_numpy), _map(g, torch.from_numpy),
             {"mu": _map(m, lambda x: torch.from_numpy(x).to(tdt)),
              "nu": _map(v, lambda x: torch.from_numpy(x).to(tdt)),
              "step": torch.tensor(2, dtype=torch.int32)})
    return jtree, ttree


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def test_schedule_matches_jax():
    cfg = topt.OptConfig(lr=3e-4, warmup_steps=7, total_steps=40)
    jcfg = jopt.OptConfig(lr=3e-4, warmup_steps=7, total_steps=40)
    for step in range(0, 46):
        got = topt.schedule(cfg, torch.tensor(step, dtype=torch.int32))
        want = jopt.schedule(jcfg, jnp.int32(step))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(want), rtol=testing.RTOL,
                                   atol=0, err_msg=f"step {step}")


@pytest.mark.parametrize("clip", [1.0, 100.0])
@pytest.mark.parametrize("moment_dtype", ["bfloat16", "float32"])
def test_apply_updates_matches_jax(moment_dtype, clip):
    cfg = topt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                         clip_norm=clip, moment_dtype=moment_dtype)
    jcfg = jopt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                          clip_norm=clip, moment_dtype=moment_dtype)
    (jp, jg, jo), (tp, tg, to) = _tree(3, moment_dtype)
    jp2, jo2, jaux = jax.jit(jopt.apply_updates, static_argnums=0)(
        jcfg, jp, jg, jo)
    tp2, to2, taux = topt.apply_updates(cfg, tp, tg, to)
    assert tp2 is tp                                     # in place
    assert int(to2["step"]) == int(jo2["step"]) == 3
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(_np(taux[key]), _np(jaux[key]),
                                   rtol=testing.RTOL, err_msg=key)
    jl, tl = jax.tree_util.tree_leaves(jp2), topt.tree_leaves(tp2)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(_np(a), _np(b), rtol=testing.RTOL,
                                   atol=testing.ATOL)
    ulp = 2.0 ** -8 if moment_dtype == "bfloat16" else testing.RTOL
    for name in ("mu", "nu"):
        for a, b in zip(topt.tree_leaves(to2[name]),
                        jax.tree_util.tree_leaves(jo2[name])):
            assert a.dtype == topt.dtype_of(moment_dtype)
            np.testing.assert_allclose(_np(a), _np(b), rtol=ulp, atol=1e-30,
                                       err_msg=name)


def test_tree_leaves_in_jax_order():
    tree = {"b": {"y": 1, "x": 2}, "a": 3, "c": {"k": {"j": 4}}}
    assert topt.tree_leaves(tree) == jax.tree_util.tree_leaves(tree)


@pytest.mark.parametrize("prefix", [0, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_matches_jax(prefix, masked):
    r = np.random.default_rng(prefix + 2 * masked)
    B, S, V, vocab = 3, 9, 32, 27
    logits = (r.standard_normal((B, S + prefix, V)) * 3).astype(np.float32)
    tokens = r.integers(0, vocab, (B, S)).astype(np.int32)
    mask = (r.random((B, S)) < 0.7).astype(np.float32) if masked else None
    got = tts.lm_loss(torch.from_numpy(logits).to(torch.bfloat16),
                      torch.from_numpy(tokens),
                      None if mask is None else torch.from_numpy(mask),
                      vocab_size=vocab)
    want = jts.lm_loss(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(tokens),
                       None if mask is None else jnp.asarray(mask),
                       vocab_size=vocab)
    np.testing.assert_allclose(_np(got), _np(want), rtol=testing.RTOL)


@pytest.mark.parametrize("group,S,T,causal", [(1, 40, 40, True),
                                              (4, 24, 70, True),
                                              (2, 33, 50, False)])
def test_flash_attention_grad_matches_jax(group, S, T, causal):
    """The CPU's autograd of ``ops.flash_attention`` (the plain version)
    against ``jax.grad`` of the JAX reference, fp32."""
    r = np.random.default_rng(S + T + group)
    B, Hkv, D = 2, 2, 16
    q = r.standard_normal((B, Hkv * group, S, D)).astype(np.float32)
    k, v = (r.standard_normal((B, Hkv, T, D)).astype(np.float32)
            for _ in range(2))
    w = r.standard_normal(q.shape).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jref.flash_attention(q, k, v, causal=causal) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=causal)
    torch.sum(out * torch.from_numpy(w)).backward()
    for name, a, b in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                          want):
        testing.assert_grad_close(a, b, torch.float32, name)


def _ckpt_trees():
    """A JAX tree and the port's, the same values: fp32 masters, bf16 and
    fp32 moments, an int32 step."""
    r = np.random.default_rng(5)
    p = {"w": r.standard_normal((4, 3)).astype(np.float32),
         "a": {"z": r.standard_normal((2,)).astype(np.float32)}}
    m = {"w": r.standard_normal((4, 3)).astype(np.float32),
         "a": {"z": r.standard_normal((2,)).astype(np.float32)}}
    jtree = {"params": _map(p, jnp.asarray),
             "opt": {"mu": _map(m, lambda x: jnp.asarray(x, jnp.bfloat16)),
                     "nu": _map(m, lambda x: jnp.asarray(x * x)),
                     "step": jnp.int32(7)}}
    ttree = {"params": _map(p, torch.from_numpy),
             "opt": {"mu": _map(m, lambda x: torch.from_numpy(x).to(
                 torch.bfloat16)),
                     "nu": _map(m, lambda x: torch.from_numpy(x * x)),
                     "step": torch.tensor(7, dtype=torch.int32)}}
    return jtree, ttree


def _bits(x) -> np.ndarray:
    """A leaf's raw element bits (bf16 as uint16) for an exact compare."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def test_checkpoint_jax_file_read_by_port(tmp_path):
    jtree, ttree = _ckpt_trees()
    jckpt.save(str(tmp_path), 7, jtree)
    # how the JAX package stores a bf16 leaf: raw two-byte records, the bits
    with np.load(tmp_path / "step_00000007" / "shard_0.npz") as data:
        leaf = data["leaf_0"]                      # opt.mu.a.z, sorted first
        assert leaf.dtype.kind == "V" and leaf.dtype.itemsize == 2
        np.testing.assert_array_equal(
            leaf.view(np.uint16), _bits(jtree["opt"]["mu"]["a"]["z"]))
    like = topt.tree_map(torch.zeros_like, ttree)
    assert tckpt.latest_step(str(tmp_path)) == 7
    got = tckpt.restore(str(tmp_path), 7, like)
    for a, b in zip(topt.tree_leaves(got), topt.tree_leaves(ttree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_checkpoint_port_file_read_by_jax(tmp_path):
    jtree, ttree = _ckpt_trees()
    tckpt.save(str(tmp_path), 3, ttree)
    assert jckpt.latest_step(str(tmp_path)) == 3
    got = jckpt.restore(str(tmp_path), 3, jtree)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    # the port's file holds what the JAX package's holds, leaf for leaf
    jckpt.save(str(tmp_path / "jax"), 3, jtree)
    with np.load(tmp_path / "step_00000003" / "shard_0.npz") as mine, \
            np.load(tmp_path / "jax" / "step_00000003" / "shard_0.npz") as ref:
        assert sorted(mine.files) == sorted(ref.files)
        for name in ref.files:
            assert mine[name].shape == ref[name].shape
            assert mine[name].dtype.itemsize == ref[name].dtype.itemsize
            np.testing.assert_array_equal(
                np.atleast_1d(mine[name]).view(np.uint8),
                np.atleast_1d(ref[name]).view(np.uint8))


def test_checkpoint_rotation_and_interrupted_save(tmp_path, monkeypatch):
    _, ttree = _ckpt_trees()
    mgr = tft.CheckpointManager(str(tmp_path), every_steps=2, keep=2)
    for step in range(1, 9):
        ttree["opt"]["step"] = torch.tensor(step, dtype=torch.int32)
        path = mgr.maybe_save(step, ttree)
        assert (path is None) == (step % 2 == 1)
    assert sorted(os.listdir(tmp_path)) == ["step_00000006", "step_00000008"]
    real = tckpt._write_npy
    calls = []

    def crash(f, arr):
        calls.append(1)
        if len(calls) == 3:
            raise OSError("disk went away")
        return real(f, arr)

    monkeypatch.setattr(tckpt, "_write_npy", crash)
    ttree["opt"]["step"] = torch.tensor(10, dtype=torch.int32)
    with pytest.raises(OSError):
        mgr.maybe_save(10, ttree)
    monkeypatch.setattr(tckpt, "_write_npy", real)
    assert "step_00000010.tmp0" in os.listdir(tmp_path)
    assert tckpt.latest_step(str(tmp_path)) == 8
    like = topt.tree_map(torch.zeros_like, ttree)
    restored, step = mgr.restore_latest(like)
    assert step == 8 and int(restored["opt"]["step"]) == 8
    # the same save again completes over the partial directory
    assert mgr.maybe_save(10, ttree) is not None
    assert tckpt.latest_step(str(tmp_path)) == 10
    assert sorted(os.listdir(tmp_path)) == ["step_00000008", "step_00000010"]
    assert tft.CheckpointManager(str(tmp_path / "none")).restore_latest(
        like) == (None, 0)


def test_straggler_monitor_on_injected_clock(monkeypatch):
    """The port's monitor against the JAX package's on one clock: step
    times with slow steps before and after the window fills."""
    durations = [1.0, 5.0, 1.1, 0.9, 1.0, 1.2, 4.0, 1.0, 3.5, 1.0] * 6
    stamps = np.cumsum([0.0] + [x for d in durations for x in (d, 0.5)])

    def clock_from(ts):
        it = iter(ts)
        return lambda: float(next(it))

    mine = tft.StragglerMonitor(window=20, clock=clock_from(stamps))
    monkeypatch.setattr(jft.time, "perf_counter", clock_from(stamps))
    ref = jft.StragglerMonitor(window=20)
    flags = []
    for _ in durations:
        mine.start()
        ref.start()
        flags.append((mine.stop(), ref.stop()))
    assert [a for a, _ in flags] == [b for _, b in flags]
    got = [a for a, _ in flags]
    assert not any(got[:4])          # fewer than 5 steps: never flagged
    assert got[6] and not got[7] and sum(got) >= 6


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-1.5-large-398b"])
def test_train_step_recurrent_families_match_jax(arch, n_micro):
    """RWKV-6 and the hybrid at ``reduced()``, S = 16 (the JAX chunked
    form's clip stays out of reach at init decays), fp32 compute in both
    packages: see ``_torch_train.step_parity``."""
    step_parity(arch, n_micro, "fp32")
