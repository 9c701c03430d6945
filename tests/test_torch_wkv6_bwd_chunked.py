"""The chunked ``wkv6`` backward's formulas on the CPU.

``csrc/wkv6_bwd_chunked.cu`` runs time in parallel over chunks of 64 steps
(sub-chunks of 16): each chunk's own state and gradient-state, two scans
over the chunks, then each chunk's gradients from its entry state and exit
gradient-state, dw as Σ_j G[:, j]·S[:, j] and du summed in a fixed order.
``ref.wkv6_backward_chunked`` writes those formulas out in PyTorch (in
float64 for float64 inputs; in fp32 with each tensor-core product split in
three bf16 pieces as the kernel runs it, otherwise).  Held here:

* in float64, to 1e-12 of the exact gradients (float64 autograd of the
  recurrence written out): the formulas are the gradient;
* in fp32 and on bf16 operands, within half of ``testing.WKV_GRAD_TOL`` of
  the exact gradients (each reading printed, ``pytest -s``), and within
  ``WKV_GRAD_TOL`` of the recurrent backward (``ref.wkv6_backward``), of
  autograd of ``ref.wkv6`` and of ``jax.vjp`` of the JAX ``ref.wkv6``;
* ``wkv6.bwd_route`` and the launch counters of both routes;
* the card path's wiring with the chunked launch replaced by these
  formulas, down to an fp32 train step of RWKV-6 against the CPU's.

Decays "model" (the init), "fast", 0.5, 0.05 and 1e-6; states (16, 16),
(64, 64) and (16, 128); T = 1, on a chunk boundary, one past it, ragged;
from zeros and from a given S_0 with dS_T.  Inputs are drawn with NumPy
from a seed.  The kernel itself runs only on a card (``chip_smoke.py``'s
``phase_kernels_wkv6_bwd``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch import testing
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import wkv6 as wkv_mod
from repro_torch.models import layers as TL
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from test_torch_wkv6_bwd import DTYPES, GRADS, _autograd, _draw, _exact, \
    _torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Thousands of small ops: one thread a worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (B, H, T, Dk, Dv, decay): T = 1, a chunk boundary and one past it, ragged
# T, two chunks and a ragged third; every decay and state
CASES = [(1, 2, 1, 16, 16, "fast"), (2, 1, 64, 16, 16, "model"),
         (1, 1, 65, 64, 64, 0.5), (1, 2, 37, 16, 128, 1e-6),
         (1, 1, 150, 64, 64, 1e-6), (2, 2, 100, 16, 16, 0.05),
         (1, 1, 129, 16, 128, "model"), (1, 1, 23, 64, 64, "fast")]


@pytest.mark.parametrize("B,H,T,Dk,Dv,decay", CASES)
def test_chunked_formulas_are_the_gradient(B, H, T, Dk, Dv, decay):
    """float64: the chunked formulas equal float64 autograd of the
    recurrence to 1e-12 of the largest |value|, from zeros and from a
    given state with dS_T."""
    for given in (False, True):
        arrs = _draw(T + Dk, B, H, T, Dk, Dv, decay, given)
        f64 = [None if a is None else torch.from_numpy(a) for a in arrs]
        got = ref.wkv6_backward_chunked(*f64)
        for name, a, b in zip(GRADS, got, _exact(*arrs)):
            assert a.dtype == torch.float64, name
            assert testing.grad_share(a, b) < 1e-12, (name, given)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,T,Dk,Dv,decay", CASES)
def test_chunked_against_the_references(B, H, T, Dk, Dv, decay, dtype):
    """fp32 and bf16 operands: within half of WKV_GRAD_TOL of the exact
    gradients (the reading printed), and within WKV_GRAD_TOL of the
    recurrent backward and of autograd of ``ref.wkv6``; each gradient in
    its operand's type (dw and d_state fp32)."""
    for given in (False, True):
        arrs = _draw(T + Dv, B, H, T, Dk, Dv, decay, given)
        args = _torch(arrs, DTYPES[dtype])
        got = ref.wkv6_backward_chunked(*args)
        exact = _exact(*(None if t is None else t.double().numpy()
                         for t in args))
        types = args[:5] + (torch.zeros(()),)
        for name, a, b, src in zip(GRADS, got, exact, types):
            assert a.dtype == src.dtype and a.shape == b.shape, name
            share = testing.grad_share(a, b)
            print(f"chunked {B, H, T, Dk, Dv, decay} {dtype} state={given} "
                  f"{name}: {share:.3g}")
            assert share <= testing.WKV_GRAD_TOL[a.dtype] / 2, (name, share)
        for side in (ref.wkv6_backward(*args), _autograd(*args)):
            for name, a, b in zip(GRADS, got, side):
                testing.assert_grad_close(a, b, a.dtype, f"{name} {dtype}",
                                          testing.WKV_GRAD_TOL)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,T,Dk,Dv,decay", CASES[1:4])
def test_chunked_matches_jax_grad(B, H, T, Dk, Dv, decay, dtype):
    """From a zero state, dr, dk, dv, dw and du against ``jax.vjp`` of the
    JAX ``ref.wkv6`` (which rounds y to r's type: the cotangent goes in as
    that type), within WKV_GRAD_TOL."""
    args = _torch(_draw(T + 7, B, H, T, Dk, Dv, decay), DTYPES[dtype])
    got = ref.wkv6_backward_chunked(*args)
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    r, k, v, w, u, _, dy, _ = (None if t is None else
                               jnp.asarray(t.float().numpy()) for t in args)
    _, vjp = jax.vjp(jref.wkv6, *[x.astype(jdt) for x in (r, k, v)], w,
                     u.astype(jdt))
    for name, a, b in zip(GRADS, got, vjp(dy.astype(jdt))):
        testing.assert_grad_close(a, np.asarray(b.astype(jnp.float32)),
                                  a.dtype, f"{name} {dtype}",
                                  testing.WKV_GRAD_TOL)


@pytest.mark.parametrize("Dk,Dv,dtype,route", [
    (64, 64, torch.bfloat16, "chunked"), (16, 16, torch.float32, "chunked"),
    (16, 128, torch.bfloat16, "chunked"), (64, 16, torch.bfloat16,
                                           "recurrent"),
    (16, 64, torch.float32, "recurrent"), (8, 16, torch.float32,
                                           "recurrent"),
    (64, 128, torch.bfloat16, "recurrent"), (64, 64, torch.float16,
                                             "recurrent")])
def test_bwd_route(Dk, Dv, dtype, route):
    """The model's three states take the chunked kernel at any T; the other
    states the recurrent one; T < 1 raises; both routes' counters and
    sources exist."""
    for T in (1, 16, 64, 65, 2100):
        assert wkv_mod.bwd_route(T, Dk, Dv, dtype) == route
    with pytest.raises(ValueError):
        wkv_mod.bwd_route(0, Dk, Dv, dtype)
    assert {"wkv6_bwd", "wkv6_bwd_du", "wkv6_bwd_chunked",
            "wkv6_bwd_chunked_du"} <= set(_build.launch_counts)
    assert {"wkv6_bwd", "wkv6_bwd_chunked"} <= set(_build.SOURCES)
    assert set(wkv_mod.BWD_CHUNKED_SHAPES) == {(64, 64), (16, 16), (16, 128)}


@pytest.fixture
def chunked_card_path(monkeypatch):
    """``ops`` as on the card: wkv6's forward by its plain version, the
    backward's two routes by the chunked formulas and the recurrent plain
    version (each call counted by route), ``flash_attention`` plain."""
    calls = {"chunked": 0, "recurrent": 0}

    def launch(r, k, v, w, u, state=None, *, state_out=None, out_dtype=None):
        y, fin = ref.wkv6(r, k, v, w, u, state, out_dtype=out_dtype)
        return y, fin if state_out is None else state_out.copy_(fin)

    def by(route, fn):
        def run(*args):
            calls[route] += 1
            return fn(*args)
        return run

    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(wkv_mod, "launch", launch)
    monkeypatch.setattr(wkv_mod, "launch_backward_chunked",
                        by("chunked", ref.wkv6_backward_chunked))
    monkeypatch.setattr(wkv_mod, "launch_backward_recurrent",
                        by("recurrent", ref.wkv6_backward))
    monkeypatch.setattr(ops, "flash_attention",
                        lambda q, k, v, **kw: ref.flash_attention(q, k, v,
                                                                  **kw))
    monkeypatch.setattr(fa, "launch", None)
    return calls


@pytest.mark.parametrize("Dk,Dv,route", [(16, 16, "chunked"),
                                         (16, 32, "recurrent")])
def test_launch_backward_takes_its_route(chunked_card_path, Dk, Dv, route):
    """``ops.wkv6``'s backward goes through ``launch_backward`` to the
    route ``bwd_route`` names, once a call; the gradients are that route's."""
    args = _torch(_draw(5, 1, 2, 20, Dk, Dv, "fast", True), torch.float32)
    r, k, v, w, u, s0, dy, ds = args
    xs = [t.clone().requires_grad_(True) for t in (r, k, v, w, u, s0)]
    y, fin = ops.wkv6(*xs)
    torch.autograd.backward((y, fin), (dy, ds))
    assert chunked_card_path == {"chunked": int(route == "chunked"),
                                 "recurrent": int(route == "recurrent")}
    want = (ref.wkv6_backward_chunked if route == "chunked"
            else ref.wkv6_backward)(*args)
    for name, x, g in zip(GRADS, xs, want):
        assert torch.equal(x.grad, g), name


def test_train_step_on_the_chunked_route_matches_cpu(chunked_card_path,
                                                     monkeypatch):
    """An fp32 train step of RWKV-6 at ``reduced()`` through the card's
    autograd Function with the chunked formulas against the CPU's autograd
    step: the same loss, each leaf's gradient within WKV_GRAD_TOL[fp32] of
    its largest |value|, every master with a gradient, every backward call
    on the chunked route."""
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)
    cfg = dataclasses.replace(get_config("rwkv6-1.6b").reduced(),
                              microbatches=2)
    opt = topt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4,
                    seed=0, d_model=cfg.d_model)
    batch = SyntheticLM(dc, "cpu").batch(0)

    def step():
        state = tts.init_train_state(cfg, opt, 0, device="cpu")
        grads = []
        _, m = tts.make_train_step(cfg, opt)(state, batch, keep_grads=grads)
        return grads, float(m["loss"])

    got, loss = step()
    with monkeypatch.context() as m:
        m.setattr(ops, "_on_card", lambda t: False)
        want, loss_cpu = step()
    assert chunked_card_path == {"chunked": cfg.n_layers * cfg.microbatches,
                                 "recurrent": 0}
    assert abs(loss - loss_cpu) <= 1e-6 * abs(loss_cpu)
    for a, b in zip(got, want):
        assert bool(torch.any(a != 0))
        testing.assert_grad_close(a, b, a.dtype, "gradient",
                                  testing.WKV_GRAD_TOL)
