"""The ``wkv6`` backward on the CPU: the plain version
(``ref.wkv6_backward``, which repeats the CUDA kernel's order of sums)
against torch autograd of ``ref.wkv6`` and against ``jax.grad`` of the JAX
package's ``repro.kernels.ref.wkv6`` (from a zero state: the JAX reference
takes none); the float64 model of the backward's formulas that sets
``testing.WKV_GRAD_TOL``; and ``ops.wkv6``'s autograd wiring on the card
path (the card check patched, the kernels replaced by their plain
versions), down to a train step of RWKV-6 and of the hybrid.

Inputs are drawn with NumPy from a seed.  Tolerance:
``testing.WKV_GRAD_TOL`` by the gradient's type (fp32 2e-5, bf16 2⁻⁶ of
the largest |value|); only the bound differs between fp32 and bf16.  The
kernel itself runs only on a card (``chip_smoke.py``'s
``phase_kernels_wkv6_bwd`` holds it against the plain version there).
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

GRADS = ("dr", "dk", "dv", "dw", "du", "d_state")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The scans run thousands of small ops: on several threads a worker
    that shares the CPU with others spends its time waking them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
# (B, H, T, Dk, Dv, decay, u_zero): reduced()'s head, rwkv6-1.6b's at a
# small T, Jamba's scan (u = 0), the decays "model" and 0.05
CASES = [(2, 3, 37, 16, 16, "model", False), (1, 2, 24, 64, 64, "model", False),
         (2, 2, 45, 16, 128, 0.05, True), (2, 2, 40, 16, 16, 0.05, False)]


def _draw(seed, B, H, T, Dk, Dv, decay="model", given=False, u_zero=False):
    """r, k, v ~ N(0, 1), w at the model's init decay exp(−exp(−6 +
    N/2)), "fast" (sigmoid(N + 2)) or a constant, u ~ 0.1·N (or 0), dy ~
    N(0, 1), and S_0, dS_T ~ N(0, 1) where ``given`` (else None): float64
    NumPy arrays."""
    g = np.random.default_rng(seed)
    r, k = g.standard_normal((2, B, H, T, Dk))
    v = g.standard_normal((B, H, T, Dv))
    n = g.standard_normal((B, H, T, Dk))
    w = {"model": lambda: np.exp(-np.exp(-6.0 + 0.5 * n)),
         "fast": lambda: 1.0 / (1.0 + np.exp(-(n + 2.0)))}.get(
        decay, lambda: np.full_like(n, decay))()
    u = 0.1 * g.standard_normal((H, Dk)) * (0.0 if u_zero else 1.0)
    dy = g.standard_normal((B, H, T, Dv))
    s0 = ds = None
    if given:
        s0, ds = g.standard_normal((2, B, H, Dk, Dv))
    return r, k, v, w, u, s0, dy, ds


def _torch(arrs, dtype):
    """The draws as the port takes them: r, k, v, u and dy in ``dtype``,
    w, S_0 and dS_T fp32."""
    r, k, v, w, u, s0, dy, ds = (
        None if a is None else torch.from_numpy(a.astype(np.float32))
        for a in arrs)
    return (r.to(dtype), k.to(dtype), v.to(dtype), w, u.to(dtype), s0,
            dy.to(dtype), ds)


def _autograd(r, k, v, w, u, s0, dy, ds):
    """The six gradients by torch autograd of ``ref.wkv6``."""
    B, H, _, Dk = r.shape
    st = (torch.zeros((B, H, Dk, v.shape[-1])) if s0 is None
          else s0.clone()).requires_grad_(True)
    xs = [t.clone().requires_grad_(True) for t in (r, k, v, w, u)]
    y, fin = ref.wkv6(*xs, st)
    loss = torch.sum(y.float() * dy.float())
    if ds is not None:
        loss = loss + torch.sum(fin * ds)
    # at T = 1 from zeros w reaches neither output: its gradient is zero
    return tuple(torch.zeros_like(x) if g is None else g for x, g in zip(
        xs + [st], torch.autograd.grad(loss, xs + [st], allow_unused=True)))


def _exact(r, k, v, w, u, s0, dy, ds):
    """The six gradients in float64 by autograd of the recurrence written
    out (``y_t = r_t (S + diag(u) k_tᵀ v_t)``, ``S ← diag(w_t) S + k_tᵀ
    v_t``), independent of ``ref``."""
    xs = [torch.as_tensor(np.asarray(a, np.float64)).requires_grad_(True)
          for a in (r, k, v, w, u)]
    B, H, T, Dk = xs[0].shape
    Dv = xs[2].shape[-1]
    S = st = torch.as_tensor(np.zeros((B, H, Dk, Dv)) if s0 is None
                             else np.asarray(s0, np.float64)
                             ).requires_grad_(True)
    R, K, V, W, U = xs
    ys = []
    for t in range(T):
        kv = K[:, :, t, :, None] * V[:, :, t, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", R[:, :, t],
                               S + U[None, :, :, None] * kv))
        S = W[:, :, t, :, None] * S + kv
    loss = torch.sum(torch.stack(ys, 2) * torch.as_tensor(
        np.asarray(dy, np.float64)))
    if ds is not None:
        loss = loss + torch.sum(S * torch.as_tensor(np.asarray(ds,
                                                               np.float64)))
    return tuple(torch.zeros_like(x) if g is None else g for x, g in zip(
        xs + [st], torch.autograd.grad(loss, xs + [st], allow_unused=True)))


@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,T,Dk,Dv,decay,u_zero", CASES)
def test_plain_backward_matches_autograd(B, H, T, Dk, Dv, decay, u_zero,
                                         dtype, given):
    """The plain backward against autograd of the plain forward, within
    WKV_GRAD_TOL, each gradient in its operand's type (dw and d_state
    fp32)."""
    args = _torch(_draw(T + Dv, B, H, T, Dk, Dv, decay, given, u_zero),
                  DTYPES[dtype])
    got = ref.wkv6_backward(*args)
    want = _autograd(*args)
    for name, a, b, src in zip(GRADS, got, want, args[:5] + (
            torch.zeros((), dtype=torch.float32),)):
        assert a.dtype == src.dtype and a.shape == b.shape, name
        testing.assert_grad_close(a, b, a.dtype, f"{name} {dtype}",
                                  testing.WKV_GRAD_TOL)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,H,T,Dk,Dv,decay,u_zero", CASES)
def test_plain_backward_matches_jax_grad(B, H, T, Dk, Dv, decay, u_zero,
                                         dtype):
    """From a zero state, dr, dk, dv, dw and du against ``jax.vjp`` of the
    JAX ``ref.wkv6`` on the same inputs (the JAX function rounds y to r's
    type: the cotangent goes in as that type)."""
    arrs = _draw(T + Dk, B, H, T, Dk, Dv, decay, False, u_zero)
    args = _torch(arrs, DTYPES[dtype])
    got = ref.wkv6_backward(*args)
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    r, k, v, w, u, _, dy, _ = (None if t is None else
                               jnp.asarray(t.float().numpy()) for t in args)
    cast = [x.astype(jdt) for x in (r, k, v)] + [w, u.astype(jdt)]
    _, vjp = jax.vjp(jref.wkv6, *cast)
    want = vjp(dy.astype(jdt))
    for name, a, b in zip(GRADS, got, want):
        testing.assert_grad_close(a, np.asarray(b.astype(jnp.float32)),
                                  a.dtype, f"{name} {dtype}",
                                  testing.WKV_GRAD_TOL)


MODEL_CASES = [(2, 3, 37, 16, 16, "fast"), (1, 2, 100, 64, 64, "model"),
               (2, 2, 45, 16, 128, 0.5), (1, 2, 300, 64, 64, 0.05),
               (1, 2, 300, 64, 64, 1e-6), (1, 1, 1000, 16, 16, "model")]


@pytest.mark.parametrize("B,H,T,Dk,Dv,decay", MODEL_CASES)
def test_float64_model_sets_the_bound(B, H, T, Dk, Dv, decay):
    """The float64 model: the backward's formulas on float64 inputs equal
    float64 autograd (to 1e-12); then each fp32 side (the plain backward,
    autograd of the plain forward) sits within half of WKV_GRAD_TOL of
    those exact gradients, from zeros and from a state with dS_T, in fp32
    and on bf16 operands (the exact gradients taken at the bf16 values).
    Each reading is printed (``pytest -s``); WKV_GRAD_TOL's note records
    their largest by the gradient's type (fp32 9.54e-7, bf16 3.70e-3)."""
    for given in (False, True):
        arrs = _draw(T, B, H, T, Dk, Dv, decay, given)
        f64 = [None if a is None else torch.from_numpy(a) for a in arrs]
        exact = _exact(*arrs)
        for a, b in zip(ref.wkv6_backward(*f64), exact):
            assert testing.grad_share(a, b) < 1e-12
        for dtype in DTYPES.values():
            args = _torch(arrs, dtype)
            exact = _exact(*(None if t is None else t.double().numpy()
                             for t in args))
            for side in (ref.wkv6_backward(*args), _autograd(*args)):
                for name, a, b in zip(GRADS, side, exact):
                    share = testing.grad_share(a, b)
                    print(f"float64 model {B, H, T, Dk, Dv, decay} {dtype} "
                          f"state={given} {name}: {share:.3g}")
                    assert share <= testing.WKV_GRAD_TOL[a.dtype] / 2, (
                        name, dtype, given, share)


@pytest.fixture
def card_path(monkeypatch):
    """``ops`` as on the card, the kernels replaced by their plain
    versions: wkv6's forward and backward launches (counted), and
    flash_attention as its plain version with autograd."""
    calls = {"forward": 0, "backward": []}

    def launch(r, k, v, w, u, state=None, *, state_out=None, out_dtype=None):
        calls["forward"] += 1
        y, fin = ref.wkv6(r, k, v, w, u, state, out_dtype=out_dtype)
        return y, fin if state_out is None else state_out.copy_(fin)

    def launch_backward(*args):
        calls["backward"].append(tuple(args[0].shape) + (args[2].shape[-1],))
        return ref.wkv6_backward(*args)

    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(wkv_mod, "launch", launch)
    monkeypatch.setattr(wkv_mod, "launch_backward", launch_backward)
    monkeypatch.setattr(ops, "flash_attention",
                        lambda q, k, v, **kw: ref.flash_attention(q, k, v,
                                                                  **kw))
    monkeypatch.setattr(fa, "launch", None)
    return calls


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_autograd_wiring_on_the_card_path(card_path, dtype):
    """Gradients reach r, k, v, w, u and the state, each in its input's
    type and equal to the plain backward's; the backward launches once."""
    args = _torch(_draw(1, 2, 2, 20, 16, 16, "fast", True), DTYPES[dtype])
    r, k, v, w, u, s0, dy, ds = args
    xs = [t.clone().requires_grad_(True) for t in (r, k, v, w, u, s0)]
    y, fin = ops.wkv6(*xs)
    torch.autograd.backward((y, fin), (dy, ds))
    assert len(card_path["backward"]) == 1
    for name, x, want in zip(GRADS, xs, ref.wkv6_backward(*args)):
        assert x.grad.dtype == x.dtype and torch.equal(x.grad, want), name


def test_inputs_without_grad_get_none(card_path):
    """Only the inputs that require a gradient get one; an unused final
    state's gradient goes in as zeros (None)."""
    r, k, v, w, u, s0, dy, _ = _torch(_draw(2, 1, 2, 9, 16, 16), torch.float32)
    rr, ww = r.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y, _ = ops.wkv6(rr, k, v, ww, u)
    dr, dw = torch.autograd.grad(y, (rr, ww), dy, retain_graph=True)
    want = ref.wkv6_backward(r, k, v, w, u, None, dy, None)
    assert torch.equal(dr, want[0]) and torch.equal(dw, want[3])
    grads = y.grad_fn.apply(dy, None)
    assert [g is None for g in grads] == [False, True, True, False, True,
                                          True, True, True]


def test_state_out_in_place_marks_it_dirty(card_path):
    """With ``state_out`` the final state is written into it, the tensor is
    marked dirty (its version moves and its grad_fn is the backward's), and
    an update in place (state_out is the state) still differentiates the
    state it read."""
    r, k, v, w, u, s0, dy, ds = _torch(_draw(3, 1, 2, 12, 16, 16, "fast",
                                             True), torch.float32)
    base = s0.clone().requires_grad_(True)
    rr = r.clone().requires_grad_(True)
    out = torch.zeros_like(s0)
    version = out._version
    y, fin = ops.wkv6(rr, k, v, w, u, base, state_out=out)
    assert fin is out and out._version > version
    assert out.grad_fn is not None and out.grad_fn is y.grad_fn
    state = base * 1.0
    y, fin = ops.wkv6(rr, k, v, w, u, state, state_out=state)
    assert fin is state
    torch.autograd.backward((y, fin), (dy, ds))
    want = ref.wkv6_backward(r, k, v, w, u, s0, dy, ds)
    assert torch.equal(base.grad, want[5])


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-1.5-large-398b"])
def test_train_step_on_the_card_path_matches_cpu(card_path, monkeypatch,
                                                  arch):
    """A train step of RWKV-6 and of the hybrid at ``reduced()`` in fp32
    through the card's autograd Function (with the plain kernels) against
    the CPU's autograd step: the same loss, gradients within
    WKV_GRAD_TOL[fp32] of the largest |value| of each leaf, every master
    with a gradient, one backward launch a Mamba or RWKV layer and
    microbatch."""
    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)
    cfg = dataclasses.replace(get_config(arch).reduced(), microbatches=2)
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
    n_layers = (cfg.n_layers if arch == "rwkv6-1.6b" else
                cfg.n_layers // cfg.attn_period * (cfg.attn_period - 1))
    assert len(card_path["backward"]) == n_layers * cfg.microbatches
    assert abs(loss - loss_cpu) <= 1e-6 * abs(loss_cpu)
    for a, b in zip(got, want):
        assert bool(torch.any(a != 0))
        testing.assert_grad_close(a, b, a.dtype, "gradient",
                                  testing.WKV_GRAD_TOL)


def test_launch_counters_exist():
    """The backward's two kernels are counted apart."""
    assert {"wkv6_bwd", "wkv6_bwd_du"} <= set(_build.launch_counts)
    assert "wkv6_bwd" in _build.SOURCES


@pytest.mark.parametrize("Dk,Dv,tile", [
    (16, 16, (16, 4, 4)), (8, 12, (16, 4, 4)), (16, 64, (16, 16, 4)),
    (16, 128, (16, 16, 8)), (32, 64, (64, 16, 4)), (64, 64, (64, 16, 4)),
    (64, 128, (64, 16, 8)), (64, 16, (64, 4, 4))])
def test_backward_tile(Dk, Dv, tile):
    """The instantiation a state takes; past Dk = 64 or Dv = 128 none."""
    assert ref.wkv6_bwd_tile(Dk, Dv) == tile
    for bad in ((65, 16), (16, 129), (0, 16)):
        with pytest.raises(ValueError):
            ref.wkv6_bwd_tile(*bad)
