"""The plain versions of the selection kernels on narrow operands against
the JAX package's ``ref`` on the CPU: bf16 rows, int8 rows with per-row
scales that are and are not powers of two, and the bf16 x·e contraction
(``compute_dtype``), alone and combined, unconstrained, under knapsack ∩
partition and with eval weights; the wrappers' operand checks and launch
counters; and the narrow kernels against their plain versions on a card.
The JAX Pallas kernels are not run: the JAX package's own quantized Pallas
test fails on this JAX (ROADMAP queue 3), so the reference is ``ref`` on
the same bytes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch import testing
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import exemplar_gains as eg_mod

from _torch_parity import cuda, make_attrs, make_inputs  # noqa: F401

#: rows (fp32, bf16, int8 with power-of-two or other scales) and the dot
OPERANDS = ["bf16", "q8pow2", "q8", "fp32+dot", "bf16+dot", "q8+dot"]
CAPS = (3, 2, 4, 1)


def _operand(X: np.ndarray, name: str, seed: int):
    """``X`` (M, n, d) fp32 as operand ``name``: (JAX rows, port rows, JAX
    kwargs, port kwargs), per-row parameters over the leading axes."""
    rows, _, dot = name.partition("+")
    jkw, tkw = {}, {}
    if rows == "bf16":
        Xj, Xt = jnp.asarray(X).astype(jnp.bfloat16), torch.from_numpy(
            X).bfloat16()
    elif rows.startswith("q8"):
        lo, hi = X.min(axis=-1), X.max(axis=-1)
        scale = np.maximum(hi - lo, 1e-3) / np.float32(254.0)
        if rows == "q8pow2":
            scale = np.exp2(np.ceil(np.log2(scale)))
        else:
            scale = scale * np.random.default_rng(seed).uniform(
                1.0, 1.3, lo.shape)
        scale, zp = scale.astype(np.float32), ((lo + hi) * 0.5).astype(
            np.float32)
        q = np.clip(np.rint((X - zp[..., None]) / scale[..., None]), -127,
                    127).astype(np.int8)
        Xj, Xt = jnp.asarray(q), torch.from_numpy(q)
        jkw = {"x_scale": jnp.asarray(scale), "x_zp": jnp.asarray(zp)}
        tkw = {"x_scale": torch.from_numpy(scale),
               "x_zp": torch.from_numpy(zp)}
    else:
        Xj, Xt = jnp.asarray(X), torch.from_numpy(X)
    if dot:
        jkw["compute_dtype"] = jnp.bfloat16
        tkw["compute_dtype"] = torch.bfloat16
    return Xj, Xt, jkw, tkw


def _machine(kw: dict, i: int) -> dict:
    """Machine i's slice of the per-row operands."""
    return {key: (v[i] if key in ("x_scale", "x_zp", "weights", "group_ids")
                  else v) for key, v in kw.items()}


def _dequantized(Xt, tkw):
    return ref.dequantize_rows(Xt, tkw.get("x_scale"), tkw.get("x_zp"))


@pytest.mark.parametrize("name", OPERANDS)
def test_dequantize_rows_matches_jax(name):
    X, _, _ = make_inputs(2, 300, 1, 7, seed=5)
    Xj, Xt, jkw, tkw = _operand(X * 4.0, name, seed=6)
    for i in range(2):
        got = ref.dequantize_rows(Xt[i], *(_machine(tkw, i).get(k)
                                           for k in ("x_scale", "x_zp")))
        want = jref.dequantize_rows(Xj[i], *(_machine(jkw, i).get(k)
                                             for k in ("x_scale", "x_zp")))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("d", [3, 6, 17])
@pytest.mark.parametrize("name", OPERANDS)
def test_exemplar_gains_narrow_matches_jax(name, d):
    M, n, m = 2, 150, 37
    X, E, _ = make_inputs(M, n, m, d, seed=d)
    Xj, Xt, jkw, tkw = _operand(X, name, seed=d + 1)
    cm = (np.sum(E * E, axis=-1) * np.random.default_rng(d).uniform(
        0.5, 1.0, (M, m))).astype(np.float32)
    w = np.random.default_rng(d + 2).uniform(0.5, 1.5, m).astype(np.float32)
    for ew in (None, w):
        got = ops.exemplar_gains(
            Xt, torch.from_numpy(E), torch.from_numpy(cm),
            eval_weights=None if ew is None else torch.from_numpy(ew), **tkw)
        for i in range(M):
            want = jref.exemplar_gains(
                Xj[i], jnp.asarray(E), jnp.asarray(cm[i]),
                eval_weights=None if ew is None else jnp.asarray(ew),
                **_machine(jkw, i))
            testing.assert_close(got[i], want, f"{name} machine {i}")
        # the narrow rows score as their dequantized fp32 rows, to the bit
        assert torch.equal(got, ref.exemplar_gains(
            _dequantized(Xt, tkw), torch.from_numpy(E), torch.from_numpy(cm),
            compute_dtype=tkw.get("compute_dtype"),
            eval_weights=None if ew is None else torch.from_numpy(ew)))


def _constraint_kwargs(kind, M, n, k, seed):
    w, g = make_attrs(np.random.default_rng(seed), (M, n), len(CAPS))
    if kind == "both":
        return {"weights": w, "budget": 0.3 * k, "group_ids": g,
                "caps": CAPS}
    if kind == "weighted":
        return {"eval_weights": np.random.default_rng(seed).uniform(
            0.5, 1.5, 23).astype(np.float32)}
    return {}


def _split(kw):
    """(JAX, port) forms of NumPy operands."""
    return ({key: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
             for key, v in kw.items()},
            {key: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
             for key, v in kw.items()})


@pytest.mark.parametrize("kind", ["none", "both", "weighted"])
@pytest.mark.parametrize("name", OPERANDS)
def test_greedy_select_narrow_matches_jax(name, kind):
    M, n, m, d, k = 2, 120, 23, 6, 8
    X, E, mask = make_inputs(M, n, m, d, seed=len(name) + len(kind))
    Xj, Xt, jkw, tkw = _operand(X, name, seed=3)
    ckj, ckt = _split(_constraint_kwargs(kind, M, n, k, seed=4))
    cm0 = np.sum(E * E, axis=-1)
    args = (torch.from_numpy(E), torch.from_numpy(cm0),
            torch.from_numpy(mask), k)
    sel, cm = ops.greedy_select(Xt, *args, **tkw, **ckt)
    _, _, gap, best = ref.greedy_select_trace(Xt, *args, **tkw, **ckt)
    for i in range(M):
        jsel, jcm = jref.greedy_select(
            Xj[i], jnp.asarray(E), jnp.asarray(cm0), jnp.asarray(mask[i]), k,
            **_machine(jkw, i), **_machine(ckj, i))
        ok, _ = testing.selections_agree(sel[i:i + 1], np.asarray(jsel)[None],
                                         gap[i:i + 1], best[i:i + 1])
        assert ok, f"{name} {kind} machine {i}"
        if np.array_equal(sel[i].numpy(), np.asarray(jsel)):
            testing.assert_close(cm[i], jcm, f"{name} {kind} machine {i}")
    s32, c32 = ops.greedy_select(_dequantized(Xt, tkw), *args,
                                 compute_dtype=tkw.get("compute_dtype"),
                                 **ckt)
    assert torch.equal(sel, s32) and torch.equal(cm, c32)


@pytest.mark.parametrize("bn", [16, 256])
@pytest.mark.parametrize("kind", ["none", "both"])
@pytest.mark.parametrize("name", OPERANDS)
def test_threshold_select_narrow_matches_jax(name, kind, bn):
    M, n, m, d, k = 2, 300, 29, 5, 12
    X, E, mask = make_inputs(M, n, m, d, seed=bn + len(name))
    Xj, Xt, jkw, tkw = _operand(X, name, seed=bn)
    r = np.random.default_rng(bn + len(kind))
    ckj, ckt = _split(_constraint_kwargs(kind, M, n, k, seed=5))
    cm = (np.sum(E * E, axis=-1) * (0.6 + 0.4 * r.random((M, m)))).astype(
        np.float32)
    count = np.full((M,), 3, np.int32)
    used = np.full((M,), 0.4, np.float32)
    counts = (np.zeros((M, 1), np.int32) if kind == "none" else
              np.minimum(r.integers(0, 2, (M, len(CAPS))),
                         np.asarray(CAPS) - 1).astype(np.int32))
    g0 = ref.exemplar_gains(Xt, torch.from_numpy(E), torch.from_numpy(cm),
                            **tkw)
    tau = (g0.amax(dim=1) * 0.3).numpy()
    acc, cm_out = ops.threshold_select(
        Xt, torch.from_numpy(E), torch.from_numpy(cm), torch.from_numpy(mask),
        torch.from_numpy(tau), k, used=torch.from_numpy(used),
        count=torch.from_numpy(count), counts=torch.from_numpy(counts),
        bn=bn, **tkw, **ckt)
    n_acc = 0
    for i in range(M):
        jacc, jcm = jref.threshold_select(
            Xj[i], jnp.asarray(E), jnp.asarray(cm[i]), jnp.asarray(mask[i]),
            jnp.float32(tau[i]), jnp.float32(used[i]),
            jnp.asarray(counts[i]), jnp.int32(count[i]), k=k, bn=bn,
            **_machine(jkw, i), **_machine(ckj, i))
        np.testing.assert_array_equal(acc[i].numpy(), np.asarray(jacc))
        testing.assert_close(cm_out[i], jcm, f"{name} {kind} machine {i}")
        n_acc += int(np.asarray(jacc).sum())
    assert n_acc > 0
    a32, c32 = ops.threshold_select(
        _dequantized(Xt, tkw), torch.from_numpy(E), torch.from_numpy(cm),
        torch.from_numpy(mask), torch.from_numpy(tau), k,
        used=torch.from_numpy(used), count=torch.from_numpy(count),
        counts=torch.from_numpy(counts), bn=bn,
        compute_dtype=tkw.get("compute_dtype"), **ckt)
    assert torch.equal(acc, a32) and torch.equal(cm_out, c32)


@pytest.mark.parametrize("dtype,scaled,shape,match", [
    (torch.float32, True, (2, 5), "int8 rows with x_scale"),
    (torch.bfloat16, True, (2, 5), "int8 rows with x_scale"),
    (torch.int8, False, (2, 5), "int8 rows with x_scale"),
    (torch.float16, False, (2, 5), "int8 rows with x_scale"),
    (torch.int8, True, (2, 4), "contiguous fp32"),
])
def test_row_operand_refuses_what_the_kernels_do_not_take(dtype, scaled,
                                                          shape, match):
    X = torch.zeros((2, 5, 3), dtype=dtype)
    s = torch.ones(shape) if scaled else None
    with pytest.raises(ValueError, match=match):
        eg_mod.row_operand(X, s, s, "exemplar_gains")
    assert eg_mod.row_operand(torch.zeros((2, 5, 3), dtype=torch.int8),
                              torch.ones((2, 5)), torch.ones((2, 5)),
                              "exemplar_gains") == 2


def test_narrow_counters_count_once_more():
    ops.reset_launch_counts()
    eg_mod.count_launches("greedy_select", "greedy_select_weighted", 2, True,
                          5)
    eg_mod.count_launches("threshold_select", "threshold_select", 1, False)
    eg_mod.count_launches("exemplar_gains", "exemplar_gains", 0, False)
    got = {key: v for key, v in _build.launch_counts.items() if v}
    assert got == {"greedy_select_weighted": 5, "greedy_select_q8": 5,
                   "greedy_select_bf16dot": 5, "threshold_select": 1,
                   "threshold_select_bf16": 1, "exemplar_gains": 1}
    ops.reset_launch_counts()


def test_compute_dtype_other_than_bf16_is_refused():
    X, E, mask = make_inputs(1, 10, 4, 3, seed=0)
    with pytest.raises(ValueError, match="compute_dtype"):
        ops.exemplar_gains(torch.from_numpy(X), torch.from_numpy(E),
                           torch.ones(4), compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="pair up"):
        ops.greedy_select(torch.from_numpy(X), torch.from_numpy(E),
                          torch.ones(4), torch.from_numpy(mask), 2,
                          x_scale=torch.ones((1, 10)))


@pytest.mark.parametrize("name", OPERANDS)
def test_narrow_kernels_match_plain_on_card(cuda, name):  # noqa: F811
    M, n, m, d, k = 3, 333, 70, 17, 9
    X, E, mask = make_inputs(M, n, m, d, seed=len(name))
    _, Xt, _, tkw = _operand(X, name, seed=1)
    Xt = Xt.to(cuda)
    tkw = {key: (v.to(cuda) if isinstance(v, torch.Tensor) else v)
           for key, v in tkw.items()}
    Et, mt = torch.as_tensor(E, device=cuda), torch.as_tensor(mask,
                                                              device=cuda)
    e0 = torch.sum(Et * Et, dim=-1)
    testing.assert_close(ops.exemplar_gains(Xt, Et, e0, **tkw),
                         ref.exemplar_gains(Xt, Et, e0, **tkw))
    sel, cm = ops.greedy_select(Xt, Et, e0, mt, k, **tkw)
    sel_p, cm_p, gap, best = ref.greedy_select_trace(Xt, Et, e0, mt, k,
                                                     **tkw)
    ok, _ = testing.selections_agree(sel, sel_p, gap, best)
    assert ok
    same = torch.all(sel == sel_p, dim=1)
    testing.assert_close(cm[same], cm_p[same])
