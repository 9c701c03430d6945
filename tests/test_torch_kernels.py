"""The port's kernels: plain versions against the JAX package's ``ref`` and
``ops`` on the CPU, dispatch rules, and the CUDA kernels against their plain
versions on a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import testing
from repro_torch.kernels import exemplar_gains as eg_mod
from repro_torch.kernels import greedy_select as gs_mod
from repro_torch.kernels import ops, ref

from _torch_parity import cuda, make_inputs  # noqa: F401

SHAPES = [(1, 37, 13, 5), (3, 61, 29, 17), (3, 45, 130, 3)]


@pytest.mark.parametrize("M,n,m,d", SHAPES)
def test_pairwise_sqdist_matches_jax(M, n, m, d):
    X, E, _ = make_inputs(M, n, m, d, seed=n)
    got = ref.pairwise_sqdist(torch.from_numpy(X), torch.from_numpy(E))
    for i in range(M):
        testing.assert_close(got[i], jref.pairwise_sqdist(jnp.asarray(X[i]),
                                                          jnp.asarray(E)))


@pytest.mark.parametrize("M,n,m,d", SHAPES)
def test_exemplar_gains_matches_jax(M, n, m, d):
    X, E, _ = make_inputs(M, n, m, d, seed=n + 1)
    cm = np.random.default_rng(m).random((M, m)).astype(np.float32) * d
    got = ops.exemplar_gains(torch.from_numpy(X), torch.from_numpy(E),
                             torch.from_numpy(cm))
    for i in range(M):
        want = jops.exemplar_gains(jnp.asarray(X[i]), jnp.asarray(E),
                                   jnp.asarray(cm[i]))
        testing.assert_close(got[i], want, f"machine {i}")
    # the unbatched form is the same function
    testing.assert_close(
        ops.exemplar_gains(torch.from_numpy(X[0]), torch.from_numpy(E),
                           torch.from_numpy(cm[0])), got[0])


@pytest.mark.parametrize("M,n,m,d", SHAPES)
@pytest.mark.parametrize("k", [7, 50])
def test_greedy_select_matches_jax(M, n, m, d, k):
    """k=50 exceeds the available rows of the smallest block: the −1 tail."""
    X, E, mask = make_inputs(M, n, m, d, seed=n + k)
    cm0 = np.sum(E * E, axis=-1)
    sel, cm = ops.greedy_select(torch.from_numpy(X), torch.from_numpy(E),
                                torch.from_numpy(cm0), torch.from_numpy(mask),
                                k)
    assert sel.shape == (M, k) and cm.shape == (M, m)
    for i in range(M):
        jsel, jcm = jops.greedy_select(jnp.asarray(X[i]), jnp.asarray(E),
                                       jnp.asarray(cm0), jnp.asarray(mask[i]),
                                       k)
        np.testing.assert_array_equal(sel[i].numpy(), np.asarray(jsel))
        testing.assert_close(cm[i], jcm, f"machine {i}")


def test_greedy_select_matches_pallas_interpret():
    """One tiny case against the JAX Pallas kernel in interpret mode."""
    X, E, mask = make_inputs(1, 40, 21, 5, seed=7)
    cm0 = np.sum(E * E, axis=-1)
    jsel, jcm = jops.greedy_select(jnp.asarray(X[0]), jnp.asarray(E),
                                   jnp.asarray(cm0), jnp.asarray(mask[0]), 6,
                                   impl="pallas", bn=16)
    sel, cm = ops.greedy_select(torch.from_numpy(X[0]), torch.from_numpy(E),
                                torch.from_numpy(cm0),
                                torch.from_numpy(mask[0]), 6)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    testing.assert_close(cm, jcm)


def test_trace_matches_greedy_select():
    X, E, mask = make_inputs(2, 30, 11, 4, seed=3)
    Xt, Et, mt = map(torch.from_numpy, (X, E, mask))
    e0 = torch.sum(Et * Et, dim=-1)
    sel, cm, gap, best = ref.greedy_select_trace(Xt, Et, e0, mt, 6)
    sel2, cm2 = ref.greedy_select(Xt, Et, e0, mt, 6)
    assert torch.equal(sel, sel2) and torch.equal(cm, cm2)
    assert bool(torch.all(gap >= 0))
    g0 = ref.exemplar_gains(Xt, Et, e0).masked_fill(~mt, ref.NEG_INF)
    testing.assert_close(best[:, 0], g0.max(dim=1).values)


@pytest.mark.parametrize("M,n,m,d,k", [(1, 70, 9, 4, 8), (2, 41, 13, 6, 8),
                                       (1, 6, 5, 3, 8)])
def test_row_chunked_trace_matches_machine_chunks(monkeypatch, M, n, m, d, k):
    """The plain greedy over a machine too large for its distance tensor
    (chunked over rows, as at n = 45M on the card) selects as the whole-
    machine version does, −1 past the last candidate included."""
    X, E, mask = make_inputs(M, n, m, d, seed=n)
    Xt, Et, mt = map(torch.from_numpy, (X, E, mask))
    e0 = torch.sum(Et * Et, dim=-1)
    want = ref.greedy_select_trace(Xt, Et, e0, mt, k)
    monkeypatch.setattr(ref, "_CHUNK_ELEMS", 4 * m)       # 4 rows a chunk
    got = ref.greedy_select_trace(Xt, Et, e0, mt, k)
    assert torch.equal(got[0], want[0])
    for a, b, what in zip(got[1:], want[1:], ("cur_min", "gap", "best")):
        testing.assert_close(a, b, what)


def test_refresh_cur_min_replays_the_selection():
    X, E, mask = make_inputs(3, 25, 11, 5, seed=4)
    Xt, Et, mt = map(torch.from_numpy, (X, E, mask))
    e0 = torch.sum(Et * Et, dim=-1)
    sel, cm = ref.greedy_select(Xt, Et, e0, mt, 30)       # −1 at the end
    assert bool(torch.any(sel < 0))
    assert torch.equal(ref.refresh_cur_min(Xt, Et, e0, sel), cm)
    assert torch.equal(ref.refresh_cur_min(Xt[1], Et, e0, sel[1]), cm[1])


def test_near_tie_rule():
    """Selections must agree up to the first near-tie step, and may part
    after it."""
    ref_sel = np.array([[1, 2, 3]])
    gaps = np.array([[1.0, 1e-9, 1.0]])
    best = np.ones((1, 3))
    assert testing.selections_agree(np.array([[1, 2, 4]]), ref_sel, gaps,
                                    best) == (True, 1)
    assert testing.selections_agree(np.array([[1, 5, 4]]), ref_sel, gaps,
                                    best) == (True, 1)
    assert not testing.selections_agree(np.array([[0, 2, 3]]), ref_sel, gaps,
                                        best)[0]


@pytest.mark.parametrize("kw,item", [({"compute_dtype": torch.bfloat16}, "10"),
                                     ({"x_scale": 1}, "10"),
                                     ({"x_zp": 1}, "10")])
def test_unported_arguments_name_their_roadmap_item(kw, item):
    """The arguments of ROADMAP queue 1 item 10 are ported: the bf16 dot
    runs on every entry point like the plain version it reaches, and a
    dequant scale or zero-point alone is refused (they pair up)."""
    X, E, mask = make_inputs(1, 9, 5, 3, seed=0)
    args = (torch.from_numpy(X[0]), torch.from_numpy(E),
            torch.ones(5), torch.from_numpy(mask[0]), 2)
    if "compute_dtype" not in kw:
        kw = {key: torch.ones(9) for key in kw}
        for call in (lambda: ops.greedy_select(*args, **kw),
                     lambda: ops.threshold_select(*args[:4], 0.1, 2, **kw),
                     lambda: ops.exemplar_gains(*args[:3], **kw)):
            with pytest.raises(ValueError, match="pair up"):
                call()
        return
    sel, cm = ops.greedy_select(*args, **kw)
    sel_p, cm_p = ref.greedy_select(*args, **kw)
    assert torch.equal(sel, sel_p) and torch.equal(cm, cm_p)
    acc, _ = ops.threshold_select(*args[:4], 0.1, 2, **kw)
    assert torch.equal(acc, ref.threshold_select(*args[:4], 0.1, 2, **kw)[0])
    assert torch.equal(ops.exemplar_gains(*args[:3], **kw),
                       ref.exemplar_gains(*args[:3], **kw))


def test_non_cpu_tensor_never_falls_back_to_plain():
    """A tensor that is neither on the CPU nor on a card raises."""
    X = torch.empty((4, 3), device="meta")
    E = torch.empty((2, 3), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.exemplar_gains(X, E, torch.empty((2,), device="meta"))
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.greedy_select(X, E, torch.empty((2,), device="meta"),
                          torch.empty((4,), dtype=torch.bool, device="meta"),
                          1)


def test_kernel_launchers_refuse_cpu_tensors():
    """The kernel wrappers launch on CUDA tensors only: a CPU tensor is an
    error, not a quiet run of the plain version."""
    X = torch.zeros((1, 8, 3))
    E = torch.zeros((64, 3))
    cm = torch.zeros((1, 64))
    with pytest.raises(ValueError, match="CUDA"):
        eg_mod.launch(X, E, cm)
    with pytest.raises(ValueError, match="CUDA"):
        gs_mod.launch(X, E, cm, torch.ones((1, 8), dtype=torch.uint8), 2, 64)


def test_launch_counts_untouched_by_plain_path():
    ops.reset_launch_counts()
    X, E, mask = make_inputs(2, 20, 7, 3, seed=1)
    ops.greedy_select(torch.from_numpy(X), torch.from_numpy(E),
                      torch.ones(7), torch.from_numpy(mask), 3)
    ops.threshold_select(torch.from_numpy(X), torch.from_numpy(E),
                         torch.ones(7), torch.from_numpy(mask), 0.01, 3,
                         eval_weights=torch.ones(7))
    ops.exemplar_gains(torch.from_numpy(X), torch.from_numpy(E),
                       torch.ones(7), eval_weights=torch.ones(7))
    ops.rbf_kernel(torch.from_numpy(X), torch.from_numpy(E), 0.5)
    q = torch.ones((1, 2, 3, 16))
    ops.flash_attention(q, q[:, :1], q[:, :1])
    ops.flash_attention(q[:, :, :1], q[:, :1], q[:, :1], kv_valid_len=2)
    qg = q.clone().requires_grad_(True)
    ops.flash_attention(qg, q[:, :1], q[:, :1]).sum().backward()
    ops.wkv6(q, q, q, q, q[0, :, 0])
    ops.wkv6(q[:, :, :1], q[:, :, :1], q[:, :, :1], q[:, :, :1], q[0, :, 0],
             torch.zeros((1, 2, 16, 16)))
    Xq = torch.from_numpy(X).to(torch.int8)
    ones = torch.ones((2, 20))
    ops.greedy_select(Xq, torch.from_numpy(E), torch.ones(7),
                      torch.from_numpy(mask), 3, x_scale=ones, x_zp=ones,
                      compute_dtype=torch.bfloat16)
    ops.exemplar_gains(torch.from_numpy(X).bfloat16(), torch.from_numpy(E),
                       torch.ones(7))
    assert ops.launch_counts == {
        "exemplar_gains": 0, "exemplar_gains_weighted": 0,
        "exemplar_gains_bf16": 0, "exemplar_gains_q8": 0,
        "exemplar_gains_bf16dot": 0,
        "greedy_select": 0, "greedy_select_constrained": 0,
        "greedy_select_weighted": 0, "greedy_select_bf16": 0,
        "greedy_select_q8": 0, "greedy_select_bf16dot": 0,
        "threshold_select": 0, "threshold_select_weighted": 0,
        "threshold_select_bf16": 0, "threshold_select_q8": 0,
        "threshold_select_bf16dot": 0, "threshold_select_prepass": 0,
        "threshold_select_tail": 0, "rbf_kernel": 0, "rbf_kernel_rowvec": 0,
        "flash_attention_prefill": 0, "flash_attention_prefill_wgmma": 0,
        "flash_attention_decode": 0, "flash_attention_prefill_lse": 0,
        "flash_attention_bwd_delta": 0, "flash_attention_bwd_dkdv": 0,
        "flash_attention_bwd_dq": 0, "wkv6_prefill": 0, "wkv6_decode": 0,
        "wkv6_recurrent": 0, "wkv6_chunked": 0}


@pytest.mark.parametrize("M,n,m,d", [(1, 300, 70, 6), (7, 333, 130, 17),
                                     (2, 129, 65, 3072), (7, 20_011, 130, 6),
                                     (5, 30_011, 1100, 6)])
def test_kernels_match_plain_on_card(cuda, M, n, m, d):  # noqa: F811
    """exemplar_gains (one launch of the persistent grid; the last two
    shapes have more (machine, tile) pairs than the grid has CTAs, so CTAs
    walk several tiles and cross machines, resident and chunked) and
    greedy_select against their plain versions."""
    X, E, mask = make_inputs(M, n, m, d, seed=M + n)
    X /= np.sqrt(d)
    E /= np.sqrt(d)
    Xt, Et, mt = (torch.as_tensor(a, device=cuda) for a in (X, E, mask))
    e0 = torch.sum(Et * Et, dim=-1)
    ops.reset_launch_counts()
    testing.assert_close(ops.exemplar_gains(Xt, Et, e0),
                         ref.exemplar_gains(Xt, Et, e0))
    assert ops.launch_counts["exemplar_gains"] == 1
    sel, cm = ops.greedy_select(Xt, Et, e0, mt, 9)
    sel_p, cm_p, gap, best = ref.greedy_select_trace(Xt, Et, e0, mt, 9)
    ok, _ = testing.selections_agree(sel, sel_p, gap, best)
    assert ok
    same = torch.all(sel == sel_p, dim=1)
    testing.assert_close(cm[same], cm_p[same])


def test_machine_chunked_gains_match_whole(monkeypatch):
    """The plain gains over a stack too large for its distance tensor (a
    full round at the card's shape) are scored a machine chunk at a time,
    to the same bits."""
    X, E, _ = make_inputs(9, 50, 13, 5, seed=8)
    Xt, Et = torch.from_numpy(X), torch.from_numpy(E)
    cm = torch.rand((9, 13), generator=torch.Generator().manual_seed(0)) * 5
    want = ref.exemplar_gains(Xt, Et, cm)
    shared = ref.exemplar_gains(Xt, Et, cm[0])
    monkeypatch.setattr(ref, "_CHUNK_ELEMS", 2 * 50 * 13)
    assert torch.equal(ref.exemplar_gains(Xt, Et, cm), want)
    assert torch.equal(ref.exemplar_gains(Xt, Et, cm[0]), shared)
