"""The exemplar gain tile's arithmetic and the threshold pre-pass, modelled
on the CPU.

``csrc/exemplar_tile.cuh`` folds the squared norms into one product of
depth K = round_up(d + 2, 8), x~ = (x, ‖x‖², 1, 0…) against
e~ = (−2e, 1, ‖e‖², 0…), and runs it as three TF32 products (lo·hi,
hi·lo, hi·hi of each operand's ``cvt.rna`` split) per 8-deep k-step; each
thread sums its columns in order and a quad folds with a fixed butterfly.
:func:`tile_model` repeats that arithmetic in NumPy (each ``mma`` modelled
as its exact products summed in float64 and rounded once to fp32 — the
card's accumulation order is its own, which only a chip run reads).  The
split model meets the port's RTOL/ATOL against the plain
``exemplar_gains`` (and the JAX package's) at Webscope-like operands, and
one unsplit TF32 product does not.

``csrc/threshold_select.cu`` walks each machine's first blocks as the
block-sequential walk does, then scores the rest on the whole card and
visits only the blocks in which some row qualifies there;
:func:`prepass_walk` is that walk in plain PyTorch, held against
``ref.threshold_select`` (which scores every block) on every constraint
encoding.  Inputs are made with NumPy from a seed.

``exemplar_gains``, ``greedy_select``'s steps and the threshold pre-pass
launch the tile's persistent grid (``persistent_tiles`` /
``persistent_grid`` / ``cta_of``): P = min(resident CTAs, T) CTAs over
the T = M · ntiles flattened (machine, 128-row tile) pairs, CTA c walking
[c·T/P, (c+1)·T/P).  :func:`persistent_ranges` and
:func:`gains_writes` model the ranges and ``exemplar_gains``' writes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch import testing
from repro_torch.data import datasets
from repro_torch.kernels import ref
from repro_torch.kernels import threshold_select as _ts

from _torch_parity import make_attrs, make_inputs

F32, F64 = np.float32, np.float64


def rna_tf32(v) -> np.ndarray:
    """``cvt.rna.tf32.f32``: round to 10 mantissa bits, to nearest with
    ties away from zero (the magnitude's bits, so the sign is kept), the
    13 low bits cleared."""
    b = np.ascontiguousarray(v, F32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def sq_norm(V: np.ndarray) -> np.ndarray:
    """Σ_c v_c² by fp32 FMAs in feature order (each fma: the exact product
    added in float64, rounded once to fp32)."""
    s = np.zeros(V.shape[0], F32)
    for c in range(V.shape[1]):
        v = V[:, c].astype(F64)
        s = (s.astype(F64) + v * v).astype(F32)
    return s


def augment(X: np.ndarray, E: np.ndarray):
    """x~ (n, K) and e~ (m, K) with K = round_up(d + 2, 8)."""
    d = X.shape[1]
    K = -(-(d + 2) // 8) * 8
    Xa = np.zeros((X.shape[0], K), F32)
    Ea = np.zeros((E.shape[0], K), F32)
    Xa[:, :d], Xa[:, d], Xa[:, d + 1] = X, sq_norm(X), 1.0
    Ea[:, :d], Ea[:, d], Ea[:, d + 1] = -2.0 * E, 1.0, sq_norm(E)
    return Xa, Ea


def distances(X, E, split=True) -> np.ndarray:
    """t = x~·e~ (n, m) as the tile forms it: per 8-deep k-step, lo·hi,
    hi·lo, hi·hi (split) or hi·hi alone (one TF32 product) into one fp32
    accumulator."""
    Xa, Ea = augment(X, E)
    xh, eh = rna_tf32(Xa), rna_tf32(Ea)
    xl, el = rna_tf32(Xa - xh), rna_tf32(Ea - eh)
    terms = ((xl, eh), (xh, el), (xh, eh)) if split else ((xh, eh),)
    acc = np.zeros((X.shape[0], E.shape[0]), F32)
    for k0 in range(0, Xa.shape[1], 8):
        s = slice(k0, k0 + 8)
        for A, B in terms:
            acc = (acc.astype(F64)
                   + A[:, s].astype(F64) @ B[:, s].astype(F64).T).astype(F32)
    return acc


def tile_model(X, E, cm, ew=None, split=True) -> np.ndarray:
    """Raw gain sums (n,) of the tile: column j goes to the thread of its
    quad with tig = (j mod 8) // 2, which adds its columns in order
    (``fmaf(contrib, w, sum)`` with weights); the quad folds as
    ((s0 + s1) + (s2 + s3))."""
    d2 = np.maximum(distances(X, E, split), F32(0))
    contrib = np.maximum(np.asarray(cm, F32)[None, :] - d2, F32(0))
    n, m = contrib.shape
    w = np.ones(m, F32) if ew is None else np.asarray(ew, F32)
    parts = []
    for tig in range(4):
        s = np.zeros(n, F32)
        for j in [j for j in range(m) if (j % 8) // 2 == tig]:
            if ew is None:
                s = s + contrib[:, j]
            else:
                s = (contrib[:, j].astype(F64) * F64(w[j])
                     + s.astype(F64)).astype(F32)
        parts.append(s)
    return (parts[0] + parts[1]) + (parts[2] + parts[3])


def webscope_operands(n=3_000, m=512, seed=5):
    """Webscope-like rows (the port's d = 6 analog), eval rows from the
    same draw, fp32."""
    data = datasets.webscope(n=n + m, d=6, seed=seed)
    return data[:n], data[n:]


@pytest.fixture(scope="module")
def webscope_trace():
    X, E = webscope_operands()
    Xt, Et = torch.from_numpy(X), torch.from_numpy(E)
    e0 = torch.sum(Et * Et, dim=-1)
    mask = torch.ones(X.shape[0], dtype=torch.bool)
    return X, E, e0, ref.greedy_select_trace(Xt, Et, e0, mask, 50)


def _cm_after(X, E, e0, sel, steps):
    return ref.refresh_cur_min(torch.from_numpy(X), torch.from_numpy(E), e0,
                               sel[:steps]).numpy()


@pytest.mark.parametrize("steps", [0, 10, 49])
def test_split_tile_meets_the_check_and_one_tf32_product_does_not(
        webscope_trace, steps):
    X, E, e0, (sel, _, _, _) = webscope_trace
    cm = _cm_after(X, E, e0, sel, steps)
    m = E.shape[0]
    plain = ref.exemplar_gains(torch.from_numpy(X), torch.from_numpy(E),
                               torch.from_numpy(cm)).numpy()
    jax_g = np.asarray(jref.exemplar_gains(jnp.asarray(X), jnp.asarray(E),
                                           jnp.asarray(cm)))
    split = tile_model(X, E, cm) / F32(m)
    testing.assert_close(split, plain, f"split tile after {steps} steps")
    testing.assert_close(split, jax_g, f"split tile vs JAX, {steps} steps")
    one = tile_model(X, E, cm, split=False) / F32(m)
    with pytest.raises(AssertionError):
        testing.assert_close(one, plain, "one TF32 product")


def test_split_tile_selects_as_the_plain_greedy(webscope_trace):
    """k = 50 greedy steps scored by the split model (cur_min refreshed in
    the difference form, as the kernel's commit does) against the plain
    trace under the near-tie rule."""
    X, E, e0, (sel_p, _, gap, best) = webscope_trace
    Et = torch.from_numpy(E)
    m = E.shape[0]
    cm = e0.clone()
    avail = np.ones(X.shape[0], bool)
    sel = []
    for _ in range(sel_p.shape[0]):
        g = tile_model(X, E, cm.numpy()) / F32(m)
        g = np.where(avail, g, F32(ref.NEG_INF))
        i = int(np.argmax(g))                       # lowest index on ties
        sel.append(i)
        avail[i] = False
        x = torch.from_numpy(X[i])
        cm = torch.minimum(cm, torch.sum((Et - x) ** 2, dim=-1))
    ok, _ = testing.selections_agree(np.asarray(sel), sel_p.numpy(),
                                     gap.numpy(), best.numpy())
    assert ok


@pytest.mark.parametrize("d", [6, 17, 64])
def test_augmented_layout_at_every_width(d):
    """K = round_up(d + 2, 8); x~·e~ is ‖x‖² + ‖e‖² − 2x·e; the split model
    meets the check against the plain gains and the JAX package's."""
    n, m = 400, 130
    r = np.random.default_rng(d)
    X = (r.standard_normal((n, d)) / np.sqrt(d)).astype(F32)
    E = (r.standard_normal((m, d)) / np.sqrt(d)).astype(F32)
    Xa, Ea = augment(X, E)
    assert Xa.shape[1] == Ea.shape[1] == -(-(d + 2) // 8) * 8
    exact = (np.sum(X.astype(F64) ** 2, 1)[:, None]
             + np.sum(E.astype(F64) ** 2, 1)[None, :]
             - 2.0 * X.astype(F64) @ E.astype(F64).T)
    np.testing.assert_allclose(Xa.astype(F64) @ Ea.astype(F64).T, exact,
                               rtol=0, atol=1e-5)
    cm = (np.sum(E * E, 1) * (0.5 + 0.5 * r.random(m))).astype(F32)
    g = tile_model(X, E, cm) / F32(m)
    testing.assert_close(g, ref.exemplar_gains(
        torch.from_numpy(X), torch.from_numpy(E), torch.from_numpy(cm)), "d")
    testing.assert_close(g, np.asarray(jref.exemplar_gains(
        jnp.asarray(X), jnp.asarray(E), jnp.asarray(cm))), "d vs JAX")


@pytest.mark.parametrize("mp", [320, 384])
def test_zero_padded_eval_rows_contribute_exactly_zero(mp):
    """E and cur_min zero-padded past m (the wrapper pads to BM): the
    padded columns' terms are exactly +0 and the raw sums keep their bits,
    weighted or not."""
    X, E, _ = make_inputs(1, 200, 300, 6, seed=mp)
    X, E = X[0], E
    cm = (np.sum(E * E, 1) * 0.8).astype(F32)
    w = np.random.default_rng(mp).uniform(0.5, 1.5, 300).astype(F32)
    Ep = np.zeros((mp, 6), F32)
    Ep[:300] = E
    cmp_, wp = np.zeros(mp, F32), np.zeros(mp, F32)
    cmp_[:300], wp[:300] = cm, w
    t = np.maximum(distances(X, Ep)[:, 300:], F32(0))
    term = np.maximum(cmp_[None, 300:] - t, F32(0))
    assert np.all(term == 0) and not np.any(np.signbit(term))
    for ew, ewp in ((None, None), (w, wp)):
        a, b = tile_model(X, E, cm, ew), tile_model(X, Ep, cmp_, ewp)
        assert a.tobytes() == b.tobytes()


def test_unit_weights_give_the_unweighted_sums(webscope_trace):
    X, E, e0, (sel, _, _, _) = webscope_trace
    for steps in (0, 25):
        cm = _cm_after(X, E, e0, sel, steps)
        ones = np.ones(E.shape[0], F32)
        assert (tile_model(X[:500], E, cm, ones).tobytes()
                == tile_model(X[:500], E, cm).tobytes())


@pytest.mark.parametrize("weighted", [False, True])
def test_plain_gains_are_monotone_in_cur_min_bit_for_bit(weighted):
    """Each term max(cm − d², 0) is monotone in cm and a fixed-order sum
    of non-negative fp32 terms is monotone: a lower cur_min never raises a
    gain, to the bit — what lets the threshold walk skip a block in which
    no row qualifies at the level's entry."""
    M, n, m, d = 3, 300, 130, 6
    X, E, _ = make_inputs(M, n, m, d, seed=7 + weighted)
    r = np.random.default_rng(weighted)
    cm_hi = (np.sum(E * E, 1) * (0.5 + r.random((M, m)))).astype(F32)
    ew = (torch.from_numpy(r.uniform(0.5, 1.5, m).astype(F32)) if weighted
          else None)
    Xt, Et = torch.from_numpy(X), torch.from_numpy(E)
    g_hi = ref.exemplar_gains(Xt, Et, torch.from_numpy(cm_hi),
                              eval_weights=ew)
    for frac in (1.0, 0.999, 0.9, 0.5):
        cm_lo = np.minimum(cm_hi, (cm_hi * F32(frac)
                                   * r.uniform(0.8, 1.0, (M, m))).astype(F32))
        g_lo = ref.exemplar_gains(Xt, Et, torch.from_numpy(cm_lo),
                                  eval_weights=ew)
        assert bool(torch.all(g_lo <= g_hi))
        if frac == 1.0:
            assert torch.equal(g_lo, ref.exemplar_gains(
                Xt, Et, torch.from_numpy(np.minimum(cm_hi, cm_lo)),
                eval_weights=ew))


# -- the threshold pre-pass and the flagged walk ----------------------------


def prepass_walk(X, E, cm, mask, tau, k, *, bn, enc, used, counts, count,
                 active, ew=None):
    """One τ-level as ``csrc/threshold_select.cu`` runs it, in plain
    PyTorch, with the qualify, accept and fold arithmetic of
    ``ref.threshold_select``.  Per machine: the head walks the blocks in
    order, each scored at its block-entry cur_min, until the machine is
    done or ``HEAD_EMPTIES`` blocks in a row accepted nothing; the pre-pass
    then scores the rest at the head's exit state and flags the blocks with
    a qualifying row; the tail visits the flagged blocks only (the
    pre-pass gains until its first accept, a rescore after).  Returns
    (accept, cur_min, count, used, counts, stop, visits) with ``visits[i]``
    the (block, how it was scored, rows accepted) of machine i."""
    M, n, _ = X.shape
    m = E.shape[0]
    d2 = ref.pairwise_sqdist(X, E)
    blocks = [slice(b * bn, min(n, (b + 1) * bn)) for b in range(-(-n // bn))]
    accept = torch.zeros((M, n), dtype=torch.bool)
    cm, used, counts = cm.clone(), used.clone(), counts.clone()
    count = count.clone().long()
    stop = torch.zeros(M, dtype=torch.bool)
    visits = [[] for _ in range(M)]

    def gains(i, b):
        return ref._gain_sums(cm[i:i + 1].unsqueeze(1), d2[i:i + 1, blocks[b]],
                              ew) / m

    def visit(i, b, g, how):
        """Qualify, accept and fold block b of machine i at gains g."""
        row = (slice(i, i + 1), blocks[b])
        blk = enc.rows(row)
        q = blk.feasible(mask[row] & (g >= tau[i]), used[i:i + 1],
                         counts[i:i + 1])
        violate = (count[i] + torch.cumsum(q.long(), dim=-1)) > k
        if blk.w is not None:
            cumw = torch.cumsum(torch.where(q, blk.w, 0.0), dim=-1)
            violate = violate | (used[i] + cumw > blk.limit)
        if blk.gid is not None:
            for grp in range(enc.G):
                cg = torch.cumsum((q & (blk.gid == grp)).long(), dim=-1)
                violate = violate | (counts[i, grp] + cg > enc.caps[grp])
        acc = q & (torch.cumsum(violate.long(), dim=-1) == 0)
        stop[i] = bool(torch.any(violate & q))
        n_acc = int(acc.sum())
        visits[i].append((b, how, n_acc))
        accept[row] = acc
        count[i] += n_acc
        if blk.w is not None:
            used[i] = used[i] + torch.sum(torch.where(acc, blk.w, 0.0))
        if blk.gid is not None:
            for grp in range(enc.G):
                counts[i, grp] += int(torch.sum(acc & (blk.gid == grp)))
        if n_acc:
            cm[i] = torch.minimum(cm[i], torch.amin(torch.where(
                acc[0].unsqueeze(-1), d2[i, blocks[b]], float("inf")), dim=0))
        return n_acc

    for i in range(M):
        if not active[i] or (enc.gid is not None
                             and bool(torch.any(counts[i] > enc.caps))):
            continue
        nxt, empties = None, 0
        for b in range(len(blocks)):
            if stop[i] or count[i] >= k:
                break
            empties = 0 if visit(i, b, gains(i, b), "head") else empties + 1
            if (empties >= _ts.HEAD_EMPTIES and b + 1 < len(blocks)
                    and not stop[i] and count[i] < k):
                nxt = b + 1
                break
        if nxt is None:
            continue
        pre = {b: gains(i, b) for b in range(nxt, len(blocks))}
        feas = enc.rows((slice(i, i + 1), slice(None))).feasible(
            mask[i:i + 1], used[i:i + 1], counts[i:i + 1])
        flagged = [b for b in pre
                   if bool(torch.any(feas[:, blocks[b]] & (pre[b] >= tau[i])))]
        moved = False
        for b in flagged:
            if stop[i] or count[i] >= k:
                break
            if moved:
                visit(i, b, gains(i, b), "rescored")
            else:
                moved = visit(i, b, pre[b], "pre-pass") > 0
    return accept, cm, count, used, counts, stop, visits


def _state_of(acc, count0, used0, counts0, enc, bn):
    """count, used, counts after the accept set ``acc``: ``used`` adds each
    block's accepted weight, block by block, as the plain walk does."""
    count = count0.long() + acc.sum(dim=1)
    used, counts = used0.clone(), counts0.clone()
    for b0 in range(0, acc.shape[1], bn):
        a = acc[:, b0:b0 + bn]
        if enc.w is not None:
            used = used + torch.sum(torch.where(a, enc.w[:, b0:b0 + bn], 0.0),
                                    dim=-1)
    if enc.gid is not None:
        for i, j in torch.nonzero(acc).tolist():
            counts[i, enc.gid[i, j]] += 1
    return count, used, counts


CAPS = (3, 2, 4, 1)


@pytest.mark.parametrize("case,frac,bn", [
    ("none", 0.4, 32), ("knapsack", 0.4, 32), ("partition", 0.4, 32),
    ("both", 0.4, 32), ("weighted", 0.4, 32), ("mid-ladder", 0.4, 32),
    ("early-stop", 0.2, 32), ("none", 0.6, 16), ("knapsack", 0.6, 16),
    ("partition", 0.6, 16), ("both", 0.6, 16), ("weighted", 0.6, 16),
    ("mid-ladder", 0.6, 16)])
def test_prepass_walk_matches_the_plain_threshold_select(case, frac, bn):
    """τ = frac · the best gain: at 0.4 many rows qualify and the head fills
    k or stops in a few blocks; at 0.6 over 16-row blocks fewer do, the
    head leaves the machines to the pre-pass and the tail visits their
    flagged blocks."""
    M, n, m, d, k = 4, 300, 64, 5, 12
    X, E, mask = make_inputs(M, n, m, d, seed=len(case))
    r = np.random.default_rng(len(case) + 1)
    w, g = make_attrs(r, (M, n), len(CAPS))
    Xt, Et = torch.from_numpy(X), torch.from_numpy(E)
    maskt = torch.from_numpy(mask)
    cm = torch.from_numpy((np.sum(E * E, -1)
                           * (0.6 + 0.4 * r.random((M, m)))).astype(F32))
    kw = {}
    if case in ("knapsack", "both", "mid-ladder"):
        kw.update(weights=torch.from_numpy(w), budget=0.3 * k)
    if case in ("partition", "both", "mid-ladder"):
        kw.update(group_ids=torch.from_numpy(g), caps=CAPS)
    enc = ref.Encoding(M, n, "cpu", **kw)
    ew = (torch.from_numpy(r.uniform(0.5, 1.5, m).astype(F32))
          if case == "weighted" else None)
    count = torch.zeros(M, dtype=torch.int32)
    used = torch.zeros(M)
    counts = torch.zeros((M, enc.G), dtype=torch.int32)
    if case == "mid-ladder":
        count = torch.from_numpy(r.integers(0, k // 2, M).astype(np.int32))
        used = torch.from_numpy((r.random(M) * 0.1 * k).astype(F32))
        counts = torch.from_numpy(np.minimum(
            r.integers(0, 2, (M, enc.G)), np.asarray(CAPS) - 1
        ).astype(np.int32))
    if case == "early-stop":
        count = torch.full((M,), k - 1, dtype=torch.int32)
    g0 = ref.exemplar_gains(Xt, Et, cm, eval_weights=ew).masked_fill(
        ~maskt, 0.0)
    tau = torch.amax(g0, dim=1) * frac
    active = torch.tensor([True, True, False, True])
    acc_p, cm_p = ref.threshold_select(
        Xt, Et, cm, maskt, tau, k, used=used, counts=counts, count=count,
        bn=bn, active=active, enc=enc, eval_weights=ew)
    acc, cm_out, cnt, u, cts, stop, visits = prepass_walk(
        Xt, Et, cm, maskt, tau, k, bn=bn, enc=enc, used=used, counts=counts,
        count=count, active=active, ew=ew)
    assert torch.equal(acc, acc_p)
    assert torch.equal(cm_out, cm_p)
    cnt_p, u_p, cts_p = _state_of(acc_p, count, used, counts, enc, bn)
    assert torch.equal(cnt, cnt_p)
    assert torch.equal(cts, cts_p)
    np.testing.assert_array_equal(u.numpy(), u_p.numpy())
    assert visits[2] == [] and not bool(acc[2].any())
    n_blocks = M * -(-n // bn)
    visited = sum(len(v) for v in visits)
    assert 0 < visited < n_blocks            # some blocks skipped
    hows = {how for v in visits for _, how, _ in v}
    if frac == 0.6:                          # the tail took over
        assert "pre-pass" in hows
    if case == "early-stop":                 # one accept, then the stop
        assert bool(stop[[0, 1, 3]].all())
        assert bool(torch.all(acc.sum(dim=1) <= 1))


def test_flagged_block_that_no_longer_qualifies_after_the_first_accept():
    """Blocks 0 and 1 hold no gain, so the head leaves the machine to the
    pre-pass and the tail; block 2's best row is accepted from the
    pre-pass gains, and block 3's only row that qualifies at the pre-pass
    is that row's near twin: the tail rescores block 3 at the cur_min
    block 2 left, accepts nothing there, and the result is
    ref.threshold_select's."""
    bn, k, d, m = 32, 8, 4, 64
    n = 5 * bn
    r = np.random.default_rng(3)
    E = r.standard_normal((m, d)).astype(F32)
    X = (10.0 + r.standard_normal((1, n, d))).astype(F32)  # far: no gain
    X[0, 2 * bn + 6] = E[:8].mean(0)                          # block 2
    X[0, 3 * bn + 8] = X[0, 2 * bn + 6] + F32(1e-3)           # its twin
    Xt, Et = torch.from_numpy(X), torch.from_numpy(E)
    mask = torch.ones((1, n), dtype=torch.bool)
    cm = torch.sum(Et * Et, dim=-1)[None].clone()
    g0 = ref.exemplar_gains(Xt, Et, cm)
    tau = g0[:, 2 * bn + 6] * 0.5
    assert float(g0[0, 3 * bn + 8]) >= float(tau[0])         # flagged
    enc = ref.Encoding(1, n, "cpu")
    acc, cm_out, cnt, *_, visits = prepass_walk(
        Xt, Et, cm, mask, tau, k, bn=bn, enc=enc, used=torch.zeros(1),
        counts=torch.zeros((1, 1), dtype=torch.int32),
        count=torch.zeros(1, dtype=torch.int32),
        active=torch.ones(1, dtype=torch.bool))
    assert visits[0] == [(0, "head", 0), (1, "head", 0), (2, "pre-pass", 1),
                         (3, "rescored", 0)]
    acc_p, cm_p = ref.threshold_select(Xt, Et, cm, mask, tau, k, bn=bn)
    assert torch.equal(acc, acc_p) and torch.equal(cm_out, cm_p)
    assert torch.nonzero(acc[0]).flatten().tolist() == [2 * bn + 6]


# ---------------------------------------------------------------------------
# The persistent grid of csrc/exemplar_tile.cuh, as exemplar_gains launches it
# ---------------------------------------------------------------------------

BN = 128   # rows of a tile (csrc/exemplar_tile.cuh)


def persistent_ranges(T: int, resident: int) -> np.ndarray:
    """``persistent_grid``'s P = min(resident, T) CTAs and each CTA c's
    tile range [c·T/P, (c+1)·T/P) of ``persistent_tiles``, in int64:
    (P, 2)."""
    P = min(resident, T)
    c = np.arange(P + 1, dtype=np.int64)
    edges = c * T // P
    return np.stack([edges[:-1], edges[1:]], axis=1)


def cta_of(t, P: int, T: int):
    """``cta_of``: the CTA whose range holds flattened tile t."""
    return ((np.asarray(t, np.int64) + 1) * P - 1) // T


def gains_writes(M: int, n: int, resident: int) -> np.ndarray:
    """How many times ``exemplar_gains``' kernel writes each (machine, row)
    of its (M, n) output: every CTA walks its range in order; a tile t is
    machine t // ntiles, rows (t % ntiles)·BN + [0, BN), and on_rows
    writes the rows below n."""
    R = BN
    ntiles = -(-n // R)
    writes = np.zeros((M, n), np.int64)
    for t0, t1 in persistent_ranges(M * ntiles, resident):
        t = np.arange(t0, t1)
        mach, row0 = t // ntiles, (t % ntiles) * R
        rows = row0[:, None] + np.arange(R)[None, :]
        keep = rows < n
        np.add.at(writes, (np.broadcast_to(mach[:, None], rows.shape)[keep],
                           rows[keep]), 1)
    return writes


@pytest.mark.parametrize("M", [1, 7, 2000])
@pytest.mark.parametrize("ntiles", [1, 176])
def test_persistent_ranges_cover_every_tile_once_in_order(M, ntiles):
    """At every grid size from 1 past T: no CTA's range is empty, the
    ranges follow one another from 0 to T (so every (machine, tile) is
    walked once, in order), cta_of names the CTA that walks each tile,
    and cur_min is staged at most once per (CTA, machine) met."""
    T = M * ntiles
    sizes = sorted({1, 2, 3, 131, 132, 527, 528, 660, max(1, T // 2),
                    max(1, T - 1), T, T + 1, 2 * T, 10 ** 6} - {0})
    t = np.arange(T, dtype=np.int64)
    for resident in sizes:
        rg = persistent_ranges(T, resident)
        P = len(rg)
        assert P == min(resident, T)
        assert rg[0, 0] == 0 and rg[-1, 1] == T
        assert np.all(rg[:, 1] > rg[:, 0])
        assert np.array_equal(rg[1:, 0], rg[:-1, 1])
        owner = np.repeat(np.arange(P), rg[:, 1] - rg[:, 0])
        assert np.array_equal(cta_of(t, P, T), owner)
        # a CTA enters each machine of its range once (cur_min staged once
        # a machine): the grid stages cur_min at most P + M − 1 times
        first, last = rg[:, 0] // ntiles, (rg[:, 1] - 1) // ntiles
        assert np.all(last >= first)
        assert int(np.sum(last - first + 1)) <= P + M - 1


@pytest.mark.parametrize("M,n,resident", [
    (1, 22_500, 528), (7, 300, 5), (7, 20_011, 528), (3, 129, 1),
    (2, 1, 528), (1, 128, 528), (40, 22_500, 528)])
def test_gains_writes_every_row_once(M, n, resident):
    """Each row of each machine's output is written exactly once by the
    persistent grid, ragged last tiles included."""
    assert np.all(gains_writes(M, n, resident) == 1)
