"""The one-card dry run and roofline of the port
(``repro_torch.launch.{op_analyzer,specs,roofline,dryrun}``,
``repro_torch.kernels.cost``) against the JAX package's counterparts, on
the CPU with no card.

Of ``repro.launch`` these tests import ``roofline``, ``hlo_analyzer`` and
``specs`` only: ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host
devices at import, which would change every JAX test that runs later in
the same worker.

* the op analyzer on the cases of ``tests/test_hlo_analyzer.py``: a loop
  of matmuls counts its flops exactly (nested too), a one-slot cache write
  counts the slot, an embedding lookup its result, remat at least the
  plain flops;
* product flops of the plain path (``device="cpu"``) equal to
  ``hlo_analyzer.analyze`` of the compiled JAX step at ``reduced()``, B = 2,
  S = 64;
* the abstract inputs leaf by leaf against ``repro.launch.specs`` at full
  size, all ten archs;
* the roofline under a TPU v5e device model row for row against
  ``repro.launch.roofline``;
* the card's path: each kernel counted as its launches and ``cost.py``'s
  work, the wrappers' dry branches never building or loading, refusing
  what a launch refuses, and never taken by a real tensor.
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jax_config
from repro.launch import roofline as jax_roofline
from repro.launch import specs as jax_specs
from repro.launch.hlo_analyzer import analyze as hlo_analyze
from repro.models import get_model as jax_model
from repro.train import optimizer as jax_opt
from repro.train import train_step as jax_ts

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.paper_submod import SubmodConfig
from repro_torch.device import dry_card, resolve_device
from repro_torch.kernels import _build, cost, ops
from repro_torch.kernels import exemplar_gains as eg
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import wkv6 as wk
from repro_torch.launch import dryrun, roofline, specs
from repro_torch.launch.op_analyzer import OpAnalyzer as analyze_ops
from repro_torch.launch.op_analyzer import analyze
from repro_torch.models import layers as TL
from repro_torch.train import optimizer as opt_lib

#: TPU v5e as the JAX roofline models it (its three constants)
TPU_V5E = cost.Device("TPU v5e", peak_flops=jax_roofline.PEAK_FLOPS,
                      hbm_bw=jax_roofline.HBM_BW, link_bw=jax_roofline.ICI_BW)


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


# -- the analyzer (tests/test_hlo_analyzer.py's cases) ----------------------

@pytest.mark.parametrize("L", [4, 16])
def test_loop_flops_exact(L):
    def f(x, ws):
        for i in range(ws.shape[0]):
            x = torch.tanh(x @ ws[i])
        return x
    r = analyze(f, _meta(64, 64), _meta(L, 64, 64))
    assert r["flops"] == L * 2 * 64 ** 3
    assert r["unknown_trip_loops"] == [] and r["collectives"] == {
        "total": 0.0}


def test_nested_loop_flops_exact():
    def f(x, wss):
        for ws in wss:
            for w in ws:
                x = torch.tanh(x @ w)
        return x
    r = analyze(f, _meta(64, 64), _meta(3, 8, 64, 64))
    assert r["flops"] == 3 * 8 * 2 * 64 ** 3


def test_cache_write_counts_slice_not_buffer():
    def write(cache, upd, pos):
        cache[:, pos:pos + 1] = upd
    r = analyze(write, _meta(8, 4096, 128, dtype=torch.bfloat16),
                _meta(8, 1, 128, dtype=torch.bfloat16), 17)
    assert r["hbm_bytes"] < 0.01 * 8 * 4096 * 128 * 2, r["hbm_bytes"]


def test_embedding_counts_result_not_table():
    r = analyze(lambda e, t: F.embedding(t, e), _meta(50000, 512),
                _meta(8, 128, dtype=torch.long))
    assert r["hbm_bytes"] <= 3 * 8 * 128 * 512 * 4
    assert r["hbm_bytes"] < 0.2 * 50000 * 512 * 4


def test_remat_flops_counted():
    """``torch.utils.checkpoint`` re-runs the forward: at least the plain
    flops."""
    x, w = _meta(128, 128), _meta(128, 128, grad=True)

    def plain():
        torch.sum(torch.tanh(x @ w)).backward()

    def remat():
        torch.sum(torch.utils.checkpoint.checkpoint(
            lambda a, b: torch.tanh(a @ b), x, w,
            use_reentrant=False)).backward()
    fp, fr = analyze(plain)["flops"], analyze(remat)["flops"]
    assert fr >= fp > 0


def test_peak_counts_live_storages():
    """Inputs and every storage live at once; a view adds nothing; a freed
    temporary stops counting."""
    def f(x):
        y = x * 2             # 4 KiB beside x
        z = y + 1             # x, y and z live: the peak
        del y                 # freed: no longer counted
        return z[:8].sum()    # a view (nothing) and one 512-byte block
    r = analyze(f, _meta(1024))
    assert r["peak_bytes"] == 3 * 4096
    assert r["hbm_bytes"] == 2 * 4096 + 2 * 4096 + 8 * 4 + 4


# -- product flops against the JAX HLO analyzer ------------------------------

def _jax_flops(arch: str, kind: str, B: int = 2, S: int = 64) -> float:
    cfg = jax_config(arch).reduced()
    model = jax_model(cfg)
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    if kind == "train":
        opt_cfg = jax_opt.OptConfig(moment_dtype=cfg.moment_dtype)
        state = jax_specs.abstract_train_state(cfg, opt_cfg)
        c = jax.jit(jax_ts.make_train_step(cfg, opt_cfg)).lower(
            state, {"tokens": tok}).compile()
    elif kind == "prefill":
        def prefill(params, tokens):
            return model.prefill(params, cfg, tokens,
                                 model.init_cache(cfg, B, S))
        c = jax.jit(prefill).lower(jax_specs.abstract_params(cfg),
                                   tok).compile()
    else:
        c = jax.jit(lambda p, ca, t: model.decode_step(p, cfg, ca, t)).lower(
            jax_specs.abstract_params(cfg),
            jax_specs.abstract_cache(cfg, B, S),
            jax.ShapeDtypeStruct((B, 1), jnp.int32)).compile()
    return hlo_analyze(c.as_text())["flops"]


def _plain_flops(arch: str, kind: str, B: int = 2, S: int = 64) -> float:
    return dryrun.dryrun_cell(arch, "t", cfg=get_config(arch).reduced(),
                              shape=ShapeConfig("t", S, B, kind),
                              device="cpu")["flops_per_dev"]


@pytest.mark.parametrize("arch,kind", [
    ("qwen3-8b", "prefill"), ("qwen3-8b", "decode"), ("qwen3-8b", "train"),
    ("deepseek-moe-16b", "prefill")])
def test_plain_flops_equal_hlo_analyzer(arch, kind):
    """RWKV-6 is left out: the JAX prefill runs ``gla_chunked``, whose
    chunk products the port's recurrence does not have (ROADMAP queue
    3), so the two count different algorithms."""
    assert _plain_flops(arch, kind) == _jax_flops(arch, kind)


def test_moe_train_flops_differ_by_the_recomputed_combine():
    """The MoE train step counts one product per layer more than the JAX
    step: under remat ``torch.utils.checkpoint`` recomputes each layer's
    forward up to the last tensor its backward saved, which in
    ``layers.moe`` is past the routed combine einsum (the shared experts
    come after it), so the combine's (G, g, E·C) × (G, E·C, d) product
    runs again although no gradient reads its output; XLA drops that dead
    product from the rematerialized forward.  At ``reduced()`` (4 layers,
    G = 2 groups of g = 64 tokens, E·C = 8 × 64, d = 64) that is
    4 × 2·2·64·512·64 = 33,554,432 flops; without remat the two are
    equal."""
    extra = 4 * 2 * 2 * 64 * 512 * 64
    assert extra == 33_554_432
    assert (_plain_flops("deepseek-moe-16b", "train")
            - _jax_flops("deepseek-moe-16b", "train")) == extra


# -- the abstract inputs against repro.launch.specs -------------------------

def _jax_leaves(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)
        out[key] = (tuple(leaf.shape), str(leaf.dtype))
    return out


def _port_leaves(tree, prefix=()) -> dict:
    """Tensor leaves by path; host ints (a cache's ``pos``) left out."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_port_leaves(v, prefix + (k,)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_port_leaves(v, prefix + (i,)))
    elif isinstance(tree, torch.Tensor):
        assert tree.device.type == "meta"
        out[prefix] = (tuple(tree.shape),
                       str(tree.dtype).replace("torch.", ""))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_jax(arch):
    """Every leaf of the abstract train state, of the parameters drawn as
    masters and of the cache (2 × 64) at full size has its JAX
    counterpart's shape and dtype.  The serving parameters are the
    masters as ``layers.serving_view`` casts them (the port casts once at
    the draw what the JAX package casts at every call); the JAX cache's
    scalar ``pos`` (and ``enc_len``) are host ints in the port."""
    jc, pc = jax_config(arch), get_config(arch)
    with specs.abstract():
        with TL.masters():
            masters = specs.abstract_params(pc)
        got = [_port_leaves(masters),
               _port_leaves(specs.abstract_train_state(
                   pc, opt_lib.OptConfig(moment_dtype=pc.moment_dtype))),
               _port_leaves(specs.abstract_cache(pc, 2, 64))]
        assert (_port_leaves(specs.abstract_params(pc))
                == _port_leaves(TL.serving_view(masters)))
    want = [_jax_leaves(jax_specs.abstract_params(jc)),
            _jax_leaves(jax_specs.abstract_train_state(
                jc, jax_opt.OptConfig(moment_dtype=jc.moment_dtype))),
            {k: v for k, v in _jax_leaves(jax_specs.abstract_cache(
                jc, 2, 64)).items() if v[0] != ()}]
    for g, w in zip(got, want):
        assert g == w


def test_specs_refuse_a_mesh():
    with pytest.raises(NotImplementedError, match="item 15"):
        specs.abstract_params(get_config("qwen3-8b").reduced(),
                              mesh="16x16")
    with pytest.raises(NotImplementedError, match="item 15"):
        dryrun.main(["--mesh", "single", "--only-submod"])


def test_dry_card_resolves_to_meta():
    with dry_card():
        assert resolve_device("cuda") == torch.device("meta")
        assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device("cpu") == torch.device("cpu")


# -- the roofline -----------------------------------------------------------

SMALL_SUBMOD = SubmodConfig(k=8, capacity=1024, n_eval=128, d=64)


@pytest.fixture(scope="module")
def records():
    """A dry record of each kind: qwen3-8b at ``reduced()`` on the real
    shape names (their token counts), the submod cell at a small size."""
    cfg = get_config("qwen3-8b").reduced()
    out = [dryrun.dryrun_cell("qwen3-8b", s, cfg=cfg)
           for s in ("train_4k", "prefill_32k", "decode_32k")]
    out.append(dryrun.dryrun_submod("greedy", scfg=SMALL_SUBMOD))
    return out


@pytest.mark.parametrize("kind", ["train", "prefill", "decode", "submod"])
def test_roofline_matches_jax_under_tpu_v5e(records, kind):
    rec = next(r for r in records if r["kind"] == kind)
    jax_rec = {k: v for k, v in rec.items()
               if k not in ("flops_by_rate", "kernels")}
    want = jax_roofline.analyze_record(jax_rec)
    got = roofline.analyze_record(rec, TPU_V5E)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a == b or (isinstance(a, float) and math.isnan(a)
                          and math.isnan(b)), f.name


def test_roofline_h100_rates(records):
    """On the H100 each product counts at its rate and each kernel at
    cost.py's: the compute term is the sum, the kernels' part theirs."""
    rec = next(r for r in records if r["kind"] == "train")
    row = roofline.analyze_record(rec)
    aten = dict(rec["flops_by_rate"])
    kern = 0.0
    for k in rec["kernels"].values():
        for r, v in k["flops_by_rate"].items():
            aten[r] -= v
        kern += sum(v / cost.H100.rate(r)
                    for r, v in k["flops_by_rate"].items())
    want = kern + sum(v / cost.H100.rate(r) for r, v in aten.items())
    assert row.compute_s == pytest.approx(want, rel=1e-12)
    assert aten["bf16"] > 0 and rec["kernels"]
    assert row.fits is True and row.collective_s == 0.0
    assert 0.0 < row.kernel_frac < 1.0


def test_render_table(records):
    table = roofline.render_table(records)
    assert table.count("\n") == len(records) + 1
    assert "submod-tree[greedy]" in table


# -- the card's path ----------------------------------------------------------

def _train_record(arch: str, n_micro: int = 1) -> dict:
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              microbatches=n_micro)
    return dryrun.dryrun_cell(arch, "t", cfg=cfg,
                              shape=ShapeConfig("t", 64, 2 * n_micro,
                                                "train")), cfg


@pytest.mark.parametrize("n_micro", [1, 2])
def test_attention_train_step_launches(n_micro):
    """A forward launch with the log-sum-exp a layer and microbatch, twice
    under remat; one backward a layer and microbatch (reduced()'s D = 16:
    the CUDA-core route, with its Δ pre-pass)."""
    rec, cfg = _train_record("qwen3-8b", n_micro)
    calls = cfg.n_layers * n_micro
    got = {k: v["launches"] for k, v in rec["kernels"].items()}
    assert got == {"flash_attention_prefill": 2 * calls,
                   "flash_attention_prefill_lse": 2 * calls,
                   "flash_attention_bwd_delta": calls,
                   "flash_attention_bwd_dkdv": calls,
                   "flash_attention_bwd_dq": calls}
    fwd = cost.attention(2, cfg.n_heads, cfg.n_kv_heads, 64, 64, cfg.hd,
                         True, None, 2)
    bwd = cost.attention_backward(2, cfg.n_heads, cfg.n_kv_heads, 64, 64,
                                  cfg.hd, True, 2)
    k = rec["kernels"]
    assert k["flash_attention_prefill"]["flops"] == 2 * calls * fwd.flops
    assert k["flash_attention_bwd_dkdv"]["bytes"] == calls * bwd.nbytes


@pytest.mark.parametrize("n_micro", [1, 2])
def test_wkv6_train_step_launches(n_micro):
    """RWKV-6: the recurrent forward a layer and microbatch, twice under
    remat; the chunked backward (three launches and du's sum) once."""
    rec, cfg = _train_record("rwkv6-1.6b", n_micro)
    calls = cfg.n_layers * n_micro
    got = {k: v["launches"] for k, v in rec["kernels"].items()}
    assert got == {"wkv6_recurrent": 2 * calls, "wkv6_prefill": 2 * calls,
                   "wkv6_bwd_chunked": 3 * calls,
                   "wkv6_bwd_chunked_du": calls}
    H, D = cfg.n_heads, cfg.rwkv_head_dim
    want = cost.wkv6_backward(2, H, 64, D, D, 2, 2, False)
    assert rec["kernels"]["wkv6_bwd_chunked"]["flops"] == calls * want.flops


def test_submod_counts_k_greedy_launches():
    s = SMALL_SUBMOD
    rec = dryrun.dryrun_submod("greedy", scfg=s)
    assert {k: v["launches"] for k, v in rec["kernels"].items()} == {
        "greedy_select": s.k}
    work = cost.greedy_select(1, s.capacity, s.d, s.n_eval, s.k)
    k = rec["kernels"]["greedy_select"]
    assert (k["flops"], k["bytes"], k["overlap"]) == (
        work.flops, work.nbytes, True)
    bf16 = dryrun.dryrun_submod("greedy", "bfloat16", scfg=s)
    assert bf16["kernels"]["greedy_select_bf16dot"]["launches"] == s.k
    sg = dryrun.dryrun_submod("stochastic_greedy", scfg=s)
    assert sg["kernels"]["exemplar_gains"]["launches"] == s.k


def test_dry_run_never_builds_or_loads(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the dry run reached the build")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)
    _train_record("jamba-1.5-large-398b")
    dryrun.dryrun_submod("stochastic_greedy", scfg=SMALL_SUBMOD)
    cfg = get_config("qwen3-8b").reduced()
    dryrun.dryrun_cell("qwen3-8b", "decode_32k", cfg=cfg)
    dryrun.dryrun_cell("rwkv6-1.6b", "decode_32k",
                       cfg=get_config("rwkv6-1.6b").reduced())
    test_threshold_and_rbf_counted()


def test_threshold_and_rbf_counted():
    """The two kernels no dry-run cell reaches (THRESHOLD-BATCH reads a
    flag on the host each level; rbf_kernel serves the other objectives):
    one call each on meta operands, its launches and cost.py's work."""
    M, n, d, m, k = 3, 500, 17, 130, 10
    with analyze_ops() as a:
        acc, cm = ops.threshold_select(
            _meta(M, n, d), _meta(m, d), _meta(M, m),
            _meta(M, n, dtype=torch.bool), 0.5, k)
        K = ops.rbf_kernel(_meta(1, d), _meta(M, n, d), 0.5)
    assert acc.shape == (M, n) and cm.shape == (M, m)
    assert K.shape == (M, 1, n)
    r = a.result()["kernels"]
    assert {c: v["launches"] for c, v in r.items()} == dict.fromkeys((
        "threshold_select", "threshold_select_prepass",
        "threshold_select_tail", "rbf_kernel", "rbf_kernel_rowvec"), 1)
    mp = m + (-m) % eg.BM
    assert r["threshold_select"]["flops"] == cost.threshold_select(
        M, n, d, mp).flops
    assert r["rbf_kernel"]["bytes"] == cost.rbf_kernel(1, 1, M, n, d).nbytes


@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-1.6b"])
def test_dry_run_leaves_the_launch_counters(arch):
    """The dry branches bump the launch counters inside the analyzer, which
    reads them and puts them back: after a dry train step every counter
    holds what it held before, so the counters only count launches on the
    card."""
    ops.reset_launch_counts()
    ops.launch_counts["greedy_select"] = 3
    before = dict(ops.launch_counts)
    rec, _ = _train_record(arch)
    assert any(v["launches"] for v in rec["kernels"].values())
    assert ops.launch_counts == before
    ops.reset_launch_counts()


def test_refused_shapes_raise_the_launch_error():
    """A meta operand of a shape the kernel refuses fails the dry run with
    the launch's ``ValueError`` (the counterpart of a failed compile)."""
    q, k = _meta(1, 4, 8, 48), _meta(1, 4, 8, 48)
    with pytest.raises(ValueError, match="head dim 48 is not one of"):
        ops.flash_attention(q, k, k)
    r = _meta(1, 2, 8, 80)
    u = _meta(2, 80)
    with pytest.raises(ValueError, match="Dk <= 64"):
        ops.wkv6(r, r, r, r, u)
    X, E = _meta(1, 100, 6), _meta(100, 6)
    with pytest.raises(ValueError, match="unsupported shape"):
        eg.launch(X, E, _meta(1, 100))
    # the tile's cur_min stage grows with the padded eval set: 60,032
    # columns pass the H100's 227 KB a block
    with pytest.raises(ValueError, match="shared memory"):
        ops.exemplar_gains(_meta(1, 128, 6), _meta(60_000, 6),
                           _meta(60_000))


def test_real_tensors_never_take_the_dry_branch(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a CPU tensor took the dry branch")
    monkeypatch.setattr(cost, "report", refuse)
    ops.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    X, E = torch.randn(3, 50, 6, generator=g), torch.randn(20, 6, generator=g)
    mask = torch.ones(3, 50, dtype=torch.bool)
    ops.greedy_select(X, E, torch.sum(E * E, -1), mask, 4)
    q = torch.randn(1, 4, 8, 16, generator=g)
    ops.flash_attention(q, q, q)
    assert not any(ops.launch_counts.values())
    assert not _build.dry(q) and _build.dry(q.to("meta"))


def test_dry_facts_formulas():
    """The dry branches' formulas of what the built kernels report:
    the tile's shared memory (resident e~ at d ≤ 6, mp ≤ 1,024), the
    recurrent wkv6 backward's chunk."""
    assert eg.tile_smem(6, 512, False) == 512 * 64 + 8192 + 512 * 4
    assert eg.tile_smem(1024, 8192, True) == 4096 + 8192 + 2 * 8192 * 4
    assert [wk.bwd_chunk_steps(*t) for t in
            ((16, 4, 4), (64, 16, 4), (64, 16, 8))] == [32, 8, 4]


def test_dry_decode_counts_and_splits():
    """A decode call on meta operands: one launch under the decode
    counter, ``cost.attention``'s work, and the split scratch the decode
    launch cuts for one CTA an SM (32k keys: several splits)."""
    B, H, Hkv, T, D = 2, 32, 8, 32768, 128
    q = _meta(B, H, 1, D, dtype=torch.bfloat16)
    k = _meta(B, Hkv, T, D, dtype=torch.bfloat16)
    with analyze_ops((q, k)) as a:
        out = ops.flash_attention(q, k, k, causal=False)
    assert out.shape == q.shape
    r = a.result()
    kern = r["kernels"]["flash_attention_decode"]
    assert kern["launches"] == 1 and set(r["kernels"]) == {
        "flash_attention_decode"}
    assert kern["bytes"] == cost.attention(B, H, Hkv, 1, T, D, False, None,
                                           2).nbytes
    nsplit, _ = fa.decode_splits(B, Hkv, H // Hkv, T, cost.H100.sms, 1)
    assert nsplit > 1
    # k (also v here) and the two fp32 split buffers are live at once
    assert r["peak_bytes"] >= (k.numel() * 2 + nsplit * B * H * (D + 2) * 4)


@pytest.mark.parametrize("causal", [True, False])
def test_visible_pairs_closed_form(causal):
    for S, T in ((1, 1), (7, 7), (5, 12), (64, 64), (2048, 2080)):
        for kv in (None, T, T - 1, 3):
            n = T if kv is None else min(kv, T)
            loop = (S * n if not causal else
                    sum(min(n, r + 1 + T - S) for r in range(S)))
            assert cost.visible_pairs(S, T, causal, kv) == loop


def test_cli_writes_records(tmp_path):
    out = tmp_path / "dry.json"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen3-8b", "--shape", "decode_32k",
                     "--out", str(out)])
    assert e.value.code == 0
    data = json.loads(out.read_text())
    (rec,) = data["records"]
    assert rec["mesh"] == "1" and rec["n_devices"] == 1
    assert rec["kernels"]["flash_attention_decode"]["launches"] == 36
    assert rec["fits"] is False and data["failures"] == []


# -- kernels/cost.py against the bounds chip_smoke.py printed before it ------

_FP32, _TF32, _BF16, _HBM = 67e12, 495e12, 989e12, 3.35e12


def _old_bound(flops, nbytes):
    t_ops, t_bytes = flops / _FP32, nbytes / _HBM
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _old_tile(pairs, d, nbytes, epilogue):
    t_ops = max(pairs * 2 * d / _TF32, pairs * epilogue / _FP32)
    t_bytes = nbytes / _HBM
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes",
            _old_bound(pairs * (2 * d + epilogue), nbytes)[0])


def _old_tc(flops, nbytes, rate):
    t_ops, t_bytes = flops / rate, nbytes / _HBM
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes",
            _old_bound(flops, nbytes)[0])


def _old_greedy(M, n, d, m, calls, nbytes, epilogue):
    """The former greedy_select bound (the distances recomputed for every
    score), unless the distances computed once, written as an fp32 matrix
    that fits the card and read back for every score, bound it lower."""
    fresh = _old_tile(calls * m, d, nbytes, epilogue)
    pairs = M * n * m
    if 4 * pairs > cost.H100.memory_bytes:
        return fresh
    flops, once_bytes = pairs * 2 * d + calls * m * epilogue, (
        nbytes + 4 * pairs + 4 * calls * m)
    t_ops = max(pairs * 2 * d / _TF32, calls * m * epilogue / _FP32)
    t_bytes = once_bytes / _HBM
    once = (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes",
            _old_bound(flops, once_bytes)[0])
    return fresh if fresh[0] <= once[0] else once


def _bounds(work):
    return work.bound_ms() + (work.fp32_only_ms(),)


@pytest.mark.parametrize("d", [1, 6, 11, 12, 64, 1024])
def test_greedy_bound_recomputes_at_small_d(d):
    """At d ≤ 11 recomputing the distances for every score is the cheaper
    way at any k, so greedy_select keeps the tile's bound; past it the
    bound is never above the tile's, and at the paper's cell (d = 1,024)
    one fp32 distance matrix (2 GiB at 65,536 × 8,192), written once and
    read for every score, bounds it lower, by its bytes."""
    for M, n, m, k in ((1, 65536, 8192, 8), (8, 22500, 512, 50),
                       (64, 3000, 130, 256), (1, 300, 64, 1)):
        calls = cost.greedy_calls(M, n, k)
        io = (4 * M * n * d + 4 * m * d + 4 * m + M * n + 4 * M * k
              + 4 * M * m)
        fresh = cost.gain_tile(calls * m, d, io, 3)
        work = cost.greedy_select(M, n, d, m, k)
        if d <= 11:
            assert work == fresh
        else:
            assert work.bound_ms()[0] <= fresh.bound_ms()[0]
        if d == 1024 and n == 65536:
            assert work.nbytes == io + 4 * M * n * m + 4 * calls * m
            assert work.bound_ms()[0] < fresh.bound_ms()[0] / 2
            assert work.bound_ms()[1] == "bytes"


@pytest.mark.parametrize("seed", range(4))
def test_cost_reproduces_the_former_bounds(seed):
    """The formulas ``chip_smoke.py``'s times phase held inline before
    they moved to ``kernels/cost.py`` (``tile_bound``, ``bound_ms``,
    ``attention_bound``, ``wkv6_bound``, ``wkv6_bwd_bound`` and each call
    site's bytes): the same shape gives the same bound, to the last bit."""
    import random
    R = random.Random(seed)
    for _ in range(100):
        M = R.choice([1, 7, 8, 64, 2000])
        n = R.choice([300, 3000, 22500, 65536, 1 << 20])
        d, m = R.choice([6, 17, 64, 1024, 3072]), R.choice([64, 130, 512])
        k, calls = R.choice([8, 50, 256]), R.randrange(1, 10 ** 9)
        rb = R.choice([4 * d, 2 * d, d + 8])
        assert _bounds(cost.greedy_select(M, n, d, m, k, calls=calls)) == \
            _old_greedy(M, n, d, m, calls, 4 * M * n * d + 4 * m * d + 4 * m
                        + M * n + 4 * M * k + 4 * M * m, 3)
        assert _bounds(cost.greedy_select(
            M, n, d, m, k, calls=calls, constrained=True)) == _old_greedy(
            M, n, d, m, calls, 4 * M * n * d + 4 * m * d + 4 * m + M * n
            + 8 * M * n + 4 * M * k + 4 * M * m, 3)
        assert _bounds(cost.greedy_select(
            M, n, d, m, k, calls=calls, weighted=True)) == _old_greedy(
            M, n, d, m, calls, 4 * M * n * d + 4 * m * d + 8 * m + M * n
            + 4 * M * k + 4 * M * m, 4)
        assert _bounds(cost.greedy_select(
            M, n, d, m, k, calls=calls, row_bytes=rb)) == _old_greedy(
            M, n, d, m, calls, M * n * rb + 4 * m * d + 4 * m + M * n
            + 4 * M * k + 4 * M * m, 3)
        assert _bounds(cost.threshold_select(
            M, n, d, m, rows=calls, constrained=True)) == _old_tile(
            calls * m, d, M * n * (4 * d + 4 + 4 + 1 + 1) + 4 * m * d
            + 8 * M * m + 16 * M, 3)
        assert _bounds(cost.threshold_select(
            M, n, d, m, rows=calls, row_bytes=rb)) == _old_tile(
            calls * m, d, M * n * (rb + 2) + 4 * m * d + 8 * M * m + 16 * M,
            3)
        for w in (False, True):
            assert _bounds(cost.exemplar_gains(M, n, d, m, weighted=w)) == \
                _old_tile(M * n * m, d, 4 * (M * n * d + m * d + M * m
                                             + M * n), 4 if w else 3)
        assert _bounds(cost.exemplar_gains(M, n, d, m, row_bytes=rb)) == \
            _old_tile(M * n * m, d, M * n * rb + 4 * m * d + 4 * M * m
                      + 4 * M * n, 3)
        assert cost.rbf_kernel(M, 1, M, n, d).bound_ms() == _old_bound(
            M * n * (2 * d + 6), 4 * (M * d + M * n * d + M * n))
        assert cost.rbf_kernel(1, m, M, n, d).bound_ms() == _old_bound(
            M * m * n * (2 * d + 6), 4 * (m * d + M * n * d + M * m * n))
        B, H, Hkv = R.choice([1, 8, 32]), R.choice([32, 64]), R.choice([1, 8])
        S = R.choice([1, 7, 1500, 2048])
        T = S + R.choice([0, 32, 100])
        D, causal = R.choice([16, 64, 128, 256]), R.random() < 0.6
        kv = R.choice([None, T - 3, 1500])
        pairs = (S * min(kv or T, T) if not causal else
                 sum(min(T if kv is None else min(kv, T), r + 1 + T - S)
                     for r in range(S)))
        kvn = T if kv is None else min(kv, T)
        assert cost.attention(B, H, Hkv, S, T, D, causal, kv,
                              2).bound_ms() == _old_tc(
            4 * B * H * D * pairs,
            2 * D * (2 * B * H * S + 2 * B * Hkv * kvn), _BF16)[:2]
        full = (S * T if not causal else
                sum(min(T, r + 1 + T - S) for r in range(S)))
        assert cost.attention_backward(B, H, Hkv, S, T, D, causal,
                                       2).bound_ms() == _old_tc(
            5 * 2 * B * H * D * full,
            2 * D * (4 * B * H * S + 4 * B * Hkv * T) + 4 * B * H * S,
            _BF16)[:2]
        Dk, Dv = R.choice([16, 64]), R.choice([16, 64, 128])
        given = R.random() < .5
        steps = B * H * T
        assert _bounds(cost.wkv6(B, H, T, Dk, Dv, 2, given,
                                 4 if given else 2)) == _old_tc(
            steps * (5 * Dk * Dv + 3 * Dk + 2 * Dv),
            steps * ((2 * Dk + Dv) * 2 + 4 * Dk + Dv * (4 if given else 2))
            + H * Dk * 2 + 4 * B * H * Dk * Dv * (1 + int(given)), _TF32)
        assert _bounds(cost.wkv6_backward(B, H, T, Dk, Dv, 2, 2,
                                          given)) == _old_tc(
            steps * (14 * Dk * Dv + 12 * Dk + 4 * Dv),
            steps * (2 * (2 * Dk + Dv) * 2 + Dv * 2 + 8 * Dk) + 2 * H * Dk * 2
            + 4 * B * H * Dk * Dv * (3 if given else 0), _TF32)
