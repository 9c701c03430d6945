"""The port's examples (``repro_torch.examples``) on the CPU, each held
against the JAX package's example (``examples/*.py``, run in this process
with its output captured): the port's ``main(device="cpu", plan=...)``
given the JAX example's round plans (``_torch_parity.jax_tree_plan`` of
each JAX run's machine counts; RandGreedI's partition replayed from the
same key) gives every TREE run's selection, rounds, machines per round and
oracle calls as the JAX example's, and its values, the centralized columns
and the printed ratios within ``testing``'s tolerance.  Also the
examples' own claims: every TREE value at least 0.9 of its centralized
greedy (PERF.md §2), ``distributed_tree``'s streaming and pipelined runs
equal to its healthy run bit for bit, its constrained streaming run equal
to its resident one."""
import contextlib
import functools
import io
import math
import os
import re
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro_torch import testing
from repro_torch.core.plan import ArrayPlan
from repro_torch.examples import (active_set_selection, distributed_tree,
                                  quickstart)

from _torch_parity import jax_tree_plan

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@functools.lru_cache(maxsize=None)
def jax_example(name: str):
    """The JAX example's module globals and printed lines.  Its own
    ``XLA_FLAGS`` default (8 host devices) takes effect only before JAX
    starts, so it is kept out of this process's environment."""
    mp = pytest.MonkeyPatch()
    mp.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    mp.setattr(sys, "path", list(sys.path))
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            g = runpy.run_path(str(EXAMPLES / f"{name}.py"),
                               run_name="jax_example")
    finally:
        mp.undo()
    return g, buf.getvalue().splitlines()


def _plan(jres, mu):
    return jax_tree_plan(0, mu, jres.machines_per_round)


def _same_run(t, j, what):
    """A port TREE run against the JAX example's, field by field."""
    np.testing.assert_array_equal(t.sel_rows, np.asarray(j.sel_rows),
                                  err_msg=what)
    np.testing.assert_array_equal(t.sel_mask, np.asarray(j.sel_mask),
                                  err_msg=what)
    assert t.rounds == j.rounds, what
    assert list(t.machines_per_round) == list(j.machines_per_round), what
    assert t.oracle_calls == int(j.oracle_calls), what
    testing.assert_close(t.value, float(j.value), what)


def _printed_ratio(lines, start: str) -> float:
    """The TREE / centralized percentage printed on the line ``start``."""
    line, = [l for l in lines if l.startswith(start)]
    return float(re.search(r"(\d+\.\d+)%", line).group(1)) / 100


def _same_lines(lines, jlines, n=None):
    """The printed lines: the same text around the numbers, each number
    within 0.01 (two decimals of a percentage or of a value)."""
    n = n or len(jlines)
    assert len(lines) >= n and len(jlines) >= n
    for a, b in zip(lines[:n], jlines[:n]):
        num = r"-?\d+\.\d+|\d+"
        assert re.sub(num, "#", a) == re.sub(num, "#", b), (a, b)
        np.testing.assert_allclose([float(v) for v in re.findall(num, a)],
                                   [float(v) for v in re.findall(num, b)],
                                   rtol=0, atol=0.011, err_msg=a)


def test_quickstart(capsys):
    g, jlines = jax_example("quickstart")
    out = quickstart.main(device="cpu", plan=_plan(g["tree"], 2 * g["k"]))
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("centralized greedy : ")
    _same_run(out["tree"], g["tree"], "quickstart TREE")
    testing.assert_close(out["centralized"], float(g["cent"].value),
                         "centralized greedy")
    _same_lines(lines, jlines, 2)     # the random subset draws apart
    assert out["tree"].value / out["centralized"] >= 0.9
    assert _printed_ratio(lines, "TREE (capacity 2k)") >= 0.9
    assert out["random"] < out["centralized"]


def test_distributed_tree(capsys):
    g, jlines = jax_example("distributed_tree")
    mu = 200
    jruns = {"healthy": g["healthy"], "failed": g["failed"],
             "stream": g["stream"], "piped": g["piped"],
             "constrained": g["c_res"], "constrained_stream": g["c_stream"]}
    plans = {name: _plan(j, mu) for name, j in jruns.items()}
    # the resumed run picks up the failed run's rounds where it left off
    plans["resumed"] = jax_tree_plan(
        0, mu, list(g["failed"].machines_per_round)
        + list(g["resumed"].machines_per_round))
    m = len(g["data"]) // mu
    rg_plan = ArrayPlan([np.asarray(jax.random.permutation(
        jax.random.PRNGKey(0), m * math.ceil(len(g["data"]) / m)))])
    out = distributed_tree.main(device="cpu", plan=plans.__getitem__,
                                randgreedi_plan=rg_plan)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "devices: 1"
    assert lines[1].endswith("rounds on 1 devices")
    jruns["resumed"] = g["resumed"]
    for name, key in (("healthy", "healthy"), ("failed", "failed"),
                      ("resumed", "resumed"), ("stream", "stream"),
                      ("piped", "piped"),
                      ("constrained", "constrained_resident"),
                      ("constrained_stream", "constrained")):
        _same_run(out[key], jruns[name], f"distributed_tree {name}")
    testing.assert_close(out["centralized"], float(g["cent"]),
                         "centralized greedy")
    testing.assert_close(out["randgreedi"], float(g["rg"].value),
                         "randgreedi")
    # the device line and the timings of the pipelined line differ
    idx = [i for i, l in enumerate(jlines)
           if not l.startswith(("devices:", "pipelined engine"))]
    _same_lines([lines[i] for i in idx], [jlines[i] for i in idx])
    healthy = out["healthy"]
    for name in ("stream", "piped"):
        res = out[name]
        np.testing.assert_array_equal(res.sel_rows, healthy.sel_rows)
        assert res.value == healthy.value
        assert res.oracle_calls == healthy.oracle_calls
    assert out["constrained"].value == out["constrained_resident"].value
    assert out["stream"].ingest.waves == 5
    assert out["piped"].engine_stats.hosts == 2
    assert healthy.value / out["centralized"] >= 0.9
    assert _printed_ratio(lines, "healthy run") >= 0.9
    assert out["failed"].value / out["centralized"] >= 0.9
    assert out["resumed"].value == out["failed"].value


def test_active_set_selection(capsys):
    g, jlines = jax_example("active_set_selection")
    out = active_set_selection.main(device="cpu",
                                    plan=_plan(g["tree"], 100))
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("info gain: TREE=")
    _same_run(out["tree"], g["tree"], "active_set_selection TREE")
    np.testing.assert_allclose(out["centralized"], float(g["cent"].value),
                               rtol=1e-4)
    np.testing.assert_allclose(out["knapsack_value"], float(g["res"].value),
                               rtol=1e-4)
    _same_lines(lines, jlines)
    assert out["tree"].value / out["centralized"] >= 0.9
    assert _printed_ratio(lines, "info gain: TREE=") >= 0.9
    assert 0 < out["knapsack_size"] <= 25 and out["knapsack_cost"] <= 10.0


@pytest.mark.parametrize("example", [quickstart, distributed_tree,
                                     active_set_selection])
def test_examples_default_to_the_card(example):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main()
