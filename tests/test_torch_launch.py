"""The port's CLI (``repro_torch.launch.submod``) against the JAX CLI
(``repro.launch.submod``) on the CPU.

Both CLIs run on one small dataset registered in both ``REGISTRY`` dicts
for the test (``monkeypatch.setitem``), the JAX one through its ``main()``
with ``sys.argv`` patched and its stdout captured, the port's through
``run(parse_args(argv), plan=, randgreedi_plan=)`` fed the JAX package's
draws: the tree's slot permutations replayed from its threefry chain
(``_torch_parity.jax_tree_plan``), RandGreedI's from ``PRNGKey(seed)``,
and the service's per request (``_torch_parity.jax_serve_plan``).

Every report line is held field by field: the same line prefixes in the
same order, the same words around the fields, every count equal (rounds,
machines/round, oracle calls, waves, rows, bytes, depths, retries and the
other fault counters, serve requests and delta counts), and each value
(``f=``, ``fp32=``, the recheck's ``solve=``, a knapsack's ``used=``)
within ``testing``'s tolerance.  Wall times, latencies, overlap, buffer
high-water marks, dispatcher batches and queue depth, and the compile
cache's counters (CUDA-graph captures in the port, jit compiles in JAX)
are each package's own and are not compared.  The fault case runs with
``--no-hedge``: a hedge fires on the host clock, so the hedge count of a
run is not a function of its inputs in either package.
"""
import argparse
import math
import re
import sys

import jax
import numpy as np
import pytest

from repro.core import constraint_from_spec as jax_spec
from repro.data import datasets as jdatasets
from repro.launch import submod as jsubmod
from repro_torch import testing
from repro_torch.convert import ArrayPlan
from repro_torch.core import constraint_from_spec
from repro_torch.data import datasets as tdatasets
from repro_torch.launch import submod

from _torch_parity import jax_serve_plan, jax_tree_plan

DATASET = "cli-parity"
SEED, K, MU = 0, 6, 60
BASE = ["--dataset", DATASET, "--k", str(K), "--capacity", str(MU),
        "--n-eval", "64", "--seed", str(SEED)]

CASES = {
    "resident": [],
    "chunked-pipelined-2-hosts": [
        "--source", "chunked", "--chunk-rows", "256", "--engine",
        "pipelined", "--hosts", "2", "--capacity-bytes", "20000"],
    "int8": ["--dtype", "int8", "--wave-machines", "5"],
    "intersection": [
        "--constraint",
        "intersection:knapsack:budget=2.5+partition:caps=2,2,2:col=1"],
    "threshold-batch": ["--algorithm", "threshold-batch"],
    "transient-faults": ["--fault-profile", "transient=0.3,seed=7",
                         "--no-hedge", "--wave-machines", "5"],
    "serve-smoke": ["--serve-smoke"],
}

FIELD = re.compile(r"([A-Za-z_/][A-Za-z0-9_/]*)=(\[[^\]]*\]|[^\s()]+)")
PERCENT = re.compile(r"\d+\.\d+%")
#: (prefix or None for any, key) of the fields that are each package's own
OWN = {(None, "wall"), (None, "gather"), (None, "overlap"),
       (None, "max_in_flight"), (None, "recovered"), (None, "backoff"),
       (None, "write"), (None, "stalled"), (None, "hidden"),
       (None, "rel_gap"), ("engine", "solve"), ("header", "devices"),
       ("serve", "batches"), ("serve", "p50_ms"), ("serve", "p95_ms"),
       ("serve", "qdepth_max"), ("serve", "keys"), ("serve", "compiles"),
       ("serve", "hits"), ("serve", "steady_retraces")}
VALUES = {(None, "f"), (None, "fp32"), (None, "used"), ("recheck", "solve")}


def _data():
    return tdatasets.csn(n=1_200, d=6)


def prefix(line: str) -> str:
    head = line.split(" ", 1)[0]
    if "=" in head:
        return "header"
    return line.split(":", 1)[0]


def _match(table, pre, key) -> bool:
    return (pre, key) in table or (None, key) in table


def assert_lines_agree(mine: list[str], theirs: list[str]) -> None:
    assert [prefix(l) for l in mine] == [prefix(l) for l in theirs], (
        mine, theirs)
    for a, b in zip(mine, theirs):
        pre = prefix(a)

        def skeleton(line):
            return PERCENT.sub("?%", FIELD.sub(lambda m: m.group(1) + "=?",
                                                line))

        assert skeleton(a) == skeleton(b), (a, b)
        for (key, va), (_, vb) in zip(FIELD.findall(a), FIELD.findall(b)):
            if _match(OWN, pre, key):
                continue
            if _match(VALUES, pre, key):
                testing.assert_close(float(va), float(vb), f"{pre} {key}")
            else:
                assert va == vb, (pre, key, a, b)


def _jax_lines(argv, capsys) -> list[str]:
    capsys.readouterr()
    saved = sys.argv
    sys.argv = ["submod", *argv]
    try:
        jsubmod.main()
    finally:
        sys.argv = saved
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("case", list(CASES))
def test_report_lines_match_the_jax_cli(case, monkeypatch, capsys):
    monkeypatch.setitem(jdatasets.REGISTRY, DATASET, _data)
    monkeypatch.setitem(tdatasets.REGISTRY, DATASET, _data)
    argv = BASE + CASES[case]
    theirs = _jax_lines(argv, capsys)
    n = len(_data())
    if case == "serve-smoke":
        plan = (lambda s, ladder: jax_serve_plan(SEED, s, ladder, MU))
        rg_plan = None
    else:
        tree = next(l for l in theirs if l.startswith("TREE:"))
        mpr = [int(v) for v in re.search(r"machines/round=\[([^\]]*)\]",
                                         tree).group(1).split(",")]
        plan = jax_tree_plan(SEED, MU, mpr)
        m = math.ceil(n / MU)
        rg_plan = ArrayPlan([np.asarray(jax.random.permutation(
            jax.random.PRNGKey(SEED), m * math.ceil(n / m)))])
    out = submod.run(submod.parse_args(argv + ["--device", "cpu"]),
                     plan=plan, randgreedi_plan=rg_plan)
    assert out.lines[0].split(" ", 1)[0] == (
        "serve-smoke:" if case == "serve-smoke" else f"n={n}")
    assert_lines_agree(out.lines, theirs)
    assert out.manifest.validate() == []


@pytest.mark.parametrize("spec", [
    "knapsack:budget=2.5",
    "partition:caps=4,4,4:col=1",
    "intersection:knapsack:budget=22.5+partition:caps=13,13,13,13:col=1",
])
def test_synth_attrs_match_jax(spec):
    mine = submod.synth_attrs(constraint_from_spec(spec), 5_000, 11)
    theirs = jsubmod.synth_attrs(jax_spec(spec), 5_000, 11)
    assert mine.dtype == np.float32
    np.testing.assert_array_equal(mine, theirs)
    assert submod.synth_attrs(None, 10, 0) is None


class _Parsed(Exception):
    pass


def test_flags_match_the_jax_cli(monkeypatch):
    """Every flag of the JAX CLI with the same name, default, choices and
    type; the port adds ``--device cuda|cpu`` (default the card)."""
    seen = []

    def grab(self, args=None, namespace=None):
        seen.append(self)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    monkeypatch.setattr(sys, "argv", ["submod"])
    with pytest.raises(_Parsed):
        jsubmod.main()
    with pytest.raises(_Parsed):
        submod.parse_args([])

    def flags(p):
        return {a.dest: (tuple(a.option_strings), a.default,
                         None if a.choices is None else tuple(a.choices),
                         a.type, a.nargs, a.const)
                for a in p._actions if a.dest != "help"}

    theirs, mine = flags(seen[0]), flags(seen[1])
    assert mine.pop("device") == (("--device",), "cuda", ("cuda", "cpu"),
                                  None, None, None)
    assert mine == theirs


def test_native_run_defaults_to_the_card(monkeypatch):
    """Without ``--device`` the CLI runs on the card: with none here it
    raises, never falling back to the CPU; ``--device cpu`` runs the plain
    versions with the port's own draws."""
    monkeypatch.setitem(tdatasets.REGISTRY, DATASET, _data)
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            submod.main(BASE)
    out = submod.main(BASE + ["--device", "cpu", "--algorithm",
                              "stochastic_greedy", "--no-centralized"])
    assert [prefix(l) for l in out.lines] == ["header", "TREE",
                                              "adaptivity"]
    assert out.manifest.run["algorithm"] == "stochastic_greedy"
