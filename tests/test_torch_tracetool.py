"""The port's trace tool (``repro_torch.launch.tracetool``) against the JAX
package's (``repro.launch.tracetool``) on the CPU.

Both tools read the same Chrome and JSONL files, written by each
package's ``Tracer``: the same census, top spans, ``overlap(spans)``,
``manifest:`` and ``cross-check:`` lines and the same exit codes on a
valid manifest (0), an invalid one (1) and an overlap that does not match
(2).  The port's engine also traces a ``stage`` span (H2D) per wave,
which its ``EngineStats`` counts on the device side of the overlap: the
port's tool reads it so, and cross-checks a traced run of the port's CLI
(its flag set of ``chip_smoke.py``'s CLI phase, at a small size); the JAX
tool, which knows no stage span, leaves it out there.
"""
import json

import pytest

from repro.engine import telemetry as jtel
from repro.launch import tracetool as jtool
from repro_torch.data import datasets as tdatasets
from repro_torch.engine import telemetry as ttel
from repro_torch.launch import submod
from repro_torch.launch import tracetool as ttool

PACKAGES = {"jax": jtel, "port": ttel}
# three waves: each gather on the prefetch lane, each solve on the main
# thread, the next gather under the current solve
WAVES = [(0.0, 0.8, 0.8, 1.9), (0.9, 1.7, 1.9, 2.6), (1.95, 2.5, 2.6, 3.4)]


def _trace(mod, tmp_path, fmt: str) -> str:
    tr = mod.Tracer()
    e = tr.epoch
    for w, (g0, g1, s0, s1) in enumerate(WAVES):
        tr.emit("gather", "wave", e + g0, e + g1, track="wave-prefetch",
                wave=w)
        tr.emit("host-gather", "host", e + g0, e + g1 - 0.1,
                track=f"host-{w % 2}")
        tr.emit("solve", "wave", e + s0, e + s1, wave=w)
    tr.emit("run", "run", e, e + 3.5)
    tr.instant("hedge", "fault", wave=1)
    path = str(tmp_path / f"{mod.__name__}.{fmt}")
    (tr.export_chrome_trace if fmt == "json" else tr.export_jsonl)(path)
    return path


def _manifest(tmp_path, name: str, overlap: float | None,
              valid: bool = True) -> str:
    m = ttel.RunManifest(config={"k": 6}, config_fingerprint="f" * 16,
                         run={"value": 1.25, "rounds": 3,
                              "oracle_calls": 7},
                         dtype="fp32")
    m.phases = {"total_wall_s": 3.5}
    if overlap is not None:
        m.engine = {"engine": "pipelined", "wall_s": 3.4, "gather_s": 2.05,
                    "solve_s": 2.6, "overlap_ratio": overlap,
                    "width_trajectory": [1, 1, 1]}
    path = str(tmp_path / name)
    m.write(path)
    if not valid:
        doc = json.load(open(path))
        del doc["run"]["rounds"]
        doc["config"] = {}
        json.dump(doc, open(path, "w"))
    return path


def _both(argv, capsys):
    out = {}
    for name, tool in (("jax", jtool), ("port", ttool)):
        capsys.readouterr()
        rc = tool.main(argv)
        out[name] = (rc, capsys.readouterr().out.splitlines())
    return out


@pytest.mark.parametrize("fmt", ["json", "jsonl"])
@pytest.mark.parametrize("writer", list(PACKAGES))
def test_both_tools_read_both_packages_traces(writer, fmt, tmp_path,
                                              capsys):
    path = _trace(PACKAGES[writer], tmp_path, fmt)
    events, tracks = ttool.load_trace(path)
    jevents, jtracks = jtool.load_trace(path)
    assert tracks == jtracks
    assert [(e.name, e.cat, e.t0, e.t1, e.phase) for e in events] == [
        (e.name, e.cat, e.t0, e.t1, e.phase) for e in jevents]
    wall, ov, n = ttool.span_overlap(events)
    assert (wall, ov, n) == jtool.span_overlap(jevents)
    assert n == 3 and ov > 0.0
    out = _both([path, "--limit", "4"], capsys)
    assert out["port"] == out["jax"] and out["port"][0] == 0
    assert any(l.startswith("overlap(spans): waves=3")
               for l in out["port"][1])
    # a valid manifest whose overlap matches, one that does not, an
    # invalid one: the same lines and exit codes from both tools
    for name, overlap, valid, rc in (("ok.json", ov, True, 0),
                                     ("off.json", ov + 0.01, True, 2),
                                     ("bad.json", ov, False, 1)):
        m = _manifest(tmp_path, name, overlap, valid)
        out = _both([path, "--manifest", m], capsys)
        assert out["port"] == out["jax"], name
        assert out["port"][0] == rc, (name, out["port"])
    text = "\n".join(out["port"][1])
    assert "manifest: INVALID" in text


def test_empty_trace_fails_in_both(tmp_path, capsys):
    for name, mod in PACKAGES.items():
        path = str(tmp_path / f"{name}.json")
        mod.Tracer().export_chrome_trace(path)
        out = _both([path], capsys)
        assert out["port"] == out["jax"]
        assert out["port"][0] == 1
        assert "trace: EMPTY — no events" in out["port"][1]


def test_port_cli_trace_cross_checks(tmp_path, monkeypatch, capsys):
    """A traced pipelined run of the port's CLI over two ingestion hosts
    (stage spans included): the port's tool recomputes its engine's
    overlap from the spans, the manifest validates, the cross-check
    passes; the trace's stage spans are what the JAX tool leaves out."""
    monkeypatch.setitem(tdatasets.REGISTRY, "tool-run",
                        lambda: tdatasets.csn(n=1_200, d=6))
    trace, jsonl = str(tmp_path / "t.json"), str(tmp_path / "m.json")
    manifest = str(tmp_path / "run_manifest.json")
    submod.main(["--dataset", "tool-run", "--k", "6", "--capacity", "60",
                 "--n-eval", "64", "--device", "cpu", "--source", "chunked",
                 "--chunk-rows", "256", "--engine", "pipelined", "--hosts",
                 "2", "--capacity-bytes", "20000", "--wave-autotune",
                 "--no-centralized", "--trace-out", trace,
                 "--metrics-out", jsonl, "--manifest-out", manifest])
    capsys.readouterr()
    assert ttool.main([trace, "--manifest", manifest]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-2].startswith("manifest: OK")
    assert lines[-1].startswith("cross-check: overlap") and lines[-1].endswith(
        "PASS (tol=1e-06)")
    events, _ = ttool.load_trace(trace)
    stages = [e for e in events if e.cat == "wave" and e.name == "stage"]
    solves = [e for e in events if e.cat == "wave" and e.name == "solve"]
    assert len(stages) == len(solves) > 0
    assert json.load(open(jsonl))    # the metrics snapshot parses
