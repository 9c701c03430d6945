"""One-card dry run: count every (arch × shape) cell without running it
(the port's counterpart of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--out reports/dryrun.json] [--skip-submod]
        [--only-submod] [--set k=v] [--device cpu]

For each cell this runs the port's own train, prefill or decode step once
on abstract inputs (``launch/specs.py``) under the op analyzer
(``launch/op_analyzer.py``) and records its flops, bytes and peak memory
on one card: the inputs to the roofline (``launch/roofline.py``).  On the
card's path (the default) every hand-written kernel is counted as its
launches and ``kernels/cost.py``'s work, no card needed; ``--device cpu``
counts the plain PyTorch path instead.  Also the paper's own workload:
one machine's slab of a distributed TREE round (``configs/paper_submod``,
μ = 65,536 rows of d = 1,024, 8,192 eval rows, k = 256) as the
``submod-tree`` cells, greedy, greedy with the bf16 x·e contraction and
stochastic greedy.

The records have the JAX package's schema (``mesh`` reads ``"1"``;
``lower_s`` and ``compile_s`` become ``trace_s``) plus ``kernels``,
``flops_by_rate``, ``fits`` (``peak_bytes`` within one H100 80GB HBM3)
and ``device``.  The production meshes are ROADMAP item 15: ``--mesh``
raises.  Exit code 1 if any cell failed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPES, cells_for
from repro_torch.device import resolve_device
from repro_torch.kernels.cost import H100
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.op_analyzer import analyze
from repro_torch.models import get_model
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_step as ts_lib


def _step_fn(cfg, shape, opt_cfg, device: str):
    model = get_model(cfg)
    if shape.kind == "train":
        return ts_lib.make_train_step(cfg, opt_cfg)
    if shape.kind == "prefill":
        def prefill_step(params, tokens, embeds=None):
            B = tokens.shape[0]
            extra = cfg.frontend_tokens if cfg.family == "vlm" else 0
            cache = model.init_cache(cfg, B, shape.seq_len + extra,
                                     device=resolve_device(device))
            with torch.no_grad():
                return model.prefill(params, cfg, tokens, cache,
                                     embeds=embeds)
        return prefill_step

    def decode(params, cache, tokens):
        with torch.no_grad():
            return model.decode_step(params, cfg, cache, tokens)
    return decode


def _record(counts: dict, **fields) -> dict:
    return {**fields, "n_devices": 1,
            "peak_bytes": counts["peak_bytes"],
            "flops_per_dev": counts["flops"],
            "bytes_per_dev": counts["hbm_bytes"],
            "collective_bytes_per_dev": counts["collectives"],
            "unknown_trip_loops": counts["unknown_trip_loops"],
            "flops_by_rate": counts["flops_by_rate"],
            "kernels": counts["kernels"],
            "fits": counts["peak_bytes"] <= H100.memory_bytes}


def dryrun_cell(arch: str, shape_name: str, overrides: dict | None = None,
                device: str = "cuda", mesh=None, cfg=None,
                shape=None) -> dict:
    """The record of one (arch × shape) cell on one card (``cfg``: a
    config to count in place of ``arch``'s, e.g. a ``reduced()`` one;
    ``shape``: a ``ShapeConfig`` in place of ``SHAPES[shape_name]``)."""
    cfg = cfg or get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = shape or SHAPES[shape_name]
    opt_cfg = opt_lib.OptConfig(moment_dtype=cfg.moment_dtype)
    t0 = time.time()
    with specs_lib.abstract(device):
        sp = specs_lib.input_specs(cfg, shape, mesh, opt_cfg=opt_cfg,
                                   device=device)
        fn = _step_fn(cfg, shape, opt_cfg, device)
        if shape.kind == "train":
            args = (sp["state"], sp["batch"])
        elif shape.kind == "prefill":
            args = (sp["params"], sp["tokens"]) + (
                (sp["embeds"],) if cfg.frontend else ())
        else:
            args = (sp["params"], sp["cache"], sp["tokens"])
        counts = analyze(fn, *args)
    return _record(counts, arch=arch, shape=shape_name, mesh="1",
                   kind=shape.kind, trace_s=round(time.time() - t0, 2),
                   params=cfg.param_count(),
                   active_params=cfg.active_param_count(), device=device)


def dryrun_submod(alg: str = "greedy", score_dtype=None,
                  device: str = "cuda", scfg=None, mesh=None) -> dict:
    """The paper's own cell on one card: ``distributed.run_round`` over one
    machine of ``capacity`` × d rows (every row valid), ``n_eval`` eval
    rows, k selections (``scfg``: a ``SubmodConfig``, the paper's by
    default)."""
    from repro_torch.configs.paper_submod import CONFIG
    from repro_torch.core import distributed as dist
    from repro_torch.core.objectives import ExemplarClustering
    specs_lib._no_mesh(mesh)
    scfg = scfg or CONFIG
    M, cap, d = 1, scfg.capacity, scfg.d
    t0 = time.time()
    with specs_lib.abstract(device):
        dev = resolve_device(device)
        blocks = torch.empty((M, cap, d), dtype=torch.float32, device=dev)
        bmask = torch.ones((M, cap), dtype=torch.bool, device=dev)
        E = torch.empty((scfg.n_eval, d), dtype=torch.float32, device=dev)
        obj = ExemplarClustering(E, score_dtype=score_dtype)
        draws = None
        if alg == "stochastic_greedy":
            def draws(j):
                return torch.rand((M, cap), device=dev)
        counts = analyze(lambda: dist.run_round(
            obj, blocks, bmask, k=scfg.k, alg=alg, eps=0.5, draws=draws),
            inputs=(blocks, bmask, E))
    variant = alg + ("_bf16" if score_dtype else "")
    return _record(counts, arch=f"submod-tree[{variant}]",
                   shape=f"mu{cap}_k{scfg.k}_d{d}", mesh="1", kind="submod",
                   trace_s=round(time.time() - t0, 2), params=0,
                   active_params=0, device=device)


SUBMOD_VARIANTS = [("greedy", None), ("greedy", "bfloat16"),
                   ("stochastic_greedy", None)]


def _overrides(pairs: list[str]) -> dict:
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            v = {"true": True, "false": False}.get(v.lower(), v)
        out[k] = v
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default=None, help="the production meshes: ROADMAP "
                    "item 15 (raises)")
    ap.add_argument("--out", default="reports/dryrun.json")
    ap.add_argument("--skip-submod", action="store_true")
    ap.add_argument("--only-submod", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (perf experiments)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda: the card's path, each kernel counted by its "
                    "own work (no card needed); cpu: the plain path")
    args = ap.parse_args(argv)
    if args.mesh is not None:
        specs_lib._no_mesh(args.mesh)
    overrides = _overrides(getattr(args, "set"))

    archs = [] if args.only_submod else (
        [args.arch] if args.arch else ARCH_IDS)
    records, failures = [], []
    t0 = time.time()
    for arch in archs:
        cfg = get_config(arch)
        shapes = [args.shape] if args.shape else cells_for(cfg)
        for shape_name in shapes:
            tag = f"{arch} × {shape_name} × 1"
            try:
                rec = dryrun_cell(arch, shape_name, overrides=overrides,
                                  device=args.device)
                records.append(rec)
                print(f"PASS {tag}: peak={rec['peak_bytes'] / 2**30:.2f}GiB "
                      f"flops={rec['flops_per_dev']:.3e} "
                      f"bytes={rec['bytes_per_dev']:.3e} fits={rec['fits']} "
                      f"(trace {rec['trace_s']}s)", flush=True)
            except Exception as e:
                failures.append({"cell": tag, "error": f"{type(e).__name__}: "
                                                      f"{e}"})
                print(f"FAIL {tag}: {e}", flush=True)
                traceback.print_exc()

    if not args.skip_submod and not args.arch:
        for alg, sd in SUBMOD_VARIANTS:
            try:
                rec = dryrun_submod(alg, sd, device=args.device)
                records.append(rec)
                print(f"PASS {rec['arch']} × 1: "
                      f"peak={rec['peak_bytes'] / 2**30:.2f}GiB "
                      f"flops={rec['flops_per_dev']:.3e} "
                      f"bytes={rec['bytes_per_dev']:.3e}", flush=True)
            except Exception as e:
                failures.append({"cell": f"submod-tree[{alg}"
                                 f"{'_bf16' if sd else ''}] × 1",
                                 "error": f"{type(e).__name__}: {e}"})
                print(f"FAIL submod-tree[{alg}]: {e}", flush=True)
                traceback.print_exc()

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"records": records, "failures": failures,
                   "seconds": round(time.time() - t0, 2)}, f, indent=1)
    print(f"\n{len(records)} cells passed, {len(failures)} failed "
          f"-> {args.out} ({time.time() - t0:.1f} s)")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
