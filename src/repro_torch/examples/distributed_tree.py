"""TREE with failure injection, restart, streaming and the round-0 engine
(counterpart of ``examples/distributed_tree.py``).

    PYTHONPATH=src python -m repro_torch.examples.distributed_tree

The JAX example shards machines over an 8-device mesh; this one runs every
machine of a round on one device (the card unless ``--device cpu``), so
its device lines read "1".  We kill 3 machines in round 0 mid-run and show
the algorithm completes with negligible quality loss (Lemma 3.4 graceful
degradation), then restart from a round checkpoint.  Then the same run
repeats with streaming round-0 ingestion — the ground set reachable only as
a chunked host stream, machine blocks dispatched in waves of 8 — and
reproduces the healthy run bit-for-bit; then once more through the
asynchronous execution engine (``engine="pipelined"``, ``hosts=2``):
prefetched double-buffered waves, the gather sharded across two emulated
ingestion hosts, still bit-identical.

## Hereditary constraints

The last section runs the same streaming pipeline under hereditary
constraints (paper Thm 3.5: Algorithm 1 keeps an α/r guarantee for *any*
hereditary family).  Usage pattern:

    from repro_torch.core import Knapsack, PartitionMatroid, Intersection

    # per-item attributes: column 0 = knapsack weight, column 1 = group id
    attrs = np.stack([weights, group_ids], axis=1).astype(np.float32)

    res = tree_maximize(
        obj, ChunkedSource.from_array(data, 1024, attrs=attrs), cfg,
        wave_machines=8,
        constraint=Intersection((Knapsack(budget=5.0, col=0),
                                 PartitionMatroid(caps=(4, 4, 4), col=1))))
    # res.sel_attrs carries the selection's attribute rows; the driver has
    # already verified feasibility with the independent NumPy checker
    # (repro_torch.core.check_feasible), and streaming output is
    # bit-identical to the all-resident run under the same seed and
    # constraint.

Attributes travel *with* their rows through every layer (waves, folds,
between-round repartitions, checkpoints), so constrained runs stream,
checkpoint, and survive machine failures exactly like unconstrained ones.
"""
import tempfile

import numpy as np

from repro_torch.core import (ChunkedSource, ExemplarClustering,
                              Intersection, Knapsack, PartitionMatroid,
                              TorchPlan, TreeConfig, centralized_greedy,
                              check_feasible, randgreedi, tree_maximize)
from repro_torch.data import datasets
from repro_torch.device import as_tensor, resolve_device
from repro_torch.examples import device_arg


def main(device="cuda", *, plan=None, randgreedi_plan=None) -> dict:
    """``plan``: a function of a run's name (``healthy``, ``failed``,
    ``resumed``, ``stream``, ``piped``, ``constrained``,
    ``constrained_stream``) giving its round plan, and
    ``randgreedi_plan`` the baseline's (default: each run draws
    ``TorchPlan(0)``, as ``tree_maximize`` does; the tests give the JAX
    example's draws)."""
    dev = resolve_device(device)
    if plan is None:
        def plan(name):
            return None
    print("devices: 1")
    data = datasets.csn(n=8_000, d=17)
    k = 20
    obj = ExemplarClustering(as_tensor(data[:512], dev))
    dj = as_tensor(data, dev)

    cent = float(centralized_greedy(obj, dj, k, device=dev).value)

    with tempfile.TemporaryDirectory() as ckpt:
        cfg = TreeConfig(k=k, capacity=200, seed=0, checkpoint_dir=ckpt)
        healthy = tree_maximize(obj, dj, cfg, device=dev,
                                plan=plan("healthy"))
        print(f"healthy run   : {healthy.value / cent:.2%} of centralized, "
              f"{healthy.rounds} rounds on 1 devices")

        failed = tree_maximize(obj, dj, cfg, device=dev,
                               plan=plan("failed"),
                               fail_machines={0: [0, 1, 2]})
        print(f"3 dead machines: {failed.value / cent:.2%} "
              f"(graceful degradation)")

        resumed = tree_maximize(
            obj, dj, TreeConfig(k=k, capacity=200, seed=0,
                                checkpoint_dir=ckpt, resume=True),
            device=dev, plan=plan("resumed"))
        print(f"restart from round checkpoint: {resumed.value / cent:.2%} "
              f"(best-so-far preserved)")

    # streaming ingestion: ground set visible only as a chunked host stream;
    # round 0 runs in waves of 8 machines so at most 8·μ candidate rows are
    # ever device-resident — same answer, bit for bit.
    stream = tree_maximize(obj, ChunkedSource.from_array(data, 1024),
                           TreeConfig(k=k, capacity=200, seed=0), device=dev,
                           plan=plan("stream"), wave_machines=8)
    assert stream.value == healthy.value, (stream.value, healthy.value)
    ing = stream.ingest
    print(f"streaming ingestion: {stream.value / cent:.2%} (bit-identical), "
          f"peak {ing.peak_wave_rows} rows/wave on device vs {len(data)} "
          f"resident ({ing.waves} waves of {ing.wave_machines} machines)")

    # async execution engine: the same waves, but wave t+1's gather (source
    # reads + block assembly, on a prefetch thread) overlaps wave t's solve,
    # and the gather itself is sharded across 2 emulated ingestion hosts —
    # each host serves only the item range it owns (locality asserted
    # inside).  Engines are pure execution policy: output is bit-identical
    # to the synchronous run above, failure injection and checkpointing
    # included.
    piped = tree_maximize(obj, ChunkedSource.from_array(data, 1024),
                          TreeConfig(k=k, capacity=200, seed=0,
                                     engine="pipelined", hosts=2),
                          device=dev, plan=plan("piped"), wave_machines=8)
    assert piped.value == healthy.value, (piped.value, healthy.value)
    es = piped.engine_stats
    print(f"pipelined engine (2 ingestion hosts): bit-identical, "
          f"{es.waves} waves, gather {es.gather_s:.3f}s / solve "
          f"{es.solve_s:.3f}s, overlap ratio {es.overlap_ratio:.1%}, "
          f"≤ {es.max_in_flight} wave buffers in flight")

    # hereditary constraints: budgeted + per-group-quota selection, streamed.
    # Attributes (weight, group id) ride as trailing columns of every block;
    # machine solves respect the constraint (Thm 3.5), the fold keeps the
    # best feasible solution, and streaming matches the all-resident
    # constrained run bit for bit.  RandGreedI under the *same* constraint
    # is the honest column.
    rng = np.random.default_rng(0)
    attrs = np.stack([rng.uniform(0.2, 1.0, len(data)),
                      rng.integers(0, 3, len(data))],
                     axis=1).astype(np.float32)
    cons = Intersection((Knapsack(budget=5.0, col=0),
                         PartitionMatroid(caps=(4, 4, 4), col=1)))
    ccfg = TreeConfig(k=k, capacity=200, seed=0)
    c_res = tree_maximize(obj, dj, ccfg, device=dev, constraint=cons,
                          attrs=attrs, plan=plan("constrained"))
    c_stream = tree_maximize(
        obj, ChunkedSource.from_array(data, 1024, attrs=attrs), ccfg,
        device=dev, plan=plan("constrained_stream"), wave_machines=8,
        constraint=cons)
    assert c_stream.value == c_res.value, (c_stream.value, c_res.value)
    ok, detail = check_feasible(cons, c_stream.sel_attrs, c_stream.sel_mask)
    assert ok, detail
    rg = randgreedi(obj, dj, k, len(data) // 200,
                    TorchPlan(0) if randgreedi_plan is None
                    else randgreedi_plan,
                    constraint=cons, attrs=attrs, device=dev)
    print(f"constrained (knapsack ∩ partition): {c_stream.value / cent:.2%} "
          f"of unconstrained centralized, streaming bit-identical, {detail}")
    print(f"constrained randgreedi baseline: {float(rg.value) / cent:.2%} "
          f"(TREE at {c_stream.value / float(rg.value):.2%})")
    return {"centralized": cent, "healthy": healthy, "failed": failed,
            "resumed": resumed, "stream": stream, "piped": piped,
            "constrained_resident": c_res, "constrained": c_stream,
            "randgreedi": float(rg.value)}


if __name__ == "__main__":
    main(device_arg())
