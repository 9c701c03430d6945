"""Time one selection kernel at round 0 of the Webscope TREE for the
``repro_torch`` package under ``--src``, so that two checkouts can be
compared on one card within one call:

    python3 src/repro_torch/ab_round0.py --src OLD/src --tag parent \\
        --kernel greedy
    python3 src/repro_torch/ab_round0.py --src src --tag change \\
        --kernel greedy

Round 0 is the shape ``chip_smoke.py`` times: the 45M Webscope rows
(d = 6) split by ``balanced_partition`` over M = 2,000 machines of
μ = 22,500 rows, 512 eval rows, k = 50.  ``--kernel``:

- ``greedy``: the unconstrained ``greedy_select`` call;
- ``greedy_constrained``: under Knapsack(0.45k) ∩ PartitionMatroid(k/4 per
  group), per-row weights ~ U(0.2, 1.0) and 8 groups from seed 0 (the
  constrained phase's attributes);
- ``greedy_weighted``: eval weights ~ U(0.5, 1.5) normalised to mean 1
  (seed 0);
- ``threshold``: one ``threshold_select`` level under the intersection at
  level 0 (τ = the plain d_max of the feasible rows), the kernel alone on
  operands prepared once, cur_min restored before each launch; level 1
  (τ halved, ε = 0.5) is timed the same way beside it.

Prints one JSON line: the tag, the kernel, the card's name and power
limit, the median and every CUDA-event time of ``--runs`` calls after one
warm-up (``timing.device_times``: each queued behind a device sleep, so
the host's launch overhead falls outside the window), the launches one call counted, and a digest of
the selections (greedy) or the accept set (threshold).  Near ties may
break apart between checkouts, so a digest that differs is reported, not
failed: ``chip_smoke.py`` holds each kernel against its plain version.
Where the package reports the threshold pre-pass's block flags, the share
of blocks flagged at levels 0 and 1 is printed too.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import statistics
import sys
from pathlib import Path

if __package__:   # imported as repro_torch.ab_round0
    from .timing import card, device_times
else:             # run as a script: timing.py beside this file
    from timing import card, device_times

KERNELS = ("greedy", "greedy_constrained", "greedy_weighted", "threshold")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="directory that holds the repro_torch to time")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--kernel", choices=KERNELS, default="greedy")
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    # this file's own directory must not shadow top-level modules
    sys.path[:1] = [str(Path(args.src).resolve())]

    import numpy as np
    import torch
    from repro_torch.convert import objective_from_numpy
    from repro_torch.core import (Intersection, Knapsack, PartitionMatroid,
                                  TorchPlan)
    from repro_torch.core import partition as part_lib
    from repro_torch.core.algorithms import _fused_constraint_kwargs
    from repro_torch.data import datasets
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import threshold_select as _ts
    if not torch.cuda.is_available():
        sys.exit("ab_round0: needs a CUDA card")
    n, d, k, mu, n_eval, seed = 45_000_000, 6, 50, 22_500, 512, 0
    data = datasets.webscope(n=n, d=d)
    r = np.random.default_rng(0)            # chip_smoke.py's eval draw
    E = objective_from_numpy(
        data[r.choice(n, n_eval, replace=False)], "cuda").eval_set
    X = torch.as_tensor(data, device="cuda")
    del data
    part = part_lib.balanced_partition(
        TorchPlan(seed), 0, n, part_lib.n_parts(n, mu), cap=mu,
        device="cuda")
    blocks, bmask = part_lib.gather_partition(X, part)
    M, m = blocks.shape[0], E.shape[0]
    e0 = torch.sum(E * E, dim=-1)
    kw, ew = {}, None
    if args.kernel in ("greedy_constrained", "threshold"):
        ra = np.random.default_rng(seed)     # chip_smoke.make_attrs
        attrs = torch.as_tensor(np.stack(
            [ra.uniform(0.2, 1.0, n).astype(np.float32),
             ra.integers(0, 8, n).astype(np.float32)], axis=1),
            device="cuda")
        cons = Intersection((Knapsack(budget=0.45 * k, col=0),
                             PartitionMatroid(caps=(k // 4,) * 8, col=1)))
        kw = _fused_constraint_kwargs(
            cons, part_lib.gather_partition(attrs, part)[0])
        del attrs
    if args.kernel == "greedy_weighted":
        w = np.random.default_rng(seed).uniform(0.5, 1.5, m)
        ew = torch.as_tensor((w / w.mean()).astype(np.float32),
                             device="cuda")
    del X
    extra = {}

    if args.kernel == "threshold":
        enc = ref.Encoding(M, mu, blocks.device, **kw)
        zeros = torch.zeros((M,), device="cuda")
        cand = enc.feasible(bmask, zeros, torch.zeros(
            (M, enc.G), dtype=torch.int32, device="cuda"))
        g = ref.exemplar_gains(blocks, E, e0)
        tau0 = torch.clamp_min(torch.amax(torch.where(cand, g, 0.0), dim=1),
                               1e-12)
        del g
        Xb = blocks.contiguous()
        Ep, cmp_ = ops._pad_eval(E, e0.expand(M, m))
        cm_run = cmp_.clone()
        state = (bmask.to(torch.uint8), zeros,
                 torch.zeros((M,), dtype=torch.int32, device="cuda"),
                 torch.zeros((M, enc.G), dtype=torch.int32, device="cuda"),
                 torch.ones((M,), dtype=torch.uint8, device="cuda"))
        has_flags = "flags_out" in inspect.signature(_ts.launch).parameters
        flags = torch.empty((M, -(-mu // 256)), dtype=torch.uint8,
                            device="cuda")

        def level(tau):
            cm_run.copy_(cmp_)
            fkw = {"flags_out": flags} if has_flags else {}
            return _ts.launch(Xb, Ep, cm_run, state[0], tau.contiguous(),
                              *state[1:], k, 256, m,
                              **ops._card_encoding(enc), **fkw)

        def call():
            return level(tau0)

        extra["ms_level1_median"] = statistics.median(
            device_times(lambda: level(tau0 * 0.5), args.runs))
        if has_flags:
            for lv, tau in ((0, tau0), (1, tau0 * 0.5)):
                level(tau)
                extra[f"flagged_share_level{lv}"] = float(
                    flags.float().mean())
    else:
        def call():
            return ops.greedy_select(blocks, E, e0, bmask, k,
                                     eval_weights=ew, **kw)[0]

    out = call()                            # build, load, warm up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    call()
    torch.cuda.synchronize()
    launches = {key: v for key, v in ops.launch_counts.items() if v}
    times = device_times(call, args.runs)
    smi = card()
    print(json.dumps({
        "tag": args.tag, "kernel": args.kernel, "card": smi,
        "shape": [*blocks.shape, m], "k": k,
        "ms_median": statistics.median(times), "ms": times,
        "launches_per_call": launches,
        "digest": hashlib.sha256(
            out.cpu().numpy().tobytes()).hexdigest()[:16], **extra}),
        flush=True)


if __name__ == "__main__":
    main()
