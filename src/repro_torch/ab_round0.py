"""Time the unconstrained ``greedy_select`` at round 0 of the Webscope TREE
for the ``repro_torch`` package under ``--src``, so that two checkouts can
be compared on one card within one call:

    python3 src/repro_torch/ab_round0.py --src OLD/src --tag parent
    python3 src/repro_torch/ab_round0.py --src src --tag change

Round 0 is the shape ``chip_smoke.py`` times: the 45M Webscope rows
(d = 6) split by ``balanced_partition`` over M = 2,000 machines of
μ = 22,500 rows, 512 eval rows, k = 50.  Prints one JSON line: the tag,
the card's name and power limit, the median and every CUDA-event time of
``--runs`` calls after one warm-up (each queued behind a device sleep, so
the host's launch overhead falls outside the window), and a digest of the
selections, which must be the same for both checkouts.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="directory that holds the repro_torch to time")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    # this file's own directory must not shadow top-level modules
    sys.path[:1] = [str(Path(args.src).resolve())]

    import numpy as np
    import torch
    from repro_torch.convert import objective_from_numpy
    from repro_torch.core import TorchPlan
    from repro_torch.core import partition as part_lib
    from repro_torch.data import datasets
    from repro_torch.kernels import ops
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
    e0 = torch.sum(E * E, dim=-1)

    def call():
        return ops.greedy_select(blocks, E, e0, bmask, k)

    sel, _ = call()                         # build, load, warm up
    torch.cuda.synchronize()
    times = []
    for _ in range(args.runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)
        a.record()
        call()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "tag": args.tag, "card": smi, "shape": [*blocks.shape, E.shape[0]],
        "k": k, "ms_median": statistics.median(times), "ms": times,
        "sel_digest": hashlib.sha256(
            sel.cpu().numpy().tobytes()).hexdigest()[:16]}), flush=True)


if __name__ == "__main__":
    main()
