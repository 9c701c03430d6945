"""Time and trace ``flash_attention`` at the Qwen3-8B serving cell's shapes
for the ``repro_torch`` package under ``--src``, so that two checkouts can
be compared on one card within one call:

    python3 src/repro_torch/ab_attention.py --src OLD/src --tag parent
    python3 src/repro_torch/ab_attention.py --src src --tag change --trace

Shapes, bf16, q/k/v ~ N(0, 1) from a seed: prefill B = 8, H = 32, Hkv = 8,
S = T = 2,048, D = 128, causal (the cell's 36 prefill launches); decode
B = 8, S = 1, T = kv_valid_len = 2,080 (its 1,116 decode launches); with
``--long``, the prefill at S = T = 32,768, B = 1; ``--shapes`` names
others of :data:`SHAPES` instead (``"prefill gemma-2b"``: Gemma-2B's
heads, 8 over one KV head of 256).  ``--decode-chain N`` sets the decode
split rule's longest chain (``flash_attention.DECODE_CHAIN``) before
timing, to sweep the split count.  For each: the median
CUDA-event time of ``--runs`` calls after a warm-up (each queued behind a
device sleep, so the host's launch overhead falls outside the window),
PyTorch's ``scaled_dot_product_attention`` on the same inputs (the
yardstick, never called by the port), and the max |Δ| against the plain
version.  ``--trace`` adds ``torch.profiler``'s device time per kernel
name over ``--runs`` calls (every launch of the call apart: the decode
kernel and its combining pass, where there are two).  Prints the
``flash_attention`` library's ptxas lines (registers, shared memory,
spills) where this process built it, and one JSON line.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

SHAPES = {  # name: (B, H, Hkv, S, T, D, causal, kv_valid_len)
    "prefill": (8, 32, 8, 2048, 2048, 128, True, None),
    "decode": (8, 32, 8, 1, 2080, 128, False, 2080),
    "prefill 32k": (1, 32, 8, 32768, 32768, 128, True, None),
    "prefill gemma-2b": (8, 8, 1, 2048, 2048, 256, True, None),
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="directory that holds the repro_torch to time")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--long", action="store_true")
    ap.add_argument("--shapes", nargs="+", choices=sorted(SHAPES))
    ap.add_argument("--decode-chain", type=int)
    args = ap.parse_args()
    # this file's own directory must not shadow top-level modules
    sys.path[:1] = [str(Path(args.src).resolve())]

    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    if not torch.cuda.is_available():
        sys.exit("ab_attention: needs a CUDA card")
    if args.decode_chain is not None:
        fa.DECODE_CHAIN = args.decode_chain

    def timed(fn, runs):
        fn()
        times = []
        for _ in range(runs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(2_000_000)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    # (a parent checkout may predate the split rule's names)
    out = {"tag": args.tag, "decode_chain": getattr(fa, "DECODE_CHAIN", None)}
    names = args.shapes or (["prefill", "decode"]
                            + (["prefill 32k"] if args.long else []))
    for name in names:
        B, H, Hkv, S, T, D, causal, kv = SHAPES[name]
        g = torch.Generator(device="cuda")
        g.manual_seed(7)
        q, k, v = (torch.randn(s, generator=g, device="cuda").to(
            torch.bfloat16) for s in ((B, H, S, D), (B, Hkv, T, D),
                                      (B, Hkv, T, D)))

        def call():
            return ops.flash_attention(q, k, v, causal=causal,
                                       kv_valid_len=kv)

        o = call()
        err = float((o.float() - ref.flash_attention(
            q, k, v, causal=causal, kv_valid_len=kv).float()).abs().max())
        runs = max(3, args.runs // (10 if S > 4096 else 1))
        res = {"ms": timed(call, runs), "max_abs_err": err}
        shape = getattr(fa, "_decode_shape", {})
        if S == 1 and shape:   # (nsplit, chunk) as the launch chose them
            res["splits"] = fa.decode_splits(
                B, Hkv, H // Hkv, kv, torch.cuda.get_device_properties(
                    0).multi_processor_count, *next(iter(shape.values())))
        if kv is None:
            res["sdpa_ms"] = timed(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), runs)
        else:
            mask = (torch.arange(T, device="cuda") < kv)[None, None, None]
            res["sdpa_ms"] = timed(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True), runs)
        if args.trace:
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(runs):
                    call()
                torch.cuda.synchronize()
            kernels = {}
            for e in prof.key_averages():
                dev = getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0))
                if dev > 0 and e.count:
                    kernels[e.key] = {"count": e.count,
                                      "us_per_launch": dev / e.count}
            res["trace"] = kernels
        out[name] = res
        del q, k, v, o
        torch.cuda.empty_cache()
    log = _build.build_log.get("flash_attention", "")
    out["ptxas"] = [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln]
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
