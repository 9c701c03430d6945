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
timing, to sweep the split count.  ``--shapes "backward qwen3-8b"
"backward whisper-tiny"`` time ``launch_backward`` at the training shapes
instead (the share of the largest |value| against autograd of the plain
version, a second call to the bit, a digest of the gradients' bits, SDPA's
backward beside it).  For each: the median
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
import sys
from pathlib import Path

if __package__:   # imported as repro_torch.ab_attention
    from .timing import card, device_ms, kernel_trace
else:             # run as a script: timing.py beside this file
    from timing import card, device_ms, kernel_trace

SHAPES = {  # name: (B, H, Hkv, S, T, D, causal, kv_valid_len)
    "prefill": (8, 32, 8, 2048, 2048, 128, True, None),
    "decode": (8, 32, 8, 1, 2080, 128, False, 2080),
    "prefill 32k": (1, 32, 8, 32768, 32768, 128, True, None),
    "prefill gemma-2b": (8, 8, 1, 2048, 2048, 256, True, None),
    # the backward at Qwen3-8B's training microbatch and whisper-tiny's
    # encoder (chip_smoke.ATTN_BWD_SHAPES)
    "backward qwen3-8b": (1, 32, 8, 2048, 2048, 128, True, None),
    "backward whisper-tiny": (8, 6, 6, 1500, 1500, 64, False, None),
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

        if name.startswith("backward"):
            out[name] = _backward(q, k, v, causal, g, max(3, args.runs),
                                  args.trace)
            del q, k, v
            torch.cuda.empty_cache()
            continue

        def call():
            return ops.flash_attention(q, k, v, causal=causal,
                                       kv_valid_len=kv)

        o = call()
        err = float((o.float() - ref.flash_attention(
            q, k, v, causal=causal, kv_valid_len=kv).float()).abs().max())
        runs = max(3, args.runs // (10 if S > 4096 else 1))
        res = {"ms": device_ms(call, runs), "max_abs_err": err}
        shape = getattr(fa, "_decode_shape", {})
        if S == 1 and shape:   # (nsplit, chunk) as the launch chose them
            res["splits"] = fa.decode_splits(
                B, Hkv, H // Hkv, kv, torch.cuda.get_device_properties(
                    0).multi_processor_count, *next(iter(shape.values())))
        if kv is None:
            res["sdpa_ms"] = device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), runs)
        else:
            mask = (torch.arange(T, device="cuda") < kv)[None, None, None]
            res["sdpa_ms"] = device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True), runs)
        if args.trace:
            res["trace"] = kernel_trace(call, runs)
        out[name] = res
        del q, k, v, o
        torch.cuda.empty_cache()
    out["ptxas"] = [ln.strip() for lib in ("flash_attention",
                                           "flash_attention_bwd")
                    for ln in _build.build_log.get(lib, "").splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln]
    out["card"] = card()
    print(json.dumps(out), flush=True)


def _backward(q, k, v, causal, g, runs, trace) -> dict:
    """``launch_backward`` at q, k, v against autograd of the plain version
    (the worst share of the largest |value|), a second call to the bit,
    its time, and SDPA's backward under autograd beside it."""
    import hashlib

    import torch
    import torch.nn.functional as F
    from repro_torch import testing
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    scale = 1.0 / q.shape[-1] ** 0.5
    do = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)
    o, lse = fa.launch(q, k, v, causal=causal, scale=scale, with_lse=True)

    def call():
        return fa.launch_backward(q, k, v, o, lse, do, causal=causal,
                                  scale=scale)

    grads = call()
    plain = ref.flash_attention_backward(q, k, v, do, causal=causal)
    res = {"share": max(testing.grad_share(a, b)
                        for a, b in zip(grads, plain)),
           "same_bits": all(torch.equal(a, b)
                            for a, b in zip(grads, call())),
           "digest": hashlib.sha256(b"".join(
               t.contiguous().view(torch.int16).cpu().numpy().tobytes()
               for t in grads)).hexdigest()[:16]}
    del grads, plain
    torch.cuda.empty_cache()
    res["ms"] = device_ms(call, runs)
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
    with torch.enable_grad():
        o_l = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                             enable_gqa=True)
    res["sdpa_ms"] = device_ms(lambda: torch.autograd.grad(
        o_l, (qs, ks, vs), do, retain_graph=True), runs)
    if trace:
        res["trace"] = kernel_trace(call, runs)
    return res


if __name__ == "__main__":
    main()
