"""Time and trace ``wkv6`` and ``rbf_kernel`` at their main-path shapes for
the ``repro_torch`` package under ``--src``, so that two checkouts can be
compared on one card within one call:

    python3 src/repro_torch/ab_kernels.py --src OLD/src --tag parent --trace
    python3 src/repro_torch/ab_kernels.py --src src --tag change --trace

Shapes (:data:`WKV_SHAPES`, :data:`RBF_SHAPES`): ``wkv6`` prefill at the
RWKV serving cell (B = 8, H = 32, T = 2,048, Dk = Dv = 64, bf16 r/k/v/u,
fp32 w at the model's init decay, the final state written), its decode
(T = 1, state in and out, y fp32) and, with ``--long``, the 32k prefill
(B = 1); ``rbf_kernel`` at ActiveSetSelection's round-0 update (one row
against 2,000 machines × 22,500 rows, d = 6, h = 0.5) and, with
``--long``, its centralized update (one row against 45M rows).  Operands
~ N(0, 1) (rows / √d) from a seed on the card.  ``--only`` keeps shapes
by name.  (``chip_smoke.py``'s times phase times both ``wkv6`` kernels
by T.)

For each shape: the median device time of ``--runs`` calls
(``timing.device_ms``) of ``ops`` (the routed call) and, for ``wkv6``,
of the chunked kernel where the package has one
(``wkv6.launch_chunked``), with the max |Δ| against the plain version
where the plain version is quick enough; ``--trace`` adds
``torch.profiler``'s device time per kernel name
(``timing.kernel_trace``).  One JSON line, with the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __package__:   # imported as repro_torch.ab_kernels
    from .timing import card, device_ms, kernel_trace
else:             # run as a script: timing.py beside this file
    from timing import card, device_ms, kernel_trace

WKV_SHAPES = {  # name: (B, H, T, D, state in)
    "wkv6 prefill": (8, 32, 2048, 64, False),
    "wkv6 decode": (8, 32, 1, 64, True),
    "wkv6 prefill 32k": (1, 32, 32768, 64, False),
}
RBF_SHAPES = {  # name: (M, n, m, d, h)
    "rbf update": (2000, 1, 22_500, 6, 0.5),
    "rbf central": (1, 1, 45_000_000, 6, 0.5),
}
LONG = ("wkv6 prefill 32k", "rbf central")


def wkv_inputs(B, H, T, D, seed):
    """r, k, v ~ N(0, 1) and u ~ 0.1·N(0, 1) in bf16, w fp32 at the model's
    init decay exp(−exp(−6 + N(0, 1)/2)), as (B, H, T, D) views of
    (B, T, H, D) tensors (the model's layout)."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def draw(dt):
        return torch.randn((B, T, H, D), generator=g, device="cuda").to(
            dt).transpose(1, 2)

    r, k, v = draw(torch.bfloat16), draw(torch.bfloat16), draw(torch.bfloat16)
    w = torch.exp(-torch.exp(-6.0 + 0.5 * draw(torch.float32)))
    u = (0.1 * torch.randn((H, D), generator=g, device="cuda")).to(
        torch.bfloat16)
    return r, k, v, w, u


def run_wkv(name, B, H, T, D, given, args) -> dict:
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import wkv6 as wk
    r, k, v, w, u = wkv_inputs(B, H, T, D, 17)
    s0 = torch.randn((B, H, D, D), device="cuda") if given else None
    st = torch.empty((B, H, D, D), device="cuda")
    out_dtype = torch.float32 if given else None
    routes = {"ops": ops.wkv6}
    if hasattr(wk, "launch_chunked"):   # (a parent checkout has none)
        routes["chunked"] = wk.launch_chunked
    res = {}
    plain = (ref.wkv6(r, k, v, w, u, s0, out_dtype=out_dtype)
             if B * H * T <= 8 * 32 * 2048 else None)
    runs = max(3, args.runs // (10 if T > 4096 else 1))
    for route, fn in routes.items():
        def call(fn=fn):
            return fn(r, k, v, w, u, s0, state_out=st, out_dtype=out_dtype)
        y, s = call()
        one = {"ms": device_ms(call, runs)}
        if plain is not None:
            one["max_abs_err"] = max(
                float((y.float() - plain[0].float()).abs().max()),
                float((s - plain[1]).abs().max()))
        if args.trace:
            one["trace"] = kernel_trace(call, runs)
        res[route] = one
    del r, k, v, w, u, s0, st, plain
    torch.cuda.empty_cache()
    return res


def run_rbf(name, M, n, m, d, h, args) -> dict:
    import torch
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    Y = torch.randn((M, m, d), generator=g, device="cuda") / d ** 0.5
    X = Y[:, 1:1 + n]
    res = {}

    def call():
        return ops.rbf_kernel(X, Y, h)

    K = call()
    if M * m <= 2000 * 22_500:
        res["max_abs_err"] = float((K - ref.rbf_kernel(X, Y, h)).abs().max())
    del K
    res["ms"] = device_ms(call, args.runs)
    if args.trace:
        res["trace"] = kernel_trace(call, args.runs)
    del X, Y
    torch.cuda.empty_cache()
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="directory that holds the repro_torch to time")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--long", action="store_true")
    ap.add_argument("--only", nargs="+",
                    choices=sorted({**WKV_SHAPES, **RBF_SHAPES}))
    args = ap.parse_args()
    # this file's own directory must not shadow top-level modules
    sys.path[:1] = [str(Path(args.src).resolve())]

    import torch
    if not torch.cuda.is_available():
        sys.exit("ab_kernels: needs a CUDA card")
    out = {"tag": args.tag}
    names = args.only or [s for s in {**WKV_SHAPES, **RBF_SHAPES}
                          if args.long or s not in LONG]
    for name in names:
        if name in WKV_SHAPES:
            out[name] = run_wkv(name, *WKV_SHAPES[name], args)
        else:
            out[name] = run_rbf(name, *RBF_SHAPES[name], args)
    out["card"] = card()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
