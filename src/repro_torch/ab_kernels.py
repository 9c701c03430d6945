"""Time and trace ``wkv6``, ``rbf_kernel`` and ``exemplar_gains`` at their
main-path shapes for the ``repro_torch`` package under ``--src``, so that
two checkouts can be compared on one card within one call:

    python3 src/repro_torch/ab_kernels.py --src OLD/src --tag parent --trace
    python3 src/repro_torch/ab_kernels.py --src src --tag change --trace

Shapes (:data:`WKV_SHAPES`, :data:`RBF_SHAPES`, :data:`EG_SHAPES`):
``wkv6`` prefill at the RWKV serving cell (B = 8, H = 32, T = 2,048,
Dk = Dv = 64, bf16 r/k/v/u, fp32 w at the model's init decay, the final
state written), its decode (T = 1, state in and out, y fp32) and, with
``--long``, the 32k prefill (B = 1); ``rbf_kernel`` at
ActiveSetSelection's round-0 update (one row against 2,000 machines ×
22,500 rows, d = 6, h = 0.5) and, with ``--long``, its centralized
update (one row against 45M rows); ``exemplar_gains`` at the scan block
(M = 1, n = 22,500, m = 512, d = 6), at round 0's THRESHOLD-BATCH
``d_max`` pass (M = 2,000, n = 22,500) in every instantiation (fp32,
bf16 and int8 rows, the bf16 dot, eval weights), at one chunk of the
streaming centralized greedy (M = 1, n = 2²⁰), in the chunked layout
(d = 17; m = 1,280) and at one 128-row tile (m = 512 and 64: the floor
of one CTA).  Operands ~ N(0, 1) (rows / √d) from a fixed seed on the
card, so two checkouts' outputs compare bit for bit.  ``--only`` keeps
shapes by name.  (``chip_smoke.py``'s times phase times the same
kernels.)

For each shape: the median device time of ``--runs`` calls
(``timing.device_ms``) of ``ops`` (the routed call) and, for ``wkv6``,
of the chunked kernel where the package has one
(``wkv6.launch_chunked``), with the max |Δ| against the plain version
where the plain version is quick enough and the sha256 of the output
bytes (``wkv6``: y then the state); ``--trace`` adds ``torch.profiler``'s
device time per kernel name (``timing.kernel_trace``).  One JSON line,
with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import hashlib
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
EG_SHAPES = {  # name: (M, n, m, d, operand)
    "eg scan block": (1, 22_500, 512, 6, "fp32"),
    "eg round0 fp32": (2000, 22_500, 512, 6, "fp32"),
    "eg round0 bf16": (2000, 22_500, 512, 6, "bf16"),
    "eg round0 q8": (2000, 22_500, 512, 6, "q8"),
    "eg round0 bf16dot": (2000, 22_500, 512, 6, "bf16dot"),
    "eg round0 weighted": (2000, 22_500, 512, 6, "weighted"),
    "eg chunk 2^20": (1, 1 << 20, 512, 6, "fp32"),
    "eg chunked d=17": (200, 22_500, 512, 17, "fp32"),
    "eg chunked m=1280": (200, 22_500, 1280, 6, "fp32"),
    "eg one tile": (1, 128, 512, 6, "fp32"),
    "eg one tile m=64": (1, 128, 64, 6, "fp32"),
}
LONG = ("wkv6 prefill 32k", "rbf central")


def digest(*ts) -> str:
    """sha256 of the tensors' bytes, in order."""
    import torch
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().view(-1).view(
            torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


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
    g = torch.Generator(device="cuda")
    g.manual_seed(19)
    s0 = (torch.randn((B, H, D, D), generator=g, device="cuda") if given
          else None)
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
        one = {"ms": device_ms(call, runs), "sha256": digest(y, s)}
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


def eg_inputs(M, n, m, d, operand, seed):
    """Rows, eval rows, cur_min = ‖e‖² (the first step's) and the
    operand's keyword arguments for ``ops.exemplar_gains``."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    X = torch.randn((M, n, d), generator=g, device="cuda") / d ** 0.5
    E = torch.randn((m, d), generator=g, device="cuda") / d ** 0.5
    kw = {}
    if operand == "bf16":
        X = X.bfloat16()
    elif operand == "q8":
        X = torch.randint(-127, 128, (M, n, d), generator=g, device="cuda",
                          dtype=torch.int8)
        kw["x_scale"] = (0.002 + 0.01 * torch.rand(
            (M, n), generator=g, device="cuda")) / d ** 0.5
        kw["x_zp"] = 0.01 * torch.randn((M, n), generator=g, device="cuda")
    elif operand == "bf16dot":
        kw["compute_dtype"] = torch.bfloat16
    elif operand == "weighted":
        w = 0.5 + torch.rand((m,), generator=g, device="cuda")
        kw["eval_weights"] = w / w.mean()
    return X, E, torch.sum(E * E, dim=-1), kw


def run_eg(name, M, n, m, d, operand, args) -> dict:
    import torch
    from repro_torch.kernels import ops, ref
    X, E, cm, kw = eg_inputs(M, n, m, d, operand, 23)

    def call():
        return ops.exemplar_gains(X, E, cm, **kw)

    out = call()
    res = {"sha256": digest(out),
           "max_abs_err": float((out - ref.exemplar_gains(
               X, E, cm, **kw)).abs().max())}
    del out
    res["ms"] = device_ms(call, args.runs)
    if args.trace:
        res["trace"] = kernel_trace(call, args.runs)
    del X, E, cm, kw
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
                    choices=sorted({**WKV_SHAPES, **RBF_SHAPES,
                                    **EG_SHAPES}))
    args = ap.parse_args()
    # this file's own directory must not shadow top-level modules
    sys.path[:1] = [str(Path(args.src).resolve())]

    import torch
    if not torch.cuda.is_available():
        sys.exit("ab_kernels: needs a CUDA card")
    out = {"tag": args.tag}
    names = args.only or [s for s in {**WKV_SHAPES, **RBF_SHAPES,
                                       **EG_SHAPES}
                          if args.long or s not in LONG]
    for name in names:
        if name in WKV_SHAPES:
            out[name] = run_wkv(name, *WKV_SHAPES[name], args)
        elif name in RBF_SHAPES:
            out[name] = run_rbf(name, *RBF_SHAPES[name], args)
        else:
            out[name] = run_eg(name, *EG_SHAPES[name], args)
    out["card"] = card()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
