"""Time variants of the chunked ``wkv6`` backward side by side on one card,
beside the recurrent backward, at the two training shapes:

    python3 src/repro_torch/ab_wkv6_bwd.py
    python3 src/repro_torch/ab_wkv6_bwd.py --variant edited=/path/to/copy.cu --trace

Each variant is a source file in ``csrc/wkv6_bwd_chunked.cu``'s form (the
repo's own file is ``base``), built with the repo's nvcc flags into
``build/variants/`` (all at once, one ``nvcc`` each) and loaded in place of
the ``wkv6_bwd_chunked`` library for its turn.  Shapes, bf16 from zeros
(``--fp32`` adds the microbatch in fp32): rwkv6-1.6b's training
microbatch (B = 4, H = 32, T = 2,048, Dk = Dv = 64, the model's init
decay) and Jamba's Mamba scan (B = 8, H = 128, T = 2,048, Dk = 16, Dv =
128, u = 0, w = 0.5), inputs ~ N(0, 1) from a seed.  For each shape every
variant is timed twice, in turns (the order reversed the second time):
the median CUDA-event time of ``--runs`` calls after a warm-up, each
queued behind a device sleep; the recurrent kernel once; each variant's
worst gradient share against the recurrent kernel as a fraction of
``testing.WKV_GRAD_TOL``.  ``--trace`` adds ``torch.profiler``'s device
time per kernel name for each variant.  Prints each variant's ptxas
registers and spills, the card (``nvidia-smi``) and one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

SHAPES = {"micro": (4, 32, 2048, 64, 64, "model", False),
          "jamba": (8, 128, 2048, 16, 128, 0.5, True)}


def inputs(B, H, T, Dk, Dv, dtype, seed, decay, u_zero):
    """r, k, v (B, H, T, D) views of (B, T, H, D), w, u, no state, dy and
    no dS_T: the backward's operands as the model passes them."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def bthd(D):
        return torch.randn((B, T, H, D), generator=g,
                           device="cuda").to(dtype).transpose(1, 2)

    r, k, v = bthd(Dk), bthd(Dk), bthd(Dv)
    n = torch.randn((B, T, H, Dk), generator=g, device="cuda").transpose(1, 2)
    w = (torch.exp(-torch.exp(-6.0 + 0.5 * n)) if decay == "model"
         else torch.full_like(n, decay))
    u = (0.1 * torch.randn((H, Dk), generator=g, device="cuda")).to(dtype)
    if u_zero:
        u = torch.zeros_like(u)
    return r, k, v, w.float(), u, None, bthd(Dv), None


def build(variants: dict, out: Path) -> dict:
    """{name: loaded library} of each variant source, built at once."""
    from repro_torch.kernels import _build
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in variants.items():
        cu = out / f"{name}.cu"
        cu.write_text(Path(src).read_text())
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.nvcc_flags(), "-I", str(_build.CSRC),
             "-o", str(out / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"{name}: registers {regs}, spill stores {spills}")
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        for fn, argtypes in _build.ARGTYPES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv=None) -> dict:
    root = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root / "src"))
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--variant", action="append", default=[],
                   help="name=path of another source to time")
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--trace", action="store_true")
    args = p.parse_args(argv)
    import torch
    from repro_torch import testing
    from repro_torch.kernels import _build
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.timing import card, device_ms, kernel_trace
    variants = {"base": _build.CSRC / "wkv6_bwd_chunked.cu"}
    variants.update(v.split("=", 1) for v in args.variant)
    libs = build(variants, root / "build" / "variants")
    load, cur = _build.load, [None]
    _build.load = lambda name: (libs[cur[0]] if name == "wkv6_bwd_chunked"
                                else load(name))
    shapes = dict(SHAPES)
    if args.fp32:
        shapes["micro-fp32"] = SHAPES["micro"]
    out = {"card": card(), "shapes": {}}
    print(out["card"])
    try:
        for what, (B, H, T, Dk, Dv, decay, u_zero) in shapes.items():
            dtype = torch.float32 if what.endswith("fp32") else torch.bfloat16
            ops = inputs(B, H, T, Dk, Dv, dtype, 41, decay, u_zero)
            rec = wk.launch_backward_recurrent(*ops)
            res = {"recurrent_ms": device_ms(
                lambda: wk.launch_backward_recurrent(*ops), args.runs)}
            ms = {name: [] for name in libs}
            for turn in (list(libs), list(libs)[::-1]):
                for name in turn:
                    cur[0] = name
                    ms[name].append(device_ms(
                        lambda: wk.launch_backward_chunked(*ops), args.runs))
            for name in libs:
                cur[0] = name
                got = wk.launch_backward_chunked(*ops)
                share = max(testing.grad_share(a, b)
                            / testing.WKV_GRAD_TOL[a.dtype]
                            for a, b in zip(got, rec))
                res[name] = {"ms": ms[name], "share_of_tol": share}
                line = (f"{what} {name}: {ms[name][0]:.4f} / "
                        f"{ms[name][1]:.4f} ms (recurrent "
                        f"{res['recurrent_ms']:.4f}); worst share / tol "
                        f"{share:.3f}")
                if args.trace:
                    tr = kernel_trace(
                        lambda: wk.launch_backward_chunked(*ops), args.runs)
                    res[name]["trace"] = tr
                    line += "; " + ", ".join(
                        f"{k.split('(')[0][-40:]} {v['us_per_launch']:.1f} us"
                        for k, v in tr.items())
                print(line, flush=True)
            out["shapes"][what] = res
    finally:
        _build.load = load
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
