"""Roofline over dry-run records, for one H100 (the port's counterpart of
``repro.launch.roofline``).

Per (arch × shape) cell, from the op analysis of one step on one card
(``repro_torch.launch.dryrun``; all quantities PER DEVICE):

  compute    = Σ over ops of each op's flops at its own rate      [s]
  memory     = bytes_per_dev / HBM_BW                              [s]
  collective = collective_bytes_per_dev / link rate                [s]

The ATen products count at their operands' rate (bf16 at 989 TFLOP/s;
fp32 at 67 TFLOP/s, since the port leaves TF32 off, as torch does by
default and ``kernels/ref.py``'s ``exact_fp32`` says); each hand-written
kernel at the rates of ``kernels/cost.py``, the gain tile's tensor-core
products and CUDA-core epilogue overlapping as its bound takes them.  A
record with only ``flops_per_dev`` (a JAX record) takes the device's
single peak, as the JAX roofline does.  The collective term is 0 on one
device; the link's rate comes with multi-GPU (ROADMAP item 15).

The device is a parameter (:class:`repro_torch.kernels.cost.Device`),
:data:`repro_torch.kernels.cost.H100` by default: an NVIDIA H100 SXM's
data-sheet rates (bf16 989, TF32 495 and fp32 67 TFLOP/s, 3.35 TB/s of
HBM3) and, as one card's memory, the ``total_memory`` torch reports on an
H100 80GB HBM3 at a 700 W power limit (``nvidia-smi``): 85,017,493,504
bytes (79.18 GiB).  ``fits``: the cell's ``peak_bytes`` within it.

MODEL_FLOPS (analytic, per device): train 6·N·tokens, prefill and decode
2·N·tokens, N the active parameters; ``useful = MODEL_FLOPS / flops``.
"""
from __future__ import annotations

import dataclasses
import json

from repro_torch.kernels.cost import H100, Device, Work

KIND_FLOP_FACTOR = {"train": 6.0, "prefill": 2.0, "decode": 2.0}


@dataclasses.dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    kind: str
    compute_s: float
    memory_s: float
    collective_s: float
    bound: str
    model_flops_per_dev: float
    useful_ratio: float
    peak_gib: float
    step_s: float                    # max of the three terms
    roofline_frac: float             # compute_s / step_s  (≤ 1)
    kernel_frac: float = 0.0         # the kernels' share of the bound term
    fits: bool | None = None         # peak_bytes within the device

    def row(self) -> str:
        fits = "" if self.fits is None else ("yes" if self.fits else "**no**")
        return (f"| {self.arch} | {self.shape} | {self.mesh} | "
                f"{self.compute_s:.3e} | {self.memory_s:.3e} | "
                f"{self.collective_s:.3e} | **{self.bound}** | "
                f"{self.useful_ratio:.2f} | {self.peak_gib:.1f} | {fits} | "
                f"{self.roofline_frac:.2%} | {self.kernel_frac:.1%} |")


def tokens_for(shape_name: str) -> float:
    from repro_torch.configs.base import SHAPES
    s = SHAPES.get(shape_name)
    if s is None:
        return 0.0
    if s.kind == "decode":
        return float(s.global_batch)             # one token per sequence
    return float(s.global_batch * s.seq_len)


def _kernel_s(k: dict, dev: Device) -> float:
    return Work(tuple(k.get("flops_by_rate", {}).items()), 0.0,
                bool(k.get("overlap"))).compute_s(dev)


def compute_terms(rec: dict, dev: Device = H100) -> tuple[float, float]:
    """(compute seconds of the whole record, of its kernels alone)."""
    by_rate = rec.get("flops_by_rate")
    if not by_rate or not dev.rates:
        return rec["flops_per_dev"] / dev.peak_flops, 0.0
    aten = dict(by_rate)
    kernel_s = 0.0
    for k in rec.get("kernels", {}).values():
        for r, v in k.get("flops_by_rate", {}).items():
            aten[r] = aten.get(r, 0.0) - v
        kernel_s += _kernel_s(k, dev)
    aten_s = sum(max(v, 0.0) / dev.rate(r) for r, v in aten.items())
    return aten_s + kernel_s, kernel_s


def analyze_record(rec: dict, device: Device = H100) -> RooflineRow:
    n_dev = rec["n_devices"]
    compute_s, kernel_s = compute_terms(rec, device)
    memory_s = rec["bytes_per_dev"] / device.hbm_bw
    coll = rec["collective_bytes_per_dev"].get("total", 0.0)
    collective_s = (coll / device.link_bw if device.link_bw else 0.0)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bound = max(terms, key=terms.get)

    if rec["kind"] == "submod":
        model_flops = 0.0
        useful = float("nan")
    else:
        factor = KIND_FLOP_FACTOR[rec["kind"]]
        n_active = rec["active_params"]
        model_flops = factor * n_active * tokens_for(rec["shape"]) / n_dev
        useful = model_flops / max(rec["flops_per_dev"], 1.0)

    step = max(compute_s, memory_s, collective_s, 1e-12)
    kernels = rec.get("kernels", {}).values()
    if bound == "memory":
        kb = sum(k.get("bytes", 0.0) for k in kernels)
        kernel_frac = kb / max(rec["bytes_per_dev"], 1.0)
    else:
        kernel_frac = kernel_s / max(compute_s, 1e-30)
    fits = (rec["peak_bytes"] <= device.memory_bytes
            if device.memory_bytes and "kernels" in rec else None)
    return RooflineRow(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        kind=rec["kind"], compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, bound=bound,
        model_flops_per_dev=model_flops, useful_ratio=useful,
        peak_gib=rec["peak_bytes"] / 2**30,
        step_s=step, roofline_frac=compute_s / step,
        kernel_frac=kernel_frac, fits=fits)


HEADER = ("| arch | shape | mesh | compute s | memory s | collective s | "
          "bound | useful | peak GiB | fits | roofline frac | kernels |\n"
          "|---|---|---|---|---|---|---|---|---|---|---|---|")


def render_table(records: list[dict], mesh: str | None = "1",
                 device: Device = H100) -> str:
    rows = [analyze_record(r, device) for r in records
            if mesh is None or r["mesh"] == mesh]
    return "\n".join([HEADER] + [r.row() for r in rows])


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="inp", default="reports/dryrun.json")
    ap.add_argument("--mesh", default="1")
    args = ap.parse_args(argv)
    with open(args.inp) as f:
        data = json.load(f)
    print(render_table(data["records"],
                       None if args.mesh == "all" else args.mesh))
    rows = [analyze_record(r) for r in data["records"]
            if args.mesh == "all" or r["mesh"] == args.mesh]
    lm = [r for r in rows if r.kind != "submod"]
    worst = sorted(lm, key=lambda r: r.roofline_frac)[:5]
    print("\nWorst roofline fraction (hillclimb candidates):")
    for r in worst:
        print(f"  {r.arch} × {r.shape}: {r.roofline_frac:.2%} ({r.bound})")
    over = [r for r in rows if r.fits is False]
    print(f"Past one card's {H100.memory_bytes / 2**30:.2f} GiB: "
          + (", ".join(f"{r.arch} × {r.shape} ({r.peak_gib:.1f} GiB)"
                       for r in over) or "none"))
    for f in data.get("failures", []):
        print(f"FAILED {f['cell']}: {f['error']}")


if __name__ == "__main__":
    main()
