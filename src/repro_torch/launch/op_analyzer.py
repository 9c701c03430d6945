"""What one call of a function dispatches: flops, bytes, live memory and
kernel launches (the port's counterpart of ``repro.launch.hlo_analyzer``).

The JAX analyzer reads the compiled program's HLO text.  Eager PyTorch has
no compiled program; what it runs is the sequence of ATen ops it
dispatches, so this analyzer is a ``TorchDispatchMode`` that sees every
op of the call once, in order, over tensors that hold no data:

* ``meta`` tensors for the card's path (``repro_torch.device.dry_card``):
  every hand-written kernel's wrapper takes its dry branch there
  (``kernels/_build.dry``), runs its checks, allocates its outputs and
  scratch, bumps its launch counters and reports its call's work from
  :mod:`repro_torch.kernels.cost` instead of launching;
* ``FakeTensorMode`` CPU tensors for the plain path (``--device cpu``),
  where the kernels are their plain PyTorch versions.

A count of dispatched ops needs no card and covers any cell, including
the ones that no card holds.  (A CPU build of torch has no CUDA device
guard, which autograd, indexing and ``copy_`` on a fake ``cuda`` tensor
need; ``meta`` tensors run the same code on every build.)

Counting rules, mirroring the JAX analyzer's:

* flops: the products of ``torch.utils.flop_counter``'s registered
  formulas (mm, bmm, addmm, baddbmm, convolutions, attention ops), each at
  its operands' rate (``"bf16"`` for bf16/fp16, ``"fp32"`` for fp32 with
  TF32 off, as the port leaves it, ``"tf32"`` with it on); the elementwise
  ops count none, as in the JAX analyzer; each kernel call at
  ``cost.py``'s rate;
* bytes: each op that is not a view reads its inputs and writes its
  outputs once (an operand broadcast by a zero stride counts its distinct
  elements); an op that only writes an operand (``copy_``, ``fill_``, an
  ``out=``) does not read it; a write into a slice of a cache counts the
  slice, not the buffer; an embedding lookup or gather counts twice its
  result and its indices, not the table; a view, reshape or allocation
  counts nothing; a kernel call counts ``cost.py``'s bytes, not what runs
  inside its wrapper (the wrapper's own copies and fills count as ops);
* ``peak_bytes``: the most bytes live at once, inputs included: each
  storage counts from the first op that touches it until its release (a
  weak reference on each storage; a saved activation stays live until
  autograd frees it), rounded up to the CUDA caching allocator's 512-byte
  blocks;
* ``kernels``: ``{launch counter: {launches, flops, bytes,
  flops_by_rate, overlap}}``, the launches read from
  ``_build.launch_counts`` (a call's work under its first counter; the
  counters it bumps once more, ``_wgmma``, ``_lse``, ``_bf16dot``, carry
  launches only), which leave the analyzer as they entered it, so that
  they only ever count launches on the card;
* ``collectives``: ``{"total": 0.0}`` on one device;
  ``unknown_trip_loops``: ``[]`` (eager code runs every iteration).
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _build, cost

#: the CUDA caching allocator's block: every allocation is rounded up to it
ALLOC_ROUND = 512

_aten = torch.ops.aten
#: ops that move no bytes (allocations, aliases, metadata)
_FREE = {_aten.empty.memory_format, _aten.empty_strided.default,
         _aten.empty_like.default, _aten.new_empty.default,
         _aten.new_empty_strided.default, _aten.detach.default,
         _aten.alias.default, _aten._unsafe_view.default,
         _aten.lift_fresh.default, _aten.set_.source_Storage_storage_offset,
         _aten.resize_.default}
#: gathers: twice the result (read where it lies, written) and the indices
_GATHER = {_aten.embedding.default, _aten.index_select.default,
           _aten.index.Tensor, _aten.gather.default}
#: scatters into a buffer in place: twice the values and the indices
_SCATTER = {_aten.index_put_.default, _aten._index_put_impl_.default,
            _aten.scatter_.src, _aten.scatter_.value,
            _aten.scatter_add_.default, _aten.index_add_.default,
            _aten.index_copy_.default}
#: in-place ops that write their first operand without reading it
_WRITE_ONLY = {"copy_", "fill_", "zero_", "normal_", "uniform_", "random_",
               "bernoulli_", "exponential_", "set_"}


def _nbytes(t: torch.Tensor) -> int:
    """Distinct bytes of ``t``: a dim broadcast by a zero stride counts
    once."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n if t.numel() else 0


def _rate(dtype: torch.dtype) -> str:
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        return "tf32"
    return "fp32"


class OpAnalyzer(TorchDispatchMode):
    """Count what runs inside ``with OpAnalyzer(inputs):``; read
    :meth:`result` after.  ``inputs``: any nest of tensors that are live
    when the call starts (its arguments), counted in ``peak_bytes``."""

    def __init__(self, inputs=()):
        super().__init__()
        self.flops_by_rate: dict[str, float] = {}
        self.hbm_bytes = 0.0
        self.kernels: dict[str, dict] = {}
        self.live = 0
        self.peak = 0
        self._storages: dict[int, int] = {}
        self._inputs = inputs
        self._launch0: dict[str, int] = {}

    # -- memory ---------------------------------------------------------
    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND
        self._storages[key] = n
        self.live += n
        weakref.finalize(st, self._free, key).atexit = False

    # -- kernels --------------------------------------------------------
    def _kernel(self, counter: str, work: cost.Work) -> None:
        k = self.kernels.setdefault(counter, {
            "launches": 0, "flops": 0.0, "bytes": 0.0, "flops_by_rate": {},
            "overlap": work.overlap})
        k["flops"] += work.flops
        k["bytes"] += work.nbytes
        for r, v in work.by_rate().items():
            k["flops_by_rate"][r] = k["flops_by_rate"].get(r, 0.0) + v
            self.flops_by_rate[r] = self.flops_by_rate.get(r, 0.0) + v
        self.hbm_bytes += work.nbytes

    def __enter__(self):
        self._launch0 = dict(_build.launch_counts)
        cost._sinks.append(self._kernel)
        for t in tree_leaves(self._inputs):
            if isinstance(t, torch.Tensor):
                self._track(t)
        self.peak = max(self.peak, self.live)
        return super().__enter__()

    def __exit__(self, *exc):
        cost._sinks.remove(self._kernel)
        for name, n in _build.launch_counts.items():
            got = n - self._launch0.get(name, 0)
            if got:
                self.kernels.setdefault(name, {
                    "launches": 0, "flops": 0.0, "bytes": 0.0,
                    "flops_by_rate": {}, "overlap": False})
                self.kernels[name]["launches"] = got
        # the dry branches launched nothing: the counters keep real launches
        _build.launch_counts.update(
            {name: self._launch0.get(name, 0)
             for name in _build.launch_counts})
        return super().__exit__(*exc)

    # -- ops ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        for t in ins:
            self._track(t)
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self._track(t)
        self.peak = max(self.peak, self.live)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            f = float(count(*args, **kwargs, out_val=out))
            r = _rate(outs[0].dtype if outs else ins[0].dtype)
            self.flops_by_rate[r] = self.flops_by_rate.get(r, 0.0) + f
        self.hbm_bytes += self._bytes(func, args, ins, outs)
        return out

    @staticmethod
    def _bytes(func, args, ins, outs) -> int:
        if func in _FREE or func.is_view or not outs:
            return 0
        if func in _GATHER:
            idx = sum(_nbytes(t) for t in ins
                      if not t.is_floating_point())
            return 2 * sum(_nbytes(t) for t in outs) + idx
        if func in _SCATTER:
            # the buffer is written where the values go: count the values
            # (twice: read, written) and the indices
            rest = ins[1:]
            vals = sum(_nbytes(t) for t in rest if t.is_floating_point())
            return 2 * vals + sum(_nbytes(t) for t in rest
                                  if not t.is_floating_point())
        schema = func._schema
        write_only = set()
        for i, a in enumerate(schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write and (
                    schema.overload_name.startswith("out")
                    or func._overloadpacket.__name__ in _WRITE_ONLY):
                v = args[i] if i < len(args) and not a.kwarg_only else None
                if isinstance(v, torch.Tensor):
                    write_only.add(id(v))
                for o in outs:
                    if a.kwarg_only:
                        write_only.add(id(o))
        seen, n = set(), 0
        for t in ins:
            if id(t) in seen or id(t) in write_only:
                continue
            seen.add(id(t))
            n += _nbytes(t)
        return n + sum(_nbytes(t) for t in outs)

    # -- the record -----------------------------------------------------
    def result(self) -> dict:
        """The JAX analyzer's keys (``flops``, ``hbm_bytes``,
        ``collectives``, ``unknown_trip_loops``) and ``peak_bytes``,
        ``flops_by_rate``, ``kernels``."""
        return {
            "flops": float(sum(self.flops_by_rate.values())),
            "hbm_bytes": float(self.hbm_bytes),
            "collectives": {"total": 0.0},
            "unknown_trip_loops": [],
            "peak_bytes": int(self.peak),
            "flops_by_rate": dict(self.flops_by_rate),
            "kernels": self.kernels,
        }


def analyze(fn, *args, inputs=None, **kwargs) -> dict:
    """``fn(*args, **kwargs)`` counted (:class:`OpAnalyzer`), its tensor
    arguments (or ``inputs``) live from the start; returns the counts."""
    with OpAnalyzer(inputs=(args, kwargs) if inputs is None else inputs) as a:
        fn(*args, **kwargs)
    return a.result()
