"""The cost of a step, counted while it runs — the port's counterpart of the
reference's ``compiled.cost_analysis()`` and ``memory_analysis()``.

The port runs eagerly, so its cost is the cost of the operators it
dispatches.  :class:`CostMode` is a ``TorchDispatchMode`` that sees each of
them, on the meta device (shapes and dtypes only: the dry-run traces a step
at full size without memory) or on the card (the same step, run), and
records:

- **FLOPs** of aten ops, from the public ``torch.utils.flop_counter``
  formulas (matmuls, convolutions, attention; elementwise ops count none);
- **bytes**: each op's inputs read once and its outputs written once, the
  port's real eager traffic, since nothing fuses.  Views and metadata ops
  count 0.  Indexing ops (``embedding``, ``index_select``, ``gather``,
  ``index``) count the rows they read, not their whole source; writes into
  a slice (``copy_`` into a cache slot, ``index_put_``, in-place scatters
  and index updates) count the slice, not the whole destination; fills
  and factory ops count only what they write;
- **peak live bytes**: the step's arguments, and the high-water mark of the
  storages that the step allocates while they live (each tracked until its
  storage is freed);
- **kernel records**: a hand-written kernel's wrapper runs its body inside
  :func:`kernel`, which records ``(flops, bytes)`` from the kernel's own
  formula (below) and counts none of the aten ops inside the wrapper a
  second time (their allocations still count towards the peak).  The
  wrappers record on every device, so a meta trace, a CPU run (the plain
  versions) and a card run of one step count the same;
- **collectives**, by kind (``roofline.analysis.CollectiveStats``): each
  ``_c10d_functional`` op (DTensor's redistributions) and ``c10d`` op (the
  process-group calls of the pod gossip), with the bytes of its output on
  this rank as ``roofline.analysis`` counts them (the gathered block of an
  all-gather, the kept shard of a reduce-scatter, the operand of an
  all-reduce or all-to-all, the sent block of a permute).  They, and the
  bookkeeping ops around them (``wait_tensor``, ``_wrap_tensor_autograd``),
  count no HBM bytes and no aten op; their outputs count towards the peak.

A DTensor step (the pod runtime, ``launch.sharding``) is counted at its
local shapes: the mode lets DTensor's dispatch run first and counts the
local ops and collectives it runs, so one rank's own cost is what it
sees, and its arguments' bytes are their local blocks'.

The kernel formulas: each input read once and each output written once for
bytes; ``4 hd B H open_pairs`` FLOP for the flash forward and ``10 hd B H
open_pairs`` for its backward, ``2 m n D`` for the dense mix, ``2 m k D``
for the gather and ``5 n D`` for the bank update.  :func:`bound_ms` is the
least time the H100 could take for ``(bytes, flops)``.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.mesh import HARDWARE

__all__ = ["KernelCost", "CostMode", "kernel", "bound_ms", "open_pairs",
           "flash_forward_cost", "flash_backward_cost", "dense_mix_cost",
           "gather_cost", "update_cost"]

aten = torch.ops.aten


class KernelCost(NamedTuple):
    """What one launch of a kernel must do: FLOP and bytes moved."""

    flops: float
    bytes: float

    def bound_ms(self, flop_per_s: float | None = None) -> tuple[float, str]:
        return bound_ms(self.bytes, self.flops, flop_per_s)


def bound_ms(n_bytes: float, flops: float,
             flop_per_s: float | None = None) -> tuple[float, str]:
    """The least time (ms) the H100 takes to move ``n_bytes`` through HBM
    and do ``flops`` at ``flop_per_s`` (default the f32 peak outside the
    tensor cores), and which of the two bounds it: ``"bytes"`` or
    ``"operations"``."""
    rate = HARDWARE["peak_flops_f32"] if flop_per_s is None else flop_per_s
    t_bytes = n_bytes / HARDWARE["hbm_bw"] * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def open_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs that the causal and window masks leave open, per
    (batch, head): the pairs the attention needs on these inputs.  The
    window closes keys with ``q - k >= window``."""
    if not window or window >= s:
        return s * (s + 1) // 2 if causal else s * s
    w = window
    if causal:  # row i: min(i + 1, w) keys
        return w * (w + 1) // 2 + (s - w) * w
    # row i: the keys from max(0, i - w + 1) to the end
    return s * s - (s - w) * (s - w + 1) // 2


def flash_forward_cost(b: int, h: int, kv: int, s: int, hd: int,
                       causal: bool, window: int, itemsize: int,
                       lse: bool = False) -> KernelCost:
    """The flash forward: q, k, v read, o written (and the rows' f32
    logsumexp with ``lse``); 4 hd FLOP an open pair a query head."""
    n_bytes = itemsize * (2 * b * h + 2 * b * kv) * s * hd
    if lse:
        n_bytes += 4 * b * h * s
    return KernelCost(4.0 * hd * b * h * open_pairs(s, causal, window),
                      float(n_bytes))


def flash_backward_cost(b: int, h: int, kv: int, s: int, hd: int,
                        causal: bool, window: int, itemsize: int,
                        lse: bool = False) -> KernelCost:
    """The flash backward: q, o, dO and k, v read, dq, dk, dv written (and
    the forward's logsumexp read where given); 10 hd FLOP an open pair a
    query head."""
    n_bytes = itemsize * (4 * b * h + 4 * b * kv) * s * hd
    if lse:
        n_bytes += 4 * b * h * s
    return KernelCost(10.0 * hd * b * h * open_pairs(s, causal, window),
                      float(n_bytes))


def dense_mix_cost(m: int, n: int, d: int, itemsize: int) -> KernelCost:
    """Y = P X with P (m, n) f32 and X (n, D): P and X read, Y written."""
    return KernelCost(2.0 * m * n * d, 4.0 * m * n + itemsize * (n + m) * d)


def gather_cost(m: int, n: int, k: int, d: int, itemsize: int) -> KernelCost:
    """m receivers of k slots each over X (n, D): X read, Y (m, D) written,
    the int32 indices and f32 weights read."""
    return KernelCost(2.0 * m * k * d, itemsize * (n + m) * d + 8.0 * m * k)


def update_cost(n: int, d: int, itemsize: int) -> KernelCost:
    """The bank update: X, G read and X', Z' written in the bank's dtype,
    V read and V' written in f32, w read; 5 FLOP an element."""
    return KernelCost(5.0 * n * d, (4.0 * itemsize + 8.0) * n * d + 4.0 * n)


# Collective ops -> their kind in ``roofline.analysis``'s terms.
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allreduce_": "all-reduce",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute"}
# The process-group calls whose first argument is what they count (the
# operand, or the preallocated output); the functional ops count their
# output, and ``alltoall_base_`` its input (its second argument).
_FIRST_ARG = {"allreduce_", "send", "allgather_", "_allgather_base_",
              "reduce_scatter_", "_reduce_scatter_base_",
              "allgather_into_tensor_coalesced_"}
_COUNTED_NAMESPACES = ("_c10d_functional", "c10d")
# Communication ops, counted as collectives or not at all: the autograd
# wrappers reach the mode as the functional ops they call.
_COMM_NAMESPACES = _COUNTED_NAMESPACES + ("_c10d_functional_autograd",)
# The functional collectives' wrappers of an output already allocated: on
# a device they hold their input's memory; on meta they come back as new
# tensors.  Either way they share their input's allocation, which lives
# while any of them does.
_WRAPPERS = {"_wrap_tensor_autograd", "wait_tensor"}


def _collective_bytes(name: str, args, out) -> int:
    if name == "alltoall_base_":
        return _unique_bytes(_tensors(args[1]))
    if name in _FIRST_ARG:
        return sum(_nbytes(t) for t in _tensors(args[0]))
    return sum(_nbytes(t) for t in _tensors(out))


def _faking() -> bool:
    """Whether a ``FakeTensorMode`` is running (DTensor's sharding
    propagation makes its outputs' shapes with one)."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


# Modes counting right now, innermost last: a kernel wrapper records into
# each of them.
_ACTIVE: list = []


@contextlib.contextmanager
def kernel(name: str, cost):
    """Run a kernel wrapper's body as one record under ``name`` in every
    counting :class:`CostMode`, of ``cost()`` (a :class:`KernelCost`,
    computed once the body has returned); the aten ops inside are not
    counted.  Without a counting mode it does nothing."""
    modes = list(_ACTIVE)
    for m in modes:
        m._inside += 1
    try:
        yield
    finally:
        for m in modes:
            m._inside -= 1
    if modes:
        c = cost()
        for m in modes:
            m._record(name, c)


# Allocate only: no byte is read or written.
_FREE = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
         aten.new_empty_strided, aten._unsafe_view, aten._reshape_alias,
         aten.lift_fresh, aten.resize_, aten.set_, aten.sym_size,
         aten.sym_stride, aten.sym_numel, aten.sym_storage_offset,
         aten._local_scalar_dense, aten.is_same_size, aten.record_stream}
# Write their output, read nothing.
_WRITE_ONLY = {aten.zeros, aten.ones, aten.full, aten.arange, aten.zeros_like,
               aten.ones_like, aten.full_like, aten.new_zeros, aten.new_ones,
               aten.new_full, aten.fill_, aten.zero_, aten.scalar_tensor}
# Their last output is a scratch buffer, full size on the CPU and empty on
# CUDA: neither its bytes nor its memory count, so that every device counts
# the same.
_SCRATCH_LAST = {aten.log_sigmoid_forward}
# Read the rows they name (the size of their output), not their source.
_ROWS_READ = {aten.embedding, aten.index_select, aten.gather, aten.index}
# Write the slice their values fill, not their whole destination: (values
# argument, whether the slice is read as well).
_SLICE_WRITE = {aten.index_put_: ("values", None),
                aten._index_put_impl_: ("values", None),
                aten.scatter_: ("src", False), aten.scatter_add_: ("src", True),
                aten.scatter_reduce_: ("src", True),
                aten.index_add_: ("source", True),
                aten.index_copy_: ("source", False)}


def _tensors(tree) -> list:
    """The tensors of nested lists, tuples and dicts (a DTensor's local
    block in its place)."""
    if isinstance(tree, torch.Tensor):
        local = getattr(tree, "_local_tensor", None)
        return [tree if local is None else local]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _unique_bytes(ts) -> int:
    seen, total = set(), 0
    for t in ts:
        if id(t) not in seen:
            seen.add(id(t))
            total += _nbytes(t)
    return total


def _named(func, args, kwargs, name: str):
    """Argument ``name`` of an aten call, positional or keyword."""
    if name in kwargs:
        return kwargs[name]
    for i, a in enumerate(func._schema.arguments):
        if a.name == name:
            return args[i] if i < len(args) else None
    return None


def op_bytes(func, args, kwargs, out) -> int:
    """Bytes one aten op moves under the module's rules."""
    packet = func.overloadpacket
    if func.is_view or packet in _FREE:
        return 0
    if packet is aten.log_sigmoid_backward:  # its buffer is scratch
        return _unique_bytes(args[:2]) + _unique_bytes(_tensors(out))
    outs = _tensors(out)
    if packet in _WRITE_ONLY:
        return _unique_bytes(outs)
    if packet is aten.copy_:
        return _nbytes(args[0]) + _nbytes(args[1])
    if packet in _ROWS_READ:
        idx = [t for t in _tensors((args[1:], kwargs)) if not t.is_floating_point()]
        return 2 * _unique_bytes(outs) + _unique_bytes(idx)
    if packet in _SLICE_WRITE:
        name, reads = _SLICE_WRITE[packet]
        vals = _named(func, args, kwargs, name)
        idx = [t for t in _tensors((args[1:], kwargs))
               if not t.is_floating_point() and t is not vals]
        if reads is None:  # index_put_: the slice is read when accumulating
            reads = bool(_named(func, args, kwargs, "accumulate"))
        v = _nbytes(vals) if isinstance(vals, torch.Tensor) else 0
        return (2 + reads) * v + _unique_bytes(idx)
    return _unique_bytes(_tensors((args, kwargs))) + _unique_bytes(outs)


class CostMode(TorchDispatchMode):
    """Counts the FLOPs, bytes, peak live bytes, kernel records and
    collectives of what runs inside it (see the module docstring).
    ``args`` are the step's arguments, resident before it runs: their
    bytes are the peak's base, and their storages are not counted again
    when an op writes into them in place.  Read the totals with
    :meth:`result` after the block."""

    def __init__(self, args=()):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode

        from repro_torch.roofline.analysis import CollectiveStats

        self._formulas = FlopCounterMode(display=False).flop_registry
        self.collectives = CollectiveStats()
        self._args = {}
        for t in _tensors(args):
            st = t.untyped_storage()
            self._args[id(st)] = st
        self.argument_bytes = sum(st.nbytes() for st in self._args.values())
        self.aten_flops = 0.0
        self.aten_bytes = 0.0
        self.aten_ops = 0
        self.kernels: dict = {}
        self._inside = 0
        self._live: dict = {}
        self._now = 0
        self.temp_bytes = 0  # high-water mark of the step's allocations

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def _record(self, name: str, cost: KernelCost) -> None:
        rec = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                             "bytes": 0.0})
        rec["launches"] += 1
        rec["flops"] += cost.flops
        rec["bytes"] += cost.bytes

    def _freed(self, key: int) -> None:
        alloc = self._live.pop(key)  # [bytes, live storages sharing them]
        alloc[1] -= 1
        if not alloc[1]:
            self._now -= alloc[0]

    def _track(self, out, share=None) -> None:
        """Count each new storage of ``out`` as an allocation, or with
        ``share`` (a storage) as one more holder of that storage's."""
        alloc = self._live.get(id(share)) if share is not None else None
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._args or key in self._live:
                continue
            if share is not None and alloc is None:
                continue  # an argument's, or uncounted
            if alloc is None:
                self._live[key] = [st.nbytes(), 1]
                self._now += st.nbytes()
                self.temp_bytes = max(self.temp_bytes, self._now)
            else:
                alloc[1] += 1
                self._live[key] = alloc
            weakref.finalize(st, self._freed, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        subs = [t for t in types if t is not torch.Tensor]
        fake = _faking() or any(t.__name__ == "FakeTensor" for t in subs)
        if subs and not fake:
            # A tensor subclass (DTensor, a collective's async result)
            # lowers to plain ops first, which come back here.
            return NotImplemented
        if fake:
            # The fake tensors of DTensor's sharding propagation (whole
            # shapes, once per cached signature): not the step's work.
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        made = out[0] if func.overloadpacket in _SCRATCH_LAST else out
        if func.namespace in _COMM_NAMESPACES:
            kind = COLLECTIVE_KINDS.get(func._opname)
            if kind is not None and func.namespace in _COUNTED_NAMESPACES:
                self.collectives.add(
                    kind, _collective_bytes(func._opname, args, out))
        elif not self._inside:
            formula = self._formulas.get(func.overloadpacket)
            if formula is not None:
                self.aten_flops += formula(*args, **kwargs, out_val=out)
            self.aten_bytes += op_bytes(func, args, kwargs, made)
            self.aten_ops += 1
        wrapped = (func.namespace in _COMM_NAMESPACES
                   and func._opname in _WRAPPERS)
        self._track(made, args[0].untyped_storage() if wrapped else None)
        return out

    def result(self, outputs=()) -> dict:
        """The totals: ``flops`` and ``bytes accessed`` (aten ops and kernel
        records), each part, the kernel records by name, the
        ``collectives`` (``{"bytes": ..., "count": ...}`` by kind), and the
        memory:
        ``argument`` bytes, ``temp`` (the high-water mark of the step's
        allocations), ``output`` (``outputs``' storages the step allocated,
        still live), ``alias`` (``outputs``' storages that are arguments,
        updated in place) and ``peak_estimate`` = argument + temp."""
        k_flops = sum(r["flops"] for r in self.kernels.values())
        k_bytes = sum(r["bytes"] for r in self.kernels.values())
        out_st = {id(t.untyped_storage()): t.untyped_storage()
                  for t in _tensors(outputs)}
        return {
            "flops": self.aten_flops + k_flops,
            "bytes accessed": self.aten_bytes + k_bytes,
            "aten_flops": self.aten_flops,
            "aten_bytes": self.aten_bytes,
            "aten_ops": self.aten_ops,
            "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())},
            "collectives": {
                "bytes": dict(self.collectives.bytes_by_kind),
                "count": dict(self.collectives.count_by_kind)},
            "memory": {
                "argument": self.argument_bytes,
                "output": sum(st.nbytes() for k, st in out_st.items()
                              if k not in self._args),
                "temp": self.temp_bytes,
                "alias": sum(st.nbytes() for k, st in out_st.items()
                             if k in self._args),
                "peak_estimate": self.argument_bytes + self.temp_bytes,
            },
        }
