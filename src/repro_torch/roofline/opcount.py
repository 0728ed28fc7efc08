"""Costs of the ops the port really runs: the counterpart of the
reference's ``repro/roofline/hloparse.py``.

The reference compiles a step with XLA and parses the HLO text: it scales
every instruction by the trip counts of the ``while`` loops a
``lax.scan`` lowers to, and counts dots and convolutions as FLOPs, the
operand and output bytes of every top-level instruction as HBM traffic
(fusion bodies free) and the operand bytes of each collective.  The port
runs eagerly and makes no HLO, so there is nothing to parse: a
:class:`CostCounter` (a ``TorchDispatchMode``) sees every ATen op as it
runs and counts the same three quantities from the op's tensors:

* FLOPs: 2·|out|·contraction for ``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  the convolutions and their backward ops (the shapes from
  ``torch.utils.flop_counter``'s formulas), by the operands' dtype
  (``flops_by_dtype``: this card's float32 and bf16 products have
  different peaks).  Elementwise FLOPs are ignored, as in the reference.
* Traffic: the bytes each op reads and writes, each distinct input once
  and each output once; view and metadata ops move nothing
  (:data:`NO_TRAFFIC`, the counterpart of ``_NO_TRAFFIC_OPS``), and an op
  that writes into part of a tensor (``index_copy_``, ``index_put_``,
  ``scatter_``, ``copy_`` into a slice) counts what it reads and the part
  it writes, not the whole destination.  Eager PyTorch fuses nothing, so
  this is the traffic the port makes, where the reference counts a
  fusion's inputs and outputs only.
* Collectives: ``c10d`` and ``_c10d_functional`` ops by the reference's
  five kinds, by operand bytes.

Loops need no trip counts: an eager loop runs its body as many times as
it is counted, and a remat recompute is counted where it runs (the
backward), as the reference's HLO holds it.  The backward runs wherever
autograd runs it: on a CUDA device it is the engine's own thread, which
inherits the forward thread's dispatch modes, so the counter sees it
there too.

The hand-written kernels launch through ctypes and no dispatch mode sees
them: each wrapper runs under :func:`declare`, which charges the
kernel's cost (``roofline.kernels``) and hides the ops inside it, so the
plain version on the CPU, the kernel on the card and the empty outputs on
the ``meta`` device give one count.

On a ``DTensor`` mesh the counter sees each DTensor op once, at its
global shape, and the redistributions the caller asks for
(``redistribute``, ``full_tensor``) as functional collectives; those
DTensor makes inside an op's own dispatch run below the mode and are not
seen.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from collections import defaultdict

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.analysis import _COLLECTIVES, dtype_name

aten = torch.ops.aten

#: The products whose FLOPs are counted (``hloparse``'s dots and convs;
#: the backend convolutions run below ``convolution``, unseen).
FLOP_OPS = frozenset({aten.mm, aten.addmm, aten.bmm, aten.baddbmm,
                      aten.convolution, aten.convolution_backward})
_CONV_OPS = frozenset({aten.convolution, aten.convolution_backward})

#: Ops that move no bytes besides the views (every op whose schema makes
#: its outputs aliases: ``view``, ``expand``, ``t``, ``transpose``,
#: ``slice``, ``select``, ``as_strided``, ``detach`` ...): a view made
#: without the schema's alias, allocations of uninitialised memory, and
#: the bookkeeping of collectives.
NO_TRAFFIC = frozenset({
    "_unsafe_view", "detach_", "empty", "empty_like", "empty_strided",
    "new_empty", "new_empty_strided", "empty_permuted", "resize_", "set_",
    "record_stream", "wait_tensor", "_wrap_tensor_autograd", "barrier",
    "monitored_barrier_"})

#: In-place ops that write ``self`` without reading it.
_WRITE_ONLY = frozenset({
    "copy_", "fill_", "zero_", "normal_", "uniform_", "random_",
    "bernoulli_", "exponential_", "geometric_", "cauchy_", "log_normal_"})

#: In-place ops that write ``self`` only where an index points; the
#: second group also reads the destination there (it accumulates).
_INDEXED_WRITE = frozenset({"index_copy_", "index_put_", "_index_put_impl_",
                            "scatter_", "masked_scatter_", "put_"})
_INDEXED_ACCUMULATE = frozenset({"index_add_", "scatter_add_",
                                 "scatter_reduce_", "index_reduce_"})
_UPDATE_ARGS = ("source", "src", "values")

#: Collective kind by a fragment of the op's name (checked in order).
_COLLECTIVE_NAMES = (("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
                     ("reduce_scatter", "reduce-scatter"),
                     ("all_gather", "all-gather"), ("allgather", "all-gather"),
                     ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                     ("broadcast", "collective-permute"),
                     ("send", "collective-permute"),
                     ("recv", "collective-permute"))
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")

#: Counters entered anywhere in this process; :func:`declare` looks no
#: further when it is empty.
_ACTIVE: list = []


@dataclasses.dataclass
class Costs:
    """What a :class:`CostCounter` counted (``hloparse.HloCosts``'s
    fields, plus ``flops_by_dtype`` and the ``kernels`` declared: name →
    calls, FLOPs, bytes)."""
    flops: float
    traffic_bytes: float
    collective_bytes: dict
    warnings: list
    flops_by_dtype: dict = dataclasses.field(default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of the memory ``t`` spans once: a broadcast (stride-0)
    dimension is read once, not once per index."""
    n = math.prod(size for size, stride in zip(t.shape, t.stride())
                  if stride != 0)
    return n * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _unique(ts) -> list:
    seen, out = set(), []
    for t in ts:
        if id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


def _named_args(func, args, kwargs) -> list:
    """(schema argument, value) for every argument given."""
    schema = func._schema.arguments
    pairs = list(zip(schema, args))
    by_name = {a.name: a for a in schema}
    pairs += [(by_name[k], v) for k, v in kwargs.items() if k in by_name]
    return pairs


def _flops_dtype(func, tensor: torch.Tensor) -> str:
    """The key of ``analysis.PEAKS`` a product of ``tensor``'s dtype runs
    at: float32 products on a CUDA device run as TF32 where PyTorch lets
    them."""
    name = dtype_name(tensor.dtype)
    if name == "float32" and tensor.device.type == "cuda":
        packet = func.overloadpacket
        if packet in _CONV_OPS:
            tf32 = torch.backends.cudnn.allow_tf32
        else:
            tf32 = torch.get_float32_matmul_precision() != "highest"
        if tf32:
            return "tf32"
    return name


def _collective_kind(func) -> str | None:
    name = func.overloadpacket.__name__
    return next((kind for frag, kind in _COLLECTIVE_NAMES if frag in name),
                None)


class CostCounter(TorchDispatchMode):
    """Counts the FLOPs, traffic and collective bytes of the ops run under
    it (``with CostCounter() as c: ...; c.costs()``), and the costs the
    kernel wrappers :func:`declare`."""

    def __init__(self):
        super().__init__()
        self._flops = defaultdict(float)
        self._traffic = 0.0
        self._coll = dict.fromkeys(_COLLECTIVES, 0.0)
        self._warnings: list[str] = []
        self._kernels: dict[str, dict] = {}
        self._lock = threading.Lock()
        self._thread = threading.local()

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not getattr(self._thread, "hidden", 0):
            self._count(func, args, kwargs, out)
        return out

    # ------------------------------------------------------------------
    def _count(self, func, args, kwargs, out) -> None:
        packet = func.overloadpacket
        name = packet.__name__
        flops = dtype = None
        if packet in FLOP_OPS:
            flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
            dtype = _flops_dtype(func, _tensors(args)[0])
        kind = None
        if func.namespace in _COLLECTIVE_NAMESPACES:
            kind = _collective_kind(func)
        traffic = 0 if name in NO_TRAFFIC or func.is_view else \
            self._traffic_of(func, name, args, kwargs, out)
        with self._lock:
            if flops is not None:
                self._flops[dtype] += flops
            self._traffic += traffic
            if kind is not None:
                self._coll[kind] += self._operand_bytes(func, args, kwargs)
            elif (func.namespace in _COLLECTIVE_NAMESPACES
                  and name not in NO_TRAFFIC):
                self._warn(f"{func}: not one of the five collective kinds; "
                           f"its bytes are not counted as a collective")

    @staticmethod
    def _traffic_of(func, name: str, args, kwargs, out) -> int:
        named = _named_args(func, args, kwargs)
        # Arguments the op writes: `self` of an in-place op, `out=`.
        written = [v for a, v in named if a.alias_info is not None
                   and a.alias_info.is_write and isinstance(v, torch.Tensor)]
        out_args = {id(v) for a, v in named if a.kwarg_only and
                    a.alias_info is not None and a.alias_info.is_write}
        self_arg = args[0] if args and isinstance(args[0], torch.Tensor) \
            else None
        if name in _INDEXED_WRITE or name in _INDEXED_ACCUMULATE:
            reads = _unique(t for a, v in named if a.name != "self"
                            for t in _tensors(v))
            upd = next((_nbytes(v) for a, v in named
                        if a.name in _UPDATE_ARGS
                        and isinstance(v, torch.Tensor)), None)
            if upd is None:           # a scalar value: one per index
                index = _tensors([v for a, v in named if a.name == "index"])
                upd = sum(i.numel() for i in index) * self_arg.element_size()
            accumulate = name in _INDEXED_ACCUMULATE or any(
                a.name == "accumulate" and v for a, v in named)
            return sum(_nbytes(t) for t in reads) + upd * (2 if accumulate
                                                           else 1)
        skip = set(out_args)
        if name in _WRITE_ONLY and self_arg is not None:
            skip.add(id(self_arg))
        reads = [t for t in _unique(_tensors((args, kwargs)))
                 if id(t) not in skip]
        writes = _unique([*_tensors(out), *written])
        return sum(_nbytes(t) for t in reads) + sum(_nbytes(t)
                                                    for t in writes)

    @staticmethod
    def _operand_bytes(func, args, kwargs) -> int:
        """A collective's operand bytes: its ``input*`` arguments, else
        the tensors it reduces or sends in place."""
        named = _named_args(func, args, kwargs)
        ins = [v for a, v in named if a.name.startswith("input")] or \
            [v for a, v in named if a.name in ("tensors", "tensor", "self")]
        return sum(_nbytes(t) for t in _unique(_tensors(ins)))

    def _warn(self, msg: str) -> None:
        if msg not in self._warnings:
            self._warnings.append(msg)

    # ------------------------------------------------------------------
    def _declare(self, name: str, cost) -> None:
        with self._lock:
            for dt, f in cost.flops.items():
                self._flops[dt] += f
            self._traffic += cost.bytes
            k = self._kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                                "bytes": 0.0})
            k["calls"] += 1
            k["flops"] += cost.total_flops
            k["bytes"] += cost.bytes

    @contextlib.contextmanager
    def _hidden(self):
        """The ops this thread runs inside are not counted."""
        self._thread.hidden = getattr(self._thread, "hidden", 0) + 1
        try:
            yield
        finally:
            self._thread.hidden -= 1

    def costs(self) -> Costs:
        with self._lock:
            coll = dict(self._coll)
            coll["total"] = float(sum(self._coll.values()))
            by_dtype = {k: v for k, v in self._flops.items() if v}
            return Costs(flops=float(sum(by_dtype.values())),
                         traffic_bytes=float(self._traffic),
                         collective_bytes=coll,
                         warnings=list(self._warnings),
                         flops_by_dtype=by_dtype,
                         kernels={k: dict(v)
                                  for k, v in self._kernels.items()})


def count(fn, *args, **kw) -> Costs:
    """The costs of ``fn(*args, **kw)`` (its result is dropped; enter a
    :class:`CostCounter` to keep it)."""
    with CostCounter() as counter:
        fn(*args, **kw)
    return counter.costs()


def _counters() -> list:
    """The counters on this thread's dispatch-mode stack (the autograd
    engine hands a CUDA backward's thread the forward thread's stack; a
    context variable would not follow it there)."""
    if not _ACTIVE:
        return []
    return [m for m in _get_current_dispatch_mode_stack()
            if isinstance(m, CostCounter)]


@contextlib.contextmanager
def declare(name: str, cost):
    """Run a hand-written kernel's wrapper: when a :class:`CostCounter` is
    counting on this thread, charge it ``cost()`` (a zero-argument
    callable giving the kernel's ``roofline.kernels.KernelCost``, called
    only then) and count none of the ops inside.  With no counter it
    costs one check of a module-level list.  Never reads a tensor's
    value."""
    counters = _counters()
    if not counters:
        yield
        return
    work = cost()
    with contextlib.ExitStack() as stack:
        for counter in counters:
            counter._declare(name, work)
            stack.enter_context(counter._hidden())
        yield


__all__ = ["FLOP_OPS", "NO_TRAFFIC", "CostCounter", "Costs", "count",
           "declare"]
