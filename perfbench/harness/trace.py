"""Spans around the program's layers and the device's trace.

The traced run (``--trace 1``) wraps, from the benchmark's side, the calls
into each layer of the program's query path and records one span per
call, on the host clock and as a ``torch.profiler.record_function`` range
(so that the trace can say what the host was doing while the device
idled):

=========  ===================================================
span       wraps
=========  ===================================================
request    one ``db.query`` call (the harness's loop)
plan       ``core.planner.QueryPlanner.plan``
execute    ``core.executor.{Pipelined,Sync}Executor.run``
dispatch   ``core.engine._QueryBlockDispatcher.dispatch``
sync       ``core.executor.Fence.wait``
marshal    ``core.engine._QueryBlockDispatcher.marshal``
order      ``api.QueryResult.from_result_set`` (the caller's order)
=========  ===================================================

``DeviceTrace`` reads the profiler's events: the device's operations
(kernels, copies, fills) and the host spans above, on the profiler's clock.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import importlib
import inspect
import sys
import time

import numpy as np
import torch

#: nesting depth of each span (a deeper span names a gap first)
DEPTH = {"request": 0, "plan": 1, "execute": 1, "order": 1,
         "dispatch": 2, "sync": 2, "marshal": 2}
PREFIX = "perfbench."


class Spans:
    """Host-clock durations by span name."""

    def __init__(self):
        self.seconds = collections.defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        with torch.profiler.record_function(PREFIX + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.seconds[name].append(time.perf_counter() - t0)

    def total(self, name: str) -> float | None:
        """The span's seconds summed, or None where it never ran."""
        if name not in self.seconds:
            return None
        return float(sum(self.seconds[name]))


#: (span, module, class, method) of each wrapped call
TARGETS = (("plan", "repro_torch.core.planner", "QueryPlanner", "plan"),
           ("execute", "repro_torch.core.executor", "PipelinedExecutor", "run"),
           ("execute", "repro_torch.core.executor", "SyncExecutor", "run"),
           ("dispatch", "repro_torch.core.engine", "_QueryBlockDispatcher",
            "dispatch"),
           ("sync", "repro_torch.core.executor", "Fence", "wait"),
           ("marshal", "repro_torch.core.engine", "_QueryBlockDispatcher",
            "marshal"),
           ("order", "repro_torch.api", "QueryResult", "from_result_set"))


def _resolve(module: str, cls: str, attr: str):
    """(owner, the attribute as the class holds it), or None where the
    program no longer has it."""
    try:
        owner = getattr(importlib.import_module(module), cls, None)
    except ImportError:
        return None
    if owner is None:
        return None
    raw = inspect.getattr_static(owner, attr, None)
    if raw is None or not callable(getattr(owner, attr, None)):
        return None
    return owner, raw


@contextlib.contextmanager
def wrapped(spans: Spans):
    """Install the span wrappers for the duration of the block.  A target
    the program no longer has is left out and named on standard error;
    the metrics that read its span then find nothing to read."""
    saved = []
    for name, module, cls, attr in TARGETS:
        found = _resolve(module, cls, attr)
        if found is None:
            print(f"perfbench: span {name!r} left out: the program has no "
                  f"{module}.{cls}.{attr}", file=sys.stderr)
            continue
        owner, raw = found
        static = isinstance(raw, staticmethod)
        fn = raw.__func__ if static else raw

        def wrapper(*a, _fn=fn, _name=name, **kw):
            with spans.span(_name):
                return _fn(*a, **kw)

        functools.update_wrapper(wrapper, fn)
        own = attr in owner.__dict__
        setattr(owner, attr, staticmethod(wrapper) if static else wrapper)
        saved.append((owner, attr, raw, own))
    try:
        yield spans
    finally:
        for owner, attr, raw, own in reversed(saved):
            if own:
                setattr(owner, attr, raw)
            else:
                delattr(owner, attr)


@dataclasses.dataclass
class DeviceTrace:
    """Device operations and host spans of one profiled window (ns)."""

    ops: list            # (name, start, end) of every device operation
    host: dict           # span name -> (starts, ends) arrays, sorted
    window: tuple        # (start, end): the first request's start to the last's end

    @staticmethod
    def from_profiler(prof) -> "DeviceTrace | None":
        ops, host = [], collections.defaultdict(list)
        cuda = torch.autograd.DeviceType.CUDA
        for e in prof.profiler.kineto_results.events():
            if e.name().startswith(PREFIX):
                # a host span; its copy on the device's timeline is an
                # annotation, not an operation
                if e.device_type() != cuda:
                    host[e.name()[len(PREFIX):]].append(
                        (e.start_ns(), e.start_ns() + e.duration_ns()))
            elif e.device_type() == cuda:
                ops.append((e.name(), e.start_ns(),
                            e.start_ns() + e.duration_ns()))
        requests = host.get("request")
        if not ops or not requests:
            return None
        spans = {}
        for name, iv in host.items():
            iv = np.asarray(sorted(iv), dtype=np.int64)
            spans[name] = (iv[:, 0], iv[:, 1])
        window = (int(spans["request"][0].min()), int(spans["request"][1].max()))
        return DeviceTrace(ops, spans, window)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self) -> np.ndarray:
        """The union of the device's operations inside the window."""
        lo, hi = self.window
        iv = np.asarray([(max(s, lo), min(e, hi)) for _, s, e in self.ops
                         if e > lo and s < hi], dtype=np.int64)
        if len(iv) == 0:
            return np.zeros((0, 2), np.int64)
        iv = iv[np.argsort(iv[:, 0], kind="stable")]
        ends = np.maximum.accumulate(iv[:, 1])
        new = np.ones(len(iv), bool)
        new[1:] = iv[1:, 0] > ends[:-1]
        starts = iv[new, 0]
        last = np.append(np.flatnonzero(new)[1:] - 1, len(iv) - 1)
        return np.stack([starts, ends[last]], axis=1)

    def busy_s(self) -> float:
        b = self.busy_intervals()
        return float((b[:, 1] - b[:, 0]).sum()) * 1e-9

    def device_ops(self, top: int = 10) -> list:
        """The device operations that took most time, summed by name."""
        total = collections.Counter()
        for name, s, e in self.ops:
            total[name] += (e - s) * 1e-9
        return [[n[:160], t] for n, t in total.most_common(top)]

    def time_by_kernel(self, needle: str) -> float:
        return sum((e - s) for n, s, e in self.ops if needle in n) * 1e-9

    def idle_gaps(self, top: int = 10) -> list:
        """Idle time inside the window, summed by the deepest host span
        that covers each gap's middle (``between requests`` where none)."""
        lo, hi = self.window
        b = self.busy_intervals()
        edges = np.concatenate([[lo], b.ravel(), [hi]]).reshape(-1, 2)
        gap_s, gap_e = edges[:, 0], edges[:, 1]
        keep = gap_e > gap_s
        gap_s, gap_e = gap_s[keep], gap_e[keep]
        mid = (gap_s + gap_e) // 2
        label = np.full(len(mid), "between requests", dtype=object)
        depth = np.full(len(mid), -1)
        for name, (starts, ends) in self.host.items():
            j = np.searchsorted(starts, mid, "right") - 1
            inside = (j >= 0) & (ends[np.maximum(j, 0)] >= mid)
            deeper = inside & (DEPTH.get(name, 3) > depth)
            label[deeper] = name
            depth[deeper] = DEPTH.get(name, 3)
        total = collections.Counter()
        for name, s, e in zip(label, gap_s, gap_e):
            total[name] += (e - s) * 1e-9
        return [[n, t] for n, t in total.most_common(top)]
