"""Runtime sync-sentinel for the port: count *actual* device→host
transfers.

The SYNC rules are static claims; this harness is the runtime witness.
Inside a ``with SyncSentinel() as s:`` block it patches torch's and the
executor's device→host transfer points:

* ``repro_torch.core.executor.Fence.wait`` — the *explicit, sanctioned*
  sync of the executors' phase B.  The executors add one to
  ``ExecStats.num_syncs`` per wait, so ``s.explicit_syncs`` must equal
  the reported ``num_syncs`` (counted on the CPU too, where a fence has
  nothing to wait for).
* the implicit materializers on ``torch.Tensor``: ``item``, ``tolist``,
  ``cpu``, ``numpy``, ``__array__`` (``np.asarray`` of a tensor goes
  through it), ``__int__``, ``__float__``, ``__bool__``, ``__index__``
  and ``to`` with a CPU target.  A read of a CUDA tensor **blocks** when
  the device's current stream has not drained just before it
  (``torch.cuda.current_stream(dev).query()`` is false): that is a hidden
  host sync, and ``blocking_reads`` must stay 0 on the pipelined path.
  Its host time is summed in ``blocked_seconds``.
* the pinned host tensors a dispatch stages (``core.engine.
  _stage_to_host``, through ``executor.watch_staged``): a read of one
  before a fence recorded after its copy has been waited on is an
  **unfenced read** — on the card a data race that can return stale
  bytes, not a stall; ``unfenced_reads`` must stay 0.  A read after the
  fence is a ready read.
* ``torch.cuda.synchronize``, ``torch.cuda.Event.synchronize`` and
  ``torch.cuda.Stream.synchronize`` outside ``Fence.wait``:
  ``other_syncs``, which must stay 0.
* ATen's own host syncs (a pageable upload, ``nonzero``, a blocking
  copy): ``torch.cuda.set_sync_debug_mode("warn")`` makes each one warn,
  and every warning is counted (``aten_syncs``) with its source line and
  the dispatch group it ran in.

Reads and ATen syncs are attributed to the calling thread's dispatch
group (``repro_torch.core.executor.current_group_label``); the ``None``
key collects those outside any group.

Usage::

    with SyncSentinel() as s:
        rs, stats = backend.run(queries, d, plan)
    rep = s.report()
    assert rep.blocking_reads == rep.unfenced_reads == 0
    assert rep.explicit_syncs == stats.num_syncs <= 2 * stats.num_groups

The patches are process-global while the context is active; the counters
sit under a lock, since the broker and the scheduler read from several
threads.  ``watch`` names the device types whose tensors count as device
tensors (``("cuda",)``; a CPU rehearsal passes ``("cpu",)`` and stubs
``torch.cuda.current_stream``).  ``sync_debug`` (default: whether CUDA is
available) turns on the sync-debug warnings; on CUDA the sentinel raises
when torch has no ``set_sync_debug_mode`` instead of counting nothing.
"""
from __future__ import annotations

import dataclasses
import sys
import threading
import time
import warnings

import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.core import executor as _executor
from repro_torch.core.executor import current_group_label

#: the message of torch's sync-debug warning
SYNC_WARNING = "called a synchronizing CUDA operation"


@dataclasses.dataclass
class SentinelReport:
    """What actually crossed the device→host boundary."""

    explicit_syncs: int          # Fence.wait calls (sanctioned)
    blocking_reads: int          # device-tensor reads that had to wait
    ready_reads: int             # reads of finished tensors / fenced copies
    by_kind: dict                # interception point -> count
    #: dispatch-group label → blocking reads inside that group's scope
    #: (``None``: outside any group) — the "who stalled the pipeline" view
    blocking_by_group: dict = dataclasses.field(default_factory=dict)
    #: reads of staged pinned copies before their fence had been waited on
    unfenced_reads: int = 0
    unfenced_by_group: dict = dataclasses.field(default_factory=dict)
    #: CUDA synchronize calls outside Fence.wait
    other_syncs: int = 0
    #: torch's sync-debug warnings: total, by group, by "file:line"
    aten_syncs: int = 0
    aten_by_group: dict = dataclasses.field(default_factory=dict)
    aten_sites: dict = dataclasses.field(default_factory=dict)
    #: host seconds spent inside the reads that blocked
    blocked_seconds: float = 0.0

    @property
    def total_syncs(self) -> int:
        """Host stalls: sanctioned syncs + hidden blocking reads."""
        return self.explicit_syncs + self.blocking_reads

    def to_json(self) -> dict:
        out = dataclasses.asdict(self)
        out["total_syncs"] = self.total_syncs
        for key in ("blocking_by_group", "unfenced_by_group",
                    "aten_by_group"):
            out[key] = {str(k): v for k, v in out[key].items()}
        return out


def _is_cpu(target) -> bool:
    if isinstance(target, torch.Tensor):
        return target.device.type == "cpu"
    if isinstance(target, (str, torch.device)):
        try:
            return torch.device(target).type == "cpu"
        except RuntimeError:
            return False
    return False


class SyncSentinel:
    """Context manager that instruments the port's device→host boundary."""

    #: methods patched on ``torch.Tensor``
    _METHODS = ("item", "tolist", "cpu", "numpy", "__array__", "__int__",
                "__float__", "__bool__", "__index__")

    def __init__(self, *, watch=("cuda",), sync_debug: bool | None = None):
        self.watch = frozenset(watch)
        self.sync_debug = (torch.cuda.is_available() if sync_debug is None
                           else bool(sync_debug))
        self._rep = SentinelReport(0, 0, 0, {})
        self._lock = threading.Lock()
        self._local = threading.local()       # in_read / in_fence flags
        #: staged host tensor -> (stage sequence number, device, event)
        self._staged = WeakIdKeyDictionary()
        self._seq = 0
        #: device -> highest stage sequence number a waited fence covers
        self._horizon: dict = {}
        self._devices: set = set()            # devices that staged copies
        self._saved: list = []
        self._prev_mode = None
        self._warn_ctx = None
        self._show = None

    # -- bookkeeping ---------------------------------------------------
    def _bump(self, kind: str) -> None:
        self._rep.by_kind[kind] = self._rep.by_kind.get(kind, 0) + 1

    @staticmethod
    def _bump_group(table: dict) -> None:
        label = current_group_label()
        table[label] = table.get(label, 0) + 1

    def _flag(self, name: str) -> bool:
        return getattr(self._local, name, False)

    def _stage(self, tensors, device) -> None:
        """``executor.watch_staged``'s hook: number the staged copies and
        record an event behind them."""
        event = None
        if device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
        with self._lock:
            self._seq += 1
            self._devices.add(device)
            for t in tensors:
                self._staged[t] = (self._seq, device, event)

    def _advance(self, device, upto: int) -> None:
        with self._lock:
            if upto > self._horizon.get(device, 0):
                self._horizon[device] = upto

    # -- reads ---------------------------------------------------------
    def _read(self, kind: str, tensor, call):
        """Run ``call()`` (one user-level read of ``tensor``), classifying
        and counting it."""
        if self._flag("in_read"):
            return call()
        staged = self._staged.get(tensor)
        device_read = staged is None and tensor.device.type in self.watch
        if staged is None and not device_read:
            return call()
        ready = True
        if device_read:
            ready = bool(torch.cuda.current_stream(tensor.device).query())
        self._local.in_read = True
        t0 = time.perf_counter()
        try:
            return call()
        finally:
            dt = time.perf_counter() - t0
            self._local.in_read = False
            with self._lock:
                self._bump(kind)
                if staged is not None:
                    seq, dev, event = staged
                    if seq <= self._horizon.get(dev, 0):
                        self._rep.ready_reads += 1
                    else:
                        self._rep.unfenced_reads += 1
                        self._bump_group(self._rep.unfenced_by_group)
                        if event is not None and not event.query():
                            self._bump("unfenced:copy_incomplete")
                elif ready:
                    self._rep.ready_reads += 1
                else:
                    self._rep.blocking_reads += 1
                    self._rep.blocked_seconds += dt
                    self._bump_group(self._rep.blocking_by_group)

    def _sync(self, kind: str, call, drains: bool):
        """Count an unsanctioned synchronize; one that drains the stream
        (``torch.cuda.synchronize``, ``Stream.synchronize``) also fences
        every copy staged before it."""
        if self._flag("in_fence"):
            return call()
        with self._lock:
            self._rep.other_syncs += 1
            self._bump(kind)
            upto, devices = self._seq, set(self._devices)
        out = call()
        if drains:
            for dev in devices:
                self._advance(dev, upto)
        return out

    def _on_warning(self, message, category, filename, lineno, file=None,
                    line=None):
        if SYNC_WARNING not in str(message):
            return self._show(message, category, filename, lineno, file,
                              line)
        if filename == __file__:
            # raised inside one of the patched methods: the site is the
            # first caller outside this module and ``warnings``
            frame = sys._getframe(1)
            while frame is not None and frame.f_code.co_filename in (
                    __file__, warnings.__file__):
                frame = frame.f_back
            if frame is not None:
                filename, lineno = frame.f_code.co_filename, frame.f_lineno
        with self._lock:
            self._rep.aten_syncs += 1
            self._bump_group(self._rep.aten_by_group)
            site = f"{filename}:{lineno}"
            self._rep.aten_sites[site] = self._rep.aten_sites.get(site, 0) + 1
        return None

    # -- patching ------------------------------------------------------
    def _patch(self, owner, name: str, new) -> None:
        own = name in vars(owner)
        self._saved.append((owner, name, vars(owner).get(name), own))
        setattr(owner, name, new)

    def __enter__(self) -> "SyncSentinel":
        sentinel = self
        if self.sync_debug:
            if not hasattr(torch.cuda, "set_sync_debug_mode"):
                raise RuntimeError("torch.cuda.set_sync_debug_mode is "
                                   "missing: ATen's host syncs would go "
                                   "uncounted")
            self._prev_mode = torch.cuda.get_sync_debug_mode()
        try:
            self._install(sentinel)
        except BaseException:
            self.__exit__(None, None, None)
            raise
        return self

    def _install(self, sentinel) -> None:
        fence_cls = _executor.Fence
        fence_init, fence_wait = fence_cls.__init__, fence_cls.wait

        def init(fence, device, _orig=fence_init):
            # number taken before the event is recorded: the fence covers
            # only copies staged (on any thread) before its event
            with sentinel._lock:
                upto = sentinel._seq
            _orig(fence, device)
            fence._sentinel_upto = (device, upto)

        def wait(fence, _orig=fence_wait):
            with sentinel._lock:
                sentinel._rep.explicit_syncs += 1
                sentinel._bump("Fence.wait")
            sentinel._local.in_fence = True
            try:
                _orig(fence)
            finally:
                sentinel._local.in_fence = False
            mark = getattr(fence, "_sentinel_upto", None)
            if mark is not None:
                sentinel._advance(*mark)

        self._patch(fence_cls, "__init__", init)
        self._patch(fence_cls, "wait", wait)

        for name in self._METHODS:
            orig = getattr(torch.Tensor, name)

            def method(t, *args, _orig=orig, _name=name, **kwargs):
                return sentinel._read(
                    _name, t, lambda: _orig(t, *args, **kwargs))
            self._patch(torch.Tensor, name, method)

        orig_to = torch.Tensor.to

        def to(t, *args, **kwargs):
            target = kwargs.get("device", args[0] if args else None)
            if not _is_cpu(target) or t.device.type not in sentinel.watch:
                return orig_to(t, *args, **kwargs)
            # to(device, dtype, non_blocking) / to(other, non_blocking)
            pos = 2 if isinstance(target, (str, torch.device)) else 1
            if kwargs.get("non_blocking",
                          len(args) > pos and args[pos] is True):
                out = orig_to(t, *args, **kwargs)
                sentinel._stage([out], t.device)      # pending until fenced
                return out
            return sentinel._read("to", t,
                                  lambda: orig_to(t, *args, **kwargs))
        self._patch(torch.Tensor, "to", to)

        orig_sync = torch.cuda.synchronize

        def synchronize(device=None):
            return sentinel._sync("torch.cuda.synchronize",
                                  lambda: orig_sync(device), True)
        self._patch(torch.cuda, "synchronize", synchronize)
        for cls, kind, drains in (
                (torch.cuda.Event, "Event.synchronize", False),
                (torch.cuda.Stream, "Stream.synchronize", True)):
            orig = cls.synchronize

            def obj_sync(obj, _orig=orig, _kind=kind, _drains=drains):
                return sentinel._sync(_kind, lambda: _orig(obj), _drains)
            self._patch(cls, "synchronize", obj_sync)

        self._patch(_executor, "_staging_hook", self._stage)

        if self.sync_debug:
            self._warn_ctx = warnings.catch_warnings()
            self._warn_ctx.__enter__()
            # every sync warns, not just the first at each source line
            warnings.filterwarnings("always", message=f".*{SYNC_WARNING}")
            self._show = warnings.showwarning
            warnings.showwarning = self._on_warning
            torch.cuda.set_sync_debug_mode("warn")

    def __exit__(self, exc_type, exc, tb):
        if self.sync_debug and self._prev_mode is not None:
            torch.cuda.set_sync_debug_mode(self._prev_mode)
            self._prev_mode = None
        if self._warn_ctx is not None:
            self._warn_ctx.__exit__(None, None, None)
            self._warn_ctx = None
        while self._saved:
            owner, name, orig, own = self._saved.pop()
            if own:
                setattr(owner, name, orig)
            else:
                delattr(owner, name)
        return False

    # ------------------------------------------------------------------
    def report(self) -> SentinelReport:
        with self._lock:
            return dataclasses.replace(
                self._rep, by_kind=dict(self._rep.by_kind),
                blocking_by_group=dict(self._rep.blocking_by_group),
                unfenced_by_group=dict(self._rep.unfenced_by_group),
                aten_by_group=dict(self._rep.aten_by_group),
                aten_sites=dict(self._rep.aten_sites))


__all__ = ["SYNC_WARNING", "SentinelReport", "SyncSentinel"]
