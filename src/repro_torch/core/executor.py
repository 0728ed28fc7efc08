"""Execution layer: dispatcher protocol + the sync / pipelined executors.

The port's counterpart of ``repro/core/executor.py``.  A
:class:`~repro_torch.core.planner.QueryPlan` says *what* to run; this
module runs it through a :class:`BatchDispatcher`:

* ``dispatch(batch, capacity)`` — enqueue the batch's device work and its
  copies back to the host, with no host read, and return a
  :class:`Dispatch` whose ``out`` becomes readable once the device has
  passed a later fence.
* ``count(dp)`` — the exact hit count, read after a fence.
* ``retry_capacity(dp)`` — ``None`` if the buffers held every hit, else
  the (bucketed, ≥ doubled) capacity a re-dispatch needs.
* ``marshal(dp, count)`` — host-side assembly into a ``ResultSet`` part.
* ``tile_stats(dp)`` — (pruned_tiles, num_tiles) of the dispatch.

Host syncs are CUDA events: the executor records one :class:`Fence` on
the current stream after a group's dispatches and waits on it with
``event.synchronize()``; everything the group enqueued before it (kernels
and host copies) is then complete.  ``ExecStats.num_syncs`` counts those
waits — one per batch (+ retries) for :class:`SyncExecutor`, ≤ 2 per
dispatch group for :class:`PipelinedExecutor`.  On the CPU the same fences
are recorded and counted; there is nothing to wait for.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core.batching import QueryBatch
from repro_torch.core.errors import CapacityError
from repro_torch.core.planner import QueryPlan


# ----------------------------------------------------------------------
# Results + stats.
# ----------------------------------------------------------------------
@dataclasses.dataclass
class ResultSet:
    """Flat result arrays: one row per (entry segment, query segment, interval)."""

    entry_idx: np.ndarray    # global index into the sorted database
    entry_traj: np.ndarray   # trajectory id of the entry segment
    entry_seg: np.ndarray    # segment id of the entry segment
    query_idx: np.ndarray    # global index into the sorted query array
    t_enter: np.ndarray
    t_exit: np.ndarray

    def __len__(self) -> int:
        return int(self.entry_idx.shape[0])

    @staticmethod
    def empty() -> "ResultSet":
        zi = np.zeros(0, np.int64)
        zf = np.zeros(0, np.float32)
        return ResultSet(zi, zi.copy(), zi.copy(), zi.copy(), zf, zf.copy())

    @staticmethod
    def concatenate(parts: list["ResultSet"]) -> "ResultSet":
        if not parts:
            return ResultSet.empty()
        return ResultSet(*[np.concatenate([getattr(p, f.name) for p in parts])
                           for f in dataclasses.fields(ResultSet)])

    def sorted_canonical(self) -> "ResultSet":
        """Canonical (entry_idx, query_idx) order — for set comparisons."""
        order = np.lexsort((self.query_idx, self.entry_idx))
        return ResultSet(*[getattr(self, f.name)[order]
                           for f in dataclasses.fields(ResultSet)])


@dataclasses.dataclass
class BatchStats:
    """Per-invocation record (feeds the §8 performance model).

    ``kernel_seconds`` is dispatch + device time of the batch's first
    invocation (sync executor only); ``retry_seconds`` is the wall time of
    overflow re-dispatches.  Pipelined execution reports both as zero per
    batch (see ``ExecStats.sync_seconds``).
    """

    batch_size: int
    num_candidates: int
    num_interactions: int
    num_hits: int
    kernel_seconds: float
    retries: int
    retry_seconds: float = 0.0
    #: kernel tiles the tile-level pruning skipped / total (zero on the
    #: dense path).
    pruned_tiles: int = 0
    num_tiles: int = 0


@dataclasses.dataclass
class ExecStats:
    plan_seconds: float
    total_seconds: float
    batches: list[BatchStats]
    #: host waits on a device fence: one per invocation (+retries) in sync
    #: mode; ≤ 2 per dispatch group in pipelined mode.
    num_syncs: int = 0
    #: pipelined mode only: wall time of the asynchronous dispatches and of
    #: the device waits (summed over dispatch groups).
    dispatch_seconds: float = 0.0
    sync_seconds: float = 0.0
    pipelined: bool = False
    #: dispatch groups the executor processed.
    num_groups: int = 1
    #: interactions the planner's spatial pruning removed before dispatch.
    pruned_interactions: int = 0
    #: degradation-ladder steps taken while producing this result
    #: (filled in by the serving broker; empty on a clean execution).
    degradations: list = dataclasses.field(default_factory=list)

    @property
    def pruned_tiles(self) -> int:
        return sum(b.pruned_tiles for b in self.batches)

    @property
    def total_tiles(self) -> int:
        return sum(b.num_tiles for b in self.batches)

    @property
    def kernel_seconds(self) -> float:
        """First-dispatch device time (+ the pipelined device wait); retry
        time is in :attr:`retry_seconds`."""
        return sum(b.kernel_seconds for b in self.batches) + self.sync_seconds

    @property
    def retry_seconds(self) -> float:
        return sum(b.retry_seconds for b in self.batches)

    @property
    def host_seconds(self) -> float:
        return self.total_seconds - self.kernel_seconds - self.retry_seconds

    @property
    def total_interactions(self) -> int:
        return sum(b.num_interactions for b in self.batches)

    @property
    def total_hits(self) -> int:
        return sum(b.num_hits for b in self.batches)

    @property
    def num_invocations(self) -> int:
        return len(self.batches)

    @property
    def total_retries(self) -> int:
        return sum(b.retries for b in self.batches)


# ----------------------------------------------------------------------
# Dispatcher protocol.
# ----------------------------------------------------------------------
@dataclasses.dataclass
class Dispatch:
    """One in-flight batch dispatch: the batch, its result capacity and
    the outputs (readable after a fence)."""

    batch: QueryBatch
    capacity: int
    out: object
    #: the dispatcher's prepared inputs, for ``redispatch``.
    ctx: object = None


@runtime_checkable
class BatchDispatcher(Protocol):
    """One device-execution strategy, bound to a query set + threshold and
    to a ``device``.

    ``dispatch`` must not read from the device; the other methods are
    only called after the executor has waited on a fence recorded after
    the dispatch.

    Two hooks are optional: ``redispatch(dp, capacity)``, an overflow
    re-dispatch that reuses ``dp.ctx`` (the executors fall back to
    ``dispatch(dp.batch, capacity)``), and ``record_empty(batch)``, told
    of each zero-candidate batch skipped on the host.
    """

    device: torch.device

    def dispatch(self, batch: QueryBatch, capacity: int) -> Dispatch: ...

    def count(self, dp: Dispatch) -> int: ...

    def retry_capacity(self, dp: Dispatch) -> int | None: ...

    def marshal(self, dp: Dispatch, count: int) -> ResultSet | None: ...

    def tile_stats(self, dp: Dispatch) -> tuple[int, int]: ...


class Fence:
    """A point in the device's current stream: :meth:`wait` blocks the
    host until the device has run everything enqueued before it (one CUDA
    event; nothing to wait for on the CPU)."""

    def __init__(self, device: torch.device):
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(device))

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


def _redispatch(dispatcher: BatchDispatcher, dp: Dispatch,
                capacity: int) -> Dispatch:
    """Overflow re-dispatch, reusing prepared inputs when the dispatcher
    supports it."""
    redo = getattr(dispatcher, "redispatch", None)
    if redo is not None:
        return redo(dp, capacity)
    return dispatcher.dispatch(dp.batch, capacity)


def _record_empty(dispatcher: BatchDispatcher, batch: QueryBatch) -> None:
    """Tell the dispatcher a zero-candidate batch was skipped host-side
    (routing ledgers keep an explicit row per planned batch)."""
    fn = getattr(dispatcher, "record_empty", None)
    if fn is not None:
        fn(batch)


def _empty_stats(batch: QueryBatch) -> BatchStats:
    return BatchStats(batch.size, 0, 0, 0, 0.0, 0)


# ----------------------------------------------------------------------
# Executors.
# ----------------------------------------------------------------------
class SyncExecutor:
    """Classic per-batch loop: dispatch → wait → (maybe retry) → next.
    Per-invocation device timings are observable (the §8 perf-model fits
    need them)."""

    pipelined = False

    def __init__(self, dispatcher: BatchDispatcher, *,
                 max_capacity_retries: int = 3):
        self.dispatcher = dispatcher
        self.max_capacity_retries = int(max_capacity_retries)

    def run(self, plan: QueryPlan) -> tuple[ResultSet, ExecStats]:
        t_begin = time.perf_counter()
        disp = self.dispatcher
        nb = plan.num_batches
        groups = plan.groups if plan.groups else (
            [list(range(nb))] if nb else [])
        parts: list[ResultSet] = []
        stats_by_idx: dict[int, BatchStats] = {}
        num_syncs = 0
        for g in groups:
            for i in g:
                batch, capacity = plan.batches[i], plan.capacities[i]
                if batch.num_candidates == 0:
                    _record_empty(disp, batch)
                    stats_by_idx[i] = _empty_stats(batch)
                    continue
                t0 = time.perf_counter()
                dp = disp.dispatch(batch, capacity)
                Fence(disp.device).wait()
                kernel_s = time.perf_counter() - t0
                num_syncs += 1
                count = disp.count(dp)
                retries = 0
                retry_s = 0.0
                while (cap2 := disp.retry_capacity(dp)) is not None:
                    if retries >= self.max_capacity_retries:
                        raise CapacityError(count, dp.capacity,
                                            batch_index=i, retries=retries)
                    t0r = time.perf_counter()
                    dp = _redispatch(disp, dp, cap2)
                    Fence(disp.device).wait()
                    retry_s += time.perf_counter() - t0r
                    num_syncs += 1
                    count = disp.count(dp)
                    retries += 1
                part = disp.marshal(dp, count)
                if part is not None:
                    parts.append(part)
                pt, nt = disp.tile_stats(dp)
                stats_by_idx[i] = BatchStats(
                    batch.size, batch.num_candidates,
                    batch.size * batch.num_candidates, count, kernel_s,
                    retries, retry_s, pruned_tiles=pt, num_tiles=nt)
        total = time.perf_counter() - t_begin
        stats = [stats_by_idx[i] for i in range(nb)]
        return (ResultSet.concatenate(parts),
                ExecStats(plan.plan_seconds, total, stats,
                          num_syncs=num_syncs, pipelined=False,
                          num_groups=max(plan.num_groups, 1),
                          pruned_interactions=plan.pruned_interactions))


class PipelinedExecutor:
    """Two-phase group-wise executor: dispatch everything in a group,
    record a fence, and — after the *next* group has been dispatched —
    wait on it once, read every exact count, re-dispatch only the
    overflowed batches at enlarged capacity and wait once more: ≤ 2 host
    syncs per group.  Marshalling of group k (pure numpy on host copies)
    overlaps device compute of group k+1.
    """

    pipelined = True

    def __init__(self, dispatcher: BatchDispatcher, *,
                 max_capacity_retries: int = 3):
        self.dispatcher = dispatcher
        self.max_capacity_retries = int(max_capacity_retries)

    def run(self, plan: QueryPlan) -> tuple[ResultSet, ExecStats]:
        t_begin = time.perf_counter()
        disp = self.dispatcher
        nb = plan.num_batches
        groups = plan.groups if plan.groups else (
            [list(range(nb))] if nb else [])
        slots: dict[int, Dispatch] = {}
        fences: dict[int, Fence] = {}
        counts: dict[int, int] = {}
        retried: dict[int, float] = {}     # batch idx -> retry wall share
        rounds: dict[int, int] = {}        # batch idx -> overflow retries
        parts: dict[int, ResultSet] = {}
        timing = {"dispatch": 0.0, "sync": 0.0, "syncs": 0}

        def dispatch_group(gi: int, g: list[int]) -> None:
            t0 = time.perf_counter()
            for i in g:
                batch = plan.batches[i]
                if batch.num_candidates == 0:
                    _record_empty(disp, batch)
                    continue
                slots[i] = disp.dispatch(batch, plan.capacities[i])
            fences[gi] = Fence(disp.device)
            timing["dispatch"] += time.perf_counter() - t0

        def finish_group(gi: int, g: list[int]) -> None:
            live = [i for i in g if i in slots]
            if not live:
                return
            t0 = time.perf_counter()
            fences.pop(gi).wait()
            timing["syncs"] += 1
            for i in live:
                counts[i] = disp.count(slots[i])
            # Re-dispatch only overflowed batches; exact counts make one
            # retry sufficient, so the bound only bites on adversarial
            # capacities.
            t_retry = time.perf_counter()
            any_redo = False
            while True:
                redo = []
                for i in live:
                    cap2 = disp.retry_capacity(slots[i])
                    if cap2 is None:
                        continue
                    if rounds.get(i, 0) >= self.max_capacity_retries:
                        raise CapacityError(
                            counts[i], slots[i].capacity, batch_index=i,
                            retries=rounds.get(i, 0))
                    rounds[i] = rounds.get(i, 0) + 1
                    slots[i] = _redispatch(disp, slots[i], cap2)
                    redo.append(i)
                if not redo:
                    break
                any_redo = True
                Fence(disp.device).wait()
                timing["syncs"] += 1
                for i in redo:
                    counts[i] = disp.count(slots[i])
            retry_s = time.perf_counter() - t_retry if any_redo else 0.0
            timing["sync"] += (time.perf_counter() - t0) - retry_s
            grp_redo = [i for i in live if rounds.get(i, 0)]
            for i in grp_redo:
                retried[i] = retry_s / len(grp_redo)
            # Host-side marshalling; the next group's device work is
            # already queued, so this overlaps compute.
            for i in live:
                part = disp.marshal(slots[i], counts[i])
                if part is not None:
                    parts[i] = part

        for gi, g in enumerate(groups):
            dispatch_group(gi, g)
            if gi > 0:
                finish_group(gi - 1, groups[gi - 1])
        if groups:
            finish_group(len(groups) - 1, groups[-1])

        stats = []
        for i, batch in enumerate(plan.batches):
            if batch.num_candidates == 0:
                stats.append(_empty_stats(batch))
                continue
            pt, nt = disp.tile_stats(slots[i])
            stats.append(BatchStats(
                batch.size, batch.num_candidates,
                batch.size * batch.num_candidates, counts.get(i, 0), 0.0,
                rounds.get(i, 0), retried.get(i, 0.0),
                pruned_tiles=pt, num_tiles=nt))
        total = time.perf_counter() - t_begin
        ordered = [parts[i] for i in sorted(parts)]
        return (ResultSet.concatenate(ordered),
                ExecStats(plan.plan_seconds, total, stats,
                          num_syncs=timing["syncs"],
                          dispatch_seconds=timing["dispatch"],
                          sync_seconds=timing["sync"], pipelined=True,
                          num_groups=max(len(groups), 1),
                          pruned_interactions=plan.pruned_interactions))


def make_executor(dispatcher: BatchDispatcher, *, pipeline: bool,
                  max_capacity_retries: int = 3):
    """The executor for ``pipeline=True`` (two-phase, ≤ 2 syncs per group)
    or ``pipeline=False`` (per-batch sync loop with observable timings).
    ``max_capacity_retries`` bounds overflow re-dispatches per batch;
    exceeding it raises :class:`~repro_torch.core.errors.CapacityError`."""
    cls = PipelinedExecutor if pipeline else SyncExecutor
    return cls(dispatcher, max_capacity_retries=max_capacity_retries)


__all__ = [
    "BatchDispatcher", "BatchStats", "Dispatch", "ExecStats", "Fence",
    "PipelinedExecutor", "ResultSet", "SyncExecutor", "make_executor",
]
