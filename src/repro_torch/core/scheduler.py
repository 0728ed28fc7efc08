"""Fault-tolerant batch scheduler: deadlines, re-issue, straggler
mitigation — over *batch groups*.

At thousand-node scale a query batch (or a data-parallel step) can stall on
one slow/failed worker.  The paper's online objective (minimize response
time for an arbitrary query stream, §3) makes stalls directly user-visible,
so the engine's batch queue needs the standard production treatments:

* **batch groups**: the scheduler's unit of work is a *group* of
  consecutive batches, not a single batch.  Each worker call executes its
  group as one sub-plan through the engine's pipelined executor — one
  two-phase dispatch (≤ 2 host syncs) per group — so the O(1)-sync
  property amortizes inside a stream too, instead of degrading back to one
  sync per batch the moment the scheduler is involved.  Group size
  defaults to ≥ 2 batches per call (see :meth:`DeadlineScheduler.groups`).
* **deadline + re-issue**: every group gets a deadline derived from the §8
  performance model's predicted time *summed over the group's batches* × a
  slack factor; a group that misses its deadline is re-issued (to the same
  pool here; to another pod in a real deployment).  Because the engine is
  deterministic and stateless per batch, re-executing a whole group is
  always safe (idempotent).
* **at-least-once with deduplication**: results carry the group id; the
  collector keeps the first completed copy of each group, so a straggler
  finishing after its re-issue is discarded.
* **epoch-stamped state**: the scheduler's queue state (pending/done group
  ids) is trivially checkpointable alongside the engine, so a restarted
  coordinator resumes the remaining groups only.

Execution here uses a thread pool (the stand-in for per-pod executors);
``delay_hook(group_idx, attempt)`` lets tests inject artificial stragglers.
The workers call ``engine.execute`` concurrently on the card's default
stream: each dispatch owns its outputs, pinned host copies and fence, so
concurrent and duplicate executions never share a buffer (the engine's
``execute`` docstring).

Public entry point: ``repro_torch.api.TrajectoryDB.query_stream`` (and the
``repro_torch.serve.TrajectoryQueryService`` shell on top) — callers rarely
build a ``DeadlineScheduler`` directly.  ``ExecutionPolicy.stream_group_size``
sets the group size through the facade.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Callable

from repro_torch import faults
from repro_torch.core.batching import BatchPlan
from repro_torch.core.engine import DistanceThresholdEngine, ResultSet
from repro_torch.core.planner import (DEFAULT_CAPACITY, QueryPlan,
                                      as_query_plan, derive_group_size,
                                      make_groups)
from repro_torch.core.segments import SegmentArray


@dataclasses.dataclass
class SchedulerStats:
    completed: int = 0             #: batches completed (first copy)
    groups: int = 0                #: batch groups formed (worker-call units)
    reissued: int = 0              #: groups re-issued (deadline or failure)
    duplicates_dropped: int = 0    #: late duplicate group completions dropped
    failures: int = 0              #: worker executions that raised
    wall_seconds: float = 0.0
    group_sizes: list = dataclasses.field(default_factory=list)
    #: per-pod routing accounting (the reference fills it for its sharded
    #: backend, which the port does not have yet); ``None`` here.
    routing: object = None

    @property
    def batches_per_call(self) -> float:
        """Mean batches dispatched per worker call — ≥ 2 by default when
        the plan has ≥ 2 batches (the pipelined-stream property)."""
        return (sum(self.group_sizes) / len(self.group_sizes)
                if self.group_sizes else 0.0)


class DeadlineScheduler:
    """Run a plan as deadline-tracked batch *groups* with straggler
    re-issue; each group is one pipelined engine dispatch.

    ``engine`` is anything with the engines' ``execute(queries, d, plan)``
    contract — here the single-device ``DistanceThresholdEngine``."""

    def __init__(self, engine: DistanceThresholdEngine, *,
                 workers: int = 2, slack: float = 4.0,
                 min_deadline: float = 0.05,
                 predict_seconds: Callable | None = None,
                 delay_hook: Callable | None = None,
                 group_size: int | None = None,
                 max_failures: int = 3):
        self.engine = engine
        self.workers = workers
        self.slack = slack
        self.min_deadline = min_deadline
        self.predict_seconds = predict_seconds
        self.delay_hook = delay_hook          # (group_idx, attempt) -> None
        self.group_size = group_size          # None -> auto (>= 2 per call)
        # Bounded *failure* re-issue: a group whose worker raises
        # is re-run like a deadline straggler, at most max_failures
        # executions; the max_failures-th failure propagates to the caller.
        self.max_failures = int(max_failures)
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def groups(self, num_batches: int, batches=None,
               runs=None) -> list[list[int]]:
        """Partition batch indices into worker-call groups.

        ``group_size=None`` auto-sizes so every call carries ≥ 2 batches
        (a lone trailing remainder is folded into the previous group)
        while keeping at least ~2 groups per worker in flight (re-issue
        granularity): ``max(2, ceil(n / (2·workers)))``.  When the plan's
        ``batches`` are supplied, the §8-model hit-volume heuristic
        (``repro_torch.core.planner.derive_group_size`` — marshal time ≈ hit
        volume) can additionally *shrink* auto groups so one worker call
        never marshals more than a group's worth of predicted result rows.
        An explicit ``group_size`` is honored as given, remainder group
        included.  ``runs`` (spatial-pruning split runs — see
        ``QueryPlan.runs``) keeps sibling batches of one query range in
        the same group, so ``on_group`` deliveries stay canonical slices.
        """
        if num_batches <= 0:
            return []
        gs = self.group_size
        auto = gs is None
        if auto:
            gs = max(2, math.ceil(num_batches / (2 * self.workers)))
            if batches is not None:
                model_gs = derive_group_size(batches)
                if model_gs is not None:
                    gs = min(gs, max(model_gs, 2))
        gs = max(1, min(int(gs), num_batches))
        out = make_groups(num_batches, gs, runs=runs)
        if auto and len(out) >= 2 and len(out[-1]) == 1:
            out[-2].extend(out.pop())
        return out

    def _deadline_for(self, batches) -> float:
        """§8 model-derived deadline for a whole group: the predictions sum
        over the group's batches (one pipelined dispatch executes them
        back-to-back), scaled by the slack factor.  Without a predictor
        the floor scales with the group size — a call doing k batches of
        work gets k batches of deadline."""
        if self.predict_seconds is not None:
            predicted = sum(self.predict_seconds(b) for b in batches)
            return max(self.slack * predicted, self.min_deadline)
        return self.min_deadline * max(len(batches), 1)

    def _run_one(self, queries: SegmentArray, d: float, plan: QueryPlan,
                 group_idx: int, group: list[int], attempt: int):
        if self.delay_hook is not None:
            self.delay_hook(group_idx, attempt)
        if faults.armed():
            faults.inject("scheduler.worker", group=group_idx,
                          attempt=attempt)
        sub = plan.subplan(group)
        rs, _ = self.engine.execute(queries, d, sub)
        return group_idx, attempt, rs

    # ------------------------------------------------------------------
    def execute(self, queries: SegmentArray, d: float,
                plan: BatchPlan | QueryPlan, *,
                on_group: Callable | None = None
                ) -> tuple[ResultSet, SchedulerStats]:
        """Run the plan; ``on_group(group_idx, batch_indices, results)``
        fires on the *first* completion of each group (duplicates from
        re-issued stragglers never reach it) — incremental delivery for
        streaming consumers of the scheduler path."""
        t0 = time.perf_counter()
        capacity = getattr(self.engine, "default_capacity", None)
        qplan = as_query_plan(plan, default_capacity=capacity
                              if capacity is not None else DEFAULT_CAPACITY)
        groups = self.groups(qplan.num_batches, qplan.batches,
                             getattr(qplan, "runs", None))
        stats = SchedulerStats(groups=len(groups),
                               group_sizes=[len(g) for g in groups],
                               routing=getattr(self.engine, "stats", None))
        results: dict[int, ResultSet] = {}
        pool = ThreadPoolExecutor(self.workers)
        futures = {}
        deadlines = {}
        attempts = {g: 0 for g in range(len(groups))}
        failed: dict[int, int] = {}
        try:
            for g, group in enumerate(groups):
                fut = pool.submit(self._run_one, queries, d, qplan, g,
                                  group, 0)
                futures[fut] = g
                deadlines[g] = time.perf_counter() + self._deadline_for(
                    [qplan.batches[i] for i in group])
            while len(results) < len(groups):
                done, _ = wait(list(futures), timeout=0.01,
                               return_when=FIRST_COMPLETED)
                now = time.perf_counter()
                # Deliberate syncs, not pipeline leaks: ``done`` holds only
                # *completed* worker futures (the group's device work and
                # marshalling already finished inside engine.execute), so
                # collecting them here is the scheduler's sanctioned
                # group-granular sync — the analogue of the executors'
                # phase B, needed for deadline tracking and re-issue.
                for fut in done:                     # lint: sync-point
                    g_of = futures.pop(fut)
                    try:
                        g, attempt, rs = fut.result()    # lint: sync-point
                    except Exception:
                        # Failed execution: re-issue like a deadline
                        # straggler, bounded by max_failures; the final
                        # failure propagates (structured errors like
                        # CapacityError surface unchanged).
                        with self._lock:
                            have = g_of in results
                        stats.failures += 1
                        if have:
                            stats.duplicates_dropped += 1
                            continue
                        failed[g_of] = failed.get(g_of, 0) + 1
                        if failed[g_of] >= self.max_failures:
                            raise
                        attempts[g_of] += 1
                        stats.reissued += 1
                        deadlines[g_of] = now + self._deadline_for(
                            [qplan.batches[i] for i in groups[g_of]])
                        fut2 = pool.submit(self._run_one, queries, d,
                                           qplan, g_of, groups[g_of],
                                           attempts[g_of])
                        futures[fut2] = g_of
                        continue
                    with self._lock:
                        if g in results:
                            stats.duplicates_dropped += 1
                        else:
                            results[g] = rs
                            stats.completed += len(groups[g])
                            if on_group is not None:
                                on_group(g, list(groups[g]), rs)
                # re-issue groups past deadline that are still incomplete
                pending = {g for g in futures.values()}
                for g in list(pending):
                    if g in results or now <= deadlines.get(g, now + 1):
                        continue
                    attempts[g] += 1
                    stats.reissued += 1
                    deadlines[g] = now + self._deadline_for(
                        [qplan.batches[i] for i in groups[g]])
                    fut = pool.submit(self._run_one, queries, d, qplan, g,
                                      groups[g], attempts[g])
                    futures[fut] = g
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
        ordered = [results[g] for g in range(len(groups))]
        stats.wall_seconds = time.perf_counter() - t0
        return ResultSet.concatenate(ordered), stats
