"""Query planning layer: what to run, at what size, in which order.

The execution stack is split into an explicit **planner / executor**
architecture.  Before it, planning knowledge was smeared across layers:
the batching algorithm lived in ``repro_torch.api`` (policy resolution), the
result-buffer capacity formula in ``repro_torch.core.engine._slices``, and batch
grouping did not exist (the scheduler dispatched one batch per worker
call).  This module owns all of it:

* :func:`bucket_capacity` — the power-of-two capacity ladder that bounds
  the jit-cache size (moved here from ``engine._bucket``; the engine keeps
  an alias).
* :class:`QueryPlan` — the full executable description of one query set:
  the :class:`~repro_torch.core.batching.BatchPlan` (which contiguous query runs
  hit which contiguous candidate ranges), a sized result capacity per
  batch, and *dispatch groups* — contiguous runs of batches that one
  executor phase dispatches together.
* :class:`QueryPlanner` — builds a ``QueryPlan`` from sorted queries: runs
  the batching algorithm, sizes capacities, forms groups.
* :func:`derive_group_size` — §8-model dispatch-group sizing (marshal time
  ≈ hit volume): used whenever ``group_size`` is left ``None``, so the
  "group sizing is manual" knob became a model-driven default while
  explicit sizes stay overrides.

Every executor consumes a ``QueryPlan`` — the single-device engine
(``repro_torch.core.engine``), the sharded mesh backend
(``repro_torch.core.distributed.ShardedEngine``) and the deadline scheduler
(``repro_torch.core.scheduler``, which re-plans each *group* as a sub-plan).
That shared seam is what makes a new execution strategy a dispatcher
implementation instead of a fork of the engine loop — see
``repro_torch.core.executor``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Mapping, Sequence

import numpy as np

from repro_torch.core.batching import (ALGORITHMS, BatchPlan, QueryBatch,
                                       SpatialInteractionCounter)
from repro_torch.core.index import TemporalBinIndex
from repro_torch.core.segments import SegmentArray

#: Spatial-pruning strategies a planner (and ``ExecutionPolicy.pruning``)
#: accepts: ``"spatial"`` trims-and-splits candidate ranges against the
#: per-bin MBR index; ``"hierarchical"`` refines the same pass with the
#: K-box-per-bin level (``TemporalBinIndex.build(kboxes=...)``) — batches
#: are trimmed/split/priced against the per-box MBRs, and the resulting
#: sub-ranges live in the index's *permuted* segment order (see
#: ``TemporalBinIndex.perm``; executors dispatch the permuted packed
#: array and map entry indices back).  ``"none"`` keeps the paper's
#: temporal-only ranges.
PRUNINGS = ("spatial", "hierarchical", "none")

#: Result-capacity bucket granularity (slots).  Capacities are rounded up
#: to ``CAPACITY_GRANULARITY * 2**k`` so retries and differently-sized
#: batches share jit cache entries.
CAPACITY_GRANULARITY = 256

#: Default result-buffer slots per batch (the paper statically allocates
#: |D| slots, §5; we allocate small and retry on exact-count overflow).
DEFAULT_CAPACITY = 4096

#: Predicted hit rows per dispatch group at which marshalling becomes worth
#: overlapping with the next group's device compute (§8.2: marshal time is
#: result-volume × 1/bandwidth; at 16 B/row this is ≈ 1 MiB of results).
AUTO_GROUP_HIT_ROWS = 1 << 16

#: Fallback hit fraction α when no §8-model estimate is available — the
#: order of the paper's scenario hit rates (§7.2), deliberately small so
#: low-volume plans keep the single-group O(1)-sync shape.
AUTO_GROUP_HIT_FRACTION = 0.02


def bucket_capacity(n: int, blk: int = CAPACITY_GRANULARITY) -> int:
    """Round up to blk, then to blk·2^k — bounds the jit-cache size."""
    n = max(n, 1)
    b = blk
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class QueryPlan:
    """Executable plan for one query set: batches + capacities + groups.

    ``groups`` partitions ``range(num_batches)`` into contiguous runs; each
    run is one *dispatch group* — the pipelined executor dispatches a whole
    group asynchronously, then overlaps marshalling it with the next
    group's device compute, and the deadline scheduler hands one group per
    worker call.  A single group (the default) gives the two-phase behavior:
    every batch dispatched before the first sync, ≤ 2 host syncs per query
    set.

    The ``BatchPlan`` surface (``algorithm``, ``params``, ``batches``,
    ``num_batches``, ``total_interactions``, ``sizes``) is re-exposed so
    existing consumers of ``QueryResult.plan`` keep working.
    """

    batch_plan: BatchPlan
    capacities: list[int]          # result-buffer slots per batch (bucketed)
    groups: list[list[int]]        # dispatch groups: contiguous batch index runs
    plan_seconds: float            # batching + refinement time
    #: per-original-batch split counts when spatial pruning split candidate
    #: ranges (sum == num_batches); ``None`` when no splitting happened.
    #: Sibling batches of one run share a query range, so dispatch groups
    #: must not separate them if group-slice concatenation is to stay
    #: canonical (see :func:`make_groups`).
    runs: list[int] | None = None
    #: interactions removed by spatial pruning (original temporal workload
    #: minus the planned workload) — surfaced through ``ExecStats``.
    pruned_interactions: int = 0

    # -- BatchPlan passthrough (stable consumer surface) -----------------
    @property
    def algorithm(self) -> str:
        return self.batch_plan.algorithm

    @property
    def params(self) -> dict:
        return self.batch_plan.params

    @property
    def batches(self) -> list[QueryBatch]:
        return self.batch_plan.batches

    @property
    def num_batches(self) -> int:
        return self.batch_plan.num_batches

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    @property
    def total_interactions(self) -> int:
        return self.batch_plan.total_interactions

    def sizes(self) -> np.ndarray:
        return self.batch_plan.sizes()

    # ------------------------------------------------------------------
    def subplan(self, batch_indices: Sequence[int]) -> "QueryPlan":
        """A single-group plan over a subset of this plan's batches —
        what the scheduler hands one worker call (re-execution of the same
        sub-plan is idempotent: batches are stateless and deterministic)."""
        idx = list(batch_indices)
        bp = BatchPlan(self.algorithm, self.params,
                       [self.batches[i] for i in idx], 0.0)
        return QueryPlan(bp, [self.capacities[i] for i in idx],
                         make_groups(len(idx), None), 0.0)


def size_capacity(batch: QueryBatch, default_capacity: int,
                  granularity: int = CAPACITY_GRANULARITY) -> int:
    """Result slots for one batch: never more than the interaction count
    (a batch cannot produce more hits than interactions), bucketed."""
    return bucket_capacity(min(default_capacity,
                               batch.num_candidates * batch.size),
                           granularity)


def derive_group_size(batches: Sequence[QueryBatch], *,
                      predict_hits: Callable | None = None,
                      target_hit_rows: int = AUTO_GROUP_HIT_ROWS
                      ) -> int | None:
    """§8-model-driven dispatch-group sizing: marshal time ≈ hit volume.

    The pipelined executor overlaps host-side marshalling of group k with
    device compute of group k+1, so splitting a plan into groups only pays
    off when there is marshalling to hide: the §8.2 host model says marshal
    time is result-set volume over transfer bandwidth, so predicted *hit
    rows* are the sizing signal.  ``predict_hits(batch)`` supplies the
    model's per-batch hit estimate (α × numInts — see
    ``repro_torch.core.perfmodel.estimate_alpha_by_epoch``); without one, hits
    are approximated as ``AUTO_GROUP_HIT_FRACTION × batch.num_ints``.

    Returns the derived batches-per-group, or ``None`` when one group (the
    classic O(1)-syncs-per-query-set shape) is predicted optimal — which is
    also why deriving on ``group_size=None`` is backward compatible: plans
    whose predicted result volume is below ``target_hit_rows`` keep the
    exact pre-derivation behavior.
    """
    n = len(batches)
    if n < 2:
        return None
    if predict_hits is not None:
        hits = sum(max(float(predict_hits(b)), 0.0) for b in batches)
    else:
        hits = AUTO_GROUP_HIT_FRACTION * sum(b.num_ints for b in batches)
    num_groups = min(int(hits // target_hit_rows) + 1, n)
    if num_groups <= 1:
        return None
    return math.ceil(n / num_groups)


def make_groups(num_batches: int, group_size: int | None,
                runs: list[int] | None = None) -> list[list[int]]:
    """Partition batch indices into contiguous dispatch groups.

    ``group_size=None`` (the default) puts every batch in one group — the
    O(1)-syncs-per-query-set shape.  A positive ``group_size`` chunks the
    plan so the executor can overlap marshalling of group k with device
    compute of group k+1 (and so the scheduler has re-issuable units).

    ``runs`` (from spatial-pruning sub-range splitting) marks runs of
    sibling batches that share one query range; groups then accumulate
    whole runs — splitting siblings across two groups would interleave one
    query range's rows across two slices and break the broker's
    canonical-prefix concatenation.  ``group_size`` becomes the threshold
    at which a group closes (groups may exceed it by one run's tail).
    """
    if num_batches <= 0:
        return []
    if group_size is None or group_size >= num_batches:
        return [list(range(num_batches))]
    group_size = max(int(group_size), 1)
    if runs is None:
        return [list(range(k, min(k + group_size, num_batches)))
                for k in range(0, num_batches, group_size)]
    assert sum(runs) == num_batches, (sum(runs), num_batches)
    groups: list[list[int]] = []
    cur: list[int] = []
    start = 0
    for r in runs:
        cur.extend(range(start, start + r))
        start += r
        if len(cur) >= group_size:
            groups.append(cur)
            cur = []
    if cur:
        groups.append(cur)
    return groups


class QueryPlanner:
    """Builds :class:`QueryPlan`\\ s: batching algorithm + capacity sizing +
    dispatch grouping, against one temporal-bin index.

    The planner is pure host-side bookkeeping — it never touches a device —
    so one planner serves every backend (single-device engine, sharded
    mesh, scheduler stream) and tests can assert planning decisions without
    executing anything.
    """

    def __init__(self, index: TemporalBinIndex, *,
                 algorithm: str = "greedysetsplit-min",
                 params: Mapping | None = None,
                 default_capacity: int = DEFAULT_CAPACITY,
                 granularity: int = CAPACITY_GRANULARITY,
                 group_size: int | None = None,
                 predict_hits: Callable | None = None,
                 pruning: str = "spatial",
                 max_subranges: int | None = None):
        """``group_size=None`` (the default) derives the dispatch-group size
        from the §8 perf model (:func:`derive_group_size`, optionally fed by
        ``predict_hits``); an explicit ``group_size`` is honored as given.

        ``pruning="spatial"`` (the default) activates the two-level
        candidate pruning whenever :meth:`plan` is given the query
        threshold ``d``: batching merges are priced against the pruned
        workload (``SpatialInteractionCounter``) and each planned batch's
        contiguous candidate range is trimmed and split into the sub-ranges
        the per-bin MBR index cannot rule out.  ``pruning="hierarchical"``
        runs the same pass at the K-box level (sub-ranges and pricing
        against the per-box MBRs, in the index's permuted segment order).
        Without ``d`` (legacy callers) planning is the paper's
        temporal-only behavior.

        ``max_subranges`` caps how many sub-ranges one batch may split
        into (``None`` → ``TemporalBinIndex.DEFAULT_MAX_SUBRANGES``); the
        cap is priced into the batching merges via the coarse grid, so a
        tight cap that would force merges across a huge gap is visible to
        the planner, not a silent conservativeness loss at dispatch.
        """
        if algorithm not in ALGORITHMS:
            raise ValueError(f"unknown batching algorithm {algorithm!r}; "
                             f"choose from {sorted(ALGORITHMS)}")
        if pruning not in PRUNINGS:
            raise ValueError(f"unknown pruning {pruning!r}; "
                             f"choose from {PRUNINGS}")
        self.index = index
        self.algorithm = algorithm
        self.params = dict(params or {})
        self.default_capacity = default_capacity
        self.granularity = granularity
        self.group_size = group_size
        self.predict_hits = predict_hits
        self.pruning = pruning
        self.max_subranges = max_subranges

    # ------------------------------------------------------------------
    def plan(self, sorted_queries: SegmentArray,
             d: float | None = None) -> QueryPlan:
        """Run the batching algorithm and refine the result.  Queries must
        already be sorted by ``t_start`` (the facade guarantees it).
        ``d`` is the distance threshold — required for spatial pruning
        (``None`` plans temporal-only regardless of the pruning knob)."""
        counter = None
        if self.pruning in ("spatial", "hierarchical") and d is not None:
            counter = SpatialInteractionCounter(
                self.index, sorted_queries, float(d),
                level="box" if self.pruning == "hierarchical" else "bin",
                max_subranges=self.max_subranges)
        try:
            bp = ALGORITHMS[self.algorithm](self.index, sorted_queries,
                                            counter=counter, **self.params)
        except TypeError as e:
            raise ValueError(
                f"batch params {self.params} do not match algorithm "
                f"{self.algorithm!r}: {e} (pass batching=... alongside the "
                f"algorithm's parameters)") from None
        if counter is None:
            return self.refine(bp)
        bp, runs, pruned = self._prune_batches(bp, counter)
        return self.refine(bp, runs=runs, pruned_interactions=pruned)

    def _prune_batches(self, bp: BatchPlan,
                       counter: SpatialInteractionCounter
                       ) -> tuple[BatchPlan, list[int], int]:
        """Trim and split every batch's candidate range against the per-bin
        (or, for ``pruning="hierarchical"``, per-box) MBR index: each batch
        becomes ≥ 1 sibling batches over the sub-ranges the MBR test cannot
        rule out, with *exact* per-sub-range ``num_ints`` (the dispatched
        workload — the executor's ``total_interactions`` matches by
        construction).  Box-level sub-ranges are positions in the index's
        permuted segment order (bin-granular ranges are identical in both
        orders, so the mixed bookkeeping stays consistent).  A fully pruned
        batch stays as one empty batch so query coverage bookkeeping
        (scheduler group counting, broker slices) is unchanged."""
        qlo, qhi = counter.qlo, counter.qhi
        level = "box" if self.pruning == "hierarchical" else "bin"
        out: list[QueryBatch] = []
        runs: list[int] = []
        pruned = 0
        for b in bp.batches:
            base = b.size * b.num_candidates
            if b.num_candidates <= 0:
                out.append(QueryBatch(b.q_first, b.q_last, b.qt0, b.qt1,
                                      0, -1, 0))
                runs.append(1)
                continue
            lo = qlo[b.q_first:b.q_last + 1].min(axis=0)
            hi = qhi[b.q_first:b.q_last + 1].max(axis=0)
            sub_kw = {} if self.max_subranges is None else {
                "max_subranges": self.max_subranges}
            subs = self.index.candidate_subranges(b.qt0, b.qt1, lo, hi,
                                                  counter.d, level=level,
                                                  **sub_kw)
            if not subs:
                out.append(QueryBatch(b.q_first, b.q_last, b.qt0, b.qt1,
                                      0, -1, 0))
                runs.append(1)
                pruned += base
                continue
            kept = 0
            for f, l in subs:
                ints = b.size * (l - f + 1)
                kept += ints
                out.append(QueryBatch(b.q_first, b.q_last, b.qt0, b.qt1,
                                      f, l, ints))
            runs.append(len(subs))
            pruned += base - kept
        plan = BatchPlan(bp.algorithm, bp.params, out, bp.plan_seconds)
        return plan, runs, pruned

    def refine(self, batch_plan: BatchPlan, *,
               runs: list[int] | None = None,
               pruned_interactions: int = 0) -> QueryPlan:
        """Attach capacities and dispatch groups to an existing
        ``BatchPlan`` (also the adapter engines use to accept legacy
        ``BatchPlan`` arguments).  The batches' candidate ranges are taken
        as given; ``runs``/``pruned_interactions`` carry the provenance of
        an upstream :meth:`_prune_batches` pass (groups align to runs)."""
        t0 = time.perf_counter()
        caps = [size_capacity(b, self.default_capacity, self.granularity)
                for b in batch_plan.batches]
        gs = self.group_size
        if gs is None:
            gs = derive_group_size(batch_plan.batches,
                                   predict_hits=self.predict_hits)
        groups = make_groups(len(batch_plan.batches), gs, runs=runs)
        return QueryPlan(batch_plan, caps, groups,
                         batch_plan.plan_seconds + time.perf_counter() - t0,
                         runs=runs, pruned_interactions=pruned_interactions)


def as_query_plan(plan: "BatchPlan | QueryPlan", *,
                  default_capacity: int = DEFAULT_CAPACITY,
                  group_size: int | None = None) -> QueryPlan:
    """Coerce a legacy ``BatchPlan`` into a single-group ``QueryPlan``
    (no-op for plans that already are one)."""
    if isinstance(plan, QueryPlan):
        return plan
    caps = [size_capacity(b, default_capacity) for b in plan.batches]
    return QueryPlan(plan, caps, make_groups(len(plan.batches), group_size),
                     plan.plan_seconds)


__all__ = [
    "AUTO_GROUP_HIT_FRACTION", "AUTO_GROUP_HIT_ROWS", "CAPACITY_GRANULARITY",
    "DEFAULT_CAPACITY", "PRUNINGS", "QueryPlan", "QueryPlanner",
    "as_query_plan", "bucket_capacity", "derive_group_size", "make_groups",
    "size_capacity",
]
