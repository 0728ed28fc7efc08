"""Query-batch generation algorithms (paper §6, Algorithms 2–4).

All algorithms take the query segments *sorted by non-decreasing t_start*
(the paper's precondition) and partition them into batches of **contiguous**
query segments.  A batch is fully described by its index range
``[q_first, q_last]`` into the sorted query array plus its temporal extent
``[qt0, qt1]`` (``qt0 = ts[q_first]`` by sortedness; ``qt1`` is the running
max of ``te`` over the range, maintained in O(1) across merges).

``numInts(batch) = |batch| × |E_batch|`` where ``|E_batch|`` is the number
of candidate entry segments given by the temporal-bin index (paper §4) —
this is the quantity every algorithm below minimizes increases of.

**Pruning-aware pricing.**  With spatial pruning enabled the true
per-batch workload is the *pruned* candidate count, so every merge
decision should price it: pass a :class:`SpatialInteractionCounter` as
``counter=`` and the merge loops evaluate ``numInts`` against the
temporal-bin index's coarse per-bin-MBR grid (conservative, vectorized)
while maintaining each batch's query-MBR union incrementally across
merges.  A merge of two spatially distant batches then has a *positive*
cost even when their temporal extents nest — the algorithms keep
spatially coherent batches, which is what makes the downstream sub-range
split (``repro_torch.core.planner``) effective.  ``counter=None`` (the default)
prices the paper's temporal-only count, bit-for-bit as before.

Algorithms:

* :func:`periodic` — fixed batch size ``s`` (paper §6.1).
* :func:`setsplit_fixed` — Algorithm 2: O(|Q|²) best-merge loop down to a
  target number of batches.
* :func:`setsplit_minmax` — Algorithm 3: best-merge loop with a max-size
  constraint, then a second phase merging undersized batches left/right.
* :func:`setsplit_max` — Algorithm 3 with ``min=1`` (paper §6.2 last line).
* :func:`greedysetsplit_min` / :func:`greedysetsplit_max` — Algorithm 4:
  one pass of "free" merges (merges that add zero interactions), then one
  constraint pass.  O(|Q|) merge decisions.

The SETSPLIT loops are vectorized with numpy (all adjacent-pair merge costs
are evaluated per iteration with ``candidate_range_batch``), which keeps
the quadratic algorithms usable at |Q| of a few thousand.  The *semantics*
are line-for-line the paper's: each iteration merges the adjacent pair with
the smallest ``numIntsMerged − numIntsUnmerged``.

Public entry point: algorithm selection lives in
``repro_torch.api.ExecutionPolicy(batching=..., batch_params=...)``; the facade
calls into :data:`ALGORITHMS` and owns the sortedness precondition.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from repro_torch.core.index import TemporalBinIndex
from repro_torch.core.segments import SegmentArray


@dataclasses.dataclass(frozen=True)
class QueryBatch:
    """A contiguous run of sorted query segments plus its candidate range."""

    q_first: int           # inclusive index into the sorted query array
    q_last: int            # inclusive
    qt0: float             # temporal extent start (= ts[q_first])
    qt1: float             # temporal extent end (= max te over the range)
    cand_first: int        # inclusive candidate entry index (0, -1 if empty)
    cand_last: int         # inclusive
    num_ints: int          # |batch| × num_candidates

    @property
    def size(self) -> int:
        return self.q_last - self.q_first + 1

    @property
    def num_candidates(self) -> int:
        return max(self.cand_last - self.cand_first + 1, 0)


@dataclasses.dataclass
class BatchPlan:
    """Output of a batching algorithm plus provenance for EXPERIMENTS.md."""

    algorithm: str
    params: dict
    batches: list[QueryBatch]
    plan_seconds: float    # time spent computing the plan (paper §7.4 charges this)

    @property
    def total_interactions(self) -> int:
        return int(sum(b.num_ints for b in self.batches))

    @property
    def num_batches(self) -> int:
        return len(self.batches)

    def sizes(self) -> np.ndarray:
        return np.array([b.size for b in self.batches], dtype=np.int64)


class SpatialInteractionCounter:
    """Prices ``numInts`` with spatial pruning folded in.

    Bound to one (index, sorted query set, threshold): per-batch candidate
    counts come from the index's coarse per-bin-MBR estimate
    (:meth:`~repro_torch.core.index.TemporalBinIndex.
    estimate_pruned_candidates_batch`) evaluated against each batch's
    query-MBR union.  ``level="box"`` prices against the K-box-per-bin
    hierarchy (``pruning="hierarchical"``); ``max_subranges`` folds the
    planner's sub-range cap into the price (the cap can re-admit a
    fragmented extent's gap segments, and the coarse grid charges a
    conservative surcharge for that — see the estimate's docstring), so
    the priced count tracks the capped dispatched workload instead of the
    uncapped ideal.
    """

    def __init__(self, index: TemporalBinIndex, queries: SegmentArray,
                 d: float, *, level: str = "bin",
                 max_subranges: int | None = None):
        self.index = index
        self.d = float(d)
        self.level = level
        self.max_subranges = max_subranges
        self.qlo, self.qhi = queries.mbrs()      # (nq, 3) float64

    def counts(self, qt0, qt1, lo, hi) -> np.ndarray:
        """Pruned candidate counts for batches with extents (qt0, qt1) and
        query-MBR unions (lo, hi) — all stacked arrays."""
        return self.index.estimate_pruned_candidates_batch(
            qt0, qt1, lo, hi, self.d, level=self.level,
            max_subranges=self.max_subranges)


# ----------------------------------------------------------------------
# internal representation used by the merge loops: parallel arrays over
# the current batch list B.  Batches are contiguous and ordered, so batch
# k is [starts[k], starts[k] + sizes[k] - 1].
# ----------------------------------------------------------------------
class _BatchState:
    def __init__(self, index: TemporalBinIndex, queries: SegmentArray,
                 counter: SpatialInteractionCounter | None = None):
        if not queries.is_sorted():
            raise ValueError("queries must be sorted by t_start (paper §4)")
        nq = len(queries)
        if nq == 0:
            raise ValueError("empty query set")
        self.index = index
        self.counter = counter
        self.starts = np.arange(nq, dtype=np.int64)
        self.sizes = np.ones(nq, dtype=np.int64)
        self.qt0 = queries.ts.astype(np.float64).copy()
        self.qt1 = queries.te.astype(np.float64).copy()
        if counter is not None:
            # Per-batch query-MBR unions, maintained across merges.
            self.mlo = counter.qlo.copy()
            self.mhi = counter.qhi.copy()
            self.num_ints = self.sizes * counter.counts(
                self.qt0, self.qt1, self.mlo, self.mhi)
        else:
            self.mlo = self.mhi = None
            self.num_ints = self.sizes * index.num_candidates_batch(
                self.qt0, self.qt1)

    def __len__(self) -> int:
        return len(self.starts)

    def merge_costs(self) -> np.ndarray:
        """numIntsMerged − numIntsUnmerged for every adjacent pair (vectorized)."""
        m_qt0 = self.qt0[:-1]                                 # sorted ⇒ min is left's
        m_qt1 = np.maximum(self.qt1[:-1], self.qt1[1:])
        m_size = self.sizes[:-1] + self.sizes[1:]
        if self.counter is not None:
            m_lo = np.minimum(self.mlo[:-1], self.mlo[1:])
            m_hi = np.maximum(self.mhi[:-1], self.mhi[1:])
            merged = m_size * self.counter.counts(m_qt0, m_qt1, m_lo, m_hi)
        else:
            merged = m_size * self.index.num_candidates_batch(m_qt0, m_qt1)
        return merged - (self.num_ints[:-1] + self.num_ints[1:])

    def merged_sizes(self) -> np.ndarray:
        return self.sizes[:-1] + self.sizes[1:]

    def merged_ints(self, i: int) -> int:
        """numInts of the would-be merge of batches i and i+1 (the scalar
        the GREEDYSETSPLIT free-merge test and the MINMAX fix-up use)."""
        qt0 = self.qt0[i]
        qt1 = max(self.qt1[i], self.qt1[i + 1])
        size = int(self.sizes[i] + self.sizes[i + 1])
        if self.counter is not None:
            lo = np.minimum(self.mlo[i], self.mlo[i + 1])
            hi = np.maximum(self.mhi[i], self.mhi[i + 1])
            return size * int(self.counter.counts(
                np.array([qt0]), np.array([qt1]), lo[None], hi[None])[0])
        return size * self.index.num_candidates(qt0, qt1)

    def merge_at(self, i: int) -> None:
        """Merge batches i and i+1 in place (paper's merge + removeElementAt)."""
        self.qt1[i] = max(self.qt1[i], self.qt1[i + 1])
        self.sizes[i] += self.sizes[i + 1]
        if self.counter is not None:
            self.mlo[i] = np.minimum(self.mlo[i], self.mlo[i + 1])
            self.mhi[i] = np.maximum(self.mhi[i], self.mhi[i + 1])
            self.num_ints[i] = self.sizes[i] * int(self.counter.counts(
                self.qt0[i:i + 1], self.qt1[i:i + 1],
                self.mlo[i][None], self.mhi[i][None])[0])
        else:
            self.num_ints[i] = self.sizes[i] * self.index.num_candidates(
                self.qt0[i], self.qt1[i])
        for name in ("starts", "sizes", "qt0", "qt1", "num_ints"):
            arr = getattr(self, name)
            setattr(self, name, np.delete(arr, i + 1))
        if self.counter is not None:
            self.mlo = np.delete(self.mlo, i + 1, axis=0)
            self.mhi = np.delete(self.mhi, i + 1, axis=0)

    def to_batches(self) -> list[QueryBatch]:
        first, last = self.index.candidate_range_batch(self.qt0, self.qt1)
        out = []
        for k in range(len(self.starts)):
            out.append(QueryBatch(
                q_first=int(self.starts[k]),
                q_last=int(self.starts[k] + self.sizes[k] - 1),
                qt0=float(self.qt0[k]), qt1=float(self.qt1[k]),
                cand_first=int(first[k]), cand_last=int(last[k]),
                num_ints=int(self.num_ints[k]),
            ))
        return out


def _finish(name: str, params: dict, state_or_batches, t_start: float) -> BatchPlan:
    batches = (state_or_batches.to_batches()
               if isinstance(state_or_batches, _BatchState) else state_or_batches)
    return BatchPlan(algorithm=name, params=params, batches=batches,
                     plan_seconds=time.perf_counter() - t_start)


# ----------------------------------------------------------------------
# PERIODIC (paper §6.1)
# ----------------------------------------------------------------------
def periodic(index: TemporalBinIndex, queries: SegmentArray, s: int, *,
             counter: SpatialInteractionCounter | None = None) -> BatchPlan:
    """Fixed-size batches of ``s`` consecutive sorted query segments.

    PERIODIC makes no merge decisions, so ``counter`` is accepted for
    interface uniformity only — the pruned workload is priced downstream
    by the planner's sub-range refinement.
    """
    del counter
    t_begin = time.perf_counter()
    if s <= 0:
        raise ValueError("batch size must be positive")
    nq = len(queries)
    starts = np.arange(0, nq, s, dtype=np.int64)
    ends = np.minimum(starts + s, nq) - 1
    qt0 = queries.ts[starts].astype(np.float64)
    # max te within each chunk, via a prefix-max free approach: reduceat.
    qt1 = np.maximum.reduceat(queries.te.astype(np.float64), starts)
    first, last = index.candidate_range_batch(qt0, qt1)
    sizes = ends - starts + 1
    ints = sizes * np.maximum(last - first + 1, 0)
    batches = [QueryBatch(int(a), int(b), float(t0), float(t1), int(f), int(l), int(i))
               for a, b, t0, t1, f, l, i
               in zip(starts, ends, qt0, qt1, first, last, ints)]
    return _finish("periodic", {"s": s}, batches, t_begin)


# ----------------------------------------------------------------------
# SETSPLIT (paper §6.2, Algorithms 2 & 3)
# ----------------------------------------------------------------------
def setsplit_fixed(index: TemporalBinIndex, queries: SegmentArray,
                   num_batches: int, *,
                   counter: SpatialInteractionCounter | None = None
                   ) -> BatchPlan:
    """Algorithm 2: merge the cheapest adjacent pair until |B| = numBatches."""
    t_begin = time.perf_counter()
    st = _BatchState(index, queries, counter)
    num_batches = max(1, num_batches)
    while len(st) > num_batches:
        costs = st.merge_costs()
        st.merge_at(int(np.argmin(costs)))
    return _finish("setsplit-fixed", {"num_batches": num_batches}, st, t_begin)


def setsplit_minmax(index: TemporalBinIndex, queries: SegmentArray,
                    min_size: int, max_size: int, *,
                    counter: SpatialInteractionCounter | None = None
                    ) -> BatchPlan:
    """Algorithm 3: constrained best-merge loop + undersize fix-up passes."""
    t_begin = time.perf_counter()
    if min_size > max_size:
        raise ValueError("min_size > max_size")
    st = _BatchState(index, queries, counter)
    # Phase 1 (lines 3–21): best merge among pairs whose merged size <= max.
    while True:
        if len(st) == 1:
            break
        costs = st.merge_costs().astype(np.float64)
        costs[st.merged_sizes() > max_size] = np.inf   # line 6: skip oversize merges
        i = int(np.argmin(costs))
        if not np.isfinite(costs[i]):                  # line 16: minDiff = +inf
            break
        st.merge_at(i)
    # Phase 2 (lines 22–40): merge undersized batches with cheaper neighbour.
    while True:
        small = np.nonzero(st.sizes < min_size)[0]
        if small.size == 0 or len(st) == 1:
            break
        i = int(small[0])
        left = st.merged_ints(i - 1) if i > 0 else np.inf
        right = st.merged_ints(i) if i < len(st) - 1 else np.inf
        if left < right:
            st.merge_at(i - 1)
        else:
            st.merge_at(i)
    return _finish("setsplit-minmax", {"min": min_size, "max": max_size}, st, t_begin)


def setsplit_max(index: TemporalBinIndex, queries: SegmentArray,
                 max_size: int, *,
                 counter: SpatialInteractionCounter | None = None
                 ) -> BatchPlan:
    """SETSPLIT-MINMAX with min = 1 (paper §6.2, final paragraph)."""
    plan = setsplit_minmax(index, queries, 1, max_size, counter=counter)
    plan.algorithm = "setsplit-max"
    plan.params = {"max": max_size}
    return plan


# ----------------------------------------------------------------------
# GREEDYSETSPLIT (paper §6.3, Algorithm 4)
# ----------------------------------------------------------------------
def _greedy(index: TemporalBinIndex, queries: SegmentArray, bound: int,
            variant: str,
            counter: SpatialInteractionCounter | None = None) -> BatchPlan:
    t_begin = time.perf_counter()
    st = _BatchState(index, queries, counter)
    # Phase 1 (lines 4–11): single pass of free merges.  A merge is free iff
    # numInts(merge) == numInts(B[i]) + numInts(B[i+1]).
    i = 0
    while i < len(st) - 1:
        if st.merged_ints(i) == st.num_ints[i] + st.num_ints[i + 1]:
            st.merge_at(i)
        else:
            i += 1
    # Phase 2 (lines 13–20): constraint pass.
    i = 0
    while i < len(st) - 1:
        if variant == "min":
            if st.sizes[i] < bound:
                st.merge_at(i)
            else:
                i += 1
        else:  # "max": paper swaps the test and the clauses — merge while the
            # current batch has not yet exceeded the bound.  The bound is soft
            # (the merge that crosses it is still performed), exactly as the
            # literal transformation of line 14 dictates.
            if st.sizes[i] > bound:
                i += 1
            else:
                st.merge_at(i)
    return _finish(f"greedysetsplit-{variant}", {"bound": bound}, st, t_begin)


def greedysetsplit_min(index: TemporalBinIndex, queries: SegmentArray,
                       bound: int, *,
                       counter: SpatialInteractionCounter | None = None
                       ) -> BatchPlan:
    """Algorithm 4: free merges, then merge any batch smaller than ``bound``."""
    return _greedy(index, queries, bound, "min", counter)


def greedysetsplit_max(index: TemporalBinIndex, queries: SegmentArray,
                       bound: int, *,
                       counter: SpatialInteractionCounter | None = None
                       ) -> BatchPlan:
    """Algorithm 4 MAX variant (paper §6.3 prose)."""
    return _greedy(index, queries, bound, "max", counter)


ALGORITHMS: dict[str, Callable] = {
    "periodic": periodic,
    "setsplit-fixed": setsplit_fixed,
    "setsplit-max": setsplit_max,
    "setsplit-minmax": setsplit_minmax,
    "greedysetsplit-min": greedysetsplit_min,
    "greedysetsplit-max": greedysetsplit_max,
}
