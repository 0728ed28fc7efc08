"""Unified query facade for the trajectory database — the port's
counterpart of ``repro/api.py``.

:class:`TrajectoryDB` is the front door: construction sorts the entry
segments, builds the temporal-bin index once and uploads the packed
segments to the device; ``db.query(queries, d, backend=...)`` plans,
executes and returns a :class:`QueryResult` whose ``query_idx`` refers to
the caller's query order, with rows in canonical (query_idx, entry_idx)
order whatever the backend.

Backends:

* ``"kernel"`` — the hand-written CUDA kernels through the engine and
  executor (the counterpart of the reference's ``"pallas"``);
* ``"torch"`` — the plain PyTorch oracle through the same engine and
  executor (the counterpart of ``"jnp"``);
* ``"rtree"`` — the paper's §7.3 search-and-refine R-tree baseline
  (``repro_torch.core.rtree``), which runs on the host CPU whatever the
  database's device: it is the thing the GPU is compared against;
* ``"brute"`` — the all-pairs oracle;
* ``"shard"`` — the temporal-pod backend (``repro_torch.core.
  distributed``, the paper's §1 partitioning across nodes): each batch runs
  once per pod that owns candidates of it, the pods laid over the visible
  devices, with the same ≤ 2 host syncs per dispatch group.

All five return the same canonical rows.

``db.query_stream(...)`` runs a query set through the deadline/re-issue
scheduler (``repro_torch.core.scheduler``), ``db.broker(...)`` returns the
session-oriented serving front door
(``repro_torch.serve.broker.QueryBroker``: ticketed submit, a ``step()``
pump delivering one dispatch group at a time, §8-model admission, retry
and the degradation ladder), and ``db.fit_response_model(...)`` fits the
§8 model that prices both.

Everything runs on ``device`` (default ``"cuda"``); the CPU is used only
when the caller passes ``device="cpu"``, and a ``"cuda"`` request without
CUDA raises.

Quick example::

    from repro_torch.api import TrajectoryDB

    db = TrajectoryDB.from_scenario("S1", scale=1.0)
    result = db.query(db.scenario_queries, db.scenario_d, backend="kernel")
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Mapping, Protocol, runtime_checkable

import numpy as np

from repro_torch.core.batching import ALGORITHMS, BatchPlan
from repro_torch.core.engine import (DistanceThresholdEngine, ExecStats,
                                     ResultSet, brute_force)
from repro_torch.core.errors import CapacityError, PodFailedError
from repro_torch.core.index import DEFAULT_NUM_BINS, TemporalBinIndex
from repro_torch.core.planner import PRUNINGS, QueryPlan, QueryPlanner
from repro_torch.core.rtree import RTreeEngine
from repro_torch.core.scheduler import DeadlineScheduler, SchedulerStats
from repro_torch.core.segments import SegmentArray
from repro_torch.core.trace import collect, span
from repro_torch.kernels.distthresh import DEFAULT_CAND_BLK, DEFAULT_QRY_BLK

#: Names accepted by ``TrajectoryDB.query(backend=...)``.
BACKENDS = ("kernel", "torch", "rtree", "brute", "shard")

#: Backends that execute through a ``repro_torch.core.executor`` driver.
ENGINE_BACKENDS = ("kernel", "torch", "shard")

#: Default batch size anchor used when an algorithm's parameters are not
#: given explicitly (the paper's practical PERIODIC recommendation, §7.4).
DEFAULT_BATCH_SIZE = 64


# ----------------------------------------------------------------------
# Execution policy: every tuning knob in one value object.
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    """How a query should be executed — algorithm, index, kernel and
    executor parameters.  ``num_bins`` and ``index_kboxes`` shape the index
    and are read at ``TrajectoryDB`` construction only; every other field
    may be overridden per call via ``db.query(..., policy=...)``.
    """

    # -- batching (engine backends) ------------------------------------
    batching: str = "greedysetsplit-min"
    batch_params: Mapping | None = None   # None → per-algorithm defaults

    # -- index ----------------------------------------------------------
    num_bins: int = DEFAULT_NUM_BINS
    #: per-bin spatial split factor K for the hierarchical index layer.
    index_kboxes: int = 1
    #: candidate pruning: ``"spatial"`` (default) trims and splits each
    #: batch's candidate range against the per-bin MBRs and arms the fused
    #: kernel's tile early-out; ``"hierarchical"`` plans at the K-box level
    #: and dispatches live-tile lists; ``"none"`` keeps temporal-only
    #: candidates.  Exact: every mode gives the same canonical result.
    pruning: str = "spatial"
    #: cap on sub-ranges one batch may split into (None → the index's
    #: default).
    max_subranges: int | None = None

    # -- kernel / device ------------------------------------------------
    cand_blk: int = DEFAULT_CAND_BLK
    qry_blk: int = DEFAULT_QRY_BLK
    capacity: int = 4096                  # result-buffer slots per batch
    compaction: str = "fused"             # "fused" in-kernel | "fused_rowloop"
    #                                       row-loop kernels | "dense" 2-phase
    pipeline: bool = True                 # two-phase executor (≤ 2 syncs/group)
    #: executor dispatch groups per query set (None → derived by the
    #: planner; one group unless the predicted hit volume is large).
    group_size: int | None = None
    #: bound on per-batch overflow re-dispatches; a batch still overflowing
    #: after this many enlargements raises ``CapacityError``.
    max_capacity_retries: int = 3

    # -- temporal-pod backend (backend="shard") -------------------------
    shard_pods: int | None = None         # None → one pod per visible device
    shard_capacity: int = 4096            # result slots per pod per batch
    #: the hand-written kernels in every pod's step (else the torch oracle
    #: with dense compaction, the reference's ``shard_use_pallas=False``).
    shard_use_kernel: bool = False
    shard_balance: str = "time"           # pod partition: "time" | "num_ints"
    #: pods with zero candidates for a batch are not launched.  Exact:
    #: results are identical with it on or off.
    shard_sparse: bool = True

    # -- R-tree baseline ------------------------------------------------
    rtree_r: int = 12                     # segments per leaf MBB (Fig. 5)
    rtree_fanout: int = 16
    rtree_threads: int = 1                # >1 → query_parallel

    # -- brute oracle ---------------------------------------------------
    brute_chunk: int = 2048

    # -- query_stream scheduling ---------------------------------------
    stream_workers: int = 2
    stream_slack: float = 4.0
    stream_min_deadline: float = 0.05
    #: batches per scheduler worker call (None → auto, ≥ 2 when possible —
    #: each call is one pipelined dispatch over the whole group)
    stream_group_size: int | None = None

    def with_(self, **updates) -> "ExecutionPolicy":
        """Functional update (the policy itself is immutable)."""
        return dataclasses.replace(self, **updates)

    def resolved_batch_params(self, num_queries: int) -> dict:
        """Fill in per-algorithm defaults anchored at DEFAULT_BATCH_SIZE."""
        if self.batching not in ALGORITHMS:
            raise ValueError(
                f"unknown batching algorithm {self.batching!r}; "
                f"choose from {sorted(ALGORITHMS)}")
        if self.batch_params:
            return dict(self.batch_params)
        s = DEFAULT_BATCH_SIZE
        return {
            "periodic": {"s": s},
            "setsplit-fixed": {"num_batches": max(num_queries // s, 1)},
            "setsplit-max": {"max_size": 2 * s},
            "setsplit-minmax": {"min_size": max(s // 2, 1), "max_size": 2 * s},
            "greedysetsplit-min": {"bound": s},
            "greedysetsplit-max": {"bound": 2 * s},
        }[self.batching]


# ----------------------------------------------------------------------
# Results, in the caller's query order.
# ----------------------------------------------------------------------
@dataclasses.dataclass
class QueryResult:
    """Flat result arrays, one row per (entry segment, query segment,
    temporal interval); ``query_idx`` refers to the **caller's** query
    array and rows are in canonical (query_idx, entry_idx) order."""

    entry_idx: np.ndarray    # index into the sorted database (db.segments)
    entry_traj: np.ndarray   # trajectory id of the entry segment
    entry_seg: np.ndarray    # segment id of the entry segment
    query_idx: np.ndarray    # index into the CALLER's query array
    t_enter: np.ndarray
    t_exit: np.ndarray
    d: float
    backend: str
    stats: ExecStats | None = None            # engine backends only
    plan: BatchPlan | QueryPlan | None = None  # engine backends only
    #: True when the serving stack produced this result through a
    #: degradation-ladder step (slower route, same rows) or when it is a
    #: ``QueryTicket.partial_result`` of an incomplete ticket.
    degraded: bool = False

    def __len__(self) -> int:
        return int(self.entry_idx.shape[0])

    @staticmethod
    def from_result_set(rs: ResultSet, *, order: np.ndarray | None,
                        d: float, backend: str,
                        stats: ExecStats | None = None,
                        plan: BatchPlan | QueryPlan | None = None
                        ) -> "QueryResult":
        """Map a backend ``ResultSet`` (query_idx into the sorted query
        array) back to caller order and canonicalize row order.  ``order``
        is the sort permutation (sorted position → caller position);
        ``None`` means the caller's queries were already sorted."""
        q_caller = (rs.query_idx if order is None
                    else order[rs.query_idx])
        if stats is None:
            rank = _caller_rank(q_caller, rs.entry_idx)
        else:
            with collect(stats.spans) as spans:
                rank = _caller_rank(q_caller, rs.entry_idx)
            stats.spans = spans
        return QueryResult(
            entry_idx=rs.entry_idx[rank],
            entry_traj=rs.entry_traj[rank],
            entry_seg=rs.entry_seg[rank],
            query_idx=q_caller[rank],
            t_enter=rs.t_enter[rank],
            t_exit=rs.t_exit[rank],
            d=d, backend=backend, stats=stats, plan=plan,
        )

    def matches_for(self, query_idx: int) -> "QueryResult":
        """Rows belonging to one caller query segment."""
        m = self.query_idx == query_idx
        return QueryResult(
            self.entry_idx[m], self.entry_traj[m], self.entry_seg[m],
            self.query_idx[m], self.t_enter[m], self.t_exit[m],
            d=self.d, backend=self.backend)

    def matched_trajectories(self) -> np.ndarray:
        """Unique database trajectory ids in the result — the paper's §3
        deliverable."""
        return np.unique(self.entry_traj)

    def to_result_set(self) -> ResultSet:
        """``ResultSet`` view (``query_idx`` stays in caller order)."""
        return ResultSet(self.entry_idx, self.entry_traj, self.entry_seg,
                         self.query_idx, self.t_enter, self.t_exit)


def _caller_rank(q_caller: np.ndarray, entry_idx: np.ndarray) -> np.ndarray:
    """The permutation ``np.lexsort((entry_idx, q_caller))`` gives.

    Each row's (``q_caller``, ``entry_idx``) and its position go on one
    int64, ``(q_caller * m + entry_idx) << b | row`` with ``m =
    entry_idx.max() + 1`` and ``b`` the bits of the last row's position;
    one sort of those values and a mask give the rank.  The values are
    distinct and rows that tie keep their order, as in the (stable)
    lexsort, so every sort gives its permutation.  Where the values would
    pass int64 (or the indices are negative or not integers) the lexsort
    runs instead (span ``order.rank_lexsort``)."""
    with span("order.rank"):
        rank = _packed_rank(q_caller, entry_idx)
    if rank is None:
        with span("order.rank_lexsort"):
            rank = np.lexsort((entry_idx, q_caller))
    return rank


def _packed_rank(q: np.ndarray, e: np.ndarray) -> np.ndarray | None:
    """The rank by one sort of packed int64 values, or None where they
    cannot be formed."""
    n = len(e)
    if n == 0:
        return np.zeros(0, np.int64)
    if q.dtype.kind not in "iu" or e.dtype.kind not in "iu":
        return None
    q_min, q_max = int(q.min()), int(q.max())
    e_min, m = int(e.min()), int(e.max()) + 1
    bits = (n - 1).bit_length()
    if q_min < 0 or e_min < 0 or (q_max + 1) * m << bits >= 2 ** 63:
        return None
    packed = q.astype(np.int64) * m + e.astype(np.int64, copy=False)
    packed <<= bits
    packed |= np.arange(n, dtype=np.int64)
    packed.sort()
    packed &= (1 << bits) - 1
    return packed


# ----------------------------------------------------------------------
# Backend protocol + adapters.
# ----------------------------------------------------------------------
@runtime_checkable
class QueryBackend(Protocol):
    """One execution strategy.  ``run`` receives queries already sorted by
    ``t_start`` and returns results whose ``query_idx`` indexes that
    sorted array."""

    name: str
    needs_plan: bool

    def run(self, queries: SegmentArray, d: float,
            plan: QueryPlan | None) -> tuple[ResultSet, ExecStats | None]:
        ...


class EngineBackend:
    """Adapter over ``DistanceThresholdEngine`` (hand-written kernels or
    torch oracle — same engine, one flag)."""

    needs_plan = True

    def __init__(self, name: str, engine: DistanceThresholdEngine):
        self.name = name
        self.engine = engine

    def run(self, queries: SegmentArray, d: float,
            plan: QueryPlan | None) -> tuple[ResultSet, ExecStats | None]:
        if plan is None:
            raise ValueError(f"backend {self.name!r} requires a plan")
        return self.engine.execute(queries, d, plan)


class RTreeBackend:
    """Adapter over the §7.3 search-and-refine CPU baseline (host CPU
    whatever the database's device)."""

    name = "rtree"
    needs_plan = False

    def __init__(self, engine: RTreeEngine, *, threads: int = 1):
        self.engine = engine
        self.threads = threads

    def run(self, queries: SegmentArray, d: float,
            plan: QueryPlan | None) -> tuple[ResultSet, ExecStats | None]:
        if self.threads > 1:
            return self.engine.query_parallel(queries, d, self.threads), None
        return self.engine.query(queries, d), None


class BruteBackend:
    """Adapter over the all-pairs oracle (tests / small inputs)."""

    name = "brute"
    needs_plan = False

    def __init__(self, db: SegmentArray, *, chunk: int = 2048,
                 device="cuda"):
        self.db = db
        self.chunk = chunk
        self.device = device

    def run(self, queries: SegmentArray, d: float,
            plan: QueryPlan | None) -> tuple[ResultSet, ExecStats | None]:
        return brute_force(self.db, queries, d, chunk=self.chunk,
                           device=self.device), None


class ShardBackend:
    """Adapter over the temporal-pod engine
    (``repro_torch.core.distributed.ShardedEngine``).  Shares the facade's
    sorted segments; runs through the same pipelined executor as the
    single-device engine."""

    name = "shard"
    needs_plan = True

    def __init__(self, engine):
        self.engine = engine

    def run(self, queries: SegmentArray, d: float,
            plan: QueryPlan | None) -> tuple[ResultSet, ExecStats | None]:
        if plan is None:
            raise ValueError("backend 'shard' requires a plan")
        return self.engine.execute(queries, d, plan)


# ----------------------------------------------------------------------
# Input validation: malformed workloads fail here with a clear message.
# ----------------------------------------------------------------------
def _validate_segments(segments: SegmentArray, what: str) -> None:
    """Reject NaN/Inf coordinates or timestamps and zero-length (or
    inverted) time intervals."""
    if len(segments) == 0:
        return
    for field, arr in (("coordinates", segments.xs),
                       ("coordinates", segments.ys),
                       ("coordinates", segments.zs),
                       ("coordinates", segments.xe),
                       ("coordinates", segments.ye),
                       ("coordinates", segments.ze),
                       ("timestamps", segments.ts),
                       ("timestamps", segments.te)):
        if not np.isfinite(np.asarray(arr)).all():
            raise ValueError(
                f"{what} contain non-finite (NaN/Inf) {field}; the distance"
                f" kernels require finite inputs — clean the workload before"
                f" building/querying the database")
    bad = np.asarray(segments.te) <= np.asarray(segments.ts)
    if bad.any():
        i = int(np.argmax(bad))
        raise ValueError(
            f"{what} contain a zero-length or inverted time interval at "
            f"index {i} (t_start={float(np.asarray(segments.ts)[i])!r}, "
            f"t_end={float(np.asarray(segments.te)[i])!r}); every segment "
            f"must satisfy t_end > t_start")


def _validate_threshold(d) -> float:
    """Reject a non-finite or negative distance threshold."""
    d = float(d)
    if not math.isfinite(d) or d < 0.0:
        raise ValueError(
            f"distance threshold d must be finite and >= 0, got {d!r}")
    return d


# ----------------------------------------------------------------------
# The facade.
# ----------------------------------------------------------------------
class TrajectoryDB:
    """In-memory spatiotemporal trajectory database with one query surface.

    Construction sorts the entry segments by ``t_start``, builds the
    temporal-bin index and uploads the packed segments to ``device`` once;
    every backend shares them.  Use the classmethods.
    """

    def __init__(self, segments: SegmentArray, *,
                 policy: ExecutionPolicy | None = None, device="cuda",
                 index: TemporalBinIndex | None = None):
        _validate_segments(segments, "entry segments")
        self.policy = policy or ExecutionPolicy()
        # The engine owns sorting, the index and the packed device copy;
        # the facade aliases them so there is exactly one of each.
        self._base_engine = DistanceThresholdEngine(
            segments, num_bins=self.policy.num_bins,
            cand_blk=self.policy.cand_blk, qry_blk=self.policy.qry_blk,
            default_capacity=self.policy.capacity,
            compaction=self.policy.compaction, pipeline=self.policy.pipeline,
            pruning=self.policy.pruning,
            index_kboxes=self.policy.index_kboxes, device=device, index=index)
        self.device = self._base_engine.device
        self.segments: SegmentArray = self._base_engine.db
        self.index: TemporalBinIndex = self._base_engine.index
        #: Monotone data-version counter — result caches key on it, so
        #: any mutation path must bump it to invalidate them.  The
        #: in-memory database is immutable, so it stays 0.
        self.data_epoch: int = 0
        self._backends: dict[tuple, QueryBackend] = {}
        #: fitted §8 model (see :meth:`fit_response_model`); when set it is
        #: the default ``predict_hits`` for planning and ``predict_seconds``
        #: for broker admission and stream deadlines.
        self.response_model = None
        # Populated by from_scenario for convenience.
        self.scenario_queries: SegmentArray | None = None
        self.scenario_d: float | None = None

    # -- construction ---------------------------------------------------
    @classmethod
    def from_segments(cls, segments: SegmentArray, *,
                      policy: ExecutionPolicy | None = None, device="cuda",
                      index: TemporalBinIndex | None = None
                      ) -> "TrajectoryDB":
        """Build a database from raw (possibly unsorted) segments.
        ``index`` supplies a prebuilt index of the sorted segments."""
        return cls(segments, policy=policy, device=device, index=index)

    @classmethod
    def from_trajectories(cls, points, times, *, traj_ids=None,
                          policy: ExecutionPolicy | None = None,
                          device="cuda") -> "TrajectoryDB":
        """Build from per-trajectory polylines (see
        ``SegmentArray.from_trajectories``)."""
        segs = SegmentArray.from_trajectories(points, times, traj_ids)
        return cls(segs, policy=policy, device=device)

    @classmethod
    def from_scenario(cls, name: str, *, scale: float = 1.0, seed: int = 0,
                      policy: ExecutionPolicy | None = None,
                      device="cuda") -> "TrajectoryDB":
        """Build one of the paper's §7.2 scenarios (S1–S10, C1, C3); the
        scenario's queries and threshold are attached as
        ``db.scenario_queries`` / ``db.scenario_d``."""
        from repro_torch.data import trajgen
        segments, queries, d = trajgen.make_scenario(name, scale=scale,
                                                     seed=seed)
        db = cls(segments, policy=policy, device=device)
        db.scenario_queries = queries
        db.scenario_d = float(d)
        return db

    def __len__(self) -> int:
        return len(self.segments)

    # -- backends --------------------------------------------------------
    @staticmethod
    def _backend_key(name: str, pol: ExecutionPolicy) -> tuple:
        """The policy fields a backend's construction depends on."""
        if name in ("kernel", "torch"):
            return (pol.cand_blk, pol.qry_blk, pol.capacity, pol.compaction,
                    pol.pipeline, pol.pruning, pol.max_capacity_retries)
        if name == "shard":
            # compaction (and kernel pruning) matter only on the kernel
            # path: key on the effective values, as ShardedEngine
            # normalizes them, so policies differing in an irrelevant knob
            # share one engine.  pol.pruning itself shapes construction
            # too: hierarchical builds the pod-local K-box plan index.
            compaction = pol.compaction if pol.shard_use_kernel else "dense"
            pruning = (pol.pruning if pol.shard_use_kernel
                       and compaction in ("fused", "fused_rowloop")
                       else "none")
            return (pol.shard_pods, pol.shard_capacity, pol.shard_use_kernel,
                    pol.shard_balance, pol.cand_blk, pol.qry_blk, compaction,
                    pol.pipeline, pruning, pol.pruning, pol.shard_sparse,
                    pol.max_capacity_retries)
        if name == "rtree":
            return (pol.rtree_r, pol.rtree_fanout, pol.rtree_threads)
        return (pol.brute_chunk,)

    def backend(self, name: str,
                policy: ExecutionPolicy | None = None) -> QueryBackend:
        """The (cached) backend adapter for ``name`` under ``policy``."""
        if name not in BACKENDS:
            raise ValueError(
                f"unknown backend {name!r}; choose from {BACKENDS}")
        pol = policy or self.policy
        key = (name,) + self._backend_key(name, pol)
        if key not in self._backends:
            if name in ("kernel", "torch"):
                eng = copy.copy(self._base_engine)   # shares db/index/packed
                eng.use_kernel = (name == "kernel")
                eng.cand_blk = pol.cand_blk
                eng.qry_blk = pol.qry_blk
                eng.default_capacity = pol.capacity
                eng.compaction = pol.compaction
                eng.pipeline = pol.pipeline
                eng.pruning = pol.pruning
                eng.max_capacity_retries = pol.max_capacity_retries
                self._backends[key] = EngineBackend(name, eng)
            elif name == "shard":
                from repro_torch.core.distributed import ShardedEngine
                compaction = (pol.compaction if pol.shard_use_kernel
                              else "dense")
                self._backends[key] = ShardBackend(ShardedEngine(
                    self.segments, pods=pol.shard_pods,
                    capacity_per_shard=pol.shard_capacity,
                    use_kernel=pol.shard_use_kernel, cand_blk=pol.cand_blk,
                    qry_blk=pol.qry_blk, compaction=compaction,
                    pipeline=pol.pipeline, balance=pol.shard_balance,
                    pruning=pol.pruning, index=self.index,
                    sparse=pol.shard_sparse,
                    max_capacity_retries=pol.max_capacity_retries,
                    device=self.device))
            elif name == "rtree":
                self._backends[key] = RTreeBackend(
                    RTreeEngine(self.segments, r=pol.rtree_r,
                                fanout=pol.rtree_fanout),
                    threads=pol.rtree_threads)
            else:
                self._backends[key] = BruteBackend(
                    self.segments, chunk=pol.brute_chunk, device=self.device)
        return self._backends[key]

    def engine(self, backend: str = "kernel",
               policy: ExecutionPolicy | None = None
               ) -> DistanceThresholdEngine:
        """The underlying engine of an engine backend."""
        be = self.backend(backend, policy)
        if not isinstance(be, EngineBackend):
            raise ValueError(f"backend {backend!r} has no engine")
        return be.engine

    # -- planning --------------------------------------------------------
    def planner(self, pol: ExecutionPolicy | None = None, *,
                num_queries: int = 0, backend: str = "kernel"
                ) -> QueryPlanner:
        """The :class:`~repro_torch.core.planner.QueryPlanner` a policy
        resolves to (capacities per pod for ``backend="shard"``).  A
        fitted §8 model attached via :meth:`fit_response_model` feeds its
        ``predict_hits`` (dispatch-group sizing)."""
        pol = pol or self.policy
        if pol.pruning not in PRUNINGS:
            raise ValueError(f"unknown pruning {pol.pruning!r}; "
                             f"choose from {PRUNINGS}")
        capacity = pol.shard_capacity if backend == "shard" else pol.capacity
        predict_hits = (self.response_model.predict_batch_hits
                        if self.response_model is not None else None)
        pruning = pol.pruning
        index = self.index
        if backend == "shard" and pruning == "hierarchical":
            # Shard plans under hierarchical pruning address pod-permuted
            # positions: plan on the engine's pod-partitioned K-box index,
            # whose box sub-ranges line up with the pod ownership slices
            # and the engine's permuted packed copy.
            eng = self.backend("shard", pol).engine
            if eng.plan_index is not None:
                index = eng.plan_index
            else:
                pruning = eng.plan_pruning
        return QueryPlanner(
            index, algorithm=pol.batching,
            params=pol.resolved_batch_params(num_queries),
            default_capacity=capacity, group_size=pol.group_size,
            pruning=pruning, predict_hits=predict_hits,
            max_subranges=pol.max_subranges)

    def plan(self, queries: SegmentArray,
             policy: ExecutionPolicy | None = None, *,
             backend: str = "kernel", d: float | None = None) -> QueryPlan:
        """A query plan for sorted-or-not queries.  Pass ``d`` to get the
        pruned plan the query path would execute."""
        qs, _ = self._sorted(queries)
        return self._make_plan(qs, policy or self.policy, backend, d=d)

    def _make_plan(self, sorted_queries: SegmentArray, pol: ExecutionPolicy,
                   backend: str = "kernel",
                   d: float | None = None) -> QueryPlan:
        return self.planner(pol, num_queries=len(sorted_queries),
                            backend=backend).plan(sorted_queries, d=d)

    @staticmethod
    def _sorted(queries: SegmentArray
                ) -> tuple[SegmentArray, np.ndarray | None]:
        """Sort queries by t_start, returning (sorted, permutation) where
        ``permutation[i]`` is the caller index of sorted position ``i``
        (None when already sorted)."""
        if queries.is_sorted():
            return queries, None
        order = np.argsort(queries.ts, kind="stable").astype(np.int64)
        return queries.take(order), order

    def _resolve_policy(self, batching: str | None,
                        policy: ExecutionPolicy | None,
                        batch_params: Mapping,
                        compaction: str | None = None,
                        pipeline: bool | None = None,
                        pruning: str | None = None) -> ExecutionPolicy:
        pol = policy or self.policy
        if batching is not None:
            pol = pol.with_(batching=batching, batch_params=None)
        if batch_params:
            pol = pol.with_(batch_params=dict(batch_params))
        if compaction is not None:
            pol = pol.with_(compaction=compaction)
        if pipeline is not None:
            pol = pol.with_(pipeline=pipeline)
        if pruning is not None:
            pol = pol.with_(pruning=pruning)
        return pol

    # -- the entrypoint --------------------------------------------------
    def query(self, queries: SegmentArray, d: float, *,
              backend: str = "kernel", batching: str | None = None,
              policy: ExecutionPolicy | None = None,
              compaction: str | None = None, pipeline: bool | None = None,
              pruning: str | None = None,
              **batch_params) -> QueryResult:
        """Find every (entry segment, query segment) pair within distance
        ``d`` during their temporal overlap.

        ``queries`` may be in any order; the returned ``query_idx`` is in
        the caller's order.  ``batching``/``**batch_params``,
        ``compaction=``, ``pipeline=`` and ``pruning=`` are one-off policy
        overrides for the engine backends.
        """
        d = _validate_threshold(d)
        if len(queries) == 0:
            return QueryResult.from_result_set(
                ResultSet.empty(), order=None, d=d, backend=backend)
        _validate_segments(queries, "queries")
        pol = self._resolve_policy(batching, policy, batch_params,
                                   compaction, pipeline, pruning)
        be = self.backend(backend, pol)
        qs, order = self._sorted(queries)
        plan = (self._make_plan(qs, pol, backend, d=d) if be.needs_plan
                else None)
        rs, stats = be.run(qs, d, plan)
        return QueryResult.from_result_set(
            rs, order=order, d=d, backend=backend, stats=stats, plan=plan)

    # -- streaming / serving ---------------------------------------------
    def query_stream(self, queries: SegmentArray, d: float, *,
                     backend: str = "kernel", batching: str | None = None,
                     policy: ExecutionPolicy | None = None,
                     compaction: str | None = None,
                     pipeline: bool | None = None,
                     pruning: str | None = None,
                     predict_seconds: Callable | None = None,
                     delay_hook: Callable | None = None,
                     **batch_params) -> tuple[QueryResult, SchedulerStats]:
        """Like :meth:`query`, but executes the plan through the
        deadline/re-issue scheduler (``repro_torch.core.scheduler``) — the
        mode a serving deployment uses, where a straggling batch *group* is
        re-issued rather than stalling the response.

        The scheduler hands every worker call a *group* of consecutive
        batches (≥ 2 by default; ``ExecutionPolicy.stream_group_size``
        overrides) and each call runs as one pipelined two-phase dispatch
        — ≤ 2 host syncs per group.  Re-issue, deduplication and deadlines
        (§8-model-derived, summed over the group) all operate on groups.
        ``backend="shard"`` routes every group through a per-pod
        ``repro_torch.core.distributed.PodRouter``;
        ``SchedulerStats.routing`` then carries its fan-out and hit-balance
        accounting.
        """
        if backend not in ENGINE_BACKENDS:
            raise ValueError(
                f"query_stream requires an engine backend "
                f"{ENGINE_BACKENDS}, got {backend!r}")
        d = _validate_threshold(d)
        if len(queries) == 0:
            return (QueryResult.from_result_set(
                ResultSet.empty(), order=None, d=d, backend=backend),
                SchedulerStats())
        _validate_segments(queries, "queries")
        pol = self._resolve_policy(batching, policy, batch_params,
                                   compaction, pipeline, pruning)
        engine = self.backend(backend, pol).engine
        if backend == "shard":
            from repro_torch.core.distributed import PodRouter
            engine = PodRouter(engine)
        qs, order = self._sorted(queries)
        plan = self._make_plan(qs, pol, backend, d=d)
        if predict_seconds is None and self.response_model is not None:
            predict_seconds = self.response_model.predict_batch_seconds
        sched = DeadlineScheduler(
            engine, workers=pol.stream_workers, slack=pol.stream_slack,
            min_deadline=pol.stream_min_deadline,
            predict_seconds=predict_seconds, delay_hook=delay_hook,
            group_size=pol.stream_group_size)
        rs, sstats = sched.execute(qs, d, plan)
        result = QueryResult.from_result_set(
            rs, order=order, d=d, backend=backend, plan=plan)
        return result, sstats

    # -- §8 response-time model ------------------------------------------
    def fit_response_model(self, queries: SegmentArray | None = None,
                           d: float | None = None, *,
                           s: int = DEFAULT_BATCH_SIZE,
                           backend: str = "kernel", quick: bool = True,
                           num_epochs: int = 20, seed: int = 0):
        """Fit the §8 :class:`~repro_torch.core.perfmodel.ResponseTimeModel`
        on this database and attach it as the default predictor.

        One model object then feeds the planner's ``predict_hits``
        (dispatch-group sizing), the broker's ``predict_seconds``
        admission pricing and ``query_stream``'s scheduler deadlines.  The
        device curves time ``count_hits`` through ``backend``'s path on
        this database's device (the dense kernel for ``"kernel"``); the
        host curves and the α fit run ``backend``'s engine.
        ``quick=True`` (default) uses small benchmark grids; pass
        ``quick=False`` for the paper's full grids.  Returns the fitted
        model (also at ``self.response_model``; set that to ``None`` to
        detach).
        """
        from repro_torch.core import perfmodel
        queries = queries if queries is not None else self.scenario_queries
        d = d if d is not None else self.scenario_d
        if queries is None or d is None:
            raise ValueError("fit_response_model needs a representative "
                             "query workload and threshold (or a scenario "
                             "database)")
        curves = dict(use_kernel=backend == "kernel", seed=seed,
                      device=self.device)
        if quick:
            device = perfmodel.benchmark_device_curves(
                c_values=(256, 2048), q_values=(16, 128), repeats=1,
                **curves)
        else:
            device = perfmodel.benchmark_device_curves(**curves)
        engine = self.engine(backend)
        qs, _ = self._sorted(queries)
        host = perfmodel.benchmark_host_curves(
            engine, qs, s_values=(16, 64) if quick else (16, 32, 64, 128, 256),
            seed=seed)
        model = perfmodel.ResponseTimeModel(device, host,
                                            num_epochs=num_epochs)
        model.fit_alphas(engine, qs, float(d), s=s, seed=seed)
        self.response_model = model
        return model

    # -- session-oriented serving ----------------------------------------
    def broker(self, *, backend: str = "kernel",
               policy: ExecutionPolicy | None = None, **kwargs):
        """A :class:`repro_torch.serve.broker.QueryBroker` bound to this
        database — the session-oriented serving front door: ``submit()``
        returns a ticketed future-like handle, ``step()`` /
        ``run_until_idle()`` pump pending work one dispatch group at a time
        with incremental per-group result slices, and admission control
        prices tickets with the §8 perf model.  Keyword arguments are
        forwarded to the broker constructor (``predict_seconds=``,
        ``max_inflight_interactions=``, ``cache=``, ``retry=``, ...).
        """
        from repro_torch.serve.broker import QueryBroker
        return QueryBroker(self, backend=backend, policy=policy, **kwargs)


def __getattr__(name: str):
    # Broker types are re-exported here (the facade is the stable surface)
    # but defined in repro_torch.serve.broker, which imports this module —
    # the lazy hook breaks the cycle.
    if name in ("QueryBroker", "QueryTicket", "GroupSlice",
                "AdmissionError", "DeadlineExceededError",
                "TicketHealth", "Degradation"):
        from repro_torch.serve import broker as _broker
        return getattr(_broker, name)
    if name == "RetryPolicy":
        from repro_torch.serve.retry import RetryPolicy
        return RetryPolicy
    if name in ("FaultPlan", "FaultSpec"):
        from repro_torch import faults
        return getattr(faults, name)
    raise AttributeError(f"module 'repro_torch.api' has no attribute "
                         f"{name!r}")


__all__ = [
    "BACKENDS", "DEFAULT_BATCH_SIZE", "ENGINE_BACKENDS", "AdmissionError",
    "BruteBackend", "CapacityError", "DeadlineExceededError", "Degradation",
    "EngineBackend", "ExecutionPolicy", "FaultPlan", "FaultSpec",
    "GroupSlice", "PodFailedError", "QueryBackend", "QueryBroker",
    "QueryResult", "QueryTicket", "RetryPolicy", "RTreeBackend",
    "ShardBackend", "TicketHealth", "TrajectoryDB",
]
