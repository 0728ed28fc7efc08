"""Session-oriented serving API: the :class:`QueryBroker` — the port's
counterpart of ``repro/serve/broker.py``.

The paper's workload is an *online stream* of distance-threshold queries
(§3): requests arrive continuously, and the serving loop — admission,
batching cadence, result hand-back — is where a GPU trajectory system
wins or loses at scale.

* :meth:`QueryBroker.submit` returns a :class:`QueryTicket` — a future-like
  handle (``done()`` / ``result(timeout=)`` / ``partial()``).  Planning
  happens at submit time, so the ticket knows its dispatch groups, its
  interaction volume, and (given a §8 model predictor) its predicted
  execution time before any device work runs.
* **Admission control** prices tickets with the §8 perf-model predictions:
  a ticket whose predicted time (queued work included) cannot meet its
  ``deadline=`` is rejected at submit (:class:`AdmissionError`), and a
  bounded in-flight-interactions budget (``max_inflight_interactions``)
  provides backpressure — rejected work never occupies the device.
* :meth:`QueryBroker.step` pumps pending work **one dispatch group at a
  time** through the shared
  :class:`~repro_torch.core.executor.PipelinedExecutor` (≤ 2 host syncs per
  group), delivering an incremental :class:`GroupSlice` to the ticket (and
  its ``on_slice`` callback) as each group's results marshal.
  ``run_until_idle()`` drains everything pending.
* Slices concatenate to **exactly** the canonical ``db.query(...)`` result:
  each slice is canonicalized within its group and mapped to the caller's
  query order; ``result()`` finalizes the global canonical order.
* The broker routes over *any* backend, including ``backend="shard"``: a
  ticket's groups fan out to the per-pod candidate slices through
  :class:`repro_torch.core.distributed.PodRouter`, per-pod hits merge
  globally indexed, and ``ticket.routing`` reports the pod fan-out and hit
  balance.
* A group that raises marks its ticket **errored** (state ``"error"``,
  ``result()`` re-raises, ``exception()`` exposes it) without poisoning the
  queue — callers can retry by resubmitting.

The broker is a single-threaded pump by design: ``step()`` is the event
loop body an async transport (HTTP handler, queue consumer) calls; the
broker itself is not thread-safe.  It always executes groups through the
pipelined executor.

Group selection is **earliest-deadline-first**: each ``step()`` pumps the
pending ticket with the nearest absolute deadline; tickets without a
deadline run after all deadlined ones, FIFO among themselves.  Within a
ticket, groups execute in order (slice concatenation stays a canonical
prefix).

**Fault tolerance.**  With ``retry=RetryPolicy(...)`` the broker re-issues
failed dispatch groups with bounded attempts and exponential backoff
(deterministic jitter), speculatively duplicates straggling groups (first
completion wins; group execution is stateless and every dispatch owns its
buffers, so a duplicate never touches the first one's), and walks a
**graceful-degradation ladder** on repeated non-transient failure:
compaction ``fused → fused_rowloop → dense`` on the hand-written kernels,
then, on a CPU database only, backend ``kernel → torch`` (on a CUDA
database a failure on ``kernel/dense`` fails the ticket: the port never
hands a kernel's work to its plain version on the card); a failing
planner steps pruning
``hierarchical → spatial → none`` at submit; a dropped pod re-routes the
ticket's remaining groups through a single-device fallback dispatcher
(the ``"route"`` stage: the dense CUDA kernel on a CUDA database, the
torch oracle on a CPU one).  Every rung gives the same
canonical rows — degraded, never wrong.  ``ticket.health``
(:class:`TicketHealth`) records attempts, backoff, straggler re-issues and
every :class:`Degradation` step; permanent failures stay structured
(:class:`~repro_torch.core.errors.CapacityError`, :class:`AdmissionError`,
:class:`DeadlineExceededError`) and :meth:`QueryTicket.partial_result`
hands back the completed canonical prefix flagged ``degraded=True``.
Without a retry policy the first failure errors the ticket.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import (FIRST_COMPLETED, ThreadPoolExecutor, wait)
from concurrent.futures import TimeoutError as _FuturesTimeout
from typing import Callable

import numpy as np

from repro_torch import faults
from repro_torch.api import (ExecutionPolicy, QueryResult, TrajectoryDB,
                             _validate_segments, _validate_threshold)
from repro_torch.core.errors import CapacityError, PodFailedError
from repro_torch.core.executor import ExecStats, PipelinedExecutor, ResultSet
from repro_torch.core.planner import QueryPlan, make_groups
from repro_torch.core.segments import SegmentArray
from repro_torch.serve.retry import RetryPolicy

#: Ticket lifecycle states (in order).
PENDING, PARTIAL, DONE, ERROR = "pending", "partial", "done", "error"


class AdmissionError(RuntimeError):
    """Submit-time rejection: backpressure budget exceeded, or the §8-model
    predicted time cannot meet the requested deadline.  Nothing was
    enqueued; the caller may retry later (or with a looser deadline)."""


class DeadlineExceededError(RuntimeError):
    """An admitted ticket's deadline passed before its groups finished;
    the ticket is errored and its remaining groups are dropped."""


#: The result array columns, derived from ResultSet so a future column
#: cannot silently go missing from the partial() concatenation.
_RESULT_FIELDS = tuple(f.name for f in dataclasses.fields(ResultSet))


def _concat_results(parts: list[QueryResult], *, d: float,
                    backend: str) -> QueryResult:
    """Plain concatenation of slice results in delivery order (the
    ``partial()`` view; the canonical finalize goes through
    ``ResultSet.concatenate`` + ``QueryResult.from_result_set`` instead —
    the exact transform ``db.query`` uses)."""
    if not parts:
        return QueryResult.from_result_set(ResultSet.empty(), order=None,
                                           d=d, backend=backend)
    arrays = {f: np.concatenate([getattr(p, f) for p in parts])
              for f in _RESULT_FIELDS}
    return QueryResult(d=d, backend=backend, **arrays)


@dataclasses.dataclass
class GroupSlice:
    """One delivered increment: the results of one dispatch group.

    ``result`` is canonical *within* the slice (rows lexsorted by caller
    ``query_idx`` then ``entry_idx``); consecutive slices of a ticket whose
    queries were submitted in sorted order concatenate to the exact
    canonical ``db.query`` result (dispatch groups cover disjoint,
    increasing sorted-query ranges).  ``num_syncs ≤ 2`` — each slice is one
    pipelined two-phase dispatch.
    """

    group_index: int
    num_groups: int
    batch_indices: list[int]
    result: QueryResult
    num_syncs: int
    seconds: float               # wall time of this group's pump step


#: Compaction/backend rungs of the degradation ladder, most- to
#: least-performant.  A ``backend="kernel"`` ticket enters at its
#: policy's compaction rung and steps down on repeated kernel failure;
#: the batch plan is compaction/backend-independent, so every rung
#: reuses it unchanged and produces the same canonical rows.
DEGRADATION_LADDER = (("kernel", "fused"), ("kernel", "fused_rowloop"),
                      ("kernel", "dense"), ("torch", "dense"))


def degradation_ladder(device) -> tuple:
    """The rungs a ``backend="kernel"`` ticket may walk on ``device``.

    On a CUDA database the ladder ends at ``kernel/dense``: the last rung,
    ``torch/dense``, would hand a failing kernel's work to the plain torch
    version on the same card, so a failure there fails the ticket (its
    cause in ``exception()``) instead.  A CPU database, whose kernel
    wrappers run their plain twins anyway, keeps the whole ladder."""
    if getattr(device, "type", str(device)) == "cpu":
        return DEGRADATION_LADDER
    return tuple(r for r in DEGRADATION_LADDER if r[0] == "kernel")


@dataclasses.dataclass
class Degradation:
    """One graceful-degradation step taken while serving a ticket.

    ``stage`` is ``"compaction"`` (kernel result-compaction rung),
    ``"backend"`` (kernel → torch, on a CPU database only),
    ``"pruning"`` (planner ladder at submit) or ``"route"`` (dropped pod
    re-routed to the single-device fallback).  ``before``/``after`` name
    the rungs; ``group`` is the dispatch group whose failure triggered
    the step (``None`` for submit-time planning steps)."""

    stage: str
    before: str
    after: str
    group: int | None = None
    reason: str = ""


@dataclasses.dataclass
class TicketHealth:
    """Per-ticket fault/retry accounting, live on
    ``ticket.health`` from submit on.

    ``attempts`` maps group index → executions started (1 = clean);
    ``retries`` counts re-issues after failure, ``backoff_seconds`` the
    total backoff the retry policy imposed, ``stragglers_reissued`` the
    speculative duplicates, ``cache_failures`` result-cache operations
    that failed (degraded to miss/skip), and ``degradations`` every
    ladder step taken.  ``degraded`` is the flag the final
    ``QueryResult`` carries."""

    attempts: dict = dataclasses.field(default_factory=dict)
    retries: int = 0
    backoff_seconds: float = 0.0
    stragglers_reissued: int = 0
    cache_failures: int = 0
    degradations: list = dataclasses.field(default_factory=list)

    @property
    def degraded(self) -> bool:
        return bool(self.degradations)


class QueryTicket:
    """Future-like handle for one submitted query set.

    Lifecycle: ``"pending"`` (admitted, no groups executed) →
    ``"partial"`` (≥ 1 slice delivered) → ``"done"`` (all groups delivered,
    ``result()`` available) or ``"error"`` (a group raised / deadline
    passed — ``exception()`` has the cause, ``result()`` re-raises).

    Tickets are pump-driven: nothing executes until the broker's
    ``step()`` / ``run_until_idle()`` runs (``result()`` pumps the broker
    itself, so a plain submit-then-result flow needs no explicit pump).
    """

    def __init__(self, broker: "QueryBroker", uid: int,
                 queries: SegmentArray, d: float, backend: str, *,
                 deadline: float | None, predicted_seconds: float | None,
                 interactions: int, order, plan: QueryPlan | None,
                 groups: list, group_ints: list[int],
                 group_pred: list[float], run_group: Callable | None,
                 on_slice: Callable | None):
        self.broker = broker
        self.uid = uid
        self.queries = queries
        self.d = float(d)
        self.backend = backend
        self.submitted_at = time.perf_counter()
        self.deadline = deadline
        self.predicted_seconds = predicted_seconds
        self.interactions = interactions
        self.plan = plan
        self.on_slice = on_slice
        self.routing = None           # RoutingStats for backend="shard"
        self._order = order
        self._groups = groups
        self._group_ints = group_ints
        self._group_pred = group_pred
        self._run_group = run_group
        self._slices: list[GroupSlice] = []
        self._parts: list = []          # raw ResultSet parts, sorted frame
        self._partial_cache: tuple[int, QueryResult] | None = None
        self._next_group = 0
        self._error: BaseException | None = None
        self._final: QueryResult | None = None
        #: Retry/degradation accounting.
        self.health = TicketHealth()
        self._not_before = 0.0         # pump gate while backing off
        self._consec_failures = 0      # of the *current* group/rung
        self._epoch = 0                # db.data_epoch captured at submit
        self._pol: ExecutionPolicy | None = None
        self._exec_qs: SegmentArray | None = None
        self._ladder: list = []        # remaining degradation rungs
        self._rung: tuple = (backend, "")
        self._rerouted = False         # pod-dropout fallback taken

    # -- state ----------------------------------------------------------
    @property
    def state(self) -> str:
        if self._error is not None:
            return ERROR
        if self._final is not None:
            return DONE
        if self._slices:
            return PARTIAL
        return PENDING

    def done(self) -> bool:
        """True once the ticket reached a terminal state (done or error)."""
        return self._error is not None or self._final is not None

    def exception(self) -> BaseException | None:
        return self._error

    @property
    def num_groups(self) -> int:
        return len(self._groups)

    @property
    def groups_completed(self) -> int:
        return len(self._slices)

    def slices(self) -> tuple[GroupSlice, ...]:
        """Every slice delivered so far (stable — slices never mutate)."""
        return tuple(self._slices)

    # -- results ---------------------------------------------------------
    def partial(self) -> QueryResult:
        """Concatenation of the slices delivered so far — the incremental
        view (a canonical prefix when the submitted queries were sorted).
        Valid in every state; empty while pending.  Cached per delivered
        slice count, so polling it every pump step stays linear."""
        if self._final is not None:
            return self._final
        n = len(self._slices)
        if self._partial_cache is None or self._partial_cache[0] != n:
            self._partial_cache = (n, _concat_results(
                [s.result for s in self._slices], d=self.d,
                backend=self.backend))
        return self._partial_cache[1]

    def result(self, timeout: float | None = None) -> QueryResult:
        """The full canonical result, pumping the broker until this ticket
        completes.  Raises the ticket's error if it failed, or
        ``TimeoutError`` after ``timeout`` seconds of pumping (the ticket
        stays queued and keeps its delivered slices)."""
        t0 = time.perf_counter()
        while not self.done():
            if timeout is not None and time.perf_counter() - t0 > timeout:
                raise TimeoutError(
                    f"ticket {self.uid}: {self.groups_completed}/"
                    f"{self.num_groups} groups after {timeout}s")
            if not self.broker.step():   # pragma: no cover - invariant
                raise RuntimeError("broker idle but ticket incomplete")
        if self._error is not None:
            raise self._error
        return self._final

    def partial_result(self) -> QueryResult:
        """The canonical result of the groups completed so far — the
        graceful answer for an errored (or still-running) ticket.
        Identical to :meth:`result` once done; otherwise the completed
        canonical prefix with ``degraded=True`` (an errored ticket keeps
        its delivered parts, so callers get every finished slice plus
        the structured error from :meth:`exception`)."""
        if self._final is not None:
            return self._final
        rs = (ResultSet.concatenate(self._parts) if self._parts
              else ResultSet.empty())
        res = QueryResult.from_result_set(rs, order=self._order, d=self.d,
                                          backend=self.backend)
        res.degraded = True
        return res


class QueryBroker:
    """Ticketed asynchronous serving front door over one ``TrajectoryDB``.

    Example::

        db = TrajectoryDB.from_scenario("S2", scale=0.02)
        broker = db.broker(backend="kernel")
        t = broker.submit(db.scenario_queries, db.scenario_d,
                          on_slice=lambda tk, sl: push(tk.uid, sl.result))
        while broker.step():          # the serving event loop
            ...                       # t.partial() grows as groups finish
        full = t.result()             # canonical, == db.query(...)

    Constructor knobs:

    * ``predict_seconds(batch)`` — the §8 model's per-batch prediction
      (e.g. from ``repro_torch.core.perfmodel.ResponseTimeModel``); prices
      deadline admission and per-ticket ``predicted_seconds``.
    * ``admission_slack`` — multiplier on predictions when checking
      deadlines (the scheduler's slack notion, §8.3).
    * ``max_inflight_interactions`` — backpressure: total admitted-but-
      unfinished interaction volume is bounded; a submit that would exceed
      it raises :class:`AdmissionError`.
    * ``group_size`` — dispatch-group granularity for every ticket
      (``None`` → the planner's §8-model-derived sizing; per-submit
      override available).
    * ``retry`` — a :class:`~repro_torch.serve.retry.RetryPolicy` enabling
      bounded re-issue of failed groups, speculative straggler
      duplication and the degradation ladder (module docstring);
      ``None`` (default) fails a ticket on its first failure.
    """

    def __init__(self, db: TrajectoryDB, *, backend: str = "kernel",
                 policy: ExecutionPolicy | None = None,
                 predict_seconds: Callable | None = None,
                 admission_slack: float = 4.0,
                 max_inflight_interactions: int | None = None,
                 group_size: int | None = None,
                 cache=None, retry: RetryPolicy | None = None):
        self.db = db
        self.backend = backend
        self.cache = cache            # SliceCache | None (result cache)
        self.retry = retry            # RetryPolicy | None
        self.ladder = degradation_ladder(db.device)
        self._straggler_pool: ThreadPoolExecutor | None = None
        self.policy = policy or db.policy
        if predict_seconds is None and getattr(db, "response_model",
                                               None) is not None:
            # One fitted §8 model feeds both planning (predict_hits via the
            # facade's planner) and admission pricing here.
            predict_seconds = db.response_model.predict_batch_seconds
        self.predict_seconds = predict_seconds
        self.admission_slack = float(admission_slack)
        self.max_inflight_interactions = max_inflight_interactions
        self.group_size = group_size
        self._queue: list[QueryTicket] = []
        self._next_uid = 0
        self._inflight_interactions = 0
        self._inflight_predicted = 0.0
        self.submitted = 0
        self.completed = 0
        self.errored = 0
        self.rejected = 0
        self.cache_failures = 0       # cache ops degraded to miss/skip

    # -- introspection ----------------------------------------------------
    @property
    def pending(self) -> int:
        """Tickets admitted but not yet terminal."""
        return len(self._queue)

    @property
    def inflight_interactions(self) -> int:
        """Interaction volume of admitted-but-unfinished groups (the
        quantity ``max_inflight_interactions`` bounds)."""
        return self._inflight_interactions

    # -- submit -----------------------------------------------------------
    def submit(self, queries: SegmentArray, d: float, *,
               backend: str | None = None,
               policy: ExecutionPolicy | None = None,
               deadline: float | None = None,
               group_size: int | None = None,
               on_slice: Callable | None = None) -> QueryTicket:
        """Admit a query set and return its :class:`QueryTicket`.

        Planning runs now (host-side only); device work waits for the
        pump.  ``deadline`` is wall seconds from submit — enforced at
        admission against the §8-model prediction of queued + own work
        (when the broker has a predictor) and at every pump step
        thereafter.  ``on_slice(ticket, slice)`` fires as each dispatch
        group's results marshal.  Raises :class:`AdmissionError` instead
        of enqueueing when the ticket cannot be served.
        """
        backend = backend or self.backend
        pol = policy or self.policy
        uid = self._next_uid
        self._next_uid += 1
        d = _validate_threshold(d)
        _validate_segments(queries, "queries")
        # Capture the data version *now*: the ticket's cache lookup and
        # its eventual insert both key on the submit-time epoch, so a
        # mutation that bumps the epoch mid-flight makes the entry born
        # stale (lazily dropped) instead of stamping stale rows fresh.
        epoch = getattr(self.db, "data_epoch", 0)

        if len(queries) == 0:
            ticket = QueryTicket(
                self, uid, queries, d, backend, deadline=deadline,
                predicted_seconds=0.0, interactions=0, order=None,
                plan=None, groups=[], group_ints=[], group_pred=[],
                run_group=None, on_slice=on_slice)
            ticket._final = _concat_results([], d=d, backend=backend)
            self.submitted += 1
            self.completed += 1
            return ticket

        # -- result cache: exact-containment hit ------------------------
        # A hit skips planning, admission and every pump step: the ticket
        # is born done, with one synthesized slice (num_syncs == 0) so the
        # slices()/on_slice contract holds for monitoring callers.
        if self.cache is not None:
            t0 = time.perf_counter()
            try:
                if faults.armed():
                    faults.inject("cache.lookup", uid=uid)
                hit = self.cache.lookup(queries, d, epoch)
            except Exception:
                # A cache outage degrades to a miss: the fresh
                # computation below is the canonical path, not a
                # degraded one.
                self.cache_failures += 1
                hit = None
            if hit is not None:
                arrays, _lens = hit
                res = QueryResult(
                    entry_idx=arrays["entry_idx"],
                    entry_traj=arrays["entry_traj"],
                    entry_seg=arrays["entry_seg"],
                    query_idx=arrays["query_idx"],
                    t_enter=arrays["t_enter"], t_exit=arrays["t_exit"],
                    d=d, backend=backend)
                ticket = QueryTicket(
                    self, uid, queries, d, backend, deadline=deadline,
                    predicted_seconds=0.0, interactions=0, order=None,
                    plan=None, groups=[None], group_ints=[0],
                    group_pred=[0.0], run_group=None, on_slice=on_slice)
                ticket._final = res
                ticket._next_group = 1
                slice_ = GroupSlice(
                    group_index=0, num_groups=1, batch_indices=[],
                    result=res, num_syncs=0,
                    seconds=time.perf_counter() - t0)
                ticket._slices.append(slice_)
                self.submitted += 1
                self.completed += 1
                if on_slice is not None:
                    on_slice(ticket, slice_)
                return ticket

        be = self.db.backend(backend, pol)
        qs, order = TrajectoryDB._sorted(queries)
        plan_degradations: list[Degradation] = []
        if be.needs_plan:
            # Planning ladder: a failing planner steps pruning
            # hierarchical → spatial → none before giving up — a plan
            # with less pruning does more work but yields the same
            # canonical rows.  The backend is re-resolved per rung so
            # the engine's pruning matches the plan it executes.
            while True:
                try:
                    if faults.armed():
                        faults.inject("broker.plan", uid=uid,
                                      backend=backend, pruning=pol.pruning)
                    plan = self.db._make_plan(qs, pol, backend, d=d)
                    break
                except Exception as e:
                    nxt = {"hierarchical": "spatial",
                           "spatial": "none"}.get(pol.pruning)
                    if self.retry is None or nxt is None:
                        raise
                    plan_degradations.append(Degradation(
                        stage="pruning", before=pol.pruning, after=nxt,
                        group=None, reason=repr(e)))
                    pol = pol.with_(pruning=nxt)
                    be = self.db.backend(backend, pol)
            interactions = plan.total_interactions
            gs = group_size if group_size is not None else self.group_size
            # Group along the plan's split runs: sibling batches of one
            # pruned query range must share a slice for the concatenation
            # to stay a canonical prefix.
            groups = (make_groups(plan.num_batches, gs, runs=plan.runs)
                      if gs is not None else [list(g) for g in plan.groups])
            group_ints = [sum(plan.batches[i].num_ints for i in g)
                          for g in groups]
        else:
            # CPU baselines have no plan: the whole request is one slice.
            plan = None
            interactions = len(self.db.segments) * len(qs)
            groups = [None]
            group_ints = [interactions]

        # -- admission: backpressure budget -----------------------------
        if (self.max_inflight_interactions is not None
                and self._inflight_interactions + interactions
                > self.max_inflight_interactions):
            self.rejected += 1
            raise AdmissionError(
                f"ticket {uid}: {interactions} interactions would exceed "
                f"the in-flight budget ({self._inflight_interactions} of "
                f"{self.max_inflight_interactions} in use) — retry after "
                f"pumping")

        # -- admission: §8-model deadline pricing ------------------------
        predicted = None
        group_pred = [0.0] * len(groups)
        if self.predict_seconds is not None and plan is not None:
            group_pred = [sum(self.predict_seconds(plan.batches[i])
                              for i in g) for g in groups]
            predicted = sum(group_pred)
            if deadline is not None:
                priced = (self._inflight_predicted + predicted
                          ) * self.admission_slack
                if priced > deadline:
                    self.rejected += 1
                    raise AdmissionError(
                        f"ticket {uid}: predicted {predicted:.4g}s "
                        f"(+{self._inflight_predicted:.4g}s queued) × "
                        f"slack {self.admission_slack} exceeds deadline "
                        f"{deadline}s")

        run_group = self._make_runner(be, backend, qs, d, plan)
        ticket = QueryTicket(
            self, uid, queries, d, backend, deadline=deadline,
            predicted_seconds=predicted, interactions=interactions,
            order=order, plan=plan, groups=groups, group_ints=group_ints,
            group_pred=group_pred, run_group=run_group, on_slice=on_slice)
        # Retry/degradation state: the resolved policy and sorted
        # queries let failure handling rebuild runners on a lower rung.
        ticket._pol = pol
        ticket._exec_qs = qs
        ticket._epoch = epoch
        ticket._rung = (backend, pol.compaction)
        if self.retry is not None and backend == "kernel":
            rungs = list(self.ladder)
            ticket._ladder = (rungs[rungs.index(ticket._rung) + 1:]
                              if ticket._rung in rungs
                              else [r for r in rungs if r[0] != "kernel"])
        if backend == "shard":
            ticket.routing = run_group.dispatcher.router.stats
        ticket.health.degradations.extend(plan_degradations)
        self._inflight_interactions += interactions
        self._inflight_predicted += predicted or 0.0
        self._queue.append(ticket)
        self.submitted += 1
        return ticket

    def _make_runner(self, be, backend: str, qs: SegmentArray, d: float,
                     plan: QueryPlan | None):
        """The per-ticket group runner.  Engine backends share one
        dispatcher (and its one upload of the ticket's queries) across the
        ticket's groups; ``backend="shard"`` fans out through a fresh
        ``PodRouter``."""
        if plan is None:
            def run_whole(group, _be=be, _qs=qs, _d=d):
                rs, stats = _be.run(_qs, _d, None)
                return rs, stats
            return run_whole
        if backend == "shard":
            from repro_torch.core.distributed import PodRouter
            dispatcher = PodRouter(be.engine).dispatcher(qs.packed(), d)
        else:
            dispatcher = be.engine.dispatcher(qs.packed(), d)
        return _GroupRunner(dispatcher, plan,
                            max_capacity_retries=be.engine.max_capacity_retries)

    # -- the pump ---------------------------------------------------------
    def _select(self, candidates) -> QueryTicket:
        """Earliest-deadline-first ticket selection: nearest absolute
        deadline wins; tickets without a deadline sort after every
        deadlined one, FIFO (uid order) among ties."""
        def key(t: QueryTicket):
            dl = (t.submitted_at + t.deadline if t.deadline is not None
                  else float("inf"))
            return (dl, t.uid)
        return min(candidates, key=key)

    def step(self) -> bool:
        """Execute the next pending dispatch group (one pipelined two-phase
        dispatch, ≤ 2 host syncs) of the earliest-deadline pending ticket
        and deliver its slice.  Returns ``False`` when nothing is pending —
        the serving loop's idle signal.  When every pending ticket is
        waiting out a retry backoff the step sleeps briefly (≤ 50 ms) and
        returns ``True``: the queue is not idle, just backing off."""
        if not self._queue:
            return False
        now = time.perf_counter()
        ready = [t for t in self._queue if t._not_before <= now]
        if not ready:
            wake = min(t._not_before for t in self._queue)
            time.sleep(min(max(wake - now, 0.0), 0.05))
            return True
        ticket = self._select(ready)
        if (ticket.deadline is not None
                and time.perf_counter() - ticket.submitted_at
                > ticket.deadline):
            self._fail(ticket, DeadlineExceededError(
                f"ticket {ticket.uid}: deadline {ticket.deadline}s passed "
                f"with {ticket.groups_completed}/{ticket.num_groups} "
                f"groups delivered"))
            return True
        gi = ticket._next_group
        g = ticket._groups[gi]
        ticket.health.attempts[gi] = ticket.health.attempts.get(gi, 0) + 1
        t0 = time.perf_counter()
        try:
            rs_part, stats = self._execute_group(ticket, g)
        except Exception as e:
            self._handle_failure(ticket, e)
            return True
        ticket._consec_failures = 0
        self._deliver(ticket, g, rs_part, stats,
                      time.perf_counter() - t0)
        return True

    def _execute_group(self, ticket: QueryTicket, group):
        """Run one dispatch group, with speculative straggler re-issue
        when the retry policy enables it.

        Sync audit: ``_run_group`` is the executor's pipelined dispatch
        (its ≤ 2 fence waits are the *only* host syncs);
        results come back as marshalled numpy ``ResultSet``s, so the
        delivery path never touches a device buffer."""
        run = ticket._run_group
        timeout = (self.retry.straggler_timeout(
            ticket._group_pred[ticket._next_group])
            if self.retry is not None else None)
        if timeout is None:
            return run(group)
        # Duplicate the dispatch once the predicted time (× slack) is
        # exceeded; first completion wins.  Group execution is stateless
        # and deterministic, so the duplicate is byte-identical and the
        # loser is simply discarded.
        pool = self._straggler_workers()
        fut = pool.submit(run, group)
        try:
            return fut.result(timeout=timeout)   # lint: sync-point
        except _FuturesTimeout:
            ticket.health.stragglers_reissued += 1
            fut2 = pool.submit(run, group)
            done, _ = wait({fut, fut2}, return_when=FIRST_COMPLETED)
            return next(iter(done)).result()     # lint: sync-point

    def _straggler_workers(self) -> ThreadPoolExecutor:
        if self._straggler_pool is None:
            self._straggler_pool = ThreadPoolExecutor(max_workers=2)
        return self._straggler_pool

    def run_until_idle(self) -> int:
        """Pump until no work is pending; returns pump steps executed."""
        steps = 0
        while self.step():
            steps += 1
        return steps

    # -- internals --------------------------------------------------------
    def _release(self, ticket: QueryTicket, from_group: int) -> None:
        self._inflight_interactions -= sum(ticket._group_ints[from_group:])
        self._inflight_predicted -= sum(ticket._group_pred[from_group:])

    def _fail(self, ticket: QueryTicket, error: BaseException) -> None:
        ticket._error = error
        ticket._run_group = None       # drop the dispatcher's packed copies
        self._release(ticket, ticket._next_group)
        self._queue.remove(ticket)
        self.errored += 1

    def _handle_failure(self, ticket: QueryTicket,
                        error: BaseException) -> None:
        """Route one group failure.

        Permanent/structured errors (and any failure without a retry
        policy) fail the ticket; a dropped pod re-routes the remaining
        groups through the single-device fallback and retries
        immediately; everything else re-issues with backoff,
        stepping the degradation ladder after ``degrade_after`` consecutive
        non-transient failures of the same group.  The ticket's
        interaction budget stays held across retries — the work is still
        pending — and is released exactly once, on delivery or
        :meth:`_fail`."""
        from repro_torch.faults import InjectedResourceExhausted
        gi = ticket._next_group
        health = ticket.health
        retry = self.retry
        if retry is None or isinstance(
                error, (CapacityError, AdmissionError,
                        DeadlineExceededError)):
            # Structured/permanent: re-running cannot change the outcome
            # (CapacityError already exhausted the executor's bounded
            # capacity-retry loop, exact count in hand).
            self._fail(ticket, error)
            return
        if isinstance(error, PodFailedError):
            if ticket._rerouted or ticket.backend != "shard":
                self._fail(ticket, error)
                return
            try:
                self._reroute_pod(ticket, error)
            except Exception:
                self._fail(ticket, error)
                return
            health.retries += 1
            return                 # re-issue immediately on the new route
        attempts = health.attempts.get(gi, 0)
        if attempts >= retry.max_attempts:
            self._fail(ticket, error)
            return
        transient = (isinstance(error, InjectedResourceExhausted)
                     or "RESOURCE_EXHAUSTED" in str(error))
        ticket._consec_failures += 1
        if (not transient
                and ticket._consec_failures >= retry.degrade_after
                and self._degrade(ticket, gi, error)):
            ticket._consec_failures = 0
        back = retry.backoff_seconds(ticket.uid, gi, attempts)
        if ticket.deadline is not None:
            remaining = (ticket.submitted_at + ticket.deadline
                         - time.perf_counter())
            back = max(0.0, min(back, remaining))
        ticket._not_before = time.perf_counter() + back
        health.backoff_seconds += back
        health.retries += 1

    def _degrade(self, ticket: QueryTicket, gi: int,
                 error: BaseException) -> bool:
        """Step the ticket one rung down the compaction/backend ladder.
        The plan is reused unchanged (batches and capacities are
        compaction- and backend-independent), so the degraded rung
        produces the same canonical rows — slower, never wrong."""
        if not ticket._ladder or ticket.plan is None:
            return False
        name, compaction = ticket._ladder.pop(0)
        prev = ticket._rung
        pol = ticket._pol.with_(compaction=compaction)
        be = self.db.backend(name, pol)
        ticket._run_group = self._make_runner(be, name, ticket._exec_qs,
                                              ticket.d, ticket.plan)
        ticket._pol = pol
        ticket._rung = (name, compaction)
        ticket.health.degradations.append(Degradation(
            stage="compaction" if name == prev[0] else "backend",
            before=f"{prev[0]}/{prev[1]}", after=f"{name}/{compaction}",
            group=gi, reason=repr(error)))
        return True

    def _reroute_pod(self, ticket: QueryTicket,
                     error: BaseException) -> None:
        """A pod dropped out mid-ticket: re-route the remaining groups
        through the single-device fallback dispatcher over the sharded
        engine's packed copy — no pod parallelism, the same rows."""
        from repro_torch.core.distributed import PodFallbackDispatcher
        se = self.db.backend("shard", ticket._pol).engine
        dispatcher = PodFallbackDispatcher(se, ticket._exec_qs.packed(),
                                           ticket.d)
        ticket._run_group = _GroupRunner(
            dispatcher, ticket.plan,
            max_capacity_retries=se.max_capacity_retries)
        ticket._rerouted = True
        ticket.health.degradations.append(Degradation(
            stage="route", before="shard", after="single-device",
            group=ticket._next_group, reason=repr(error)))

    def _deliver(self, ticket: QueryTicket, group, rs_part,
                 stats: ExecStats | None, seconds: float) -> None:
        sliced = QueryResult.from_result_set(
            rs_part, order=ticket._order, d=ticket.d,
            backend=ticket.backend)
        gi = ticket._next_group
        slice_ = GroupSlice(
            group_index=gi, num_groups=ticket.num_groups,
            batch_indices=list(group) if group is not None else [],
            result=sliced,
            num_syncs=stats.num_syncs if stats is not None else 0,
            seconds=seconds)
        ticket._slices.append(slice_)
        ticket._parts.append(rs_part)
        ticket._next_group += 1
        self._inflight_interactions -= ticket._group_ints[gi]
        self._inflight_predicted -= ticket._group_pred[gi]
        if stats is not None:
            # Mirror the ladder steps taken so far into the slice's
            # ExecStats — monitoring consumers read stats, not tickets.
            stats.degradations = list(ticket.health.degradations)
        if ticket._next_group == ticket.num_groups:
            # Finalize through the exact transform db.query uses
            # (ResultSet.concatenate + from_result_set) so the canonical
            # equivalence is structural, not re-implemented.
            ticket._final = QueryResult.from_result_set(
                ResultSet.concatenate(ticket._parts), order=ticket._order,
                d=ticket.d, backend=ticket.backend)
            ticket._final.degraded = ticket.health.degraded
            if self.cache is not None:
                # Memoize the finished canonical result; repeats of this
                # query set (or byte-exact subsets) now hit in submit().
                # Keyed on the *submit-time* epoch (see submit()), so a
                # mid-flight data mutation leaves this entry stale.
                try:
                    if faults.armed():
                        faults.inject("cache.insert", uid=ticket.uid)
                    self.cache.insert(ticket.queries, ticket.d,
                                      ticket._epoch, ticket._final)
                except Exception:
                    # A cache outage degrades to not memoizing; the
                    # result itself is untouched.
                    self.cache_failures += 1
                    ticket.health.cache_failures += 1
            # Completed tickets may be retained by callers (audit logs,
            # response caches): drop everything execution-only — the raw
            # parts, the runner (whose dispatcher holds packed query
            # copies), the sort permutation and the partial cache.
            ticket._parts = []
            ticket._run_group = None
            ticket._order = None
            ticket._partial_cache = None
            self._queue.remove(ticket)
            self.completed += 1
        if ticket.on_slice is not None:
            ticket.on_slice(ticket, slice_)


class _GroupRunner:
    """Bound (dispatcher, plan) pair: runs one dispatch group as a
    single-group sub-plan through the pipelined executor (≤ 2 host syncs
    per call)."""

    def __init__(self, dispatcher, plan: QueryPlan,
                 max_capacity_retries: int = 3):
        self.dispatcher = dispatcher
        self.plan = plan
        self.max_capacity_retries = max_capacity_retries

    def __call__(self, group: list[int]):
        executor = PipelinedExecutor(
            self.dispatcher, max_capacity_retries=self.max_capacity_retries)
        return executor.run(self.plan.subplan(group))


__all__ = [
    "AdmissionError", "DeadlineExceededError", "Degradation",
    "DEGRADATION_LADDER", "degradation_ladder", "GroupSlice", "QueryBroker", "QueryTicket",
    "TicketHealth", "DONE", "ERROR", "PARTIAL", "PENDING",
]
