"""Deprecated blocking submit/drain shell over ``db.query_stream``.

.. deprecated::
    :class:`TrajectoryQueryService` is superseded by the session-oriented
    :class:`repro_torch.serve.broker.QueryBroker` — ticketed async
    ``submit()``, incremental per-group result slices and §8-model
    admission control.  The port keeps it as the reference does, a thin
    shim (constructing the service emits a ``DeprecationWarning``) so
    submit/drain callers keep working.

``drain()`` never *loses* a request whose execution raises: the failed
request is surfaced as an errored :class:`QueryResponse`
(``response.error`` set, ``result`` ``None``) so callers can inspect and
retry; the remaining queue drains normally.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable

from repro_torch.api import (ENGINE_BACKENDS, ExecutionPolicy, QueryResult,
                             TrajectoryDB)
from repro_torch.core.scheduler import SchedulerStats
from repro_torch.core.segments import SegmentArray


@dataclasses.dataclass(frozen=True)
class QueryRequest:
    """One submitted unit of work: a query segment set + threshold."""

    uid: int
    queries: SegmentArray
    d: float
    submitted_at: float


@dataclasses.dataclass
class QueryResponse:
    uid: int
    result: QueryResult | None
    scheduler: SchedulerStats
    latency_seconds: float   # submit → completion (includes queueing)
    #: the exception a failed request raised (``None`` on success) — the
    #: request is consumed either way; callers retry by resubmitting.
    error: BaseException | None = None

    @property
    def ok(self) -> bool:
        return self.error is None


class TrajectoryQueryService:
    """Deprecated online query service over one ``TrajectoryDB`` (use
    :class:`repro_torch.serve.broker.QueryBroker`).

    Example::

        db = TrajectoryDB.from_scenario("S2", scale=0.02)
        svc = TrajectoryQueryService(db, backend="kernel")  # DeprecationWarning
        uid = svc.submit(db.scenario_queries, db.scenario_d)
        responses = svc.drain()           # {uid: QueryResponse}
    """

    def __init__(self, db: TrajectoryDB, *, backend: str = "kernel",
                 policy: ExecutionPolicy | None = None,
                 predict_seconds: Callable | None = None):
        warnings.warn(
            "TrajectoryQueryService is deprecated; use repro_torch.serve."
            "QueryBroker (db.broker(...)) — ticketed submit(), step()/"
            "run_until_idle() pumping and incremental result slices",
            DeprecationWarning, stacklevel=2)
        if backend not in ENGINE_BACKENDS:
            raise ValueError(
                "TrajectoryQueryService streams through the scheduler and "
                f"therefore needs an engine backend {ENGINE_BACKENDS}, "
                f"got {backend!r}")
        self.db = db
        self.backend = backend
        self.policy = policy or db.policy
        self.predict_seconds = predict_seconds
        self._next_uid = 0
        self._pending: list[QueryRequest] = []
        self.completed = 0
        self.failed = 0

    # ------------------------------------------------------------------
    def submit(self, queries: SegmentArray, d: float) -> int:
        """Enqueue a query set (any order — the facade sorts); returns a
        request id to correlate with :meth:`drain`'s responses."""
        uid = self._next_uid
        self._next_uid += 1
        self._pending.append(QueryRequest(uid, queries, float(d),
                                          time.perf_counter()))
        return uid

    @property
    def pending(self) -> int:
        return len(self._pending)

    # ------------------------------------------------------------------
    def drain(self) -> dict[int, QueryResponse]:
        """Execute every pending request through ``query_stream`` and
        return responses keyed by request id.

        A request that raises is returned as an *errored* response
        (``response.error`` set) instead of being silently dropped — the
        queue keeps draining and callers can retry the failed uid's
        payload.
        """
        out: dict[int, QueryResponse] = {}
        while self._pending:
            req = self._pending.pop(0)
            try:
                result, sstats = self.db.query_stream(
                    req.queries, req.d, backend=self.backend,
                    policy=self.policy,
                    predict_seconds=self.predict_seconds)
            except Exception as e:
                out[req.uid] = QueryResponse(
                    uid=req.uid, result=None, scheduler=SchedulerStats(),
                    latency_seconds=time.perf_counter() - req.submitted_at,
                    error=e)
                self.failed += 1
                continue
            out[req.uid] = QueryResponse(
                uid=req.uid, result=result, scheduler=sstats,
                latency_seconds=time.perf_counter() - req.submitted_at)
            self.completed += 1
        return out
