"""Deterministic fault injection for the serving stack.

The paper's engine assumes every kernel launch succeeds; a serving tier
cannot.  This package is the port's copy of the reference's
``repro/faults``: a seeded :class:`FaultPlan` armed process-globally,
consulted from named **injection sites** threaded through the stack.
Site names and the crc32 draws are the reference's, so one plan fires on
the same calls in both packages.

Sites (the ``site`` string each hook passes):

========================  ====================================================
``ops.query_block``       host entry of :func:`repro_torch.kernels.ops.query_block`
``engine.dispatch``       single-device dispatcher, before kernel launch
``engine.count``          single-device count readback (corruptible)
``engine.marshal``        single-device result marshalling
``scheduler.worker``      :class:`DeadlineScheduler` worker, per group attempt
``broker.plan``           broker planning step in ``submit()``
``cache.lookup``          broker-side :class:`SliceCache` lookup
``cache.insert``          broker-side :class:`SliceCache` insert at delivery
========================  ====================================================

Fault kinds: ``error`` (raised :class:`InjectedKernelError`),
``resource_exhausted`` (:class:`InjectedResourceExhausted`, message
prefixed ``RESOURCE_EXHAUSTED`` like an OOM-ing runtime), ``delay``
(straggler sleep), ``pod_dropout`` (:class:`PodFailedError`; the
reference fires it at its pod sites, which the port does not have yet),
``corrupt_count`` (inflates/deflates a
host-read overflow count via :func:`corrupt`).

Every hook is written as::

    if faults.armed():
        faults.inject("engine.dispatch", ...)

so the disarmed hot path costs one function call returning a cached
``False`` — no plan lookup, no allocation.  Lint rule ``FAULT001``
enforces that ``inject``/``corrupt`` never appear outside that guard.

Determinism: whether a spec fires on its *n*-th matching call is a pure
function of ``(plan.seed, spec index, site, n)`` (crc32-hash uniform
draw against ``probability``), so a chaos run replays bit-identically
for a given seed — the property the CI chaos matrix relies on.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import zlib

from repro_torch.core.errors import PodFailedError

KINDS = ("error", "resource_exhausted", "delay", "pod_dropout",
         "corrupt_count")


class InjectedKernelError(RuntimeError):
    """A fault plan's simulated device/kernel failure."""


class InjectedResourceExhausted(RuntimeError):
    """A fault plan's simulated allocator failure (retryable)."""


def _unit(*parts) -> float:
    """Deterministic uniform draw in [0, 1) from hashed parts."""
    h = zlib.crc32(":".join(map(str, parts)).encode()) & 0xFFFFFFFF
    return h / 2.0**32


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault rule: where, what, and on which matching calls.

    ``times``/``after``/``probability`` are counted over calls whose
    ``site`` and ``match`` both match: skip the first ``after``, then
    fire on each draw below ``probability``, at most ``times`` times
    (``None`` = unlimited).  ``match`` filters on the hook's context
    kwargs (e.g. ``match={"pod": 2}`` drops only pod 2).
    """

    site: str
    kind: str
    times: int | None = 1
    after: int = 0
    probability: float = 1.0
    delay: float = 0.05          # seconds, kind="delay"
    factor: float = 4.0          # kind="corrupt_count": value -> value*factor
    bias: int = 0                # ... + bias
    match: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")

    def matches_ctx(self, ctx: dict) -> bool:
        return all(ctx.get(k) == v for k, v in self.match.items())


@dataclasses.dataclass
class FaultEvent:
    """One fired fault, for the chaos report artifact."""

    site: str
    kind: str
    index: int        # 1-based matching-call index at which the spec fired
    ctx: dict


class FaultPlan:
    """A seeded, thread-safe set of :class:`FaultSpec` rules plus the
    log of every fault that actually fired (``plan.events``)."""

    def __init__(self, specs, seed: int = 0):
        self.specs = [s if isinstance(s, FaultSpec) else FaultSpec(**s)
                      for s in specs]
        self.seed = int(seed)
        self.events: list[FaultEvent] = []
        self.calls: dict[str, int] = {}        # site -> total hook calls
        self._seen = [0] * len(self.specs)     # per-spec matching calls
        self._fired = [0] * len(self.specs)
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def _firing(self, site: str, kinds, ctx: dict):
        """Advance counters for one hook call; return fired specs.

        Caller must *not* hold the lock; raising/sleeping happens on the
        caller's side so the lock is never held across a fault.
        """
        fired = []
        with self._lock:
            self.calls[site] = self.calls.get(site, 0) + 1
            for i, spec in enumerate(self.specs):
                if spec.site != site or spec.kind not in kinds:
                    continue
                if not spec.matches_ctx(ctx):
                    continue
                self._seen[i] += 1
                n = self._seen[i]
                if n <= spec.after:
                    continue
                if spec.times is not None and self._fired[i] >= spec.times:
                    continue
                if (spec.probability < 1.0
                        and _unit(self.seed, i, site, n) >= spec.probability):
                    continue
                self._fired[i] += 1
                self.events.append(FaultEvent(site, spec.kind, n, dict(ctx)))
                fired.append(spec)
        return fired

    def inject(self, site: str, ctx: dict) -> None:
        error = None
        for spec in self._firing(
                site, ("error", "resource_exhausted", "delay",
                       "pod_dropout"), ctx):
            if spec.kind == "delay":
                time.sleep(spec.delay)
            elif error is None:
                if spec.kind == "error":
                    error = InjectedKernelError(
                        f"injected kernel failure at {site}")
                elif spec.kind == "resource_exhausted":
                    error = InjectedResourceExhausted(
                        f"RESOURCE_EXHAUSTED: injected at {site}")
                else:  # pod_dropout
                    error = PodFailedError(pod=ctx.get("pod"),
                                           reason="injected dropout")
        if error is not None:
            raise error

    def corrupt(self, site: str, value: int, ctx: dict) -> int:
        for spec in self._firing(site, ("corrupt_count",), ctx):
            return max(0, int(value * spec.factor) + spec.bias)
        return int(value)

    def report(self) -> dict:
        """JSON-serializable summary for the chaos-matrix artifact."""
        with self._lock:
            return {
                "seed": self.seed,
                "specs": [dataclasses.asdict(s) for s in self.specs],
                "calls": dict(self.calls),
                "fired": list(self._fired),
                "events": [dataclasses.asdict(e) for e in self.events],
            }


# ----------------------------------------------------------------------
# Process-global arming.  `armed()` is the only thing the hot path ever
# evaluates when no chaos run is active.
_armed_plan: FaultPlan | None = None


def armed() -> bool:
    """True iff a :class:`FaultPlan` is currently armed."""
    return _armed_plan is not None


def armed_plan() -> FaultPlan | None:
    return _armed_plan


def arm(plan: FaultPlan) -> FaultPlan:
    global _armed_plan
    if _armed_plan is not None:
        raise RuntimeError("a FaultPlan is already armed")
    _armed_plan = plan
    return plan


def disarm() -> None:
    global _armed_plan
    _armed_plan = None


@contextlib.contextmanager
def active(plan: FaultPlan):
    """``with faults.active(FaultPlan([...])) as plan: ...`` — arm for
    the block, always disarm on exit."""
    arm(plan)
    try:
        yield plan
    finally:
        disarm()


def inject(site: str, **ctx) -> None:
    """Consult the armed plan at ``site``; may raise or sleep.

    Only call behind ``if faults.armed():`` (lint rule FAULT001).
    """
    plan = _armed_plan
    if plan is not None:
        plan.inject(site, ctx)


def corrupt(site: str, value: int, **ctx) -> int:
    """Pass a host-read count through the armed plan's corruptors.

    Only call behind ``if faults.armed():`` (lint rule FAULT001).
    """
    plan = _armed_plan
    if plan is None:
        return int(value)
    return plan.corrupt(site, value, ctx)


__all__ = [
    "KINDS", "FaultSpec", "FaultPlan", "FaultEvent",
    "InjectedKernelError", "InjectedResourceExhausted",
    "armed", "armed_plan", "arm", "disarm", "active", "inject", "corrupt",
]
