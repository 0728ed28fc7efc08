"""Broker-level retry policy: bounded attempts, exponential backoff with
deterministic jitter, deadline awareness.

The scheduler path already re-issues groups that *miss a
deadline*; nothing retried a group that *failed*.  :class:`RetryPolicy`
closes that gap for the broker: a failed dispatch group is re-issued up
to ``max_attempts`` times with exponentially growing backoff, a group
that exceeds its predicted time by ``straggler_slack`` is re-issued
speculatively (first completion wins — group execution is stateless, so
duplicates are harmless), and repeated failures step the degradation
ladder (see ``QueryBroker``) instead of burning all attempts on a
configuration that keeps failing.

Jitter is deterministic — hashed from ``(seed, ticket uid, group,
attempt)`` — so a chaos run's timing decisions replay bit-identically.
"""
from __future__ import annotations

import dataclasses
import zlib


def _unit(*parts) -> float:
    h = zlib.crc32(":".join(map(str, parts)).encode()) & 0xFFFFFFFF
    return h / 2.0**32


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Knobs for broker-level re-issue of failed/straggling groups.

    ``max_attempts`` counts *executions* of a group, including the
    first; ``degrade_after`` is how many consecutive failures of one
    group trigger a degradation-ladder step (transient
    ``RESOURCE_EXHAUSTED`` failures never step the ladder).  Straggler
    re-issue is off unless ``straggler_slack`` is set: a group is then
    re-issued once it runs longer than
    ``max(straggler_slack * predicted_seconds, straggler_min_timeout)``.
    """

    max_attempts: int = 4
    base_backoff: float = 0.02
    backoff_factor: float = 2.0
    max_backoff: float = 1.0
    jitter: float = 0.25          # +/- fraction of the backoff
    seed: int = 0
    degrade_after: int = 2
    straggler_slack: float | None = None
    straggler_min_timeout: float = 0.05

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")

    def backoff_seconds(self, uid: int, group: int, attempt: int) -> float:
        """Backoff before re-issuing ``group`` after its ``attempt``-th
        execution failed (attempt >= 1).  Deterministic."""
        base = min(self.base_backoff * self.backoff_factor ** (attempt - 1),
                   self.max_backoff)
        u = _unit(self.seed, uid, group, attempt)
        return base * (1.0 + self.jitter * (2.0 * u - 1.0))

    def straggler_timeout(self, predicted: float | None) -> float | None:
        """Seconds after which a running group is re-issued, or ``None``
        when speculative re-issue is disabled."""
        if self.straggler_slack is None:
            return None
        pred = float(predicted) if predicted else 0.0
        return max(self.straggler_slack * pred, self.straggler_min_timeout)


__all__ = ["RetryPolicy"]
