"""Structured failure types for the serving stack.

Permanent failures must be *diagnosable*: a capacity overflow that keeps
overflowing after its bounded retries, or a pod that drops out of the
shard mesh, surfaces as one of these exceptions instead of an anonymous
``RuntimeError`` (or, worse, an unbounded retry loop).  Both carry the
exact numbers a caller needs to re-submit with a corrected policy.
"""
from __future__ import annotations


class CapacityError(RuntimeError):
    """A batch kept overflowing its result buffer after the bounded
    capacity-doubling retries (``ExecutionPolicy.max_capacity_retries``).

    Attributes carry the exact observed hit count and the capacity it
    exceeded, so the caller can re-submit with
    ``policy.with_(capacity=...)`` sized from ``count``.
    """

    def __init__(self, count: int, capacity: int, *,
                 batch_index: int | None = None, retries: int = 0):
        self.count = int(count)
        self.capacity = int(capacity)
        self.batch_index = batch_index
        self.retries = int(retries)
        where = f" (batch {batch_index})" if batch_index is not None else ""
        super().__init__(
            f"result buffer overflow{where}: {self.count} hits exceed "
            f"capacity {self.capacity} after {self.retries} bounded "
            f"retries; re-submit with capacity >= {self.count} or raise "
            f"max_capacity_retries")


class PodFailedError(RuntimeError):
    """A temporal pod of the shard mesh failed to execute its slice.

    The broker's degradation ladder catches this and re-routes the
    group's batches to the single-device engine (results stay
    byte-identical — degraded, never wrong); outside the broker it
    propagates so callers see a structured error rather than a hang.
    """

    def __init__(self, pod: int | None = None, reason: str = "pod failure"):
        self.pod = pod
        where = f"pod {pod}" if pod is not None else "pod"
        super().__init__(f"{where} dropped out of the shard mesh: {reason}")


__all__ = ["CapacityError", "PodFailedError"]
