"""PyTorch + CUDA port of the distance-threshold trajectory query engine.

A second package beside the JAX reference (``repro``): it imports
``torch`` and numpy only, and keeps its own copy of every host-side module
it needs.  Entry points take ``device=`` (default ``"cuda"``) and run on
the card; the CPU is used only when the caller asks for it.

The stable public surface is :mod:`repro_torch.api` — ``TrajectoryDB``
and friends are re-exported lazily here, as the reference re-exports
its own, so ``import repro_torch`` stays cheap for subpackages
(``repro_torch.data``, ``repro_torch.models``, …) that never touch the
query engine.
"""
from __future__ import annotations

from repro_torch.device import resolve_device

_API_NAMES = ("TrajectoryDB", "ExecutionPolicy", "QueryResult",
              "QueryBackend", "BACKENDS", "QueryBroker", "QueryTicket",
              "GroupSlice", "AdmissionError", "DeadlineExceededError",
              "CapacityError", "PodFailedError", "RetryPolicy",
              "TicketHealth", "Degradation", "FaultPlan", "FaultSpec")


def __getattr__(name: str):
    if name in _API_NAMES:
        from repro_torch import api
        return getattr(api, name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_API_NAMES))


__all__ = list(_API_NAMES) + ["resolve_device"]
