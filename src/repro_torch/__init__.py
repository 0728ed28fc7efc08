"""PyTorch + CUDA port of the distance-threshold trajectory query engine.

A second package beside the JAX reference (``repro``): it imports
``torch`` and numpy only, and keeps its own copy of every host-side module
it needs.  Entry points take ``device=`` (default ``"cuda"``) and run on
the card; the CPU is used only when the caller asks for it.
"""
from repro_torch.api import (BACKENDS, ExecutionPolicy, QueryResult,
                             TrajectoryDB)
from repro_torch.device import resolve_device

__all__ = ["BACKENDS", "ExecutionPolicy", "QueryResult", "TrajectoryDB",
           "resolve_device"]
