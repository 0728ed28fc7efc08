"""Host-side core of the port: segments, index, batching, planner (numpy,
copied from the reference package) plus the PyTorch executor and engines.

The stable entry point for *querying* is the :mod:`repro_torch.api`
facade (``TrajectoryDB``); the engine-level names re-exported here
(``DistanceThresholdEngine``, ``brute_force``, …) stay importable as in
the reference but emit a ``DeprecationWarning``.  Importing from the
defining submodules (``repro_torch.core.engine`` etc.) stays supported
and warning-free.
"""
import warnings

from repro_torch.core.segments import SegmentArray, pad_count  # noqa: F401
from repro_torch.core.index import TemporalBinIndex, DEFAULT_NUM_BINS  # noqa: F401
from repro_torch.core.batching import (  # noqa: F401
    ALGORITHMS, BatchPlan, QueryBatch, greedysetsplit_max, greedysetsplit_min,
    periodic, setsplit_fixed, setsplit_max, setsplit_minmax)

# Deprecated engine-level re-exports: resolved lazily so touching them (and
# only them) warns.  repro_torch.core.engine itself is NOT deprecated.
_DEPRECATED_ENGINE_NAMES = {
    "DistanceThresholdEngine": "repro_torch.api.TrajectoryDB",
    "ResultSet": "repro_torch.api.QueryResult",
    "ExecStats": "repro_torch.api.QueryResult.stats",
    "brute_force": "repro_torch.api.TrajectoryDB.query(..., backend='brute')",
}


def __getattr__(name: str):
    if name in _DEPRECATED_ENGINE_NAMES:
        warnings.warn(
            f"repro_torch.core.{name} is deprecated; use "
            f"{_DEPRECATED_ENGINE_NAMES[name]} (see repro_torch.api). "
            f"Importing from repro_torch.core.engine directly remains "
            f"supported.", DeprecationWarning, stacklevel=2)
        from repro_torch.core import engine
        return getattr(engine, name)
    raise AttributeError(
        f"module 'repro_torch.core' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_DEPRECATED_ENGINE_NAMES))
