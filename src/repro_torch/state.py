"""Carry database state across from plain arrays.

The port holds the same host-side state as the reference — a struct of
segment columns and a temporal-bin index of numpy arrays — in its own
classes.  These helpers build the port's objects from the fields as plain
numpy values (for instance ``vars(obj)`` of the reference's objects), so
the same database and index can be fed to both packages without the port
importing the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

from repro_torch.core.index import TemporalBinIndex
from repro_torch.core.segments import PACKED_COLUMNS, SegmentArray

#: Column names of a segment store: the 8 packed columns plus the ids.
SEGMENT_FIELDS = PACKED_COLUMNS + ("seg_id", "traj_id")


def segments_from_numpy(cols: Mapping[str, np.ndarray]) -> SegmentArray:
    """The port's ``SegmentArray`` from columns ``xs..te``, ``seg_id`` and
    ``traj_id`` (extra keys are ignored; a missing one raises
    ``KeyError``)."""
    return SegmentArray(**{name: np.array(cols[name], copy=True)
                           for name in SEGMENT_FIELDS})


def _copy(v):
    return np.array(v, copy=True) if isinstance(v, np.ndarray) else v


def index_from_numpy(fields: Mapping[str, object]) -> TemporalBinIndex:
    """The port's ``TemporalBinIndex`` from its dataclass fields (numpy
    arrays, numbers and ``None``); every field must be present."""
    missing = [f.name for f in dataclasses.fields(TemporalBinIndex)
               if f.name not in fields]
    if missing:
        raise KeyError(f"index fields missing: {missing}")
    return TemporalBinIndex(**{f.name: _copy(fields[f.name])
                               for f in dataclasses.fields(TemporalBinIndex)})


__all__ = ["SEGMENT_FIELDS", "index_from_numpy", "segments_from_numpy"]
