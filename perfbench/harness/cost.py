"""The yardstick's arithmetic: the card's peaks and the least work a query
needs, counted from its inputs alone.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its 700 W
limit).  The distance solve is float32 on the CUDA cores.

Least work of one query set against the database (whatever computes it):

* operations: ``OPS_PER_OVERLAP`` float32 operations for every (entry,
  query) pair whose temporal extents overlap, the pairs the interval solve
  has to see; pairs that share no time need no work at all;
* bytes: ``SEGMENT_BYTES`` for every query segment and every entry segment
  that overlaps some query segment in time, each read once, and
  ``HIT_BYTES`` for every answer row written once.

The least time is the larger of operations over the float32 peak and bytes
over the memory bandwidth.
"""
from __future__ import annotations

import numpy as np

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12

#: float32 operations of one overlapping pair's interval solve (velocities,
#: relative motion, the quadratic, its roots and the clamps).
OPS_PER_OVERLAP = 45
#: one segment (8 float32) and one answer row (entry, query, t_enter, t_exit)
SEGMENT_BYTES = 32
HIT_BYTES = 16


class Work:
    """Counts the least work of query sets against one database."""

    def __init__(self, db: dict):
        self.ts = np.sort(db["ts"].astype(np.float64))
        self.te = np.sort(db["te"].astype(np.float64))
        self.ets = db["ts"].astype(np.float64)
        self.ete = db["te"].astype(np.float64)

    def overlap_pairs(self, qs: dict) -> int:
        """Pairs with ``ets <= qte`` and ``ete >= qts``: the entries that
        start by the query's end, less those that ended before its start."""
        qts = qs["ts"].astype(np.float64)
        qte = qs["te"].astype(np.float64)
        started = np.searchsorted(self.ts, qte, "right")
        ended = np.searchsorted(self.te, qts, "left")
        return int((started - ended).sum())

    def entries_touched(self, qs: dict) -> int:
        """Entries that overlap the union of the queries' extents."""
        order = np.argsort(qs["ts"], kind="stable")
        a = qs["ts"][order].astype(np.float64)
        b = np.maximum.accumulate(qs["te"][order].astype(np.float64))
        new = np.ones(len(a), bool)
        new[1:] = a[1:] > b[:-1]
        starts = a[new]
        ends = np.append(b[np.flatnonzero(new)[1:] - 1], b[-1])
        j = np.searchsorted(ends, self.ets, "left")
        hit = j < len(ends)
        hit[hit] = starts[j[hit]] <= self.ete[hit]
        return int(hit.sum())

    def least_seconds(self, qs: dict, rows: int) -> float:
        """The least time of ``qs`` answered with ``rows`` rows."""
        nbytes = (SEGMENT_BYTES * (len(qs["ts"]) + self.entries_touched(qs))
                  + HIT_BYTES * rows)
        return max(OPS_PER_OVERLAP * self.overlap_pairs(qs) / PEAK_FLOPS["float32"],
                   nbytes / HBM_BYTES_PER_S)
