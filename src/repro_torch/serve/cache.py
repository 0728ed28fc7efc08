"""Query-MBR-keyed result cache for the serving tier.

Continuous-monitoring workloads resubmit the *same* (or overlapping)
query sets on a cadence — the repeated-range-query regime of the manycore
line of work (arXiv:1411.3212): the answer changes only when the database
does, so recomputing it on every tick wastes the whole mesh.
:class:`SliceCache` memoizes finished broker results and answers repeats
from host memory:

* **Key** — ``(distance threshold d, database epoch)`` selects the
  candidate entries; each entry carries its query set's *canonical form*
  (packed query rows in lexicographic row order) plus the set's union
  MBR and temporal extent.
* **Lookup** — a submitted query set hits an entry when the entry's
  union MBR (cheap superset pre-check) contains the submitted set's and
  every submitted query row is **byte-identical** to some cached row
  (exact containment — subsets of a cached set hit too, the "superset
  MBR + post-filter" path).  A hit slices the memoized rows down to the
  submitted queries and restamps ``query_idx`` with the caller's
  indices; because a query's result rows depend only on (query row, db,
  d) — never on the rest of the batch — the assembled result is
  byte-identical to what ``db.query`` would return.
* **Invalidation** — entries are keyed on the database's
  ``data_epoch``; any mutation path bumps the epoch and every stale
  entry stops matching (and is dropped lazily).

The cache is exact by construction: a hit never changes result bytes,
only who computes them.  ``QueryBroker(cache=SliceCache())`` wires it
into ``submit()`` (pre-completed ticket, ``num_syncs == 0``) and into
delivery (completed tickets populate the cache).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.segments import SegmentArray


def _row_view(packed: np.ndarray) -> np.ndarray:
    """(n, 8) float32 rows as one opaque void scalar per row — byte-wise
    comparable/sortable, the exact-containment currency of the cache."""
    packed = np.ascontiguousarray(packed)
    if packed.shape[0] == 0:
        return np.empty(0, np.dtype((np.void, packed.dtype.itemsize * 8)))
    return packed.view(
        np.dtype((np.void, packed.dtype.itemsize * packed.shape[1]))).ravel()


@dataclasses.dataclass
class CacheStats:
    """Counters for one :class:`SliceCache` (monotone, host-side)."""

    lookups: int = 0
    hits: int = 0            # exact or subset containment hits
    superset_hits: int = 0   # hits where the entry held extra queries
    misses: int = 0
    insertions: int = 0
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0


class _Entry:
    """One memoized query set: canonical rows + grouped result arrays."""

    __slots__ = ("d", "epoch", "qrows", "mbr_lo", "mbr_hi", "qt0", "qt1",
                 "q_starts", "arrays")

    def __init__(self, d: float, epoch: int, q_packed: np.ndarray,
                 result) -> None:
        self.d = float(d)
        self.epoch = int(epoch)
        view = _row_view(q_packed)
        sort = np.argsort(view)           # canonical (byte) query order
        self.qrows = view[sort]
        self.mbr_lo = q_packed[:, :3].min(axis=0).copy()
        np.minimum(self.mbr_lo, q_packed[:, 3:6].min(axis=0), out=self.mbr_lo)
        self.mbr_hi = q_packed[:, :3].max(axis=0).copy()
        np.maximum(self.mbr_hi, q_packed[:, 3:6].max(axis=0), out=self.mbr_hi)
        self.qt0 = float(q_packed[:, 6].min())
        self.qt1 = float(q_packed[:, 7].max())
        # Result rows regrouped by canonical query position: caller
        # query_idx -> canonical position, then rows sorted by
        # (position, entry_idx) with a per-position prefix table.
        inv = np.empty(len(sort), np.int64)
        inv[sort] = np.arange(len(sort))
        pos = inv[result.query_idx]
        rank = np.lexsort((result.entry_idx, pos))
        self.arrays = {
            "entry_idx": result.entry_idx[rank],
            "entry_traj": result.entry_traj[rank],
            "entry_seg": result.entry_seg[rank],
            "t_enter": result.t_enter[rank],
            "t_exit": result.t_exit[rank],
        }
        self.q_starts = np.searchsorted(
            pos[rank], np.arange(len(sort) + 1))

    def match(self, view: np.ndarray, mbr_lo, mbr_hi, qt0: float,
              qt1: float) -> np.ndarray | None:
        """Canonical positions of every submitted row, or ``None``."""
        if (qt0 < self.qt0 or qt1 > self.qt1
                or (mbr_lo < self.mbr_lo).any()
                or (mbr_hi > self.mbr_hi).any()):
            return None                  # cannot be a subset (cheap reject)
        j = np.searchsorted(self.qrows, view)
        if (j >= len(self.qrows)).any():
            return None
        if (self.qrows[j] != view).any():
            return None
        return j


class SliceCache:
    """Exact-containment result cache keyed on (query MBR, d, db epoch).

    ``max_entries`` bounds memory with LRU eviction (lookup order).  The
    cache is not thread-safe — it lives inside the broker's
    single-threaded pump, like everything else in the serving tier.
    """

    def __init__(self, max_entries: int = 64):
        if max_entries <= 0:
            raise ValueError(f"max_entries must be positive, got {max_entries}")
        self.max_entries = int(max_entries)
        self.stats = CacheStats()
        self._entries: list[_Entry] = []   # LRU order: oldest first

    def __len__(self) -> int:
        return len(self._entries)

    # ------------------------------------------------------------------
    def lookup(self, queries: SegmentArray, d: float, epoch: int):
        """The memoized answer for ``queries`` at threshold ``d`` under
        database ``epoch``, or ``None``.

        A hit returns ``(arrays, lens)``: the result column arrays (in
        submitted-query order, ``query_idx`` already the **caller's**
        index) and per-query row counts.  The caller canonicalizes —
        ``QueryBroker`` routes this through the same lexsort
        ``db.query`` uses, so hit bytes equal computed bytes.
        """
        self.stats.lookups += 1
        q_packed = queries.packed()
        if q_packed.shape[0] == 0 or not self._entries:
            self.stats.misses += 1
            return None
        view = _row_view(q_packed)
        mbr_lo = np.minimum(q_packed[:, :3].min(axis=0),
                            q_packed[:, 3:6].min(axis=0))
        mbr_hi = np.maximum(q_packed[:, :3].max(axis=0),
                            q_packed[:, 3:6].max(axis=0))
        qt0 = float(q_packed[:, 6].min())
        qt1 = float(q_packed[:, 7].max())
        d = float(d)
        epoch = int(epoch)
        # Stale-epoch entries can never match again; drop them in passing.
        self._entries = [e for e in self._entries if e.epoch == epoch]
        for k in range(len(self._entries) - 1, -1, -1):
            e = self._entries[k]
            if e.d != d:
                continue
            j = e.match(view, mbr_lo, mbr_hi, qt0, qt1)
            if j is None:
                continue
            self.stats.hits += 1
            if len(e.qrows) > len(view):
                self.stats.superset_hits += 1
            # LRU touch: move the hit entry to the back.
            self._entries.append(self._entries.pop(k))
            starts = e.q_starts[j]
            lens = e.q_starts[j + 1] - starts
            total = int(lens.sum())
            # Gather each submitted query's row slice, back to back.
            base = np.repeat(starts - (np.cumsum(lens) - lens), lens)
            idx = base + np.arange(total)
            arrays = {name: col[idx] for name, col in e.arrays.items()}
            arrays["query_idx"] = np.repeat(
                np.arange(len(view), dtype=np.int64), lens)
            return arrays, lens
        self.stats.misses += 1
        return None

    def insert(self, queries: SegmentArray, d: float, epoch: int,
               result) -> None:
        """Memoize a finished canonical result (``result.query_idx`` must
        index ``queries`` in caller order — a ticket's final result)."""
        q_packed = queries.packed()
        if q_packed.shape[0] == 0:
            return
        self._entries.append(_Entry(d, epoch, q_packed, result))
        self.stats.insertions += 1
        while len(self._entries) > self.max_entries:
            self._entries.pop(0)
            self.stats.evictions += 1


__all__ = ["CacheStats", "SliceCache"]
