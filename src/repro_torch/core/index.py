"""Temporal-bin index (paper §4).

Entry segments, sorted by non-decreasing ``t_start``, are logically divided
into ``m`` fixed-width temporal bins.  Bin ``B_j`` is fully described by
``(B_start, B_end, B_first, B_last)``:

* ``B_start[j] = t0 + j*b`` where ``b = (t_max - t0) / m``;
* ``B_end[j]   = max over segments in bin of t_end`` (−inf if empty);
* ``B_first[j]`` / ``B_last[j]``: first/last segment index with
  ``t_start`` in ``[B_start[j], B_start[j]+b)``.

For a query with temporal extent ``[qt0, qt1]`` the set of overlapping bins
is contiguous, and the candidate entry segments are exactly the contiguous
index range ``[first, last]`` — this contiguity is what makes the search a
dense streaming computation on the accelerator.

The paper finds the overlapping bins with an index-tree over bin extents in
O(log m); we use the equivalent binary search over the prefix-max of
``B_end`` (non-decreasing, hence searchable) — same complexity, no tree.

**Spatial pruning.**  The paper's index is purely temporal: every
segment in the contiguous range is a candidate even when it is spatially
nowhere near the query (the follow-up work, arXiv:1410.2698, shows spatial
pruning is the next win).  Each bin therefore also carries a spatial MBR —
the axis-aligned box over its segments' endpoint boxes (a linearly moving
segment never leaves that box) — plus running prefix/suffix MBR unions.
:meth:`candidate_subranges` *trims and splits* a query's contiguous
``[first, last]`` range into the sub-ranges whose bin MBRs lie within the
(conservatively inflated) threshold of the query's MBR; a bin farther than
``d`` from every query in the batch cannot contribute a hit, so dropping
it is exact, never lossy.  :meth:`estimate_pruned_candidates_batch` is the
vectorized *pricing* counterpart over a coarsened bin grid — cheap enough
for the SETSPLIT merge loops, conservative (it never under-counts the
exact pruned workload).

**Hierarchical K-box layer.**  One box per bin unions multi-modal
activity (two swarms far apart in the same epoch) into one fat box that
prunes nothing.  Each bin's segments are therefore additionally split into
at most ``K`` spatial boxes: segments are *reordered within their bin* by
midpoint coordinate along the bin's widest-spread axis (the permutation is
stored as :attr:`perm`; bins stay contiguous, so every bin-granular
quantity — ``b_first``/``b_last``/``b_end``/per-bin MBRs — is invariant),
and each bin is cut at its ``K−1`` largest coordinate gaps.  Every
(bin, box) slot is then a *contiguous sub-range of permuted segment
indices* with its own MBR, so :meth:`candidate_subranges(level="box")`
prunes at box granularity with the exact same inflated-threshold test —
still never lossy.  Engines keep their segment arrays t_start-sorted
(the distributed pod partition depends on it) and permute only the packed
device copy; result entry indices are mapped back through :attr:`perm`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.segments import SegmentArray

DEFAULT_NUM_BINS = 10_000  # paper §7.2: "the number of entry bins ... is set to 10,000"

#: Coarse pricing-grid resolution: per-bin MBRs are unioned into at most
#: this many coarse bins for the vectorized pruned-count estimate (the
#: merge loops evaluate it per adjacent pair per iteration).
COARSE_GRID_BINS = 128

#: Max sub-ranges :meth:`candidate_subranges` returns per query extent —
#: each sub-range becomes one dispatched batch, so this bounds the
#: dispatch-count blow-up; surplus runs merge across the smallest gaps.
#: ``ExecutionPolicy.max_subranges`` overrides this per query; the coarse
#: pricing grid prices the re-admission cost of the cap (see
#: :meth:`TemporalBinIndex.estimate_pruned_candidates_batch`).
DEFAULT_MAX_SUBRANGES = 8

#: Hard ceiling on the per-bin spatial split factor K.  The K-box arrays
#: are dense ``(num_bins, K, …)``, so K is kept small; beyond ~8 boxes the
#: per-bin split stops paying for its planning cost anyway.
MAX_KBOXES = 8


def mbr_gap2(alo, ahi, blo, bhi):
    """Squared minimum distance between axis-aligned boxes (broadcasts
    over leading dims; the last dim is the 3 spatial axes).  Empty boxes
    (``lo=+inf, hi=-inf``) yield ``inf`` — always pruned."""
    g = np.maximum(np.maximum(blo - ahi, alo - bhi), 0.0)
    return np.sum(g * g, axis=-1)


def _coalesce_runs(kf: np.ndarray, kl: np.ndarray,
                   first: int, last: int) -> list[list[int]]:
    """Clamp surviving box ranges into ``[first, last]`` and coalesce
    adjacent boxes with no segments between them into maximal runs.

    ``kf``/``kl`` are inclusive (first, last) ranges in non-decreasing
    ``kf`` order; a new run starts only where a real index gap remains
    after the running-max of ``kl`` (boxes can nest after clamping)."""
    if kf.size == 0:
        return []
    kf = np.maximum(kf, first)
    kl = np.minimum(kl, last)
    ok = kl >= kf
    kf, kl = kf[ok], kl[ok]
    if kf.size == 0:
        return []
    cummax = np.maximum.accumulate(kl)
    newrun = np.r_[True, kf[1:] > cummax[:-1] + 1]
    starts = kf[newrun]
    ends = np.maximum.reduceat(kl, np.nonzero(newrun)[0])
    return [[int(a), int(b)] for a, b in zip(starts, ends)]


def prune_limit(d: float, scale: float) -> float:
    """Conservatively inflated threshold for MBR pruning.

    The kernels decide hits in float32; the quadratic coefficient
    ``c = |Δr|² − d²`` carries an absolute round-off ~``eps32·scale²``
    (``scale`` = largest coordinate magnitude), which can make a pair whose
    true minimum distance slightly exceeds ``d`` register as a hit.  The
    pruning test must keep such pairs, so the threshold is inflated by the
    distance overshoot that error can cause: ``err/(2d)`` in the smooth
    regime, ``sqrt(err)`` when ``d`` is tiny.  Exactness of pruning (no
    dropped hit, ever) only needs the slack to be an upper bound; the
    over-inflation costs a negligible amount of pruning.
    """
    d = float(d)
    err = 4e-6 * scale * scale
    slack = min(err / max(2.0 * d, 1e-12), float(np.sqrt(err)))
    return d + 1e-5 * d + slack + 1e-9


@dataclasses.dataclass
class TemporalBinIndex:
    """The bin description arrays + the sorted segment t arrays they index."""

    t0: float
    bin_width: float
    num_bins: int
    b_start: np.ndarray      # (m,) float64 — bin start times
    b_end: np.ndarray        # (m,) float64 — max t_end in bin, −inf if empty
    b_first: np.ndarray      # (m,) int64 — first segment index in bin
    b_last: np.ndarray       # (m,) int64 — last segment index in bin (first-1 if empty)
    _bend_prefix_max: np.ndarray  # (m,) float64 — running max of b_end
    n_segments: int
    # -- spatial pruning layer -----------------------------------------
    mbr_lo: np.ndarray       # (m, 3) float64 — per-bin MBR min (+inf if empty)
    mbr_hi: np.ndarray       # (m, 3) float64 — per-bin MBR max (−inf if empty)
    prefix_lo: np.ndarray    # (m, 3) — union MBR of bins [0, j]
    prefix_hi: np.ndarray
    suffix_lo: np.ndarray    # (m, 3) — union MBR of bins [j, m)
    suffix_hi: np.ndarray
    _prune_scale: float      # largest |coordinate| in the db (slack sizing)
    _coarse_first: np.ndarray  # (k,) int64 — coarse-bin segment ranges
    _coarse_last: np.ndarray
    _coarse_lo: np.ndarray     # (k, 3) — coarse-bin union MBRs
    _coarse_hi: np.ndarray
    # -- hierarchical K-box layer ---------------------------------------
    kboxes: int = 1          # per-bin spatial split factor K (1 = one box per bin)
    perm: np.ndarray | None = None  # (n,) within-bin reorder: new[i] = old[perm[i]]
    kbox_first: np.ndarray | None = None  # (m, K) int64 — per-box permuted ranges
    kbox_last: np.ndarray | None = None   # (m, K) int64 — first-1 / -1 when empty
    kbox_lo: np.ndarray | None = None     # (m, K, 3) — per-box MBR (+inf empty)
    kbox_hi: np.ndarray | None = None     # (m, K, 3)
    _coarse_klo: np.ndarray | None = None  # (k, K, 3) — coarse K-box unions
    _coarse_khi: np.ndarray | None = None

    # ------------------------------------------------------------------
    @staticmethod
    def build(db: SegmentArray, num_bins: int = DEFAULT_NUM_BINS, *,
              kboxes: int = 1) -> "TemporalBinIndex":
        if not db.is_sorted():
            raise ValueError("TemporalBinIndex requires segments sorted by t_start")
        n = len(db)
        if n == 0:
            raise ValueError("cannot index an empty database")
        ts = db.ts.astype(np.float64)
        te = db.te.astype(np.float64)
        t0 = float(ts[0])
        t_max = float(max(ts.max(), te.max()))
        # Degenerate all-at-one-instant databases still get one valid bin.
        width = max((t_max - t0) / num_bins, np.finfo(np.float64).tiny)

        b_start = t0 + width * np.arange(num_bins, dtype=np.float64)
        edges = t0 + width * np.arange(num_bins + 1, dtype=np.float64)
        # b_first[j] = first i with ts[i] >= edge[j]; b_last[j] = b_first[j+1]-1.
        firsts = np.searchsorted(ts, edges, side="left")
        # Segments with ts == t_max would land in bin m; clamp into the last bin
        # (paper's floor(t/b) with t = t_max edge case).
        firsts[-1] = n
        b_first = firsts[:-1].astype(np.int64)
        b_last = (firsts[1:] - 1).astype(np.int64)

        b_end = np.full(num_bins, -np.inf, dtype=np.float64)
        seg_lo, seg_hi = db.mbrs()
        mbr_lo = np.full((num_bins, 3), np.inf, dtype=np.float64)
        mbr_hi = np.full((num_bins, 3), -np.inf, dtype=np.float64)
        nonempty = b_last >= b_first
        # Per-bin max of te (and min/max of the endpoint boxes) via
        # reduceat over the sorted layout.
        if nonempty.any():
            starts = b_first[nonempty]
            seg_max = np.maximum.reduceat(te, starts)
            # reduceat reduces [starts[k], starts[k+1]) — but consecutive
            # non-empty bins may be separated by empty ones whose range is
            # empty; since starts are the b_first of non-empty bins and the
            # next non-empty bin's b_first equals this bin's b_last+1 (empty
            # bins in between contribute no indices), the reduction ranges
            # are exactly the bins' segment ranges, except the final range
            # runs to n which is also correct.
            b_end[nonempty] = seg_max
            mbr_lo[nonempty] = np.minimum.reduceat(seg_lo, starts, axis=0)
            mbr_hi[nonempty] = np.maximum.reduceat(seg_hi, starts, axis=0)
        prefix_max = np.maximum.accumulate(b_end)
        # Running MBR unions (±inf empty boxes are the min/max identities):
        # prefix[j] covers bins [0, j], suffix[j] covers bins [j, m) — a
        # query range [j_lo, j_hi] is a subset of both, so the larger of
        # the two box distances lower-bounds the distance to the range's
        # true union (the whole-range quick reject in candidate_subranges).
        prefix_lo = np.minimum.accumulate(mbr_lo, axis=0)
        prefix_hi = np.maximum.accumulate(mbr_hi, axis=0)
        suffix_lo = np.minimum.accumulate(mbr_lo[::-1], axis=0)[::-1].copy()
        suffix_hi = np.maximum.accumulate(mbr_hi[::-1], axis=0)[::-1].copy()
        scale = float(max(np.abs(seg_lo).max(), np.abs(seg_hi).max(), 1.0))
        # Coarse pricing grid: chunks of fine bins unioned down to at most
        # COARSE_GRID_BINS boxes; chunk c's segment range is contiguous
        # because the fine bins partition the sorted segment array.
        chunk = max((num_bins + COARSE_GRID_BINS - 1) // COARSE_GRID_BINS, 1)
        cstarts = np.arange(0, num_bins, chunk, dtype=np.int64)
        cends = np.minimum(cstarts + chunk - 1, num_bins - 1)
        coarse_lo = np.minimum.reduceat(mbr_lo, cstarts, axis=0)
        coarse_hi = np.maximum.reduceat(mbr_hi, cstarts, axis=0)

        # -- hierarchical K-box layer -----------------------------------
        kboxes = int(kboxes)
        if not 1 <= kboxes <= MAX_KBOXES:
            raise ValueError(f"kboxes must be in [1, {MAX_KBOXES}], got {kboxes}")
        if kboxes == 1:
            # K=1 is exactly the bin-level index: one box per bin, no reorder.
            perm = None
            kbox_first = b_first[:, None].copy()
            kbox_last = b_last[:, None].copy()
            kbox_lo = mbr_lo[:, None, :].copy()
            kbox_hi = mbr_hi[:, None, :].copy()
        else:
            counts = np.maximum(b_last - b_first + 1, 0)
            bin_id = np.repeat(np.arange(num_bins, dtype=np.int64), counts)
            mid = 0.5 * (seg_lo + seg_hi)
            # Per-bin widest-spread midpoint axis: splitting along it
            # separates spatial modes; ties/empty default to axis 0.
            axis = np.zeros(num_bins, dtype=np.int64)
            if nonempty.any():
                mmin = np.minimum.reduceat(mid, starts, axis=0)
                mmax = np.maximum.reduceat(mid, starts, axis=0)
                axis[nonempty] = np.argmax(mmax - mmin, axis=1)
            key = mid[np.arange(n), axis[bin_id]]
            # Stable within-bin sort by the split-axis coordinate: bins
            # stay contiguous, so every bin-granular quantity above is
            # unchanged, and each spatial box becomes a contiguous
            # sub-range of permuted indices.
            perm = np.lexsort((key, bin_id)).astype(np.int64)
            keyp = key[perm]
            # Split each bin at its kboxes-1 largest strictly-positive
            # coordinate gaps (equal-count quantiles would cut through a
            # lopsided mode; largest-gap cuts between modes).
            splits = np.empty(0, dtype=np.int64)
            if n > 1:
                gapv = keyp[1:] - keyp[:-1]
                cand = (bin_id[1:] == bin_id[:-1]) & (gapv > 0.0)
                cpos = np.nonzero(cand)[0].astype(np.int64) + 1
                if cpos.size:
                    cgap = gapv[cpos - 1]
                    cbin = bin_id[cpos]
                    order = np.lexsort((-cgap, cbin))
                    sb = cbin[order]
                    grp = np.r_[0, np.nonzero(np.diff(sb))[0] + 1].astype(np.int64)
                    lens = np.diff(np.r_[grp, sb.size])
                    rank = np.arange(sb.size) - np.repeat(grp, lens)
                    splits = np.sort(cpos[order[rank < kboxes - 1]])
            # Box slots: each box starts at its bin's b_first or at a
            # split position; non-empty bins tile [0, n) contiguously, so
            # each box ends right before the next start.
            allstarts = np.concatenate([b_first[nonempty], splits])
            allstarts.sort()
            abin = bin_id[allstarts]
            grp = np.r_[0, np.nonzero(np.diff(abin))[0] + 1].astype(np.int64)
            lens = np.diff(np.r_[grp, abin.size])
            bidx = np.arange(abin.size) - np.repeat(grp, lens)
            ends = np.r_[allstarts[1:] - 1, n - 1].astype(np.int64)
            slo_p, shi_p = seg_lo[perm], seg_hi[perm]
            box_lo = np.minimum.reduceat(slo_p, allstarts, axis=0)
            box_hi = np.maximum.reduceat(shi_p, allstarts, axis=0)
            kbox_first = np.zeros((num_bins, kboxes), dtype=np.int64)
            kbox_last = np.full((num_bins, kboxes), -1, dtype=np.int64)
            kbox_lo = np.full((num_bins, kboxes, 3), np.inf)
            kbox_hi = np.full((num_bins, kboxes, 3), -np.inf)
            kbox_first[abin, bidx] = allstarts
            kbox_last[abin, bidx] = ends
            kbox_lo[abin, bidx] = box_lo
            kbox_hi[abin, bidx] = box_hi
        # Coarse pricing grid, K-box flavour: cell c's box k is the union
        # over the chunk's bins of their box k.  If any fine box (j, k)
        # survives the prune test its cell's box k contains it and
        # survives too, so the coarse estimate stays conservative.
        coarse_klo = np.minimum.reduceat(kbox_lo, cstarts, axis=0)
        coarse_khi = np.maximum.reduceat(kbox_hi, cstarts, axis=0)
        return TemporalBinIndex(
            t0=t0, bin_width=width, num_bins=num_bins,
            b_start=b_start, b_end=b_end, b_first=b_first, b_last=b_last,
            _bend_prefix_max=prefix_max, n_segments=n,
            mbr_lo=mbr_lo, mbr_hi=mbr_hi,
            prefix_lo=prefix_lo, prefix_hi=prefix_hi,
            suffix_lo=suffix_lo, suffix_hi=suffix_hi,
            _prune_scale=scale,
            _coarse_first=b_first[cstarts], _coarse_last=b_last[cends],
            _coarse_lo=coarse_lo, _coarse_hi=coarse_hi,
            kboxes=kboxes, perm=perm,
            kbox_first=kbox_first, kbox_last=kbox_last,
            kbox_lo=kbox_lo, kbox_hi=kbox_hi,
            _coarse_klo=coarse_klo, _coarse_khi=coarse_khi,
        )

    # ------------------------------------------------------------------
    def bin_of(self, t_start: float) -> int:
        """floor((t_start - t0)/b), clamped into [0, m-1] (paper's bin rule)."""
        j = int(np.floor((t_start - self.t0) / self.bin_width))
        return min(max(j, 0), self.num_bins - 1)

    def _bin_range(self, qt0: float, qt1: float) -> tuple[int, int] | None:
        """Contiguous overlapping-bin range [j_lo, j_hi], or None."""
        if qt1 < qt0:
            return None
        j_hi = int(np.floor((qt1 - self.t0) / self.bin_width))
        if j_hi < 0:
            return None
        j_hi = min(j_hi, self.num_bins - 1)
        # Earliest bin whose B_end reaches qt0: prefix-max is non-decreasing
        # so binary search is valid; prefix_max[j] >= qt0 first holds at the
        # earliest overlapping bin itself.
        j_lo = int(np.searchsorted(self._bend_prefix_max, qt0, side="left"))
        if j_lo > j_hi:
            return None
        return j_lo, j_hi

    def candidate_range(self, qt0: float, qt1: float) -> tuple[int, int]:
        """Contiguous candidate index range [first, last] for query extent
        [qt0, qt1].  Returns (0, -1) when no candidates exist.

        Overlapping bins are those with ``B_start <= qt1`` and
        ``B_end >= qt0``; the range is then
        ``[min B_first, max B_last]`` over that (contiguous) set.  The
        range is clamped into ``[0, n_segments)`` — a query outlasting the
        database extent must price (and dispatch) only real segments.
        """
        r = self._bin_range(qt0, qt1)
        if r is None:
            return (0, -1)
        j_lo, j_hi = r
        # min B_first over bins [j_lo, j_hi]: b_first is non-decreasing.
        first = max(int(self.b_first[j_lo]), 0)
        last = min(int(self.b_last[j_hi]), self.n_segments - 1)
        if last < first:
            return (0, -1)
        return first, last

    def num_candidates(self, qt0: float, qt1: float) -> int:
        first, last = self.candidate_range(qt0, qt1)
        return max(last - first + 1, 0)

    def candidate_range_batch(self, qt0: np.ndarray, qt1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized :meth:`candidate_range` over arrays of query extents.

        Returns ``(first, last)`` int64 arrays; empty ranges are encoded as
        ``last < first`` (specifically first=0, last=-1).  This is the
        workhorse of the SETSPLIT algorithms, which evaluate ``numInts`` for
        every adjacent batch pair on every merge iteration.
        """
        qt0 = np.asarray(qt0, dtype=np.float64)
        qt1 = np.asarray(qt1, dtype=np.float64)
        j_hi = np.floor((qt1 - self.t0) / self.bin_width).astype(np.int64)
        valid = (qt1 >= qt0) & (j_hi >= 0)
        j_hi = np.clip(j_hi, 0, self.num_bins - 1)
        j_lo = np.searchsorted(self._bend_prefix_max, qt0, side="left").astype(np.int64)
        valid &= j_lo <= j_hi
        j_lo = np.minimum(j_lo, self.num_bins - 1)
        # Clamp into [0, n_segments) — same contract as candidate_range.
        first = np.maximum(self.b_first[j_lo], 0)
        last = np.minimum(self.b_last[j_hi], self.n_segments - 1)
        valid &= last >= first
        first = np.where(valid, first, 0)
        last = np.where(valid, last, -1)
        return first, last

    def num_candidates_batch(self, qt0: np.ndarray, qt1: np.ndarray) -> np.ndarray:
        first, last = self.candidate_range_batch(qt0, qt1)
        return np.maximum(last - first + 1, 0)

    def num_interactions(self, qt0: float, qt1: float, batch_size: int) -> int:
        """|Q_batch| × |E_Q| — the paper's interaction count for one batch."""
        return batch_size * self.num_candidates(qt0, qt1)

    # ------------------------------------------------------------------
    def bins_overlapping(self, qt0: float, qt1: float) -> np.ndarray:
        """Indices of bins that temporally overlap [qt0, qt1] (for tests)."""
        mask = (self.b_start <= qt1) & (self.b_end >= qt0)
        return np.nonzero(mask)[0]

    # ------------------------------------------------------------------
    # spatial pruning
    # ------------------------------------------------------------------
    def _limit(self, d: float, qlo: np.ndarray, qhi: np.ndarray) -> float:
        """The inflated prune threshold for one query MBR (or a stack)."""
        finite = np.isfinite(qlo) & np.isfinite(qhi)
        qscale = (float(max(np.abs(qlo[finite]).max(initial=0.0),
                            np.abs(qhi[finite]).max(initial=0.0)))
                  if finite.any() else 0.0)
        return prune_limit(d, max(self._prune_scale, qscale))

    def _bin_runs(self, bins: slice, j_lo: int, qt0: float, qlo, qhi,
                  lim2: float, first: int, last: int) -> list[list[int]]:
        """Surviving bin runs as [first, last] segment sub-ranges."""
        gap2 = mbr_gap2(self.mbr_lo[bins], self.mbr_hi[bins], qlo, qhi)
        keep = (gap2 <= lim2) & (self.b_end[bins] >= qt0)
        kept = np.nonzero(keep)[0]
        if kept.size == 0:
            return []
        # Runs of consecutive kept bins -> segment sub-ranges.  Adjacent
        # sub-ranges with no segments between them coalesce: a pruned bin
        # that is *empty* (or whose segments all sit left of the range)
        # separates runs in bin space but not in segment space, and
        # splitting there would fragment the plan for zero pruned work
        # (e.g. integer-aligned segment starts against a finer bin grid
        # leave every fifth bin empty).
        breaks = np.nonzero(np.diff(kept) > 1)[0]
        run_a = np.concatenate([[0], breaks + 1])
        run_b = np.concatenate([breaks, [kept.size - 1]])
        subs: list[list[int]] = []
        for a, b in zip(kept[run_a], kept[run_b]):
            f = max(int(self.b_first[j_lo + a]), first)
            l = min(int(self.b_last[j_lo + b]), last)
            if l < f:
                continue
            if subs and f <= subs[-1][1] + 1:
                subs[-1][1] = max(subs[-1][1], l)
            else:
                subs.append([f, l])
        return subs

    def _box_runs(self, bins: slice, qt0: float, qlo, qhi,
                  lim2: float, first: int, last: int) -> list[list[int]]:
        """Surviving K-box runs as [first, last] *permuted* sub-ranges.

        Kept boxes in (bin-major, box-minor) order are increasing in
        permuted segment position, so runs form by coalescing adjacent
        boxes with no segments between them — same rule as the bin level,
        vectorized because a long extent can keep num_bins×K boxes.
        Empty box slots carry ±inf MBRs, so ``gap2 = inf`` prunes them.
        """
        gap2 = mbr_gap2(self.kbox_lo[bins], self.kbox_hi[bins], qlo, qhi)
        keep = (gap2 <= lim2) & (self.b_end[bins] >= qt0)[:, None]
        kf = self.kbox_first[bins][keep]
        kl = self.kbox_last[bins][keep]
        return _coalesce_runs(kf, kl, first, last)

    def candidate_subranges(self, qt0: float, qt1: float,
                            qlo: np.ndarray, qhi: np.ndarray, d: float, *,
                            max_subranges: int = DEFAULT_MAX_SUBRANGES,
                            level: str = "bin") -> list[tuple[int, int]]:
        """Spatially pruned candidate sub-ranges for one query extent.

        ``qlo``/``qhi`` is the (3,) union MBR of the query segments sharing
        the extent ``[qt0, qt1]`` (a batch); ``d`` the distance threshold.
        Returns disjoint, increasing, inclusive ``(first, last)`` segment
        index sub-ranges — the temporal ``candidate_range`` with every run
        of bins (``level="bin"``) or per-bin K-boxes
        (``level="box"`` — sub-ranges are then *permuted* segment
        positions, matching the engines' permuted packed layout) farther
        than the inflated threshold from the query MBR (or temporally
        dead: ``B_end < qt0``) cut out.  Exact: a pruned box lies farther
        than ``d`` from the whole batch MBR, hence from every member
        query's box, hence from every member query at every instant — no
        hit can be dropped.  At most ``max_subranges`` runs come back
        (surplus runs merge across the *smallest* gaps; merging re-admits
        the gap's segments, so the cap trades dispatch count for pruned
        work — pruning may only shrink, never grow, the result, and on
        multi-modal extents a too-small cap silently merges across huge
        gaps, which is why the cap is policy-tunable and priced by
        :meth:`estimate_pruned_candidates_batch`).
        """
        r = self._bin_range(qt0, qt1)
        if r is None:
            return []
        j_lo, j_hi = r
        first = max(int(self.b_first[j_lo]), 0)
        last = min(int(self.b_last[j_hi]), self.n_segments - 1)
        if last < first:
            return []
        qlo = np.asarray(qlo, np.float64)
        qhi = np.asarray(qhi, np.float64)
        lim = self._limit(d, qlo, qhi)
        lim2 = lim * lim
        # Whole-range quick reject: the range's true MBR union is a subset
        # of both prefix[j_hi] and suffix[j_lo], so the larger box distance
        # lower-bounds the distance to everything in the range.
        lb2 = max(float(mbr_gap2(self.prefix_lo[j_hi], self.prefix_hi[j_hi],
                                 qlo, qhi)),
                  float(mbr_gap2(self.suffix_lo[j_lo], self.suffix_hi[j_lo],
                                 qlo, qhi)))
        if lb2 > lim2:
            return []
        bins = slice(j_lo, j_hi + 1)
        if level == "box":
            subs = self._box_runs(bins, qt0, qlo, qhi, lim2, first, last)
        else:
            subs = self._bin_runs(bins, j_lo, qt0, qlo, qhi, lim2,
                                  first, last)
        if len(subs) > max_subranges:
            # Keep only the largest inter-run gaps as split points; merging
            # across a gap re-admits the gap's segments (exactness is
            # preserved — pruning may only shrink, never grow, the result).
            gaps = np.array([subs[i + 1][0] - subs[i][1]
                             for i in range(len(subs) - 1)])
            keep = max(int(max_subranges) - 1, 0)
            splits = (set(np.argsort(gaps)[-keep:].tolist()) if keep
                      else set())
            merged = [subs[0]]
            for i, s in enumerate(subs[1:]):
                if i in splits:
                    merged.append(s)
                else:
                    merged[-1][1] = s[1]
            subs = merged
        return [(int(f), int(l)) for f, l in subs]

    def pruned_num_candidates(self, qt0: float, qt1: float, qlo, qhi,
                              d: float, *,
                              max_subranges: int = DEFAULT_MAX_SUBRANGES,
                              level: str = "bin") -> int:
        """Exact candidate count surviving :meth:`candidate_subranges`."""
        return sum(l - f + 1 for f, l in
                   self.candidate_subranges(qt0, qt1, qlo, qhi, d,
                                            max_subranges=max_subranges,
                                            level=level))

    def estimate_pruned_candidates_batch(self, qt0, qt1, qlo, qhi,
                                         d: float, *,
                                         level: str = "bin",
                                         max_subranges: int | None = None
                                         ) -> np.ndarray:
        """Vectorized pruned-candidate estimate over the coarse bin grid.

        ``qt0``/``qt1`` are (n,) extents, ``qlo``/``qhi`` (n, 3) query-MBR
        stacks.  For each row, the temporal ``[first, last]`` range is
        intersected with every coarse bin's segment range and coarse bins
        whose union MBR lies beyond the inflated threshold are dropped.
        ``level="box"`` keeps a cell only when *some* of its K coarse
        boxes survives — a strictly sharper (still conservative) test on
        multi-modal data, matching ``candidate_subranges(level="box")``.
        Conservative with respect to the *uncapped* sub-range split (a
        coarse union prunes no more than its fine bins) and exactly equal
        to the temporal count when nothing is spatially pruned.  Passing
        ``max_subranges`` additionally prices the sub-range cap: surplus
        fragments merge across gaps and re-admit the gap's segments, so
        the estimate adds ``internal_dropped × excess/(fragments−1)`` —
        the expected re-admission if the cap merges a proportional share
        of the internal gaps — keeping the pricing signal honest on
        heavily fragmented extents instead of silently under-counting
        them.  This is the signal the SETSPLIT/GREEDYSETSPLIT merge loops
        consume.
        """
        qt0 = np.asarray(qt0, np.float64)
        qt1 = np.asarray(qt1, np.float64)
        qlo = np.asarray(qlo, np.float64).reshape(-1, 3)
        qhi = np.asarray(qhi, np.float64).reshape(-1, 3)
        first, last = self.candidate_range_batch(qt0, qt1)
        cf, cl = self._coarse_first, self._coarse_last
        ov = (np.minimum(last[:, None], cl[None, :])
              - np.maximum(first[:, None], cf[None, :]) + 1)
        ov = np.maximum(ov, 0)
        lim = self._limit(float(d), qlo, qhi)
        if level == "box":
            gap2 = mbr_gap2(self._coarse_klo[None], self._coarse_khi[None],
                            qlo[:, None, None], qhi[:, None, None])  # (n,k,K)
            keep = (gap2 <= lim * lim).any(axis=2)
        else:
            gap2 = mbr_gap2(self._coarse_lo[None], self._coarse_hi[None],
                            qlo[:, None], qhi[:, None])     # (n, k)
            keep = gap2 <= lim * lim
        est = (ov * keep).sum(axis=1).astype(np.int64)
        if max_subranges is not None:
            kk = keep & (ov > 0)
            ncell = kk.shape[1]
            frag = kk[:, 0].astype(np.int64) + (kk[:, 1:] & ~kk[:, :-1]).sum(axis=1)
            any_k = kk.any(axis=1)
            idx = np.arange(ncell)
            first_k = np.where(any_k, kk.argmax(axis=1), ncell)
            last_k = np.where(any_k, ncell - 1 - kk[:, ::-1].argmax(axis=1), -1)
            internal = (~kk) & (idx[None, :] > first_k[:, None]) \
                & (idx[None, :] < last_k[:, None])
            dropped = (ov * internal).sum(axis=1).astype(np.int64)
            excess = np.maximum(frag - int(max_subranges), 0)
            denom = np.maximum(frag - 1, 1)
            est = est + (dropped * excess + denom - 1) // denom
        return est

    # ------------------------------------------------------------------
    # pod-local K-box rebuild
    # ------------------------------------------------------------------
    def build_for_slice(self, db: SegmentArray, lo: int, hi: int,
                        kboxes: int | None = None):
        """Rebuild the K-box layer over one ownership slice ``[lo, hi]``.

        The distributed pod partition assigns each pod a contiguous slice
        of the t_start-sorted segment array; a pod must only ever reorder
        *its own* rows, so the global within-bin split cannot be
        reused (its permutation moves segments across pod boundaries
        whenever a bin straddles one).  This path re-runs the K-box split
        — widest-spread midpoint axis, largest-gap cuts, at most ``K``
        boxes — independently per (bin ∩ slice) piece.  Because every
        piece lies inside one bin *and* one pod slice, the returned
        permutation leaves both bin ranges and pod ownership ranges
        occupying exactly their original index intervals.

        Returns ``(perm_slice, box_first, box_last, box_lo, box_hi,
        box_bin)``: ``perm_slice`` maps the slice's permuted positions
        ``lo..hi`` back to original segment indices; the flat box arrays
        are in increasing ``box_first`` (global permuted-position) order
        with ``box_bin`` the owning bin of each box (non-decreasing).
        """
        kboxes = self.kboxes if kboxes is None else int(kboxes)
        if not 1 <= kboxes <= MAX_KBOXES:
            raise ValueError(f"kboxes must be in [1, {MAX_KBOXES}], got {kboxes}")
        empty3 = np.empty((0, 3), dtype=np.float64)
        empty1 = np.empty(0, dtype=np.int64)
        if hi < lo:
            return empty1, empty1, empty1, empty3, empty3, empty1
        nloc = hi - lo + 1
        seg_lo, seg_hi = db.mbrs()
        slo = seg_lo[lo:hi + 1]
        shi = seg_hi[lo:hi + 1]
        # Bin of each owned segment by *index position* (non-empty bins
        # tile [0, n) and b_last is non-decreasing), immune to float
        # edge rounding in the t_start -> bin map.
        binv = np.searchsorted(self.b_last, np.arange(lo, hi + 1),
                               side="left").astype(np.int64)
        mid = 0.5 * (slo + shi)
        # Pieces = runs of equal bin inside the slice; per-piece
        # widest-spread midpoint axis, exactly as in the global build.
        pf = np.r_[0, np.nonzero(np.diff(binv))[0] + 1].astype(np.int64)
        mmin = np.minimum.reduceat(mid, pf, axis=0)
        mmax = np.maximum.reduceat(mid, pf, axis=0)
        axis = np.argmax(mmax - mmin, axis=1)
        piece_id = np.cumsum(np.r_[0, (np.diff(binv) != 0).astype(np.int64)])
        key = mid[np.arange(nloc), axis[piece_id]]
        # Stable within-piece sort: pieces (hence bins, hence the pod
        # slice itself) keep their index intervals.
        order = np.lexsort((key, binv))
        perm_slice = (np.arange(lo, hi + 1, dtype=np.int64))[order]
        keyp = key[order]
        splits = np.empty(0, dtype=np.int64)
        if nloc > 1 and kboxes > 1:
            gapv = keyp[1:] - keyp[:-1]
            cand = (binv[1:] == binv[:-1]) & (gapv > 0.0)
            cpos = np.nonzero(cand)[0].astype(np.int64) + 1
            if cpos.size:
                cgap = gapv[cpos - 1]
                cbin = binv[cpos]
                order2 = np.lexsort((-cgap, cbin))
                sb = cbin[order2]
                grp = np.r_[0, np.nonzero(np.diff(sb))[0] + 1].astype(np.int64)
                lens = np.diff(np.r_[grp, sb.size])
                rank = np.arange(sb.size) - np.repeat(grp, lens)
                splits = np.sort(cpos[order2[rank < kboxes - 1]])
        allstarts = np.concatenate([pf, splits])
        allstarts.sort()
        slo_p, shi_p = slo[order], shi[order]
        box_lo = np.minimum.reduceat(slo_p, allstarts, axis=0)
        box_hi = np.maximum.reduceat(shi_p, allstarts, axis=0)
        box_first = allstarts + lo
        box_last = np.r_[allstarts[1:] - 1, nloc - 1].astype(np.int64) + lo
        box_bin = binv[allstarts]
        return perm_slice, box_first, box_last, box_lo, box_hi, box_bin


@dataclasses.dataclass
class PodPartitionedIndex(TemporalBinIndex):
    """The hierarchical index rebuilt over a pod partition.

    Every bin-level quantity is inherited verbatim from the base index —
    the pod-local permutation reorders segments only *within*
    (bin ∩ pod-slice) pieces, so bin ranges, per-bin MBRs, prefix/suffix
    unions and the coarse pricing grid are all invariant, and so are the
    pod ownership intervals themselves (``_pod_lens`` keeps working on
    permuted coordinates unchanged).  Only the box layer differs: instead
    of a dense ``(num_bins, K)`` grid there is a flat sorted box list
    (a bin straddling a pod boundary owns up to ``K`` boxes *per pod*,
    which the dense grid cannot represent), binary-searched by bin in
    :meth:`_box_runs`.  ``perm`` composes all pod-local permutations into
    one global map, so caller-visible ``entry_idx`` never changes.
    """

    box_first: np.ndarray | None = None  # (B,) int64 — sorted permuted starts
    box_last: np.ndarray | None = None   # (B,) int64 — inclusive ends
    box_lo: np.ndarray | None = None     # (B, 3) — per-box MBR
    box_hi: np.ndarray | None = None
    box_bin: np.ndarray | None = None    # (B,) int64 — owning bin, non-decreasing

    @staticmethod
    def build_partitioned(base: "TemporalBinIndex", db: SegmentArray,
                          pod_slices, *, kboxes: int | None = None
                          ) -> "PodPartitionedIndex":
        """Compose :meth:`TemporalBinIndex.build_for_slice` over every pod
        ownership slice ``(lo, hi)`` (inclusive; empty slices allowed)."""
        kboxes = base.kboxes if kboxes is None else int(kboxes)
        n = base.n_segments
        perm = np.arange(n, dtype=np.int64)
        parts: list[tuple] = []
        for lo, hi in pod_slices:
            if hi < lo:
                continue
            ps, bf, bl, blo, bhi, bb = base.build_for_slice(
                db, int(lo), int(hi), kboxes=kboxes)
            perm[lo:hi + 1] = ps
            parts.append((bf, bl, blo, bhi, bb))
        if parts:
            box_first = np.concatenate([p[0] for p in parts])
            box_last = np.concatenate([p[1] for p in parts])
            box_lo = np.concatenate([p[2] for p in parts], axis=0)
            box_hi = np.concatenate([p[3] for p in parts], axis=0)
            box_bin = np.concatenate([p[4] for p in parts])
        else:
            box_first = box_last = box_bin = np.empty(0, dtype=np.int64)
            box_lo = box_hi = np.empty((0, 3), dtype=np.float64)
        # Pod slices arrive in increasing index order and bins increase
        # with index, so the flat lists are already box_first-sorted with
        # non-decreasing box_bin; assert rather than re-sort (a violation
        # means the pod partition overlapped, which must never happen).
        if box_first.size > 1:
            if not ((np.diff(box_first) > 0).all()
                    and (np.diff(box_bin) >= 0).all()):
                raise ValueError("pod slices must be disjoint and increasing")
        # Coarse pricing grid, K-box flavour, over the flat list: cell =
        # owning bin's coarse chunk, slot = within-cell rank mod K.  Any
        # (cell, slot) cover keeps the estimate conservative — a fine box
        # surviving the prune test keeps its containing union alive.
        chunk = max((base.num_bins + COARSE_GRID_BINS - 1)
                    // COARSE_GRID_BINS, 1)
        ncell = len(base._coarse_first)
        coarse_klo = np.full((ncell, kboxes, 3), np.inf)
        coarse_khi = np.full((ncell, kboxes, 3), -np.inf)
        if box_first.size:
            cell = box_bin // chunk
            grp = np.r_[0, np.nonzero(np.diff(cell))[0] + 1].astype(np.int64)
            lens = np.diff(np.r_[grp, cell.size])
            rank = np.arange(cell.size) - np.repeat(grp, lens)
            slot = rank % kboxes
            np.minimum.at(coarse_klo, (cell, slot), box_lo)
            np.maximum.at(coarse_khi, (cell, slot), box_hi)
        fields = {f.name: getattr(base, f.name)
                  for f in dataclasses.fields(TemporalBinIndex)}
        fields.update(
            kboxes=kboxes, perm=perm,
            # the dense (num_bins, K) grid is meaningless under the pod
            # permutation — null it out so stale reads fail loudly
            kbox_first=None, kbox_last=None, kbox_lo=None, kbox_hi=None,
            _coarse_klo=coarse_klo, _coarse_khi=coarse_khi,
        )
        return PodPartitionedIndex(
            **fields, box_first=box_first, box_last=box_last,
            box_lo=box_lo, box_hi=box_hi, box_bin=box_bin)

    def _box_runs(self, bins: slice, qt0: float, qlo, qhi,
                  lim2: float, first: int, last: int) -> list[list[int]]:
        """Flat-list override: binary-search the bin window, prune, and
        coalesce — identical semantics to the dense version."""
        a = int(np.searchsorted(self.box_bin, bins.start, side="left"))
        b = int(np.searchsorted(self.box_bin, bins.stop - 1, side="right"))
        if b <= a:
            return []
        bb = self.box_bin[a:b]
        gap2 = mbr_gap2(self.box_lo[a:b], self.box_hi[a:b], qlo, qhi)
        keep = (gap2 <= lim2) & (self.b_end[bb] >= qt0)
        kf = self.box_first[a:b][keep]
        kl = self.box_last[a:b][keep]
        return _coalesce_runs(kf, kl, first, last)
