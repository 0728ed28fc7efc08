"""Segment storage for the trajectory database.

The paper (§3) defines the database ``D`` as ``n`` 4-D line segments, each
with a spatiotemporal start point, end point, a segment id and a trajectory
id.  We store segments as a struct-of-arrays so that (a) the temporal-bin
index's contiguous candidate ranges translate into dense slices, and (b) the
Pallas kernel's BlockSpecs see flat, padded, tile-aligned arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

# Column order used when segments are packed into a single (n, 8) matrix for
# device transfer: spatial start, spatial end, temporal extent.
PACKED_COLUMNS = ("xs", "ys", "zs", "xe", "ye", "ze", "ts", "te")


@dataclasses.dataclass
class SegmentArray:
    """Struct-of-arrays segment store.

    All spatial/temporal arrays are float32 of shape (n,); ids are int32.
    ``ts``/``te`` are the segment's temporal extent (paper: t_i^start,
    t_i^end).  Invariant after :meth:`sort_by_tstart`: ``ts`` is
    non-decreasing, which the temporal-bin index requires.
    """

    xs: np.ndarray
    ys: np.ndarray
    zs: np.ndarray
    xe: np.ndarray
    ye: np.ndarray
    ze: np.ndarray
    ts: np.ndarray
    te: np.ndarray
    seg_id: np.ndarray
    traj_id: np.ndarray

    def __post_init__(self) -> None:
        n = len(self.xs)
        for name in PACKED_COLUMNS:
            arr = np.asarray(getattr(self, name), dtype=np.float32)
            if arr.shape != (n,):
                raise ValueError(f"column {name} has shape {arr.shape}, want ({n},)")
            setattr(self, name, arr)
        for name in ("seg_id", "traj_id"):
            arr = np.asarray(getattr(self, name), dtype=np.int32)
            if arr.shape != (n,):
                raise ValueError(f"column {name} has shape {arr.shape}, want ({n},)")
            setattr(self, name, arr)
        if np.any(self.te < self.ts):
            raise ValueError("segment end time precedes start time")

    def __len__(self) -> int:
        return int(self.xs.shape[0])

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------
    @staticmethod
    def from_trajectories(points: Sequence[np.ndarray], times: Sequence[np.ndarray],
                          traj_ids: Sequence[int] | None = None) -> "SegmentArray":
        """Build segments from per-trajectory polylines.

        ``points[k]`` is (m_k, 3) float array of positions, ``times[k]`` is
        (m_k,) non-decreasing timestamps.  Each consecutive pair of points
        becomes one entry segment (paper §2.2: polyline approximation).
        """
        cols: dict[str, list[np.ndarray]] = {c: [] for c in PACKED_COLUMNS}
        seg_ids: list[np.ndarray] = []
        trj_ids: list[np.ndarray] = []
        for k, (pts, tms) in enumerate(zip(points, times)):
            pts = np.asarray(pts, dtype=np.float32)
            tms = np.asarray(tms, dtype=np.float32)
            if pts.ndim != 2 or pts.shape[1] != 3:
                raise ValueError("points must be (m, 3)")
            if pts.shape[0] != tms.shape[0]:
                raise ValueError("points/times length mismatch")
            m = pts.shape[0] - 1
            if m <= 0:
                continue
            cols["xs"].append(pts[:-1, 0]); cols["ys"].append(pts[:-1, 1])
            cols["zs"].append(pts[:-1, 2])
            cols["xe"].append(pts[1:, 0]); cols["ye"].append(pts[1:, 1])
            cols["ze"].append(pts[1:, 2])
            cols["ts"].append(tms[:-1]); cols["te"].append(tms[1:])
            seg_ids.append(np.arange(m, dtype=np.int32))
            tid = k if traj_ids is None else traj_ids[k]
            trj_ids.append(np.full(m, tid, dtype=np.int32))
        if not seg_ids:
            return SegmentArray.empty()
        return SegmentArray(
            **{c: np.concatenate(cols[c]) for c in PACKED_COLUMNS},
            seg_id=np.concatenate(seg_ids),
            traj_id=np.concatenate(trj_ids),
        )

    @staticmethod
    def empty() -> "SegmentArray":
        z = np.zeros(0, dtype=np.float32)
        zi = np.zeros(0, dtype=np.int32)
        return SegmentArray(z, z, z, z, z, z, z, z, zi, zi)

    @staticmethod
    def concatenate(parts: Sequence["SegmentArray"]) -> "SegmentArray":
        return SegmentArray(
            **{c: np.concatenate([getattr(p, c) for p in parts]) for c in PACKED_COLUMNS},
            seg_id=np.concatenate([p.seg_id for p in parts]),
            traj_id=np.concatenate([p.traj_id for p in parts]),
        )

    # ------------------------------------------------------------------
    # views / transforms
    # ------------------------------------------------------------------
    def take(self, idx) -> "SegmentArray":
        return SegmentArray(
            **{c: getattr(self, c)[idx] for c in PACKED_COLUMNS},
            seg_id=self.seg_id[idx], traj_id=self.traj_id[idx],
        )

    def slice(self, first: int, last: int) -> "SegmentArray":
        """Inclusive contiguous slice [first, last] (paper's candidate range)."""
        return self.take(np.s_[first:last + 1])

    def sort_by_tstart(self) -> "SegmentArray":
        """Sort by non-decreasing t_start (paper §4, the index precondition).

        Stable so that equal-t_start segments keep (traj, seg) order, making
        results reproducible.
        """
        order = np.argsort(self.ts, kind="stable")
        return self.take(order)

    def is_sorted(self) -> bool:
        return bool(np.all(self.ts[1:] >= self.ts[:-1])) if len(self) > 1 else True

    def mbrs(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-segment axis-aligned spatial bounding boxes, ``(lo, hi)`` of
        shape (n, 3) float64.  A segment moves linearly between its
        endpoints, so its position at every instant of its temporal extent
        lies inside the box spanned by the two endpoints — the invariant
        the spatial pruning layer (``repro_torch.core.index``) relies on."""
        p0 = np.stack([self.xs, self.ys, self.zs], axis=1).astype(np.float64)
        p1 = np.stack([self.xe, self.ye, self.ze], axis=1).astype(np.float64)
        return np.minimum(p0, p1), np.maximum(p0, p1)

    @property
    def temporal_extent(self) -> tuple[float, float]:
        if len(self) == 0:
            return (0.0, 0.0)
        return float(self.ts.min()), float(self.te.max())

    # ------------------------------------------------------------------
    # device packing
    # ------------------------------------------------------------------
    def packed(self, pad_to: int | None = None, pad_multiple: int | None = None) -> np.ndarray:
        """Pack into an (n_padded, 8) float32 matrix for device transfer.

        Padding rows get a temporal extent strictly outside the data's range
        so they can never produce a temporal hit (branchless masking relies
        on this): ts = te = t_max_data + 1 with zero spatial extent.
        """
        n = len(self)
        target = n
        if pad_to is not None:
            target = max(target, pad_to)
        if pad_multiple is not None and pad_multiple > 0:
            target = ((max(target, 1) + pad_multiple - 1) // pad_multiple) * pad_multiple
        out = np.empty((target, 8), dtype=np.float32)
        for j, c in enumerate(PACKED_COLUMNS):
            out[:n, j] = getattr(self, c)
        if target > n:
            _, tmax = self.temporal_extent
            pad_t = np.float32(tmax + 1.0)
            out[n:, :] = 0.0
            out[n:, 6] = pad_t  # ts
            out[n:, 7] = pad_t  # te  (zero-length extent outside data range)
        return out

    def ids_packed(self, pad_to: int | None = None, pad_multiple: int | None = None) -> np.ndarray:
        n = len(self)
        target = n
        if pad_to is not None:
            target = max(target, pad_to)
        if pad_multiple is not None and pad_multiple > 0:
            target = ((max(target, 1) + pad_multiple - 1) // pad_multiple) * pad_multiple
        out = np.full((target, 2), -1, dtype=np.int32)
        out[:n, 0] = self.traj_id
        out[:n, 1] = self.seg_id
        return out


def pad_count(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` that is >= max(n, 1)."""
    return ((max(n, 1) + multiple - 1) // multiple) * multiple
