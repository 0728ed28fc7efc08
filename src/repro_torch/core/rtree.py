"""CPU R-tree baseline (paper §7.3, following [11]) — the port's copy of
``repro/core/rtree.py``.

The paper's CPU comparison point stores ``r`` consecutive trajectory
segments per minimum bounding box (MBB, 4-D: x/y/z/t), indexes the MBBs in
an in-memory R-tree, and answers a distance-threshold query with
search-and-refine: the search phase walks the tree collecting leaf MBBs
that intersect the query segment's d-expanded MBB; the refine phase runs
the exact interaction computation on the candidate segments.

Implementation notes:

* Trajectory splitting: each trajectory's segments are chunked ``r`` at a
  time into one MBB (the paper's [11] strategy with a fixed per-MBB segment
  count; r=12 was best on GALAXY, Fig. 5).
* The tree is STR bulk-loaded (sort-tile-recursive) with fanout 16 — the
  standard static construction for in-memory R-trees.
* The refine phase runs the torch oracle (``repro_torch.kernels.ref``
  through ``ops.interaction_tiles(use_kernel=False)``) on the candidate
  set, so the CPU baseline and the device path share one interval math.
* **The refine runs on the host CPU whatever the database's device.**
  This backend *is* the paper's multithreaded CPU baseline: its worth is
  as the thing the GPU is compared against, so it launches no kernel and
  is no fallback of the device path.
* ``query_parallel`` dispatches independent query segments across a thread
  pool (the paper's OpenMP analogue; torch's CPU ops release the GIL in
  the refine).

Public entry point: ``repro_torch.api.TrajectoryDB.query(...,
backend="rtree")`` (``ExecutionPolicy.rtree_r/rtree_fanout/rtree_threads``
carry the knobs).
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch.core.engine import ResultSet
from repro_torch.core.segments import SegmentArray
from repro_torch.kernels import ops


@dataclasses.dataclass
class _Level:
    lo: np.ndarray     # (n, 4) mins  (x, y, z, t)
    hi: np.ndarray     # (n, 4) maxs
    child: np.ndarray  # (n,) index of first child in level below
    count: np.ndarray  # (n,) number of children


class RTree:
    """STR bulk-loaded R-tree over per-trajectory segment MBBs."""

    def __init__(self, db: SegmentArray, r: int = 12, fanout: int = 16):
        self.db = db
        self.r = r
        self.fanout = fanout
        self._build_leaves()
        self._build_tree()

    # -- leaves: r consecutive same-trajectory segments per MBB ----------
    def _build_leaves(self) -> None:
        db = self.db
        order = np.lexsort((db.seg_id, db.traj_id))
        self.seg_order = order                    # leaf-contiguous segment order
        tid = db.traj_id[order]
        xs, ys, zs = db.xs[order], db.ys[order], db.zs[order]
        xe, ye, ze = db.xe[order], db.ye[order], db.ze[order]
        ts, te = db.ts[order], db.te[order]
        lo_pt = np.stack([np.minimum(xs, xe), np.minimum(ys, ye),
                          np.minimum(zs, ze), ts], axis=1)
        hi_pt = np.stack([np.maximum(xs, xe), np.maximum(ys, ye),
                          np.maximum(zs, ze), te], axis=1)
        # Chunk boundaries: every r segments, restarting at trajectory breaks.
        n = len(db)
        breaks = np.nonzero(np.diff(tid))[0] + 1
        starts = [0]
        prev = 0
        bset = set(breaks.tolist())
        for i in range(1, n):
            if i in bset or i - prev >= self.r:
                starts.append(i)
                prev = i
        starts = np.asarray(starts, dtype=np.int64)
        ends = np.append(starts[1:], n)
        self.leaf_first = starts
        self.leaf_count = ends - starts
        self.leaf_lo = np.minimum.reduceat(lo_pt, starts, axis=0)
        self.leaf_hi = np.maximum.reduceat(hi_pt, starts, axis=0)

    # -- STR bulk load ----------------------------------------------------
    def _build_tree(self) -> None:
        lo, hi = self.leaf_lo, self.leaf_hi
        idx = np.arange(lo.shape[0], dtype=np.int64)
        # STR ordering: sort by x-center then tile by t-center.
        cx = (lo[:, 0] + hi[:, 0]) / 2
        ct = (lo[:, 3] + hi[:, 3]) / 2
        order = np.lexsort((cx, ct))
        self.leaf_perm = idx[order]
        self.levels: list[_Level] = []
        cur_lo, cur_hi = lo[order], hi[order]
        child = self.leaf_perm.copy()
        is_leaf_level = True
        while cur_lo.shape[0] > 1:
            n = cur_lo.shape[0]
            f = self.fanout
            starts = np.arange(0, n, f, dtype=np.int64)
            ends = np.minimum(starts + f, n)
            lvl = _Level(
                lo=np.minimum.reduceat(cur_lo, starts, axis=0),
                hi=np.maximum.reduceat(cur_hi, starts, axis=0),
                child=starts, count=ends - starts)
            if is_leaf_level:
                self.leaf_level_children = child
                is_leaf_level = False
            self.levels.append(lvl)
            cur_lo, cur_hi = lvl.lo, lvl.hi
        if is_leaf_level:                           # single-leaf tree
            self.leaf_level_children = child
            self.levels.append(_Level(
                lo=cur_lo, hi=cur_hi,
                child=np.zeros(1, np.int64), count=np.ones(1, np.int64)))

    # -- search -----------------------------------------------------------
    def _search_leaves(self, qlo: np.ndarray, qhi: np.ndarray) -> np.ndarray:
        """Leaf ids whose MBB intersects [qlo, qhi] (pointer-chasing walk)."""
        hits: list[int] = []
        top = len(self.levels) - 1
        stack = [(top, i) for i in range(self.levels[top].lo.shape[0])]
        while stack:
            lvl_i, node = stack.pop()
            lvl = self.levels[lvl_i]
            if np.any(lvl.lo[node] > qhi) or np.any(lvl.hi[node] < qlo):
                continue
            c0 = int(lvl.child[node])
            cn = int(lvl.count[node])
            if lvl_i == 0:
                # children are positions into the STR-ordered leaf list
                for j in range(c0, c0 + cn):
                    leaf = int(self.leaf_level_children[j])
                    if (not np.any(self.leaf_lo[leaf] > qhi)
                            and not np.any(self.leaf_hi[leaf] < qlo)):
                        hits.append(leaf)
            else:
                stack.extend((lvl_i - 1, j) for j in range(c0, c0 + cn))
        return np.asarray(hits, dtype=np.int64)

    def candidate_segments(self, qseg: np.ndarray, d: float) -> np.ndarray:
        """Global segment indices whose leaf MBB intersects the d-expanded
        MBB of one packed query segment (search phase)."""
        qlo = np.array([min(qseg[0], qseg[3]) - d, min(qseg[1], qseg[4]) - d,
                        min(qseg[2], qseg[5]) - d, qseg[6]])
        qhi = np.array([max(qseg[0], qseg[3]) + d, max(qseg[1], qseg[4]) + d,
                        max(qseg[2], qseg[5]) + d, qseg[7]])
        leaves = self._search_leaves(qlo, qhi)
        if leaves.size == 0:
            return np.zeros(0, np.int64)
        parts = [self.seg_order[self.leaf_first[lf]:
                                self.leaf_first[lf] + self.leaf_count[lf]]
                 for lf in leaves]
        return np.concatenate(parts)


def _refine(db_packed: np.ndarray, db: SegmentArray, cand: np.ndarray,
            qseg: np.ndarray, q_global: int, d: float) -> ResultSet | None:
    if cand.size == 0:
        return None
    # The torch oracle on the host CPU (see the module docstring).
    t_enter, t_exit, hit = ops.interaction_tiles(
        db_packed[cand], qseg[None, :], np.float32(d), use_kernel=False,
        device="cpu")
    hit = np.asarray(hit)[:, 0]
    if not hit.any():
        return None
    rows = np.nonzero(hit)[0]
    eg = cand[rows]
    return ResultSet(
        entry_idx=eg.astype(np.int64),
        entry_traj=db.traj_id[eg].astype(np.int64),
        entry_seg=db.seg_id[eg].astype(np.int64),
        query_idx=np.full(rows.size, q_global, np.int64),
        t_enter=np.asarray(t_enter)[rows, 0],
        t_exit=np.asarray(t_exit)[rows, 0],
    )


class RTreeEngine:
    """Search-and-refine distance-threshold engine (the CPU baseline)."""

    def __init__(self, db: SegmentArray, r: int = 12, fanout: int = 16):
        self.db = db if db.is_sorted() else db.sort_by_tstart()
        self.tree = RTree(self.db, r=r, fanout=fanout)
        self._packed = self.db.packed()

    def query(self, queries: SegmentArray, d: float) -> ResultSet:
        q_packed = queries.packed()
        parts = []
        for qi in range(len(queries)):
            cand = self.tree.candidate_segments(q_packed[qi], d)
            rs = _refine(self._packed, self.db, cand, q_packed[qi], qi, d)
            if rs is not None:
                parts.append(rs)
        return ResultSet.concatenate(parts).sorted_canonical()

    def query_parallel(self, queries: SegmentArray, d: float,
                       num_threads: int = 4) -> ResultSet:
        q_packed = queries.packed()

        def one(qi: int) -> ResultSet | None:
            cand = self.tree.candidate_segments(q_packed[qi], d)
            return _refine(self._packed, self.db, cand, q_packed[qi], qi, d)

        with ThreadPoolExecutor(num_threads) as pool:
            parts = [r for r in pool.map(one, range(len(queries)))
                     if r is not None]
        return ResultSet.concatenate(parts).sorted_canonical()
