"""The comparison that decides ``correct``: an answer against the reference.

An answer is the rows of one request as the caller gets them:
``entry_traj``, ``entry_seg`` (which database segment), ``query_idx``
(which of the caller's query segments), ``t_enter``, ``t_exit``, and
``entry_idx`` (the program's own index of the segment, used only to check
the row order).  Three numbers come out, each to be held to a limit:

* ``row_errors`` (exact, limit 0): rows out of the caller's order
  (``query_idx`` ascending, then ``entry_idx`` ascending), rows repeated,
  and rows that name no segment of the database or no query.
* ``flip_ratio``: a row that one side has and the other lacks is allowed
  only where the pair's least distance lies on ``d`` to float32 round-off.
  Its size is ``|dmin² − d²| / (eps32 · R²)``, R the pair's scale
  (coordinates + speed × time, the magnitudes a float32 solve anchored at
  time zero works with); the number is the largest over such rows (0 when
  the two sides agree).  A row whose segments share no time reads
  ``INF``.
* ``interval_ratio``: for the rows both sides have, the largest gap
  between the answer's ``t_enter`` / ``t_exit`` and the reference's, over
  what float32 round-off allows at that endpoint: four ulps of the time,
  plus, where the endpoint is a root of the distance, the root's shift
  under an error of ``eps32 · R²`` in the squared distance
  (``min(δ / |slope|, sqrt(δ / A))``, so near-tangent pairs get the room
  their ill-conditioned roots need).
"""
from __future__ import annotations

import numpy as np

from perfbench.reference.distthresh import geometry, roots

EPS32 = float(np.finfo(np.float32).eps)
#: what a ratio reads where no round-off can explain the row
INF = 1e300


def _keys(e_row, q, nq):
    return e_row.astype(np.int64) * np.int64(nq) + q.astype(np.int64)


def row_errors(answer: dict, traj_slices: np.ndarray, nq: int) -> tuple:
    """(count of bad rows, db rows of the answer, valid mask)."""
    traj = answer["entry_traj"].astype(np.int64)
    seg = answer["entry_seg"].astype(np.int64)
    q = answer["query_idx"].astype(np.int64)
    valid = (traj >= 0) & (traj < len(traj_slices)) & (q >= 0) & (q < nq)
    start = np.where(valid, traj_slices[np.clip(traj, 0, len(traj_slices) - 1), 0], 0)
    end = np.where(valid, traj_slices[np.clip(traj, 0, len(traj_slices) - 1), 1], 0)
    valid &= (seg >= 0) & (seg < end - start)
    e_row = start + seg
    bad = int((~valid).sum())
    if len(q) > 1:
        e_idx = answer["entry_idx"].astype(np.int64)
        dq = np.diff(q)
        de = np.diff(e_idx)
        bad += int(((dq < 0) | ((dq == 0) & (de <= 0))).sum())
    keys = _keys(e_row[valid], q[valid], nq)
    bad += int(len(keys) - len(np.unique(keys)))
    return bad, e_row, valid


def flip_ratios(db: dict, qs: dict, e_row, q, d: float) -> np.ndarray:
    """Each pair's distance from the threshold in float32 round-offs."""
    if len(e_row) == 0:
        return np.zeros(0)
    g = geometry(db, qs, e_row, q, d)
    ratio = np.abs(g.dmin2 - d * d) / (EPS32 * g.scale ** 2)
    return np.where(g.overlap, ratio, INF)


def interval_ratios(db: dict, qs: dict, e_row, q, d: float,
                    t_enter, t_exit) -> np.ndarray:
    """Each endpoint's gap from the reference's in allowed round-offs."""
    if len(e_row) == 0:
        return np.zeros(0)
    g = geometry(db, qs, e_row, q, d)
    s1, s2 = roots(g)
    span = np.maximum(g.span, 0.0)
    delta = EPS32 * g.scale ** 2
    quad = g.A > 0
    A = np.where(quad, g.A, 1.0)
    disc = np.maximum(g.B * g.B - A * g.C, 0.0)
    with np.errstate(divide="ignore"):
        shift = np.where(quad, np.minimum(delta / (2.0 * np.sqrt(disc)),
                                          np.sqrt(delta / A)), np.inf)
    out = []
    for s, t in ((s1, t_enter), (s2, t_exit)):
        t_ref = g.lo + np.clip(s, 0.0, span)
        root_near = np.abs(g.lo + s - t_ref) <= shift
        allowed = (4.0 * EPS32 * np.maximum(np.abs(t_ref), 1.0)
                   + np.where(root_near, shift, 0.0))
        out.append(np.abs(np.asarray(t, np.float64) - t_ref) / allowed)
    return np.maximum(out[0], out[1])


def compare(answer: dict, ref: dict, db: dict, qs: dict,
            traj_slices: np.ndarray, d: float) -> dict:
    """The three numbers for one request (see the module's docstring)."""
    nq = len(qs["ts"])
    bad, e_row, valid = row_errors(answer, traj_slices, nq)
    q = answer["query_idx"].astype(np.int64)
    keys = _keys(e_row[valid], q[valid], nq)
    ref_keys = _keys(ref["e"], ref["q"], nq)
    common, ia, ib = np.intersect1d(keys, ref_keys, assume_unique=False,
                                    return_indices=True)
    only_answer = np.setdiff1d(keys, common)
    only_ref = np.setdiff1d(ref_keys, common)
    diff = np.concatenate([only_answer, only_ref])
    flips = flip_ratios(db, qs, diff // nq, diff % nq, d)
    t_enter = answer["t_enter"][valid][ia]
    t_exit = answer["t_exit"][valid][ia]
    ivals = interval_ratios(db, qs, common // nq, common % nq, d,
                            t_enter, t_exit)
    return {
        "row_errors": bad,
        "flip_ratio": float(flips.max()) if len(flips) else 0.0,
        "interval_ratio": float(ivals.max()) if len(ivals) else 0.0,
        "rows": int(len(keys)),
        "ref_rows": int(len(ref_keys)),
        "rows_differing": int(len(diff)),
    }
