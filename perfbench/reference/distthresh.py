"""Plain NumPy reference of the distance threshold query.

For a database ``D`` and query segments ``Q`` (4-D line segments moving
linearly over their temporal extents), the answer is every pair (entry
segment, query segment) whose common time ``[lo, hi] = [max(ts), min(te)]``
is not empty (closed: ``lo <= hi``) and during which the two are within
``d`` of each other, with the sub-interval ``[t_enter, t_exit]`` of the
common time in which they are.  This module computes it on its own:

* its own join (``Reference``): the entries in time bins, ordered by x
  within a bin, so that each query meets a few contiguous runs, and every
  pair of a run tested for a common time and for per-axis box gaps of at
  most ``d`` (exact: a segment stays inside the box of its endpoints);
* its own interval solve in float64, anchored at the start of the common
  time, so that its round-off is that of the coordinates alone.

Pass ``rounding=bf16`` to compute every step, inputs and outputs too, in
bfloat16 (rounded to nearest even): that is the benchmark's control, the
reference one precision below the float32 that the configurations state.
Nothing here imports the program under test.
"""
from __future__ import annotations

import dataclasses

import numpy as np

COLUMNS = ("xs", "ys", "zs", "xe", "ye", "ze", "ts", "te")
AXES = (("xs", "xe"), ("ys", "ye"), ("zs", "ze"))


def exact(x):
    return x


def bf16(x):
    """Round to the nearest bfloat16 (ties to even), returned as float64."""
    x32 = np.asarray(x, dtype=np.float32)
    bits = x32.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32).astype(np.float64)


@dataclasses.dataclass
class Geometry:
    """The float64 solve of N pairs, anchored at ``lo``: the squared
    distance is ``A s² + 2 B s + P`` for ``s = t − lo`` in ``[0, span]``,
    and ``C = P − d²``."""

    lo: np.ndarray
    hi: np.ndarray
    A: np.ndarray
    B: np.ndarray
    C: np.ndarray
    dmin2: np.ndarray       # least squared distance over the common time
    scale: np.ndarray       # coordinates + speed × time, the float32 solve's scale
    overlap: np.ndarray     # lo <= hi

    @property
    def span(self):
        return self.hi - self.lo


def _parts(cols: dict, idx, r):
    p0 = np.stack([r(cols[c][idx].astype(np.float64))
                   for c in ("xs", "ys", "zs")])
    p1 = np.stack([r(cols[c][idx].astype(np.float64))
                   for c in ("xe", "ye", "ze")])
    ts = r(cols["ts"][idx].astype(np.float64))
    te = r(cols["te"][idx].astype(np.float64))
    dt = r(te - ts)
    live = dt > 0
    v = np.where(live, r(r(p1 - p0) / np.where(live, dt, 1.0)), 0.0)
    return p0, v, ts, te


def _dot(a, b, r):
    return r(r(r(a[0] * b[0]) + r(a[1] * b[1])) + r(a[2] * b[2]))


def geometry(db: dict, qs: dict, e_idx, q_idx, d: float, r=exact) -> Geometry:
    """Solve the pairs (``db`` row ``e_idx[k]``, ``qs`` row ``q_idx[k]``)."""
    e0, ev, ets, ete = _parts(db, e_idx, r)
    q0, qv, qts, qte = _parts(qs, q_idx, r)
    lo = np.maximum(ets, qts)
    hi = np.minimum(ete, qte)
    pe = r(e0 + r(ev * r(lo - ets)))
    pq = r(q0 + r(qv * r(lo - qts)))
    p = r(pe - pq)
    w = r(ev - qv)
    A = _dot(w, w, r)
    B = _dot(p, w, r)
    P = _dot(p, p, r)
    C = r(P - r(d * d))
    span = r(hi - lo)
    s_star = np.where(A > 0, np.clip(r(-B / np.where(A > 0, A, 1.0)), 0.0,
                                     np.maximum(span, 0.0)), 0.0)
    closest = r(p + r(w * s_star))
    dmin2 = _dot(closest, closest, r)
    coord = np.max(np.abs(np.concatenate([e0, e0 + ev * (ete - ets),
                                          q0, q0 + qv * (qte - qts)])),
                   axis=0)
    speed = np.maximum(np.sqrt((ev * ev).sum(0)), np.sqrt((qv * qv).sum(0)))
    tmax = np.maximum(np.abs(ete), np.abs(qte))
    return Geometry(lo, hi, A, B, C, dmin2, coord + speed * tmax, lo <= hi)


def roots(g: Geometry, r=exact) -> tuple[np.ndarray, np.ndarray]:
    """The unclamped roots ``s1 <= s2`` of ``A s² + 2 B s + C`` (−inf, +inf
    where the separation is constant); the discriminant is taken as 0
    where it rounds below."""
    quad = g.A > 0
    A = np.where(quad, g.A, 1.0)
    disc = np.maximum(r(r(g.B * g.B) - r(A * g.C)), 0.0)
    sq = r(np.sqrt(disc))
    qq = r(-(g.B + np.where(g.B >= 0, sq, -sq)))
    safe_q = np.where(qq != 0, qq, 1.0)
    a1 = r(qq / A)
    a2 = np.where(qq != 0, r(g.C / safe_q), a1)
    s1 = np.where(quad, np.minimum(a1, a2), -np.inf)
    s2 = np.where(quad, np.maximum(a1, a2), np.inf)
    return s1, s2


def intervals(g: Geometry, r=exact):
    """``(t_enter, t_exit)`` of each pair: the roots clamped to the common
    time (the whole common time where the separation is constant)."""
    s1, s2 = roots(g, r)
    span = np.maximum(g.span, 0.0)
    t_enter = r(g.lo + np.clip(s1, 0.0, span))
    t_exit = r(g.lo + np.clip(s2, 0.0, span))
    return t_enter, t_exit


class Reference:
    """The query over one database: indexed once, then any query set.

    The entries are ordered by time bin (bins one longest entry long),
    then by the low x of their box, so that the entries a query can meet
    are, in each bin it touches, one contiguous run: those whose low x
    lies within ``d`` (and one widest box) of the query's box.  Every pair
    of such a run is tested for a common time and per-axis box gaps of at
    most ``d``, and the survivors are solved."""

    #: candidate pairs tested at once
    CHUNK = 1 << 22

    def __init__(self, db: dict):
        self.db = db
        ts = db["ts"].astype(np.float64)
        te = db["te"].astype(np.float64)
        self.t0 = float(ts.min()) if len(ts) else 0.0
        self.width = max(float((te - ts).max()) if len(ts) else 0.0, 1e-6)
        lo = np.stack([np.minimum(db[a], db[b]) for a, b in AXES], 1)
        hi = np.stack([np.maximum(db[a], db[b]) for a, b in AXES], 1)
        lo, hi = lo.astype(np.float64), hi.astype(np.float64)
        self.x0 = float(lo[:, 0].min()) if len(ts) else 0.0
        self.span_x = (float(lo[:, 0].max()) - self.x0 + 1.0) if len(ts) else 1.0
        self.wide_x = float((hi[:, 0] - lo[:, 0]).max()) if len(ts) else 0.0
        tbin = np.floor((ts - self.t0) / self.width).astype(np.int64)
        self.nbins = int(tbin.max()) + 1 if len(ts) else 0
        self.order = np.lexsort((lo[:, 0], tbin))
        self.key = tbin[self.order] * self.span_x + (lo[self.order, 0] - self.x0)
        self.sorted = {c: db[c][self.order] for c in COLUMNS}
        self.ts, self.te = ts[self.order], te[self.order]
        self.lo = [np.ascontiguousarray(lo[self.order, j]) for j in range(3)]
        self.hi = [np.ascontiguousarray(hi[self.order, j]) for j in range(3)]

    def _runs(self, qs: dict, d: float):
        """Per query and time bin: the run ``[first, last)`` of entries."""
        qts = qs["ts"].astype(np.float64)
        qte = qs["te"].astype(np.float64)
        qlo = np.minimum(qs["xs"], qs["xe"]).astype(np.float64)
        qhi = np.maximum(qs["xs"], qs["xe"]).astype(np.float64)
        b0 = np.floor((qts - self.width - self.t0) / self.width).astype(np.int64)
        b1 = np.floor((qte - self.t0) / self.width).astype(np.int64)
        b0 = np.clip(b0, 0, self.nbins)
        b1 = np.clip(b1, -1, self.nbins - 1)
        nb = np.maximum(b1 - b0 + 1, 0)
        q = np.repeat(np.arange(len(qts)), nb)
        b = np.repeat(b0, nb) + (np.arange(nb.sum()) - np.repeat(np.cumsum(nb) - nb, nb))
        margin = 1e-6 * (1.0 + np.abs(qlo[q]) + np.abs(qhi[q]) + d)
        low = np.clip(qlo[q] - d - self.wide_x - margin - self.x0, 0.0, self.span_x - 1.0)
        high = np.clip(qhi[q] + d + margin - self.x0, 0.0, self.span_x - 1.0)
        first = np.searchsorted(self.key, b * self.span_x + low, "left")
        last = np.searchsorted(self.key, b * self.span_x + high, "right")
        return q, first, np.maximum(last - first, 0)

    def _solve(self, qs, d, r, q, first, count):
        """Expand runs into pairs, test them, solve the survivors."""
        n = int(count.sum())
        q = np.repeat(q, count)
        e = np.repeat(first - (np.cumsum(count) - count), count) + np.arange(n)
        keep = ((self.ts[e] <= qs["te"][q]) & (self.te[e] >= qs["ts"][q]))
        e, q = e[keep], q[keep]
        for j, (a, b) in enumerate(AXES):
            qa, qb = qs[a][q], qs[b][q]
            keep = ~((self.lo[j][e] - np.maximum(qa, qb) > d)
                     | (np.minimum(qa, qb) - self.hi[j][e] > d))
            e, q = e[keep], q[keep]
        g = geometry(self.sorted, qs, e, q, d, r)
        hit = g.overlap & (g.dmin2 <= r(d * d))
        t_enter, t_exit = intervals(_subset(g, hit), r)
        return self.order[e[hit]], q[hit], t_enter, t_exit

    def query(self, qs: dict, d: float, r=exact) -> dict:
        """The answer rows, in canonical (query row, db row) order:
        ``e`` (db row), ``q`` (query row), ``t_enter``, ``t_exit``."""
        q, first, count = self._runs(qs, d)
        ends = np.cumsum(count)
        parts, start = [], 0
        while start < len(q):
            stop = max(int(np.searchsorted(ends, ends[start] - count[start]
                                           + self.CHUNK, "right")), start + 1)
            sl = slice(start, stop)
            parts.append(self._solve(qs, d, r, q[sl], first[sl], count[sl]))
            start = stop
        if not parts:
            z = np.zeros(0)
            return {"e": z.astype(np.int64), "q": z.astype(np.int64),
                    "t_enter": z, "t_exit": z}
        e, q, t_enter, t_exit = (np.concatenate(c) for c in zip(*parts))
        rank = np.lexsort((e, q))
        return {"e": e[rank], "q": q[rank], "t_enter": t_enter[rank],
                "t_exit": t_exit[rank]}


def _subset(g: Geometry, m) -> Geometry:
    return Geometry(*[getattr(g, f.name)[m]
                      for f in dataclasses.fields(Geometry)])


__all__ = ["Geometry", "Reference", "bf16", "exact", "geometry",
           "intervals", "roots"]
