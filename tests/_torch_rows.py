"""Row comparisons shared by the port's tests against the reference.

Index columns are compared exactly and ``t_enter``/``t_exit`` within
``rtol=1e-4, atol=1e-3`` — the reference's own tolerance between its
backends (``tests/test_api.py``).  Against the reference, a pair may be
present on one side only when it is *borderline*: its float64 closest
approach over the common time lies within the float32 round-off band of
``d`` that the repo's own pruning slack bounds
(``repro_torch.core.index.prune_limit``).  The reference's jit-fused XLA
and the port's separately rounded float32 may decide such a pair
differently (ROADMAP, queue C: "Borderline f32 hits").  At most
``max_borderline`` such pairs are allowed, and each is named on failure.
"""
import numpy as np

from repro_torch.core.index import prune_limit

RTOL, ATOL = 1e-4, 1e-3


def closest_approach(e: np.ndarray, q: np.ndarray) -> float:
    """float64 minimum distance of two packed segments over their common
    time (inf when they do not overlap in time)."""
    e, q = e.astype(np.float64), q.astype(np.float64)
    lo, hi = max(e[6], q[6]), min(e[7], q[7])
    if hi < lo:
        return np.inf
    ve = (e[3:6] - e[0:3]) / (e[7] - e[6])
    vq = (q[3:6] - q[0:3]) / (q[7] - q[6])
    a = (e[0:3] - ve * e[6]) - (q[0:3] - vq * q[6])     # r(t) = a + b t
    b = ve - vq
    bb = float(b @ b)
    t = lo if bb == 0.0 else min(max(-float(a @ b) / bb, lo), hi)
    return float(np.linalg.norm(a + b * t))


def is_borderline(e: np.ndarray, q: np.ndarray, d: float,
                  scale: float) -> bool:
    band = prune_limit(float(d), scale) - float(d)
    return abs(closest_approach(e, q) - float(d)) <= band


def assert_same_rows(got, want, label="", *, entries=None, queries=None,
                     d=None, max_borderline=0):
    """``got`` and ``want`` (``QueryResult``-like, canonical order) hold
    the same rows.  With ``entries`` (the sorted database, packed) and
    ``queries`` (packed, the order ``query_idx`` refers to), up to
    ``max_borderline`` borderline pairs may differ."""
    kg = list(zip(got.query_idx.tolist(), got.entry_idx.tolist()))
    kw = list(zip(want.query_idx.tolist(), want.entry_idx.tolist()))
    diff = sorted(set(kg) ^ set(kw))
    if diff:
        assert entries is not None and len(diff) <= max_borderline, (
            label, len(got), len(want), diff[:10])
        scale = max(float(np.abs(entries[:, 0:6]).max()),
                    float(np.abs(queries[:, 0:6]).max()), 1.0)
        for qi, ei in diff:
            assert is_borderline(entries[ei], queries[qi], d, scale), (
                label, (qi, ei), closest_approach(entries[ei], queries[qi]))
    common = set(kg) & set(kw)
    mg = np.array([k in common for k in kg], bool)
    mw = np.array([k in common for k in kw], bool)
    for f in ("entry_idx", "entry_traj", "entry_seg", "query_idx"):
        np.testing.assert_array_equal(getattr(got, f)[mg],
                                      getattr(want, f)[mw],
                                      err_msg=f"{label} {f}")
    for f in ("t_enter", "t_exit"):
        np.testing.assert_allclose(getattr(got, f)[mg], getattr(want, f)[mw],
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"{label} {f}")
