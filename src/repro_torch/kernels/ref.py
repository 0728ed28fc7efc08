"""Plain PyTorch oracle for the distance-threshold interaction computation.

The port's counterpart of the reference oracle (``repro/kernels/ref.py``)
and of the kernels' shared interval solve (``_interval_math`` in
``repro/kernels/distthresh.py``).  Given an entry segment and a query
segment, both moving linearly in 3-D over their temporal extents, it
computes the time interval during which they are within distance ``d``
(Algorithm 1's ``temporalIntersection`` + ``calcTimeInterval``) as
branchless masked float32 arithmetic.

Segment packing (``repro_torch.core.segments.PACKED_COLUMNS``)::

    [:, 0:3] = spatial start (x, y, z)
    [:, 3:6] = spatial end   (x, y, z)
    [:, 6]   = t_start
    [:, 7]   = t_end

:func:`interval_math` is written operation for operation as the TPU
kernels' solve, and the CUDA kernels' ``__device__`` interval function
(``csrc/distthresh.cu``) repeats the same sequence, built with
``-fmad=false`` and IEEE division and square root: the three agree bit for
bit, which is what makes the hit sets equal and the MBR prune slack
(``repro_torch.core.index.prune_limit``) valid for the port.  Every
constant is a float32 tensor or a float32-weak Python scalar, so nothing
promotes to float64.  Sums over the three axes are written out in axis
order rather than taken with ``sum``, whose reduction order depends on
the device.
"""
from __future__ import annotations

import torch

# A relative-motion magnitude below this is treated as constant separation.
_A_EPS = 1e-12
_B_EPS = 1e-12


def _f32(x, device) -> torch.Tensor:
    """``x`` as a float32 0-dim tensor (rounded once, like ``np.float32``).
    Filled on ``device`` rather than copied there: a blocking upload of a
    host scalar would wait for the device's stream to drain."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(x), dtype=torch.float32, device=device)


def interval_math(e8, q8, d: torch.Tensor):
    """Branchless interval solve over broadcastable components.

    ``e8`` / ``q8`` are the 8 packed-segment components (x0, y0, z0, x1,
    y1, z1, ts, te) of the entries and queries, in mutually broadcastable
    float32 shapes; ``d`` is a float32 0-dim tensor.  Returns ``(t_enter,
    t_exit, hit)`` in the broadcast shape; the interval endpoints are zero
    where ``hit`` is False.
    """
    ex0, ey0, ez0, ex1, ey1, ez1, ets, ete = e8
    qx0, qy0, qz0, qx1, qy1, qz1, qts, qte = q8

    # Velocities; zero-length temporal extents are static points.
    edt = ete - ets
    qdt = qte - qts
    e_safe = torch.where(edt > 0, edt, 1.0)
    q_safe = torch.where(qdt > 0, qdt, 1.0)
    e_live = (edt > 0).to(edt.dtype)
    q_live = (qdt > 0).to(qdt.dtype)
    evx = (ex1 - ex0) / e_safe * e_live
    evy = (ey1 - ey0) / e_safe * e_live
    evz = (ez1 - ez0) / e_safe * e_live
    qvx = (qx1 - qx0) / q_safe * q_live
    qvy = (qy1 - qy0) / q_safe * q_live
    qvz = (qz1 - qz0) / q_safe * q_live

    # temporalIntersection: common interval [lo, hi].
    lo = torch.maximum(ets, qts)
    hi = torch.minimum(ete, qte)
    t_overlap = lo <= hi

    # Relative motion r(t) = dr0 + dv t with absolute-time anchors.
    dvx = evx - qvx
    dvy = evy - qvy
    dvz = evz - qvz
    drx = (ex0 - evx * ets) - (qx0 - qvx * qts)
    dry = (ey0 - evy * ets) - (qy0 - qvy * qts)
    drz = (ez0 - evz * ets) - (qz0 - qvz * qts)

    a = dvx * dvx + dvy * dvy + dvz * dvz
    b = 2.0 * (drx * dvx + dry * dvy + drz * dvz)
    c = drx * drx + dry * dry + drz * drz - d * d

    inf = _f32(float("inf"), a.device)     # a is float32: see the callers

    # calcTimeInterval: {t : a t^2 + b t + c <= 0} as [rlo, rhi].
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    safe_a = torch.where(a > _A_EPS, a, 1.0)
    q_rlo = (-b - sq) / (2.0 * safe_a)
    q_rhi = (-b + sq) / (2.0 * safe_a)

    safe_b = torch.where(torch.abs(b) > _B_EPS, b, 1.0)
    root = -c / safe_b
    lin_rlo = torch.where(b > 0, -inf, root)
    lin_rhi = torch.where(b > 0, root, inf)

    is_quad = a > _A_EPS
    is_lin = (~is_quad) & (torch.abs(b) > _B_EPS)

    rlo = torch.where(is_quad, q_rlo, torch.where(is_lin, lin_rlo, -inf))
    rhi = torch.where(is_quad, q_rhi, torch.where(is_lin, lin_rhi, inf))
    nonempty = torch.where(is_quad, disc >= 0.0, is_lin | (c <= 0.0))

    t_enter = torch.maximum(rlo, lo)
    t_exit = torch.minimum(rhi, hi)
    hit = t_overlap & nonempty & (t_enter <= t_exit)

    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    return torch.where(hit, t_enter, zero), torch.where(hit, t_exit, zero), hit


def interaction_tile(entries: torch.Tensor, queries: torch.Tensor, d):
    """All-pairs distance-threshold intervals.

    Args:
      entries: (C, 8) packed entry segments.
      queries: (Q, 8) packed query segments.
      d: scalar threshold distance (rounded to float32).

    Returns ``(t_enter, t_exit, hit)``, each (C, Q); ``hit`` is bool and
    the interval values are zero where it is False.
    """
    entries = entries.to(torch.float32)
    queries = queries.to(torch.float32)
    return interval_math(tuple(entries[:, k:k + 1] for k in range(8)),
                         tuple(queries[:, k][None, :] for k in range(8)),
                         _f32(d, entries.device))


def pair_intervals(e_rows: torch.Tensor, q_rows: torch.Tensor, d):
    """Intervals for N explicit (entry, query) pairs: ``e_rows`` and
    ``q_rows`` are both (N, 8); returns three (N,) tensors."""
    e_rows = e_rows.to(torch.float32)
    q_rows = q_rows.to(torch.float32)
    return interval_math(tuple(e_rows[:, k] for k in range(8)),
                         tuple(q_rows[:, k] for k in range(8)),
                         _f32(d, e_rows.device))


def interaction_classes(entries: torch.Tensor, queries: torch.Tensor, d):
    """Classify each interaction for the §8 performance model.

    Returns boolean (C, Q) masks ``(alpha, beta, gamma)``: alpha — hit;
    beta — temporal miss; gamma — temporal overlap but spatial miss.
    Exactly one is True per pair.
    """
    _, _, hit = interaction_tile(entries, queries, d)
    lo = torch.maximum(entries[:, 6][:, None], queries[:, 6][None, :])
    hi = torch.minimum(entries[:, 7][:, None], queries[:, 7][None, :])
    t_overlap = lo <= hi
    return hit, ~t_overlap, t_overlap & ~hit


def count_hits(entries: torch.Tensor, queries: torch.Tensor, d) -> torch.Tensor:
    """Total number of result-set items for the tile (0-dim int32)."""
    _, _, hit = interaction_tile(entries, queries, d)
    return hit.sum(dtype=torch.int32)


__all__ = ["count_hits", "interaction_classes", "interaction_tile",
           "interval_math", "pair_intervals"]
