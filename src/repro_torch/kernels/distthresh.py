"""Distance-threshold kernels for Hopper: wrappers and plain versions.

Five hand-written CUDA kernels (``csrc/distthresh.cu``) replace the
reference's Pallas TPU kernels in ``repro/kernels/distthresh.py``:

* :func:`distthresh_compact` replaces ``distthresh_compact_pallas``:
  ``append="chunk"`` launches ``distthresh_compact``, ``append="rowloop"``
  ``distthresh_compact_rowloop`` (the ``LAUNCHES`` keys);
* :func:`distthresh_compact_live` replaces
  ``distthresh_compact_live_pallas``: ``distthresh_compact_live`` and
  ``distthresh_compact_live_rowloop``;
* :func:`distthresh_dense` replaces ``distthresh_pallas``;
* :func:`distthresh_tile_prep` replaces no Pallas kernel: it builds the
  armed compact kernels' operands (tile boxes and the prune threshold) on
  the device, where the reference builds them in jnp
  (``_jit_tile_mbrs``, ``_jit_prune_threshold``).

Each wrapper keeps its counterpart's signature and return tuple, plus
``device=`` (default ``"cuda"``, resolved as every entry point resolves
it; the tensors must lie on it).  On CUDA it checks dtype, shape and
layout, allocates the outputs, launches its kernel on the current stream
and adds one to ``LAUNCHES[name]``; with ``device="cpu"`` it runs the
``*_plain`` twin beside it, the plain PyTorch version of the same
function; with ``device="meta"`` (a dry run) it allocates the outputs and
launches nothing.  There is no fallback from the kernel to the plain
version.  Each wrapper declares the work its shapes give
(``roofline.kernels.distthresh_shape_cost``) to a ``roofline.opcount``
counter, on every device alike.

Two things differ from the TPU kernels, neither visible in the results:

* The TPU grid ran in order, so its running hit counter gave one fixed
  row order.  Hopper blocks run in parallel and append with one
  ``atomicAdd`` per block: ``append="chunk"`` cuts each tile into
  sub-tiles of at most 1,024 pairs, one block each (the paper's §5
  ``atomic_inc`` per sub-tile), and ``append="rowloop"`` into row blocks
  of 8 warps, one warp per entry row, whose hits fill one run (rows
  ascending, columns ascending within a row).  So the order of rows
  changes from run to run.  The plain versions emit the TPU's order
  (tiles in grid order, query tiles innermost, row-major inside a tile),
  which both append modes give on the TPU.  Consumers sort canonically.
* The kernels mask rows ``>= valid_c`` and columns ``>= valid_q``
  themselves and take any ``C``/``Q``: no pad rows are needed, and a
  ragged last tile is simply shorter.  ``queries_t`` may be a column
  slice of a larger (8, N) array (its rows need unit stride only).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ref
# LAUNCHES is this module's public name for the shared counters.
from repro_torch.kernels._launch import LAUNCHES  # noqa: F401
from repro_torch.kernels._launch import count_launch as _count_launch
from repro_torch.kernels._launch import ptr as _ptr
from repro_torch.kernels._launch import raise_on as _raise_on
from repro_torch.kernels._launch import stream as _stream
from repro_torch.roofline import kernels as costs
from repro_torch.roofline.opcount import declare

DEFAULT_CAND_BLK = 256
DEFAULT_QRY_BLK = 256

#: Largest tile edge the CUDA kernels take: the compact kernels' shared
#: query stage holds up to ``qry_blk`` columns (32 KB at 1,024).
MAX_BLK = 1024

#: append modes of the fused compaction wrappers (the reference's
#: ``APPEND_MODES``).
APPEND_MODES = ("chunk", "rowloop")


# ----------------------------------------------------------------------
# Argument checks shared by the wrappers.
# ----------------------------------------------------------------------
def _check_inputs(entries: torch.Tensor, queries_t: torch.Tensor,
                  cand_blk: int, qry_blk: int) -> tuple[int, int]:
    if entries.dtype != torch.float32 or queries_t.dtype != torch.float32:
        raise TypeError(f"entries/queries_t must be float32, got "
                        f"{entries.dtype}/{queries_t.dtype}")
    if entries.dim() != 2 or entries.shape[1] != 8:
        raise ValueError(f"entries must be (C, 8), got {tuple(entries.shape)}")
    if queries_t.dim() != 2 or queries_t.shape[0] != 8:
        raise ValueError(
            f"queries_t must be (8, Q), got {tuple(queries_t.shape)}")
    if entries.device != queries_t.device:
        raise ValueError(f"entries on {entries.device} but queries_t on "
                         f"{queries_t.device}")
    if not 1 <= cand_blk <= MAX_BLK or not 1 <= qry_blk <= MAX_BLK:
        raise ValueError(f"cand_blk/qry_blk must lie in [1, {MAX_BLK}], got "
                         f"{cand_blk}/{qry_blk}")
    return entries.shape[0], queries_t.shape[1]


def _valid(valid, n: int, what: str) -> int:
    v = n if valid is None else int(valid)
    if not 0 <= v <= n:
        raise ValueError(f"{what}={v} outside [0, {n}]")
    return v


def _kernel_target(entries: torch.Tensor, device) -> str:
    """``"cuda"`` when the wrapper launches its CUDA kernel, ``"cpu"`` when
    it runs the plain version (the caller asked for the CPU), ``"meta"``
    for shapes alone (a dry run: the outputs are allocated, nothing is
    launched).  ``device`` is resolved as every entry point resolves it (a
    CUDA request without CUDA raises), and the tensors must lie on it."""
    dev = torch.device("meta") if str(device) == "meta" else \
        resolve_device(device)
    if entries.device != dev:
        raise ValueError(f"tensors on {entries.device}, but device={dev}")
    return dev.type


def _layout(entries: torch.Tensor, queries_t: torch.Tensor) -> int:
    """Check the layout the CUDA kernels read; returns the row stride of
    ``queries_t``."""
    if not entries.is_contiguous():
        raise ValueError("entries must be contiguous")
    if queries_t.shape[1] > 1 and queries_t.stride(1) != 1:
        raise ValueError("queries_t rows must have unit stride")
    return int(queries_t.stride(0))


def _compact_outputs(capacity: int, device: torch.device):
    return (torch.full((capacity,), -1, dtype=torch.int32, device=device),
            torch.full((capacity,), -1, dtype=torch.int32, device=device),
            torch.zeros((capacity,), dtype=torch.float32, device=device),
            torch.zeros((capacity,), dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


# ----------------------------------------------------------------------
# Dense (C, Q) kernel.
# ----------------------------------------------------------------------
def distthresh_dense(entries: torch.Tensor, queries_t: torch.Tensor, d, *,
                     cand_blk: int = DEFAULT_CAND_BLK,
                     qry_blk: int = DEFAULT_QRY_BLK, device="cuda"):
    """Dense (C, Q) ``(t_enter, t_exit, hit)``: hit is int8 and the
    intervals are zero where it is 0.  ``cand_blk``/``qry_blk`` shape only
    the plain version's signature; the CUDA kernel runs 256-thread blocks
    over row-major spans of min(Q, 256) columns × 1,024 / that many rows,
    each side's derived terms staged once per block."""
    c, q = _check_inputs(entries, queries_t, cand_blk, qry_blk)
    target = _kernel_target(entries, device)
    with declare("distthresh_dense", lambda: costs.distthresh_shape_cost(
            c, q, "dense", valid_c=c, valid_q=q)):
        if target == "cpu":
            return distthresh_dense_plain(entries, queries_t, d,
                                          cand_blk=cand_blk, qry_blk=qry_blk)
        ldq = _layout(entries, queries_t)
        dev = entries.device
        t_enter = torch.empty((c, q), dtype=torch.float32, device=dev)
        t_exit = torch.empty((c, q), dtype=torch.float32, device=dev)
        hit = torch.empty((c, q), dtype=torch.int8, device=dev)
        if c and q and target == "cuda":
            from repro_torch.kernels import _build
            err = _build.load().distthresh_dense_launch(
                _ptr(entries), c, _ptr(queries_t), ldq, q,
                float(np.float32(d)),
                _ptr(t_enter), _ptr(t_exit), _ptr(hit), _stream(dev))
            _raise_on(err, "distthresh_dense")
            _count_launch("distthresh_dense")
        return t_enter, t_exit, hit


def distthresh_dense_plain(entries: torch.Tensor, queries_t: torch.Tensor,
                           d, *, cand_blk: int = DEFAULT_CAND_BLK,
                           qry_blk: int = DEFAULT_QRY_BLK):
    """Plain PyTorch version of :func:`distthresh_dense`."""
    del cand_blk, qry_blk
    t_enter, t_exit, hit = ref.interaction_tile(entries, queries_t.T, d)
    return t_enter, t_exit, hit.to(torch.int8)


# ----------------------------------------------------------------------
# Fused compaction kernels.
# ----------------------------------------------------------------------
def distthresh_compact(entries: torch.Tensor, queries_t: torch.Tensor, d, *,
                       capacity: int, cand_blk: int = DEFAULT_CAND_BLK,
                       qry_blk: int = DEFAULT_QRY_BLK,
                       valid_c: int | None = None, valid_q: int | None = None,
                       e_mbr: torch.Tensor | None = None,
                       q_mbr: torch.Tensor | None = None, d_prune=None,
                       append: str = "chunk", device="cuda"):
    """Fused distance-threshold kernel with in-kernel result compaction.

    Args:
      entries: (C, 8) float32, contiguous.
      queries_t: (8, Q) float32, rows of unit stride.
      d: scalar threshold (rounded to float32).
      capacity: result slots; hits past it are dropped, ``count`` stays
        exact.
      cand_blk / qry_blk: the (entry, query) tile of the early-out and
        of the plain version's order; the chunk kernel runs each tile as
        sub-tiles of at most 1,024 pairs, one 256-thread block each, and
        the row-loop kernel as row blocks of 8 warps (about 1,024 pairs).
      valid_c / valid_q: rows/columns at or past them are masked out.
      e_mbr / q_mbr / d_prune: the tile-level early-out, all three or
        none.  ``e_mbr`` is (ceil(C/cand_blk), 8) per entry tile
        ``(lo_xyz, hi_xyz, 0, 0)``, ``q_mbr`` the same per query tile
        (:func:`distthresh_tile_prep` builds all three); ``d_prune`` a
        0-dim float32 tensor, which the kernels read from device memory,
        or a number.  A tile whose boxes lie farther apart than
        ``d_prune`` is skipped and counted in ``pruned``.
      append: ``"chunk"`` (threads over a sub-tile's pairs, one atomic
        per sub-tile) or ``"rowloop"`` (one warp per entry row, one atomic per
        row block); each pair solved once, the same rows, the same
        counters.

    Returns ``(entry_idx, query_idx, t_enter, t_exit, count, pruned)``:
    four (capacity,) buffers (int32 -1 pad, float32 0 pad) and two 0-dim
    int32 counters.
    """
    _check_append(append)
    prune = e_mbr is not None
    if (q_mbr is None) == prune or (d_prune is None) == prune:
        raise ValueError("e_mbr, q_mbr and d_prune must be given together "
                         "(tile early-out armed) or all omitted")
    c, q = _check_inputs(entries, queries_t, cand_blk, qry_blk)
    valid_c = _valid(valid_c, c, "valid_c")
    valid_q = _valid(valid_q, q, "valid_q")
    ntc, ntq = -(-c // cand_blk), -(-q // qry_blk)
    if prune:
        _check_mbr(e_mbr, ntc, entries.device, "e_mbr")
        _check_mbr(q_mbr, ntq, entries.device, "q_mbr")
    target = _kernel_target(entries, device)
    name = ("distthresh_compact_rowloop" if append == "rowloop"
            else "distthresh_compact")
    with declare(name, lambda: costs.distthresh_shape_cost(
            c, q, "compact", valid_c=valid_c, valid_q=valid_q,
            capacity=capacity)):
        if target == "cpu":
            plain = (distthresh_compact_rowloop_plain if append == "rowloop"
                     else distthresh_compact_plain)
            return plain(entries, queries_t, d, capacity=capacity,
                         cand_blk=cand_blk, qry_blk=qry_blk, valid_c=valid_c,
                         valid_q=valid_q, e_mbr=e_mbr, q_mbr=q_mbr,
                         d_prune=d_prune)
        ldq = _layout(entries, queries_t)
        dev = entries.device
        outs = _compact_outputs(capacity, dev)
        if ntc and ntq and target == "cuda":
            from repro_torch.kernels import _build
            dp = ref._f32(d_prune, dev) if prune else None
            err = getattr(_build.load(), name + "_launch")(
                _ptr(entries), c, _ptr(queries_t), ldq, q,
                float(np.float32(d)),
                cand_blk, qry_blk, valid_c, valid_q, capacity,
                _ptr(e_mbr), _ptr(q_mbr), _ptr(dp),
                *(_ptr(t) for t in outs), _stream(dev))
            _raise_on(err, name)
            _count_launch(name)
        return outs


def _check_append(append: str) -> None:
    if append not in APPEND_MODES:
        raise ValueError(f"unknown append mode {append!r}; "
                         f"choose from {APPEND_MODES}")


def _check_mbr(mbr: torch.Tensor, n: int, device, what: str) -> None:
    if (mbr.dtype != torch.float32 or tuple(mbr.shape) != (n, 8)
            or mbr.device != device or not mbr.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous float32 ({n}, 8) "
                         f"tensor on {device}, got {mbr.dtype} "
                         f"{tuple(mbr.shape)} on {mbr.device}")


def distthresh_compact_live(entries: torch.Tensor, queries_t: torch.Tensor,
                            d, tile_i: torch.Tensor, tile_j: torch.Tensor,
                            n_live: torch.Tensor, *, capacity: int,
                            cand_blk: int = DEFAULT_CAND_BLK,
                            qry_blk: int = DEFAULT_QRY_BLK,
                            valid_c: int | None = None,
                            valid_q: int | None = None,
                            append: str = "chunk", device="cuda"):
    """Fused compaction over a precomputed live-tile list.

    ``tile_i`` / ``tile_j`` are (S,) int32 entry- and query-tile ids in
    grid order (query tiles innermost); slots at or past ``n_live`` ((1,)
    int32, read on the device) are skipped.  Each slot's tile runs as the
    kernel's sub-tiles or row blocks, as in :func:`distthresh_compact`.
    Returns ``(entry_idx, query_idx, t_enter, t_exit, count)`` — no
    ``pruned`` counter: the caller knows ``num_tiles - n_live``.
    """
    _check_append(append)
    c, q = _check_inputs(entries, queries_t, cand_blk, qry_blk)
    valid_c = _valid(valid_c, c, "valid_c")
    valid_q = _valid(valid_q, q, "valid_q")
    (n_slots,) = tile_i.shape
    for t, what in ((tile_i, "tile_i"), (tile_j, "tile_j"),
                    (n_live, "n_live")):
        if (t.dtype != torch.int32 or t.device != entries.device
                or not t.is_contiguous()):
            raise ValueError(f"{what} must be a contiguous int32 tensor on "
                             f"{entries.device}")
    if tuple(tile_j.shape) != (n_slots,) or tuple(n_live.shape) != (1,):
        raise ValueError(f"tile_j must be ({n_slots},) and n_live (1,), got "
                         f"{tuple(tile_j.shape)} / {tuple(n_live.shape)}")
    target = _kernel_target(entries, device)
    name = ("distthresh_compact_live_rowloop" if append == "rowloop"
            else "distthresh_compact_live")
    with declare(name, lambda: costs.distthresh_shape_cost(
            c, q, "live", valid_c=valid_c, valid_q=valid_q,
            capacity=capacity, slots=n_slots, tile=cand_blk * qry_blk)):
        if target == "cpu":
            plain = (distthresh_compact_live_rowloop_plain
                     if append == "rowloop" else
                     distthresh_compact_live_plain)
            return plain(entries, queries_t, d, tile_i, tile_j, n_live,
                         capacity=capacity, cand_blk=cand_blk, qry_blk=qry_blk,
                         valid_c=valid_c, valid_q=valid_q)
        ldq = _layout(entries, queries_t)
        dev = entries.device
        outs = _compact_outputs(capacity, dev)[:5]
        if n_slots and c and q and target == "cuda":
            from repro_torch.kernels import _build
            err = getattr(_build.load(), name + "_launch")(
                _ptr(entries), c, _ptr(queries_t), ldq, q,
                float(np.float32(d)),
                cand_blk, qry_blk, valid_c, valid_q, capacity,
                _ptr(tile_i), _ptr(tile_j), _ptr(n_live), n_slots,
                *(_ptr(t) for t in outs), _stream(dev))
            _raise_on(err, name)
            _count_launch(name)
        return outs


def distthresh_tile_prep(entries: torch.Tensor, queries_t: torch.Tensor,
                         d, *, cand_blk: int = DEFAULT_CAND_BLK,
                         qry_blk: int = DEFAULT_QRY_BLK, device="cuda"):
    """The tile-level early-out's operands of one dispatch, built where
    its slices lie: ``(e_mbr, q_mbr, d_prune)`` for
    :func:`distthresh_compact`.

    Args:
      entries: (C, 8) float32, contiguous.
      queries_t: (8, Q) float32, rows of unit stride.
      d: the dispatch's threshold (read as a Python float, as
        ``core.index.prune_limit`` reads it).
      cand_blk / qry_blk: the tiles of the compact kernel that reads them.

    Returns ``e_mbr`` (ceil(C/cand_blk), 8) and ``q_mbr``
    (ceil(Q/qry_blk), 8) float32, each tile's ``(lo_xyz, hi_xyz, 0, 0)``
    over its segments' endpoints (the last tile ragged), and ``d_prune``,
    a 0-dim float32 tensor equal bit for bit to ``np.float32(
    core.index.dispatch_prune_threshold(d, entries, queries))``.  On
    CUDA two launches in order on the current stream, one count of
    ``LAUNCHES["distthresh_tile_prep"]``, no host read; the float64
    scratch they share is freed on return (the caching allocator reuses it
    only after them on the stream).
    """
    c, q = _check_inputs(entries, queries_t, cand_blk, qry_blk)
    target = _kernel_target(entries, device)
    with declare("distthresh_tile_prep",
                 lambda: costs.distthresh_tile_prep_cost(c, q, cand_blk,
                                                         qry_blk)):
        if target == "cpu":
            return distthresh_tile_prep_plain(entries, queries_t, d,
                                              cand_blk=cand_blk,
                                              qry_blk=qry_blk)
        ldq = _layout(entries, queries_t)
        dev = entries.device
        ntc, ntq = -(-c // cand_blk), -(-q // qry_blk)
        mbr = torch.empty((ntc + ntq, 8), dtype=torch.float32, device=dev)
        e_mbr, q_mbr = mbr[:ntc], mbr[ntc:]
        d_prune = torch.empty((), dtype=torch.float32, device=dev)
        if target == "cuda":
            from repro_torch.kernels import _build
            tile_mag = torch.empty((ntc + ntq,), dtype=torch.float64,
                                   device=dev)
            err = _build.load().distthresh_tile_prep_launch(
                _ptr(entries), c, _ptr(queries_t), ldq, q, cand_blk,
                qry_blk, float(d), _ptr(e_mbr), _ptr(q_mbr), _ptr(tile_mag),
                _ptr(d_prune), _stream(dev))
            _raise_on(err, "distthresh_tile_prep")
            _count_launch("distthresh_tile_prep")
        return e_mbr, q_mbr, d_prune


# ----------------------------------------------------------------------
# Plain versions of the fused kernels.
# ----------------------------------------------------------------------
def _tile_mbr_live(e_mbr: torch.Tensor, q_mbr: torch.Tensor, d_prune):
    """(ntc, ntq) bool: the kernels' per-tile box test, same float32 ops
    (``_tile_mbr_live`` in the reference)."""
    gap2 = torch.zeros((e_mbr.shape[0], q_mbr.shape[0]), dtype=torch.float32,
                       device=e_mbr.device)
    for ax in range(3):
        elo, ehi = e_mbr[:, ax][:, None], e_mbr[:, 3 + ax][:, None]
        qlo, qhi = q_mbr[:, ax][None, :], q_mbr[:, 3 + ax][None, :]
        g = torch.clamp_min(torch.maximum(qlo - ehi, elo - qhi), 0.0)
        gap2 = gap2 + g * g
    dp = ref._f32(d_prune, e_mbr.device)
    return gap2 <= dp * dp


def _tile_boxes(rows: torch.Tensor, blk: int):
    """Per-tile boxes ``(ceil(n/blk), 8)`` float32 ``(lo_xyz, hi_xyz, 0,
    0)`` of (n, 8) packed rows, and each row's ``solve_scale`` magnitude
    (n × 3,) in float64, numpy's operations in numpy's order."""
    n = rows.shape[0]
    nt = -(-n // blk)
    pad = torch.full((nt * blk - n, 3), float("inf"), dtype=rows.dtype,
                     device=rows.device)
    lo = torch.minimum(rows[:, 0:3], rows[:, 3:6])
    hi = torch.maximum(rows[:, 0:3], rows[:, 3:6])
    box = torch.zeros((nt, 8), dtype=torch.float32, device=rows.device)
    box[:, 0:3] = torch.cat([lo, pad]).reshape(nt, blk, 3).amin(1)
    box[:, 3:6] = torch.cat([hi, -pad]).reshape(nt, blk, 3).amax(1)
    p = rows.double()
    dt = p[:, 7] - p[:, 6]
    live = dt > 0
    v = (p[:, 3:6] - p[:, 0:3]) / torch.where(live, dt, 1.0)[:, None]
    v = torch.where(live[:, None], v, 0.0)
    mag = (torch.maximum(p[:, 0:3].abs(), p[:, 3:6].abs())
           + v.abs() * p[:, 6:7].abs())
    return box, mag.reshape(-1)


def _prune_limit_plain(d, scale: torch.Tensor) -> torch.Tensor:
    """``core.index.prune_limit(d, scale)`` on a 0-dim float64 ``scale``,
    the same float64 operations in the same order, rounded once to a 0-dim
    float32 tensor."""
    d = float(d)
    err = 4e-6 * scale * scale
    slack = torch.minimum(err / max(2.0 * d, 1e-12), torch.sqrt(err))
    return (d + 1e-5 * d + slack + 1e-9).to(torch.float32)


def distthresh_tile_prep_plain(entries: torch.Tensor,
                               queries_t: torch.Tensor, d, *,
                               cand_blk: int = DEFAULT_CAND_BLK,
                               qry_blk: int = DEFAULT_QRY_BLK):
    """Plain PyTorch version of :func:`distthresh_tile_prep`: the
    dispatch's ``solve_scale`` is the largest row magnitude, at least 1."""
    e_mbr, e_mag = _tile_boxes(entries, cand_blk)
    q_mbr, q_mag = _tile_boxes(queries_t.T, qry_blk)
    one = torch.ones((1,), dtype=torch.float64, device=entries.device)
    scale = torch.cat([one, e_mag, q_mag]).max()
    return e_mbr, q_mbr, _prune_limit_plain(d, scale)


def _append_in_order(entries, queries_t, d, hit, slot_of_tile, capacity,
                     cand_blk, qry_blk):
    """Compact the hits of ``hit`` (C, Q) in slot order (``slot_of_tile``
    (ntc, ntq) int64, the order tiles append in), row-major inside a tile,
    into capacity-bounded buffers; ``count`` is the exact total."""
    dev = entries.device
    r, c = torch.nonzero(hit, as_tuple=True)
    local = (r % cand_blk) * qry_blk + (c % qry_blk)
    key = slot_of_tile[r // cand_blk, c // qry_blk] * (cand_blk * qry_blk) + local
    order = torch.argsort(key)[:capacity]
    r, c = r[order], c[order]
    e_idx, q_idx, t_enter, t_exit, _, _ = _compact_outputs(capacity, dev)
    n = r.shape[0]
    e_idx[:n] = r.to(torch.int32)
    q_idx[:n] = c.to(torch.int32)
    enter, exit_, _ = ref.pair_intervals(entries[r], queries_t[:, c].T, d)
    t_enter[:n] = enter
    t_exit[:n] = exit_
    count = hit.sum(dtype=torch.int32)
    return e_idx, q_idx, t_enter, t_exit, count


def _masked_hits(entries, queries_t, d, valid_c, valid_q):
    _, _, hit = ref.interaction_tile(entries, queries_t.T, d)
    hit[valid_c:, :] = False
    hit[:, valid_q:] = False
    return hit


def distthresh_compact_plain(entries: torch.Tensor, queries_t: torch.Tensor,
                             d, *, capacity: int,
                             cand_blk: int = DEFAULT_CAND_BLK,
                             qry_blk: int = DEFAULT_QRY_BLK,
                             valid_c: int | None = None,
                             valid_q: int | None = None,
                             e_mbr: torch.Tensor | None = None,
                             q_mbr: torch.Tensor | None = None,
                             d_prune=None):
    """Plain PyTorch version of :func:`distthresh_compact`, in the TPU
    kernel's row order (tiles in grid order, row-major inside a tile)."""
    c, q = entries.shape[0], queries_t.shape[1]
    valid_c = c if valid_c is None else valid_c
    valid_q = q if valid_q is None else valid_q
    ntc, ntq = -(-c // cand_blk), -(-q // qry_blk)
    hit = _masked_hits(entries, queries_t, d, valid_c, valid_q)
    pruned = torch.zeros((), dtype=torch.int32, device=entries.device)
    if e_mbr is not None:
        live = _tile_mbr_live(e_mbr, q_mbr, d_prune)
        pruned = (~live).sum(dtype=torch.int32)
        hit &= live.repeat_interleave(cand_blk, 0)[:c].repeat_interleave(
            qry_blk, 1)[:, :q]
    grid = torch.arange(ntc * ntq, device=entries.device).reshape(ntc, ntq)
    return _append_in_order(entries, queries_t, d, hit, grid, capacity,
                            cand_blk, qry_blk) + (pruned,)


def distthresh_compact_live_plain(entries: torch.Tensor,
                                  queries_t: torch.Tensor, d,
                                  tile_i: torch.Tensor, tile_j: torch.Tensor,
                                  n_live: torch.Tensor, *, capacity: int,
                                  cand_blk: int = DEFAULT_CAND_BLK,
                                  qry_blk: int = DEFAULT_QRY_BLK,
                                  valid_c: int | None = None,
                                  valid_q: int | None = None):
    """Plain PyTorch version of :func:`distthresh_compact_live`: tiles
    append in slot order (the list is in grid order, with no repeats)."""
    c, q = entries.shape[0], queries_t.shape[1]
    valid_c = c if valid_c is None else valid_c
    valid_q = q if valid_q is None else valid_q
    ntc, ntq = -(-c // cand_blk), -(-q // qry_blk)
    n = int(n_live.reshape(-1)[0])
    ti, tj = tile_i[:n].long(), tile_j[:n].long()
    slot = torch.full((ntc, ntq), -1, dtype=torch.int64, device=entries.device)
    slot[ti, tj] = torch.arange(n, device=entries.device)
    hit = _masked_hits(entries, queries_t, d, valid_c, valid_q)
    live = slot >= 0
    hit &= live.repeat_interleave(cand_blk, 0)[:c].repeat_interleave(
        qry_blk, 1)[:, :q]
    return _append_in_order(entries, queries_t, d, hit, slot, capacity,
                            cand_blk, qry_blk)


def distthresh_compact_rowloop_plain(entries: torch.Tensor,
                                     queries_t: torch.Tensor, d, **kw):
    """Plain PyTorch version of :func:`distthresh_compact` with
    ``append="rowloop"``.  The TPU's row loop appends the rows its chunk
    append gives, in the same grid order (its docstring: same results,
    same determinism), so the two plain versions share one body;
    arguments as :func:`distthresh_compact_plain`."""
    return distthresh_compact_plain(entries, queries_t, d, **kw)


def distthresh_compact_live_rowloop_plain(entries: torch.Tensor,
                                          queries_t: torch.Tensor, d,
                                          tile_i: torch.Tensor,
                                          tile_j: torch.Tensor,
                                          n_live: torch.Tensor, **kw):
    """Plain PyTorch version of :func:`distthresh_compact_live` with
    ``append="rowloop"`` (rows as the chunk append's; see
    :func:`distthresh_compact_rowloop_plain`)."""
    return distthresh_compact_live_plain(entries, queries_t, d, tile_i,
                                         tile_j, n_live, **kw)


__all__ = [
    "APPEND_MODES", "DEFAULT_CAND_BLK", "DEFAULT_QRY_BLK", "LAUNCHES",
    "MAX_BLK", "distthresh_compact", "distthresh_compact_live",
    "distthresh_compact_live_plain", "distthresh_compact_live_rowloop_plain",
    "distthresh_compact_plain", "distthresh_compact_rowloop_plain",
    "distthresh_dense", "distthresh_dense_plain", "distthresh_tile_prep",
    "distthresh_tile_prep_plain",
]
