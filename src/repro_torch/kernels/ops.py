"""Per-batch device computation around the distance-threshold kernels.

The port's counterpart of ``repro/kernels/ops.py``:

* :func:`interaction_tiles` — dense (C, Q) intervals through the dense
  kernel (or the torch oracle).
* :func:`query_block` — one batch's interaction evaluation plus result
  compaction into fixed-capacity buffers, with the exact hit count so the
  caller can detect overflow and retry larger (paper §5).

``query_block`` has three compaction strategies (``compaction=``):

* ``"fused"`` (default) — hits are compacted inside the kernel
  (:func:`~repro_torch.kernels.distthresh.distthresh_compact`): each tile
  appends its hits at an atomically claimed offset.  Non-hits never reach
  device memory.
* ``"fused_rowloop"`` — the same, through the row-loop kernels
  (``append="rowloop"``): one warp per entry row, each row appending at
  its own atomically claimed offset.
* ``"dense"`` — the two-phase path (and the only one for the torch
  oracle): phase 1 materializes the dense hit mask, phase 2 compacts it
  with a cumsum and a scatter and recomputes the intervals of the
  compacted hits.

Unlike the reference, no strategy falls back to another: the reference's
automatic fused → fused_rowloop lowering fallback has no counterpart.

The strategies emit different row orders (and the fused kernel's order of
tiles varies between runs); consumers sort canonically.  The kernels mask
rows and columns past the batch themselves, so no pad rows are added.

Entries and queries come in twice: as host numpy arrays, which the
tile-prune preparation reads (:func:`_host_tile_prune`,
:func:`_host_live_tiles`; no device work, so the dispatch stays
asynchronous), and optionally as tensors already resident on the device
(``entries_dev`` (C, 8), ``queries_t_dev`` (8, Q)).  Without the latter
the host arrays are uploaded here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import faults
from repro_torch.core.index import mbr_gap2, prune_limit
from repro_torch.device import resolve_device
from repro_torch.kernels import distthresh as _dt
from repro_torch.kernels import ref
from repro_torch.kernels.distthresh import DEFAULT_CAND_BLK, DEFAULT_QRY_BLK

#: compaction strategies accepted by :func:`query_block`.
COMPACTIONS = ("fused", "fused_rowloop", "dense")

#: pruning strategies accepted by :func:`query_block`: ``"spatial"`` arms
#: the fused kernel's tile-level MBR early-out; ``"hierarchical"`` runs the
#: same box test on the host and dispatches only the live tiles through
#: the live-tile kernel; ``"none"`` disables tile-level pruning.  The dense
#: path has no tile loop to skip, so pruning is a no-op there.  No mode
#: changes the result set (the box test uses the inflated ``prune_limit``).
PRUNINGS = ("spatial", "hierarchical", "none")


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload a host array without waiting for the device (a blocking
    ``.to()`` synchronizes the stream): CUDA uploads go through pinned
    memory, which the caching host allocator keeps until the copy ran."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return to_device(np.asarray(x, np.float32), device)


def interaction_tiles(entries, queries, d, *, device="cuda",
                      use_kernel: bool = True,
                      cand_blk: int = DEFAULT_CAND_BLK,
                      qry_blk: int = DEFAULT_QRY_BLK):
    """Dense all-pairs distance-threshold intervals.

    Args:
      entries: (C, 8) packed entry segments (numpy or tensor).
      queries: (Q, 8) packed query segments.
      d: scalar threshold.
      use_kernel: the dense CUDA kernel (plain version on the CPU) or the
        torch oracle; identical semantics.

    Returns ``(t_enter, t_exit, hit)`` of shape (C, Q) on ``device``; hit
    is bool.
    """
    dev = resolve_device(device)
    e = _as_tensor(entries, dev)
    q = _as_tensor(queries, dev)
    if e.shape[0] == 0 or q.shape[0] == 0:
        empty = torch.zeros((e.shape[0], q.shape[0]), dtype=torch.float32,
                            device=dev)
        return empty, empty.clone(), empty.to(torch.bool)
    if not use_kernel:
        return ref.interaction_tile(e, q, d)
    t_enter, t_exit, hit = _dt.distthresh_dense(
        e.contiguous(), q.T.contiguous(), d, cand_blk=cand_blk,
        qry_blk=qry_blk, device=dev)
    return t_enter, t_exit, hit.to(torch.bool)


def count_hits(entries, queries, d, *, device="cuda",
               use_kernel: bool = True, cand_blk: int = DEFAULT_CAND_BLK,
               qry_blk: int = DEFAULT_QRY_BLK) -> torch.Tensor:
    """Number of result-set items without materializing them (0-dim
    int32 on ``device``)."""
    _, _, hit = interaction_tiles(entries, queries, d, device=device,
                                  use_kernel=use_kernel, cand_blk=cand_blk,
                                  qry_blk=qry_blk)
    return hit.sum(dtype=torch.int32)


def _empty_block(capacity: int, device: torch.device,
                 num_tiles: int = 0) -> dict:
    return {"entry_idx": torch.full((capacity,), -1, dtype=torch.int32,
                                    device=device),
            "query_idx": torch.full((capacity,), -1, dtype=torch.int32,
                                    device=device),
            "t_enter": torch.zeros((capacity,), dtype=torch.float32,
                                   device=device),
            "t_exit": torch.zeros((capacity,), dtype=torch.float32,
                                  device=device),
            "count": torch.zeros((), dtype=torch.int32, device=device),
            "pruned_tiles": num_tiles, "num_tiles": num_tiles}


# ----------------------------------------------------------------------
# Host-side tile-prune preparation (numpy; no device work).
# ----------------------------------------------------------------------
def _host_tile_mbrs(packed: np.ndarray, blk: int) -> np.ndarray:
    """Per-tile spatial MBRs of packed segments, host-side (numpy).

    Returns ``(ceil(n/blk), 8)`` float32 rows ``(lo_xyz, hi_xyz, 0, 0)``
    over each run of ``blk`` rows (the last tile may be shorter).  A
    linearly moving segment never leaves the box spanned by its endpoints,
    so the tile box bounds every member's position over its whole temporal
    extent.
    """
    n = packed.shape[0]
    nt = (max(n, 1) + blk - 1) // blk
    lo = np.minimum(packed[:, 0:3], packed[:, 3:6]).astype(np.float64)
    hi = np.maximum(packed[:, 0:3], packed[:, 3:6]).astype(np.float64)
    starts = np.arange(0, nt * blk, blk)
    starts = np.minimum(starts, max(n - 1, 0))
    tlo = np.minimum.reduceat(lo, starts, axis=0)
    thi = np.maximum.reduceat(hi, starts, axis=0)
    out = np.zeros((nt, 8), np.float32)
    out[:, 0:3] = tlo
    out[:, 3:6] = thi
    return out


def _host_prune_threshold(d, entries: np.ndarray,
                          queries: np.ndarray) -> float:
    """The conservatively inflated tile-prune threshold at dispatch time:
    ``prune_limit`` evaluated at this dispatch's largest coordinate
    magnitude."""
    scale = max(float(np.abs(entries[:, 0:6]).max(initial=0.0)),
                float(np.abs(queries[:, 0:6]).max(initial=0.0)), 1.0)
    return prune_limit(float(d), scale)


def _slot_bucket(n: int, minimum: int = 64) -> int:
    """Bucketed live-tile-list length: next power of two ≥ ``max(n,
    minimum)``, so list buffers come in O(log) sizes."""
    return 1 << (max(n, minimum) - 1).bit_length()


def _host_live_tiles(entries: np.ndarray, queries: np.ndarray, d,
                     cand_blk: int, qry_blk: int):
    """Host-side live-tile list for one dispatch.

    Runs the inflated-threshold box test over every (entry-tile,
    query-tile) pair and compacts the survivors into a list in grid order
    (query tiles innermost).  Returns ``None`` when no tile pair would be
    skipped (the caller then runs the unarmed kernel), else ``(tile_i,
    tile_j, n_live, num_tiles)`` with the slot arrays padded to a
    :func:`_slot_bucket` length (padding points at tile 0; the kernel skips
    slots past ``n_live``).
    """
    e_mbr = _host_tile_mbrs(entries, cand_blk)
    q_mbr = _host_tile_mbrs(queries, qry_blk)
    d_prune = _host_prune_threshold(d, entries, queries)
    gap2 = mbr_gap2(e_mbr[:, None, 0:3], e_mbr[:, None, 3:6],
                    q_mbr[None, :, 0:3], q_mbr[None, :, 3:6])
    live = gap2 <= d_prune * d_prune
    if live.all():
        return None
    ti, tj = np.nonzero(live)
    n_live = int(ti.size)
    n_slots = _slot_bucket(n_live)
    tile_i = np.zeros((n_slots,), np.int32)
    tile_j = np.zeros((n_slots,), np.int32)
    tile_i[:n_live] = ti
    tile_j[:n_live] = tj
    return tile_i, tile_j, np.array([n_live], np.int32), int(live.size)


def _host_tile_prune(entries: np.ndarray, queries: np.ndarray, d,
                     cand_blk: int, qry_blk: int):
    """Host-side tile-prune preparation for one dispatch.

    Computes the per-tile entry/query MBRs and the inflated threshold,
    evaluates the box test over every tile pair, and returns ``(e_mbr,
    q_mbr, d_prune)`` only when at least one tile pair would be skipped —
    otherwise ``None``, and the caller runs the unarmed kernel, which pays
    no per-tile test.
    """
    e_mbr = _host_tile_mbrs(entries, cand_blk)
    q_mbr = _host_tile_mbrs(queries, qry_blk)
    d_prune = _host_prune_threshold(d, entries, queries)
    gap2 = mbr_gap2(e_mbr[:, None, 0:3], e_mbr[:, None, 3:6],
                    q_mbr[None, :, 0:3], q_mbr[None, :, 3:6])
    if not np.any(gap2 > d_prune * d_prune):
        return None
    return e_mbr, q_mbr, np.float32(d_prune)


# ----------------------------------------------------------------------
# The per-batch computation.
# ----------------------------------------------------------------------
def query_block(entries: np.ndarray, queries: np.ndarray, d, *,
                capacity: int, device="cuda", use_kernel: bool = True,
                cand_blk: int = DEFAULT_CAND_BLK,
                qry_blk: int = DEFAULT_QRY_BLK, compaction: str = "fused",
                pruning: str = "none",
                entries_dev: torch.Tensor | None = None,
                queries_t_dev: torch.Tensor | None = None,
                inject_faults: bool = True) -> dict:
    """Interaction evaluation + compaction into flat buffers.

    Args:
      entries / queries: (C, 8) / (Q, 8) host numpy packed segments.
      d: scalar threshold.
      capacity: result slots.
      device: where to run (``"cuda"`` unless the caller asks for the CPU).
      use_kernel: the hand-written kernels (their plain versions on the
        CPU) or the torch oracle, which always takes the dense path.
      entries_dev / queries_t_dev: the same rows already on ``device``, as
        (C, 8) and (8, Q); uploaded from the host arrays when omitted.
      inject_faults: consult the ``ops.query_block`` fault site.  The
        reference fires it only for host-side dispatches, never inside its
        pod step, so the port's pod step passes ``False``.

    Returns a dict of tensors on ``device``:
      ``entry_idx``  (capacity,) int32 — row index into ``entries`` (-1 pad)
      ``query_idx``  (capacity,) int32 — row index into ``queries`` (-1 pad)
      ``t_enter``    (capacity,) f32 (0 pad)
      ``t_exit``     (capacity,) f32 (0 pad)
      ``count``      () int32 — true number of hits (may exceed capacity ⇒
                     the caller retries larger)
      ``pruned_tiles`` () int32 from the armed kernel, else a Python int
                     the host already knows — tiles the tile-level pruning
                     skipped
      ``num_tiles``  int — tiles the dispatch comprised (both 0 on the
                     dense path)

    ``pruning="spatial"`` arms the fused kernel's per-tile box test, but
    only when the host test finds at least one skippable tile pair;
    ``pruning="hierarchical"`` dispatches the host-built live-tile list
    through the live-tile kernel (and no kernel at all when every tile is
    dead).  Neither changes the result set.  ``compaction="fused_rowloop"``
    takes the same routes through the row-loop kernels.
    """
    if compaction not in COMPACTIONS:
        raise ValueError(f"unknown compaction {compaction!r}; "
                         f"choose from {COMPACTIONS}")
    if pruning not in PRUNINGS:
        raise ValueError(f"unknown pruning {pruning!r}; "
                         f"choose from {PRUNINGS}")
    if faults.armed() and inject_faults:
        faults.inject("ops.query_block", compaction=compaction,
                      pruning=pruning, use_kernel=use_kernel,
                      rows=int(entries.shape[0]))
    dev = resolve_device(device)
    c, q = entries.shape[0], queries.shape[0]
    if c == 0 or q == 0:
        return _empty_block(capacity, dev)
    e_dev = entries_dev if entries_dev is not None else _as_tensor(entries, dev)
    q_dev = (queries_t_dev if queries_t_dev is not None
             else _as_tensor(queries, dev).T.contiguous())
    if e_dev.device != dev or q_dev.device != dev:
        raise ValueError(f"resident inputs on {e_dev.device}/{q_dev.device}, "
                         f"not on {dev}")
    if use_kernel and compaction != "dense":
        return _fused(entries, queries, e_dev, q_dev, d, capacity=capacity,
                      cand_blk=cand_blk, qry_blk=qry_blk, pruning=pruning,
                      append="rowloop" if compaction == "fused_rowloop"
                      else "chunk")
    return _dense(e_dev, q_dev, d, capacity=capacity, use_kernel=use_kernel,
                  cand_blk=cand_blk, qry_blk=qry_blk)


def _fused(entries, queries, e_dev, q_dev, d, *, capacity, cand_blk, qry_blk,
           pruning, append) -> dict:
    c, q = entries.shape[0], queries.shape[0]
    dev = e_dev.device
    num_tiles = (-(-c // cand_blk)) * (-(-q // qry_blk))
    kw = dict(capacity=capacity, cand_blk=cand_blk, qry_blk=qry_blk,
              valid_c=c, valid_q=q, append=append, device=dev)
    if pruning == "hierarchical":
        prep = _host_live_tiles(entries, queries, d, cand_blk, qry_blk)
        if prep is not None:
            tile_i, tile_j, n_live, _ = prep
            if int(n_live[0]) == 0:
                return _empty_block(capacity, dev, num_tiles)
            e_idx, q_idx, t_enter, t_exit, count = _dt.distthresh_compact_live(
                e_dev, q_dev, d, to_device(tile_i, dev), to_device(tile_j, dev),
                to_device(n_live, dev), **kw)
            return _block(e_idx, q_idx, t_enter, t_exit, count,
                          num_tiles - int(n_live[0]), num_tiles)
    prune_kw = {}
    if pruning == "spatial":
        prep = _host_tile_prune(entries, queries, d, cand_blk, qry_blk)
        if prep is not None:
            e_mbr, q_mbr, d_prune = prep
            prune_kw = dict(e_mbr=to_device(e_mbr, dev),
                            q_mbr=to_device(q_mbr, dev), d_prune=d_prune)
    e_idx, q_idx, t_enter, t_exit, count, pruned = _dt.distthresh_compact(
        e_dev, q_dev, d, **kw, **prune_kw)
    return _block(e_idx, q_idx, t_enter, t_exit, count, pruned, num_tiles)


def _block(e_idx, q_idx, t_enter, t_exit, count, pruned, num_tiles) -> dict:
    return {"entry_idx": e_idx, "query_idx": q_idx, "t_enter": t_enter,
            "t_exit": t_exit, "count": count, "pruned_tiles": pruned,
            "num_tiles": num_tiles}


def _dense(e_dev, q_dev, d, *, capacity, use_kernel, cand_blk,
           qry_blk) -> dict:
    """Two-phase compaction: dense hit mask, prefix-sum scatter of the
    first ``capacity`` hits (row-major over the block), interval
    recompute on the compacted pairs.  No host reads."""
    c, q = e_dev.shape[0], q_dev.shape[1]
    dev = e_dev.device
    if use_kernel:
        _, _, hit = _dt.distthresh_dense(e_dev, q_dev, d, cand_blk=cand_blk,
                                         qry_blk=qry_blk, device=dev)
    else:
        _, _, hit = ref.interaction_tile(e_dev, q_dev.T, d)
    flat = hit.reshape(-1).to(torch.int32)
    count = flat.sum(dtype=torch.int32)
    pos = torch.cumsum(flat, 0, dtype=torch.int64) - 1
    # Non-hits and hits past capacity go to the spare slot, then dropped.
    dest = torch.where((flat > 0) & (pos < capacity), pos,
                       torch.full_like(pos, capacity))
    lin = torch.arange(c * q, dtype=torch.int64, device=dev)
    out_e = torch.full((capacity + 1,), -1, dtype=torch.int32, device=dev)
    out_q = torch.full((capacity + 1,), -1, dtype=torch.int32, device=dev)
    out_e.scatter_(0, dest, (lin // q).to(torch.int32))
    out_q.scatter_(0, dest, (lin % q).to(torch.int32))
    out_e, out_q = out_e[:capacity], out_q[:capacity]
    valid = out_e >= 0
    e_rows = e_dev[out_e.clamp_min(0).long()]
    q_rows = q_dev.T[out_q.clamp_min(0).long()]
    enter, exit_, _ = ref.pair_intervals(e_rows, q_rows, d)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return {"entry_idx": out_e, "query_idx": out_q,
            "t_enter": torch.where(valid, enter, zero),
            "t_exit": torch.where(valid, exit_, zero), "count": count,
            "pruned_tiles": 0, "num_tiles": 0}


__all__ = ["COMPACTIONS", "PRUNINGS", "count_hits", "interaction_tiles",
           "query_block", "to_device"]
