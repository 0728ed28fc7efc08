"""The work of the hand-written kernels, and the least time a card needs
for it.

The kernels launch through ctypes with raw pointers, so no dispatch mode
sees them: each wrapper declares its cost to ``roofline.opcount`` with
these functions (``opcount.declare``), and ``chip_smoke.py`` prices its
kernel table with them.  Every count reads each input byte once and
writes each output byte once (what a kernel must move at least), and the
operations are the ones the function needs, by dtype:

* flash attention: a query row ``i`` of ``s`` sits at key position
  ``t - s + i`` and meets the ``t - s + i + 1`` keys at or before it (a
  causal pair); the forward does two products of ``2·hd`` FLOPs per pair
  (scores and the value product), the backward five (scores, dO·Vᵀ, dV,
  dQ, dK), in the inputs' dtype, float32 ones at the ``tf32x3`` rate
  (the kernels do each float32 product as three TF32 products);
* the distance kernels: float32 on the CUDA cores, 3 operations per
  (entry, query) pair for the temporal test and 45 more per pair whose
  time extents overlap (the rest of ``interval_solve`` in
  ``kernels/csrc/distthresh.cu``; the per-segment terms made once per row
  or column are not counted).  The overlaps and hits depend on the data:
  a caller that knows them (the timing phase) passes them; a wrapper
  charges what its shapes give (:func:`distthresh_shape_cost`);
* the tile-prune preparation: its segments read once and its tile boxes
  written (:func:`distthresh_tile_prep_cost`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.roofline.analysis import (HW, compute_seconds, dtype_name,
                                           tensor_bytes)

#: float32 operations of the distance kernels' interval solve: the
#: temporal test for every pair, the quadratic path for an overlapping
#: pair.
OPS_PER_PAIR = 3
OPS_PER_OVERLAP = 45
#: Bytes of one entry or query segment (8 float32) and of one compacted
#: hit (entry id, query id, t_enter, t_exit).
SEGMENT_BYTES = 32
HIT_BYTES = 16


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """FLOPs by dtype (the keys of ``analysis.PEAKS``) and bytes moved."""
    flops: dict
    bytes: float

    @property
    def total_flops(self) -> float:
        return float(sum(self.flops.values()))


def causal_pairs(bh: int, s: int, t: int) -> int:
    """(query row, key) pairs the causal mask keeps: Σ_i (t − s + i + 1)
    over the ``s`` rows of each of ``bh`` heads."""
    return bh * (s * (t - s) + s * (s + 1) // 2)


def _flash_key(dtype: torch.dtype) -> str:
    """The ``analysis.PEAKS`` key the flash kernels' products run at:
    float32 as three TF32 products, bf16 as itself."""
    name = dtype_name(dtype)
    return "tf32x3" if name == "float32" else name


def flash_fwd_cost(bh: int, bkv: int, s: int, t: int, hd: int,
                   dtype: torch.dtype, with_lse: bool = False
                   ) -> KernelCost:
    """``flashattn``/``flashattn_fwd``: 4·hd FLOPs per causal pair; q, k,
    v read, the output (and with ``with_lse`` the float32 log-sum-exp)
    written."""
    nbytes = (2 * bh * s * hd + 2 * bkv * t * hd) * tensor_bytes((), dtype)
    if with_lse:
        nbytes += 4 * bh * s
    return KernelCost({_flash_key(dtype): 4.0 * hd * causal_pairs(bh, s, t)},
                      float(nbytes))


def flash_bwd_cost(bh: int, bkv: int, s: int, t: int, hd: int,
                   dtype: torch.dtype) -> KernelCost:
    """``flashattn_bwd``: 10·hd FLOPs per causal pair; q, o, do, k, v and
    the float32 lse read, dq, dk and dv written."""
    nbytes = ((4 * bh * s * hd + 4 * bkv * t * hd) * tensor_bytes((), dtype)
              + 4 * bh * s)
    return KernelCost({_flash_key(dtype): 10.0 * hd * causal_pairs(bh, s, t)},
                      float(nbytes))


#: Bytes a distance kernel writes besides its hits: the dense kernel's
#: (t_enter, t_exit, hit) per pair; the compact kernels' int32 counters
#: (``count`` and, without a live list, ``pruned``).
_COUNTER_BYTES = {"compact": 8, "live": 4}


def distthresh_cost(c: int, q: int, pairs: int, overlap: int, hits: int,
                    kind: str, slots: int = 0) -> KernelCost:
    """A distance kernel on ``c`` entries × ``q`` queries that evaluates
    ``pairs`` pairs, ``overlap`` of them with overlapping extents:
    ``kind`` ``"dense"`` writes 9 bytes per (entry, query) pair;
    ``"compact"`` writes 16 bytes per hit and its two counters; ``"live"``
    also reads its ``slots`` (tile_i, tile_j) int32 pairs."""
    nbytes = SEGMENT_BYTES * (c + q)
    if kind == "dense":
        nbytes += 9 * c * q
    elif kind in _COUNTER_BYTES:
        nbytes += HIT_BYTES * hits + _COUNTER_BYTES[kind] + 8 * slots
    else:
        raise ValueError(f"unknown distance kernel kind {kind!r}")
    return KernelCost(
        {"float32": float(OPS_PER_PAIR * pairs + OPS_PER_OVERLAP * overlap)},
        float(nbytes))


def distthresh_shape_cost(c: int, q: int, kind: str, *, valid_c: int,
                          valid_q: int, capacity: int = 0, slots: int = 0,
                          tile: int = 0) -> KernelCost:
    """What a distance wrapper charges from its shapes alone: the
    temporal test on every pair it may evaluate (``valid_c × valid_q``;
    a live list at most ``slots`` tiles of ``tile`` pairs), its inputs
    read and its outputs' fills written (the compact kernels' result
    buffers are filled in full before the launch: 16 bytes per slot of
    ``capacity``).  Overlaps and hits are the data's and are left to a
    caller that knows them."""
    pairs = valid_c * valid_q
    if kind == "live":
        pairs = min(pairs, slots * tile)
    return distthresh_cost(c, q, pairs, 0, 0 if kind == "dense"
                           else capacity, kind, slots)


def distthresh_tile_prep_cost(c: int, q: int, cand_blk: int,
                              qry_blk: int) -> KernelCost:
    """``distthresh_tile_prep``: the ``c`` entry and ``q`` query segments
    read once, one (lo, hi) box row of 8 float32 written per entry and per
    query tile and the float32 threshold.  Its float64 work (a few
    operations per segment and axis for ``solve_scale``) is not counted:
    the bytes bound it."""
    tiles = -(-c // cand_blk) + -(-q // qry_blk)
    return KernelCost({}, float(SEGMENT_BYTES * (c + q + tiles) + 4))


def bound_ms(flops_by_dtype: dict, nbytes: float, hw: dict = HW
             ) -> tuple[float, str]:
    """The least milliseconds for the work, and what sets it: the larger
    of the bytes over ``hw``'s HBM rate and the FLOPs of each dtype over
    that dtype's peak (``analysis.PEAKS``; bf16's is ``hw``'s)."""
    t_bytes = nbytes / hw["hbm_bw"]
    t_ops = compute_seconds(flops_by_dtype, hw)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


__all__ = ["HIT_BYTES", "KernelCost", "OPS_PER_OVERLAP", "OPS_PER_PAIR",
           "SEGMENT_BYTES", "bound_ms", "causal_pairs", "distthresh_cost",
           "distthresh_shape_cost", "distthresh_tile_prep_cost",
           "flash_bwd_cost", "flash_fwd_cost"]
