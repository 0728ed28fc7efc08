"""End-to-end distance-threshold query engine (paper §4–§5).

The port's counterpart of ``repro/core/engine.py``.  As in the paper's
general approach (§4), the sorted entry segments are uploaded to the
device once, at construction, and stay there; the host keeps numpy copies
for the planner and for the per-dispatch tile-prune preparation.  Per
query set the dispatcher uploads the transposed query segments once; per
batch it slices both on the device (no copy), runs ``ops.query_block``
and enqueues the copies of the result buffers into pinned host memory, so
the executor's one fence per group covers the kernels and the copies, and
marshalling is numpy on host memory.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import faults
from repro_torch.core.batching import BatchPlan
from repro_torch.core.executor import (BatchStats, Dispatch,  # noqa: F401 (stable re-exports)
                                       ExecStats, ResultSet, make_executor,
                                       watch_staged)
from repro_torch.core.index import DEFAULT_NUM_BINS, TemporalBinIndex
from repro_torch.core.planner import (QueryPlan, as_query_plan,
                                      bucket_capacity as _bucket)
from repro_torch.core.segments import SegmentArray
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.kernels.distthresh import DEFAULT_CAND_BLK, DEFAULT_QRY_BLK


def _stage_to_host(out: dict, device: torch.device) -> dict:
    """Enqueue copies of a dispatch's output tensors into pinned host
    tensors on the current stream (no wait).  They hold the values once the
    device has passed a fence recorded after this call.  Counters the host
    already knows (Python ints) pass through; CPU outputs are already on
    the host.  While a sync sentinel watches, the staged tensors are handed
    to it, so it can tell a read before the fence from one after."""
    if device.type != "cuda":
        return out
    host, staged = {}, []
    for k, v in out.items():
        if isinstance(v, torch.Tensor):
            h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            h.copy_(v, non_blocking=True)
            staged.append(h)
            v = h
        host[k] = v
    watch_staged(staged, device)
    return host


class _QueryBlockDispatcher:
    """Single-device dispatcher: resident device slices → ``query_block``.

    Implements the ``repro_torch.core.executor.BatchDispatcher`` protocol
    for one (engine, query set, threshold) binding.
    """

    def __init__(self, engine: "DistanceThresholdEngine",
                 q_packed: np.ndarray, d: float):
        self.engine = engine
        self.device = engine.device
        self.q_packed = q_packed
        # One upload per query set, transposed: a batch is a column slice.
        self.q_dev_t = ops.to_device(q_packed.T, self.device)
        self.d = d

    def dispatch(self, batch, capacity: int) -> Dispatch:
        eng = self.engine
        if faults.armed():
            faults.inject("engine.dispatch", q_first=int(batch.q_first),
                          use_kernel=eng.use_kernel,
                          compaction=eng.compaction)
        # Hierarchical pruning plans box-level sub-ranges in the index's
        # *permuted* segment order, so the dispatched slices come from the
        # permuted packed copy (identical to ``_packed`` when K=1).
        if eng.pruning == "hierarchical":
            packed, packed_dev = eng._packed_perm, eng._packed_perm_dev
        else:
            packed, packed_dev = eng._packed, eng._packed_dev
        cf, cl = batch.cand_first, batch.cand_last + 1
        qf, ql = batch.q_first, batch.q_last + 1
        out = ops.query_block(
            packed[cf:cl], self.q_packed[qf:ql], np.float32(self.d),
            capacity=capacity, device=self.device, use_kernel=eng.use_kernel,
            cand_blk=eng.cand_blk, qry_blk=eng.qry_blk,
            compaction=eng.compaction, pruning=eng.pruning,
            entries_dev=packed_dev[cf:cl], queries_t_dev=self.q_dev_t[:, qf:ql])
        return Dispatch(batch, capacity, _stage_to_host(out, self.device))

    def count(self, dp: Dispatch) -> int:
        count = int(dp.out["count"])
        if faults.armed():
            count = faults.corrupt("engine.count", count,
                                   q_first=int(dp.batch.q_first))
        return count

    def tile_stats(self, dp: Dispatch) -> tuple[int, int]:
        """Kernel-level pruning counters (executor hook)."""
        return int(dp.out["pruned_tiles"]), int(dp.out["num_tiles"])

    def retry_capacity(self, dp: Dispatch) -> int | None:
        count = self.count(dp)
        return _bucket(count) if count > dp.capacity else None

    def marshal(self, dp: Dispatch, count: int) -> ResultSet | None:
        if faults.armed():
            faults.inject("engine.marshal", q_first=int(dp.batch.q_first))
        batch, out, db = dp.batch, dp.out, self.engine.db
        # Mask on the buffers' -1 pads rather than trusting ``count``: a
        # corrupted overflow count then costs at most one bounded retry and
        # can neither leak pad rows nor drop real ones.
        e_buf = out["entry_idx"].numpy()
        keep = e_buf >= 0
        if not keep.any():
            return None
        e_global = batch.cand_first + e_buf[keep].astype(np.int64)
        if self.engine.pruning == "hierarchical":
            perm = self.engine.index.perm
            if perm is not None:
                # Permuted dispatch position → original sorted-db index, so
                # results stay identical across pruning modes.
                e_global = perm[e_global]
        return ResultSet(
            entry_idx=e_global,
            entry_traj=db.traj_id[e_global].astype(np.int64),
            entry_seg=db.seg_id[e_global].astype(np.int64),
            query_idx=batch.q_first
            + out["query_idx"].numpy()[keep].astype(np.int64),
            t_enter=out["t_enter"].numpy()[keep],
            t_exit=out["t_exit"].numpy()[keep],
        )


class DistanceThresholdEngine:
    """In-memory distance-threshold query engine over a trajectory database."""

    def __init__(self, db: SegmentArray, *, num_bins: int = DEFAULT_NUM_BINS,
                 use_kernel: bool = True, cand_blk: int = DEFAULT_CAND_BLK,
                 qry_blk: int = DEFAULT_QRY_BLK,
                 default_capacity: int = 4096, compaction: str = "fused",
                 pipeline: bool = True, pruning: str = "spatial",
                 index_kboxes: int = 1, max_capacity_retries: int = 3,
                 device="cuda", index: TemporalBinIndex | None = None):
        """``use_kernel=False`` routes interactions through the torch
        oracle (always the dense two-phase path); ``True`` through the
        hand-written kernels (their plain versions on the CPU).

        ``compaction``, ``pipeline`` and ``pruning`` are as in the
        reference engine; the facade keeps plan and engine pruning
        consistent.  ``index`` supplies a prebuilt temporal-bin index for
        ``db`` (it must be the index ``TemporalBinIndex.build`` would give
        for the sorted segments; the state carry-over uses it).
        """
        if compaction not in ops.COMPACTIONS:
            raise ValueError(f"unknown compaction {compaction!r}; "
                             f"choose from {ops.COMPACTIONS}")
        if pruning not in ops.PRUNINGS:
            raise ValueError(f"unknown pruning {pruning!r}; "
                             f"choose from {ops.PRUNINGS}")
        self.device = resolve_device(device)
        self.db = db if db.is_sorted() else db.sort_by_tstart()
        self.index = index if index is not None else TemporalBinIndex.build(
            self.db, num_bins, kboxes=index_kboxes)
        self._packed = self.db.packed()          # (n, 8) float32, host copy
        # Permuted layout for hierarchical (box-level) plans: row i holds
        # the segment at sorted-db position perm[i].  Alias when K=1.
        self._packed_perm = (self._packed if self.index.perm is None
                             else self._packed[self.index.perm])
        # The device copies, uploaded once (paper §4).
        self._packed_dev = ops.to_device(self._packed, self.device)
        self._packed_perm_dev = (
            self._packed_dev if self.index.perm is None
            else ops.to_device(self._packed_perm, self.device))
        self.use_kernel = use_kernel
        self.cand_blk = cand_blk
        self.qry_blk = qry_blk
        self.default_capacity = default_capacity
        self.compaction = compaction
        self.pipeline = pipeline
        self.pruning = pruning
        # Batches whose hits still exceed capacity after this many
        # enlargements raise CapacityError.
        self.max_capacity_retries = int(max_capacity_retries)

    # ------------------------------------------------------------------
    def dispatcher(self, queries_packed: np.ndarray,
                   d: float) -> _QueryBlockDispatcher:
        """The engine's ``BatchDispatcher`` for one query set."""
        return _QueryBlockDispatcher(self, queries_packed, float(d))

    # ------------------------------------------------------------------
    def execute(self, queries: SegmentArray, d: float,
                plan: BatchPlan | QueryPlan, *,
                pipeline: bool | None = None) -> tuple[ResultSet, ExecStats]:
        """Run every batch in ``plan`` against the database.

        ``plan`` may be a ``QueryPlan`` (the facade's planner output) or a
        legacy ``BatchPlan`` (coerced to a single-group plan sized by
        ``default_capacity``).  ``pipeline`` overrides the engine's
        executor choice for this call (the perf-model fits run the
        per-batch executor).

        Thread-safe: the deadline scheduler and the broker's straggler
        duplicates call it from several threads at once.  Every dispatch
        allocates its own device outputs, pinned host copies and fence, so
        two executions of one plan share only read-only inputs.
        """
        if not queries.is_sorted():
            raise ValueError(
                "queries must be sorted by t_start; use "
                "repro_torch.api.TrajectoryDB.query, which sorts "
                "automatically")
        qplan = as_query_plan(plan, default_capacity=self.default_capacity)
        executor = make_executor(
            self.dispatcher(queries.packed(), d),
            pipeline=self.pipeline if pipeline is None else pipeline,
            max_capacity_retries=self.max_capacity_retries)
        return executor.run(qplan)


# ----------------------------------------------------------------------
# Brute-force oracle (for tests): all pairs, no index, chunked.
# ----------------------------------------------------------------------
def brute_force(db: SegmentArray, queries: SegmentArray, d: float,
                chunk: int = 2048, device="cuda") -> ResultSet:  # lint: ignore[SYNC001] — synchronous oracle; per-chunk host reads are its contract, not a pipeline leak
    """All-pairs reference on the torch oracle: compares every entry to
    every query segment, ``chunk`` entries at a time (one host read per
    chunk — a synchronous oracle, not a pipeline)."""
    dev = resolve_device(device)
    db_packed = ops.to_device(db.packed(), dev)
    q_packed = ops.to_device(queries.packed(), dev)
    parts: list[ResultSet] = []
    for c0 in range(0, len(db), chunk):
        t_enter, t_exit, hit = ref.interaction_tile(
            db_packed[c0:c0 + chunk], q_packed, np.float32(d))
        ei, qi = torch.nonzero(hit, as_tuple=True)
        if ei.numel() == 0:
            continue
        te = t_enter[ei, qi].cpu().numpy()
        tx = t_exit[ei, qi].cpu().numpy()
        eg = c0 + ei.cpu().numpy().astype(np.int64)
        parts.append(ResultSet(
            entry_idx=eg,
            entry_traj=db.traj_id[eg].astype(np.int64),
            entry_seg=db.seg_id[eg].astype(np.int64),
            query_idx=qi.cpu().numpy().astype(np.int64),
            t_enter=te, t_exit=tx,
        ))
    return ResultSet.concatenate(parts).sorted_canonical()
