"""Distributed distance-threshold query execution (the temporal-pod
backend) — the port's counterpart of ``repro/core/distributed.py``.

The paper notes (§1) that "a spatiotemporal database can be easily
partitioned (e.g., temporally) and queried across multiple compute nodes".
The reference runs that story on a JAX mesh under ``shard_map``; the port
runs it as a plain loop over a list of torch devices, one per pod:

* **pod axis — temporal partition.**  :func:`temporal_pod_partition` splits
  the sorted segment array into per-pod contiguous time slices that every
  pod *owns*, so results concatenate and duplicate pairs are impossible by
  construction.
* **one pod step per batch.**  :func:`pod_query_step` runs
  ``ops.query_block`` on each pod's padded candidate block against the
  replicated query batch, on that pod's device, globalizes ``entry_idx``
  on the device, and gathers the pods' outputs onto pod 0's device: the
  reference's ``psum`` becomes a sum there, and its ``out_specs`` layout
  ``(P × capacity,)`` a concatenation.  Nothing is read on the host until
  the executor's fence, so a dispatch group keeps ≤ 2 host syncs.
* **sparse dispatch** is a host branch: a pod whose candidate
  intersection with a batch is empty is not launched and contributes an
  empty block (the reference's ``lax.cond`` under ``shard_map``).
* **2-D sharding** (:func:`make_sharded_count_fn`,
  :func:`make_sharded_query_fn`, :class:`DistributedEngine`): candidates
  split over ``cand_ways`` devices and queries over ``qry_ways``, as
  per-device loops with a device-side sum.

Pods and devices: the reference builds its mesh from ``jax.devices()``
capped at ``pods``.  :class:`ShardedEngine` takes an explicit list of
torch devices (the counterpart of ``mesh=``), by default every visible
device of the database's type (every CUDA device, or one CPU device).
When ``pods`` exceeds the devices, the pods share them round-robin
(``devices[p % n]``) — the only way to run the multi-pod path on one card
or on the CPU, and a deliberate difference from the reference, which caps
the pods at its device count.

:class:`ShardedEngine` implements the ``repro_torch.core.executor``
``BatchDispatcher`` protocol, :class:`PodRouter` adds per-pod routing
accounting for the broker and the deadline scheduler, and
:class:`PodFallbackDispatcher` is the broker's ``"route"`` rung for a
dropped pod.  The facade registers the engine as ``backend="shard"``
(``repro_torch.api``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch

from repro_torch import faults
from repro_torch.core.engine import _stage_to_host
from repro_torch.core.executor import Dispatch, ResultSet, make_executor
from repro_torch.core.planner import as_query_plan, bucket_capacity
from repro_torch.core.segments import SegmentArray
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.distthresh import DEFAULT_CAND_BLK, DEFAULT_QRY_BLK


# ----------------------------------------------------------------------
# temporal pod partition (paper's multi-node suggestion)
# ----------------------------------------------------------------------
#: Accepted ``temporal_pod_partition(balance=...)`` strategies.
POD_BALANCES = ("time", "num_ints")


def temporal_pod_partition(db: SegmentArray, num_pods: int, *,
                           halo: bool = False,
                           balance: str = "time") -> list[tuple[int, int]]:
    """Per-pod inclusive ``[first, last]`` slices of the sorted database.

    With ``halo=False`` (the default) the slices are an exact *partition*:
    pod ``p`` **owns** a contiguous run of the t_start-sorted segments,
    every segment is owned by exactly one pod, and empty pods come back as
    valid empty ranges ``(first, first - 1)``.  This ownership is what
    makes cross-pod result sets trivially duplicate-free: an interaction
    pair is evaluated by the unique owner of its entry segment (the sharded
    backend's "halo dedup" is by construction, not by filtering).

    ``balance`` picks where the ownership boundaries go:

    * ``"time"`` (the default, unchanged): pod ``p`` owns the segments
      whose ``t_start`` falls in the p-th *equal-width* slice of the
      temporal extent.  Temporally dense regions make their pod own (and
      evaluate) disproportionately many candidate rows.
    * ``"num_ints"``: boundaries are placed at equal quantiles of the
      per-segment candidate-load prefix sum — the same prefix-sum
      machinery the batching algorithms use for their ``numInts``
      accounting, applied to pods.  A segment's expected interaction load
      under a stationary query stream is proportional to how many queries
      temporally overlap it, i.e. to ``duration(e) + mean query
      duration`` (interval-overlap probability); lacking the workload at
      partition time, the database's own duration distribution stands in
      for the queries'.  Equalizing that cumulative weight equalizes
      expected per-pod interactions on a temporally skewed database (the
      total candidate-row count is partition-invariant; only its per-pod
      distribution moves).

    With ``halo=True`` each slice is additionally *widened* to start at the
    first segment whose running-max ``t_end`` reaches the pod's window
    start — segments with an earlier ``t_start`` that extend into the
    window.  Halo slices overlap (a replica placement/routing view, not an
    ownership view); consumers that evaluate over halo slices must dedup by
    entry ownership.

    Degenerate inputs return valid (possibly empty) slices instead of
    nonsense ranges: an empty database yields ``num_pods`` empty slices,
    and ``num_pods`` larger than the number of distinct time slices (or
    segments) leaves the surplus pods empty.
    """
    if num_pods <= 0:
        raise ValueError(f"num_pods must be positive, got {num_pods}")
    if balance not in POD_BALANCES:
        raise ValueError(f"unknown balance {balance!r}; "
                         f"choose from {POD_BALANCES}")
    n = len(db)
    if n == 0:
        return [(0, -1)] * num_pods
    if not db.is_sorted():
        raise ValueError("database must be sorted by t_start")
    if balance == "time":
        edges = np.linspace(float(db.ts[0]), float(db.ts[-1]), num_pods + 1)
        # Ownership boundaries: bounds[p] is the first segment of pod p.
        # With fewer distinct t_start values than pods (e.g. all segments
        # at one instant) interior edges collapse and the surplus pods are
        # empty.
        bounds = np.concatenate([
            [0], np.searchsorted(db.ts, edges[1:-1], side="left"), [n]
        ]).astype(np.int64)
    else:
        # Equal-load boundaries via the prefix sum of per-segment candidate
        # weight — expected overlapping-query count ∝ own duration + mean
        # duration (the db's durations proxy the workload's): pod p starts
        # at the first index whose cumulative weight exceeds p/num_pods of
        # the total.
        dur = np.maximum(db.te.astype(np.float64)
                         - db.ts.astype(np.float64), 0.0)
        cum_w = np.cumsum(dur + max(float(dur.mean()), 1e-30))
        targets = cum_w[-1] * np.arange(1, num_pods) / num_pods
        interior = np.searchsorted(cum_w, targets, side="left") + 1
        bounds = np.concatenate([[0], interior, [n]]).astype(np.int64)
    out = []
    if halo:
        te_running_max = np.maximum.accumulate(db.te.astype(np.float64))
    for p in range(num_pods):
        first, last = int(bounds[p]), int(bounds[p + 1]) - 1
        if halo and last >= first:
            # Widen to the first segment whose running-max t_end reaches
            # the pod's window start: every earlier-starting segment that
            # extends into the window is included.
            win0 = (edges[p] if balance == "time" else float(db.ts[first]))
            first = int(np.searchsorted(te_running_max, win0, side="left"))
        out.append((first, max(last, first - 1)))
    return out


def route_query_to_pods(qt0: float, qt1: float, db: SegmentArray,
                        pod_slices: list[tuple[int, int]]) -> list[int]:
    """Pods whose temporal window may hold candidates for [qt0, qt1].

    Degenerate inputs are routed nowhere: an empty database (or all-empty
    pod slices) returns ``[]``, and an empty query extent (``qt1 < qt0``)
    matches no pod.
    """
    if len(db) == 0 or qt1 < qt0:
        return []
    pods = []
    for p, (first, last) in enumerate(pod_slices):
        if last < first:
            continue
        # pod's segments can extend past its window end; use actual extents
        seg_lo = float(db.ts[first])
        seg_hi = float(db.te[first:last + 1].max())
        if seg_lo <= qt1 and seg_hi >= qt0:
            pods.append(p)
    return pods


def choose_sharding(num_candidates: int, num_queries: int,
                    cand_ways: int, qry_ways: int) -> str:
    """Pick candidate- vs query-sharding by shard aspect ratio.

    Candidate-sharding leaves ``C/cand_ways`` rows per device; if that is
    smaller than the tile (wasted compute in padding) while Q is large, the
    query-sharded layout wastes less.  The paper always candidate-shards;
    this switch is a beyond-paper optimization evaluated in §Perf.
    """
    c_per = num_candidates / max(cand_ways, 1)
    q_per = num_queries / max(qry_ways, 1)
    return "candidates" if c_per >= q_per else "queries"


# ----------------------------------------------------------------------
# pods and devices
# ----------------------------------------------------------------------
def _device_scope(dev: torch.device):
    """Make ``dev`` the current CUDA device for the launches on it (the
    kernels run on the current device's stream); a no-op on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _visible_devices(devices, device) -> list[torch.device]:
    """``devices`` resolved, or by default every visible device of
    ``device``'s type: each CUDA device, or the one CPU device."""
    if devices is not None:
        devs = [resolve_device(x) for x in devices]
        if not devs:
            raise ValueError("devices must name at least one device")
        return devs
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def pod_devices(pods: int | None = None, devices=None,
                device="cuda") -> list[torch.device]:
    """The device of each pod: ``pods`` (default: one per device) laid
    round-robin over ``devices`` (default: every visible device of
    ``device``'s type), pod ``p`` on ``devices[p % len(devices)]``."""
    devs = _visible_devices(devices, device)
    ways = len(devs) if pods is None else max(int(pods), 1)
    return [devs[p % len(devs)] for p in range(ways)]


# ----------------------------------------------------------------------
# 2-D sharded computations (per-device loops)
# ----------------------------------------------------------------------
def make_sharded_count_fn(devices, cand_ways: int, qry_ways: int = 1, *,
                          use_kernel: bool = False):
    """Global-count function over a ``cand_ways × qry_ways`` device grid:
    entries split on dim 0 into ``cand_ways`` blocks, queries into
    ``qry_ways`` (replicated if 1); grid cell ``(i, j)`` runs on
    ``devices[(i·qry_ways + j) % len(devices)]``.

    Returns ``fn(entries (C,8), queries (Q,8), d) -> int32 scalar`` on the
    first device: the per-cell counts summed there (the reference's
    ``psum``).  C and Q must divide by the respective ways (callers pad
    with non-hitting rows).
    """
    grid = pod_devices(cand_ways * qry_ways, devices)

    def fn(entries, queries, d):
        c_loc = _split(entries.shape[0], cand_ways, "entries")
        q_loc = _split(queries.shape[0], qry_ways, "queries")
        counts = []
        for i in range(cand_ways):
            for j in range(qry_ways):
                dev = grid[i * qry_ways + j]
                with _device_scope(dev):
                    cnt = ops.count_hits(
                        entries[i * c_loc:(i + 1) * c_loc],
                        queries[j * q_loc:(j + 1) * q_loc], d, device=dev,
                        use_kernel=use_kernel)
                counts.append(cnt.to(grid[0], non_blocking=True))
        return torch.stack(counts).sum(dtype=torch.int32)

    return fn


def _split(n: int, ways: int, what: str) -> int:
    if ways < 1 or n % ways:
        raise ValueError(f"{what}: {n} rows do not split into {ways} ways")
    return n // ways


def make_sharded_query_fn(devices, cand_ways: int, capacity_per_shard: int,
                          *, qry_ways: int = 1, use_kernel: bool = False,
                          cand_blk: int = DEFAULT_CAND_BLK,
                          qry_blk: int = DEFAULT_QRY_BLK):
    """Full query step with local compaction over a ``cand_ways ×
    qry_ways`` device grid (cells as in :func:`make_sharded_count_fn`).

    ``fn(entries (C,8), queries (Q,8), d)`` (host numpy) returns result
    buffers on the first device whose leading dim is ``num_shards ×
    capacity_per_shard`` (shard ``i·qry_ways + j``), with ``entry_idx`` /
    ``query_idx`` globalized via the shard offsets on the device, plus the
    per-shard ``count`` vector (overflow detection).  Returns ``(fn,
    cand_ways)``.
    """
    grid = pod_devices(cand_ways * qry_ways, devices)
    dev0 = grid[0]

    def fn(entries, queries, d):
        c_loc = _split(entries.shape[0], cand_ways, "entries")
        q_loc = _split(queries.shape[0], qry_ways, "queries")
        outs = []
        for i in range(cand_ways):
            for j in range(qry_ways):
                dev = grid[i * qry_ways + j]
                with _device_scope(dev):
                    out = ops.query_block(
                        entries[i * c_loc:(i + 1) * c_loc],
                        queries[j * q_loc:(j + 1) * q_loc], d,
                        capacity=capacity_per_shard, device=dev,
                        use_kernel=use_kernel, cand_blk=cand_blk,
                        qry_blk=qry_blk, inject_faults=False)
                    valid = out["entry_idx"] >= 0
                    out["entry_idx"] = torch.where(
                        valid, out["entry_idx"] + i * c_loc, -1)
                    out["query_idx"] = torch.where(
                        valid, out["query_idx"] + j * q_loc, -1)
                outs.append(out)
        return _gather(outs, dev0, ("entry_idx", "query_idx", "t_enter",
                                    "t_exit"))

    return fn, cand_ways


def _gather(outs: list[dict], dev0: torch.device, keys) -> dict:
    """The pods' (or shards') output buffers concatenated on ``dev0`` in
    pod order, and their ``count`` scalars stacked into a vector."""
    res = {}
    for k in keys:
        parts = [o[k].to(dev0, non_blocking=True) for o in outs]
        res[k] = parts[0] if len(parts) == 1 else torch.cat(parts)
    counts = [o["count"].to(dev0, non_blocking=True).reshape(1)
              for o in outs]
    res["count"] = counts[0] if len(counts) == 1 else torch.cat(counts)
    return res


# ----------------------------------------------------------------------
# the temporal-pod step
# ----------------------------------------------------------------------
def pod_query_step(entries: np.ndarray, offsets: np.ndarray,
                   lens: np.ndarray, queries: np.ndarray, d, *,
                   devices: list[torch.device], capacity: int,
                   use_kernel: bool = False, cand_blk: int = DEFAULT_CAND_BLK,
                   qry_blk: int = DEFAULT_QRY_BLK, compaction: str = "dense",
                   pruning: str = "none", sparse: bool = False,
                   resident: dict | None = None) -> dict:
    """One batch on every pod: the port's ``make_pod_query_fn`` step.

    ``entries`` (P, C_loc, 8) holds each pod's padded candidate block,
    ``offsets`` (P,) its first global (plan-order) segment index, ``lens``
    (P,) its real candidate rows, ``queries`` (Q, 8) the replicated padded
    query batch — all host numpy, the blocks the reference's ``shard_map``
    body sees, so the tile-prune preparation in ``ops.query_block`` (on
    the device for spatial pruning, on the host for hierarchical) sees the
    pad rows as the reference's in-graph one does.  Pod ``p`` runs
    ``ops.query_block`` on ``devices[p]``.

    ``resident`` caches the uploads (``{"entries": {p: tensor},
    "queries_t": {device: tensor}}``), so an overflow retry at a larger
    capacity uploads nothing again.  With ``sparse`` a pod with
    ``lens[p] == 0`` is not launched and contributes an empty block.

    Returns tensors on ``devices[0]``, the reference's output layout:
    ``entry_idx`` (globalized; -1 pads), ``query_idx``, ``t_enter``,
    ``t_exit`` of shape (P × capacity,), ``count`` (P,) int32 per pod,
    ``total`` () int32 — their sum, on the device — and ``pruned_tiles`` /
    ``num_tiles`` summed over the pods (a tensor where a kernel counted
    them, else a host int).  Nothing is read on the host.
    """
    dev0 = devices[0]
    if resident is None:
        resident = {"entries": {}, "queries_t": {}}
    outs, pruned_dev, empty = [], [], None
    pruned_host = num_tiles = 0
    for p, dev in enumerate(devices):
        if sparse and lens[p] == 0:
            # One empty block serves every skipped pod: the gather only
            # reads it.
            empty = empty or ops._empty_block(capacity, dev0, 0)
            out = empty
        else:
            if p not in resident["entries"]:
                resident["entries"][p] = ops.to_device(entries[p], dev)
            if dev not in resident["queries_t"]:
                resident["queries_t"][dev] = ops.to_device(queries.T, dev)
            with _device_scope(dev):
                out = ops.query_block(
                    entries[p], queries, d, capacity=capacity, device=dev,
                    use_kernel=use_kernel, cand_blk=cand_blk,
                    qry_blk=qry_blk, compaction=compaction, pruning=pruning,
                    entries_dev=resident["entries"][p],
                    queries_t_dev=resident["queries_t"][dev],
                    inject_faults=False)
                e = out["entry_idx"]
                out["entry_idx"] = torch.where(e >= 0, e + int(offsets[p]), e)
        if isinstance(out["pruned_tiles"], torch.Tensor):
            pruned_dev.append(out["pruned_tiles"].to(dev0, non_blocking=True))
        else:
            pruned_host += out["pruned_tiles"]     # a host int already
        num_tiles += out["num_tiles"]
        outs.append(out)
    res = _gather(outs, dev0, ("entry_idx", "query_idx", "t_enter", "t_exit"))
    # One pod: its scalars are the totals (views, no reduction launched).
    res["total"] = (res["count"].reshape(()) if len(outs) == 1
                    else res["count"].sum(dtype=torch.int32))
    if len(pruned_dev) == 1 and pruned_host == 0:
        res["pruned_tiles"] = pruned_dev[0]
    elif pruned_dev:
        res["pruned_tiles"] = (torch.stack(pruned_dev).sum(dtype=torch.int32)
                               + pruned_host)
    else:
        res["pruned_tiles"] = pruned_host
    res["num_tiles"] = num_tiles
    return res


class _PodShardDispatcher:
    """``BatchDispatcher`` over the temporal pods (executor protocol).

    ``dispatch`` slices each pod's intersection with the batch's contiguous
    candidate range out of the packed database, pads every pod's block to a
    shared bucketed width (pad rows use a temporal extent beyond the data
    — and a *different* instant than query padding, so pad×pad pairs can
    never hit), and runs :func:`pod_query_step` — no host reads, so the
    pipelined executor's first phase stays asynchronous.  The outputs are
    gathered on pod 0's device and staged to the host once per dispatch,
    as a single-device dispatch stages its own.
    """

    def __init__(self, engine: "ShardedEngine", q_packed: np.ndarray,
                 d: float):
        self.engine = engine
        self.device = engine.device
        self.q_packed = q_packed
        self.d = d
        # Pad instants must lie beyond the database AND this query set —
        # a query extending past the database's extent must not overlap
        # entry pad rows.
        pad = engine._pad_t
        if q_packed.shape[0]:
            pad = max(pad, float(q_packed[:, 7].max()) + 1.0)
        self._pad_e = pad          # entry pad rows: [pad, pad]
        self._pad_q = pad + 1.0    # query pad rows: disjoint instant

    def _pod_lens(self, batch) -> tuple[list[int], list[int]]:
        """Per-pod (first index, length) of the batch's candidate range
        intersected with each pod's ownership slice — the exact fan-out."""
        los, lens = [], []
        for pf, plast in self.engine.pod_slices:
            lo = max(batch.cand_first, pf)
            hi = min(batch.cand_last, plast)
            los.append(lo)
            lens.append(max(hi - lo + 1, 0))
        return los, lens

    def dispatch(self, batch, capacity: int) -> Dispatch:
        se = self.engine
        los, lens = self._pod_lens(batch)
        if faults.armed():
            faults.inject("shard.dispatch", q_first=int(batch.q_first))
            # Pod-dropout target: one consultation per *live* pod of this
            # dispatch, so a plan can drop exactly the pod(s) it names
            # (``match={"pod": k}``) and only when they hold real work.
            for p, n in enumerate(lens):
                if n:
                    faults.inject("shard.pod", pod=p,
                                  q_first=int(batch.q_first))
        c_loc = bucket_capacity(max(max(lens), 1), se.cand_blk)
        # Pod-local candidate blocks, padded with rows at _pad_e.  Under a
        # hierarchical plan the batch ranges are permuted positions, so
        # slice the permuted packed copy — pod ownership intervals are
        # identical in permuted coordinates.
        src = (se._packed_perm if se.plan_pruning == "hierarchical"
               else se._packed)
        stacked = np.zeros((se.ways, c_loc, 8), np.float32)
        stacked[:, :, 6] = stacked[:, :, 7] = self._pad_e
        for p, (lo, n) in enumerate(zip(los, lens)):
            if n:
                stacked[p, :n] = src[lo:lo + n]
        offsets = np.asarray(los, np.int32)
        # Replicated query batch, bucketed on the same ladder as the
        # candidate blocks.
        qs = self.q_packed[batch.q_first:batch.q_last + 1]
        qn = qs.shape[0]
        qb = bucket_capacity(qn, se.qry_blk)
        if qb != qn:
            qpad = np.zeros((qb, 8), np.float32)
            qpad[:, 6] = qpad[:, 7] = self._pad_q
            qpad[:qn] = qs
            qs = qpad
        lens_arr = np.asarray(lens, np.int32)
        resident = {"entries": {}, "queries_t": {}}
        return self._launch(batch, capacity,
                            (stacked, offsets, lens_arr, qs, resident))

    def _launch(self, batch, capacity: int, prepared) -> Dispatch:
        stacked, offsets, lens, qs, resident = prepared
        se = self.engine
        out = pod_query_step(
            stacked, offsets, lens, qs, np.float32(self.d),
            devices=se.devices, capacity=capacity, use_kernel=se.use_kernel,
            cand_blk=se.cand_blk, qry_blk=se.qry_blk,
            compaction=se.compaction, pruning=se.pruning, sparse=se.sparse,
            resident=resident)
        return Dispatch(batch, capacity, _stage_to_host(out, self.device),
                        ctx=prepared)

    def redispatch(self, dp: Dispatch, capacity: int) -> Dispatch:
        """Overflow retry: only the capacity changed, so reuse the prepared
        per-pod blocks, padded queries and their uploads in ``dp.ctx``."""
        return self._launch(dp.batch, capacity, dp.ctx)

    def count(self, dp: Dispatch) -> int:
        count = int(dp.out["total"])
        if faults.armed():
            count = faults.corrupt("shard.count", count,
                                   q_first=int(dp.batch.q_first))
        return count

    def tile_stats(self, dp: Dispatch) -> tuple[int, int]:
        """Kernel-level pruning counters summed over the pods."""
        return int(dp.out["pruned_tiles"]), int(dp.out["num_tiles"])

    def retry_capacity(self, dp: Dispatch) -> int | None:
        per_shard = int(dp.out["count"].numpy().max())
        return (bucket_capacity(per_shard)
                if per_shard > dp.capacity else None)

    def marshal(self, dp: Dispatch, count: int) -> ResultSet | None:
        if faults.armed():
            faults.inject("shard.marshal", q_first=int(dp.batch.q_first))
        db = self.engine.db
        ent = dp.out["entry_idx"].numpy()
        # Mask on the -1 pads rather than trusting ``count`` (the total may
        # be corrupted by a chaos plan); no valid rows = no part.
        keep = ent >= 0
        if not keep.any():
            return None
        e_global = ent[keep].astype(np.int64)
        if self.engine.plan_pruning == "hierarchical":
            # device rows sit at permuted positions; map back so the
            # caller-visible entry_idx never changes
            perm = self.engine._perm
            if perm is not None:
                e_global = perm[e_global]
        q_local = dp.out["query_idx"].numpy()[keep].astype(np.int64)
        return ResultSet(
            entry_idx=e_global,
            entry_traj=db.traj_id[e_global].astype(np.int64),
            entry_seg=db.seg_id[e_global].astype(np.int64),
            query_idx=dp.batch.q_first + q_local,
            t_enter=dp.out["t_enter"].numpy()[keep],
            t_exit=dp.out["t_exit"].numpy()[keep],
        )


class ShardedEngine:
    """Sharded query backend over temporal pods.

    The multi-pod sibling of ``repro_torch.core.engine.
    DistanceThresholdEngine``: the database is temporally partitioned
    across the pods once (:func:`temporal_pod_partition`, ownership slices
    — duplicate pairs are impossible by construction), and each batch's
    contiguous candidate range is answered by the pods owning its
    sub-ranges against the replicated query batch.  Execution runs
    through the shared ``repro_torch.core.executor`` drivers, so the
    pipelined path keeps ≤ 2 host syncs per dispatch group with exact hit
    counts summed on the device and the same bucketed overflow-retry
    protocol as the single-device engine.

    ``devices`` lists the torch devices to lay the pods on (the
    counterpart of the reference's ``mesh=``); by default every visible
    device of ``device``'s type.  ``pods`` defaults to one per device;
    more pods than devices share them round-robin (module docstring).
    ``use_kernel`` selects the hand-written kernels per pod (their plain
    versions on the CPU) or the torch oracle, which always runs the dense
    two-phase path.

    ``pruning="hierarchical"`` rebuilds the K-box index **per pod** over
    each pod's ownership slice (``PodPartitionedIndex.build_partitioned``,
    from the base ``index=`` the facade passes in), so the planner prunes
    shard plans at box granularity; ``entry_idx`` maps back through the
    composed ``perm``.  On the fused kernel path each pod's dispatch then
    runs the live-tile kernel over the host-built live-tile list.

    ``sparse=True`` (the default) skips pods whose candidate intersection
    with a batch is empty (a host branch; totals stay exact by zero
    contribution).  :class:`RoutingStats` reports the avoided work.
    """

    def __init__(self, db: SegmentArray, *, devices=None,
                 pods: int | None = None, capacity_per_shard: int = 4096,
                 use_kernel: bool = False, cand_blk: int = DEFAULT_CAND_BLK,
                 qry_blk: int = DEFAULT_QRY_BLK, compaction: str = "dense",
                 pipeline: bool = True, balance: str = "time",
                 pruning: str = "spatial", index=None, sparse: bool = True,
                 max_capacity_retries: int = 3, device="cuda"):
        if compaction not in ops.COMPACTIONS:
            raise ValueError(f"unknown compaction {compaction!r}; "
                             f"choose from {ops.COMPACTIONS}")
        if pruning not in ops.PRUNINGS:
            raise ValueError(f"unknown pruning {pruning!r}; "
                             f"choose from {ops.PRUNINGS}")
        self.db = db if db.is_sorted() else db.sort_by_tstart()
        self._packed = self.db.packed()
        self.devices = pod_devices(pods, devices, device)
        self.device = self.devices[0]
        self.ways = len(self.devices)
        self.balance = balance
        self.pod_slices = temporal_pod_partition(self.db, self.ways,
                                                 balance=balance)
        self.capacity_per_shard = capacity_per_shard
        self.use_kernel = use_kernel
        self.cand_blk = cand_blk
        self.qry_blk = qry_blk
        self.compaction = compaction
        self.pipeline = pipeline
        self.sparse = bool(sparse)
        self.max_capacity_retries = int(max_capacity_retries)
        # Planner-level pruning: hierarchical needs the pod-local K-box
        # rebuild (from the facade's base index); without one, shard
        # plans can only use bin-granular (spatial) ranges.
        self.plan_pruning = pruning
        self.plan_index = None
        self._perm = None
        self._packed_perm = self._packed
        if pruning == "hierarchical":
            if index is None:
                self.plan_pruning = "spatial"
            else:
                from repro_torch.core.index import PodPartitionedIndex
                self.plan_index = PodPartitionedIndex.build_partitioned(
                    index, self.db, self.pod_slices)
                self._perm = self.plan_index.perm
                self._packed_perm = self._packed[self._perm]
        # Kernel-level tile pruning only exists on the fused kernel path.
        self.pruning = (pruning if use_kernel
                        and compaction in ("fused", "fused_rowloop")
                        else "none")
        self._pad_t = float(self.db.temporal_extent[1]) + 1.0
        # The reference probes its fused path here to bake its automatic
        # fused→rowloop lowering fallback into the pod step; the port has
        # no such fallback (a kernel builds and runs or raises), so there
        # is nothing to probe.

    # ------------------------------------------------------------------
    def dispatcher(self, queries_packed: np.ndarray,
                   d: float) -> _PodShardDispatcher:
        return _PodShardDispatcher(self, queries_packed, float(d))

    def execute(self, queries: SegmentArray, d: float, plan, *,
                pipeline: bool | None = None, dispatcher=None):
        """Run a plan on the pods — the single-device engine's contract
        (``plan`` may be a ``BatchPlan`` or a ``QueryPlan``; per-batch
        capacities are *per pod*).  ``dispatcher`` substitutes a pre-built
        pod dispatcher — the seam :class:`PodRouter` uses to thread
        routing accounting through."""
        if not queries.is_sorted():
            raise ValueError(
                "queries must be sorted by t_start; use "
                "repro_torch.api.TrajectoryDB.query, which sorts "
                "automatically")
        qplan = as_query_plan(plan,
                              default_capacity=self.capacity_per_shard)
        use_pipeline = self.pipeline if pipeline is None else pipeline
        if dispatcher is None:
            dispatcher = self.dispatcher(queries.packed(), d)
        executor = make_executor(
            dispatcher, pipeline=use_pipeline,
            max_capacity_retries=self.max_capacity_retries)
        return executor.run(qplan)


@dataclasses.dataclass(eq=False)      # identity compare: ndarray + lock fields
class RoutingStats:
    """Per-pod routing accounting for one :class:`PodRouter` binding.

    ``pods_per_batch[k]`` is how many pods hold a non-empty intersection
    of the k-th *dispatched* batch's candidate range with their ownership
    slice — the exact fan-out.  ``pod_hits`` accumulates marshalled hit
    rows per pod — the load signal the ``balance="num_ints"`` partition
    is meant to even out.

    Both count **work dispatched to the pods**, not unique results: on the
    deadline-scheduler path a straggling group that gets re-issued is
    accounted once per execution.  On the broker's single-threaded pump
    (no re-issue) ``pod_hits.sum()`` equals the ticket's result rows
    exactly.  Updates are lock-protected — scheduler worker threads share
    one stats object.
    """

    num_pods: int = 0
    batches: int = 0
    pods_per_batch: list = dataclasses.field(default_factory=list)
    pod_hits: np.ndarray | None = None
    #: Pod executions avoided by sparse dispatch: a pod counted here had
    #: zero candidates for its batch and was not launched.
    pods_skipped: int = 0
    #: Padded entry×query interaction slots those skipped executions
    #: would have evaluated (``skipped × C_loc × Q_pad`` per batch).
    padded_interactions_avoided: int = 0
    _lock: object = dataclasses.field(default_factory=threading.Lock,
                                      repr=False, compare=False)

    @property
    def mean_pods_per_batch(self) -> float:
        return (float(np.mean(self.pods_per_batch))
                if self.pods_per_batch else 0.0)

    @property
    def hit_balance(self) -> float:
        """max/mean per-pod hit load (1.0 = perfectly even; 0 if no hits)."""
        if self.pod_hits is None or self.pod_hits.size == 0:
            return 0.0
        if int(self.pod_hits.sum()) == 0:
            return 0.0
        return float(self.pod_hits.max() / self.pod_hits.mean())


class _RoutedPodDispatcher(_PodShardDispatcher):
    """The pod dispatcher with per-batch fan-out accounting (non-empty
    pod candidate intersections) and per-pod hit accounting on marshal —
    what :class:`PodRouter` hands the executors."""

    def __init__(self, router: "PodRouter", q_packed: np.ndarray, d: float):
        super().__init__(router.engine, q_packed, d)
        self.router = router

    def dispatch(self, batch, capacity: int) -> Dispatch:
        _, lens = self._pod_lens(batch)
        live = sum(1 for n in lens if n > 0)
        dp = super().dispatch(batch, capacity)
        st = self.router.stats
        with st._lock:
            st.batches += 1
            st.pods_per_batch.append(live)
            if self.engine.sparse:
                skipped = self.engine.ways - live
                st.pods_skipped += skipped
                # prepared ctx = (stacked (P, C_loc, 8), offsets, lens,
                # qs (Q_pad, 8), uploads): each skipped pod would have
                # evaluated the full padded C_loc × Q_pad block
                st.padded_interactions_avoided += (
                    skipped * dp.ctx[0].shape[1] * dp.ctx[3].shape[0])
        return dp

    def record_empty(self, batch) -> None:
        """Executor hook: a zero-candidate batch was skipped host-side.
        Record an explicit empty routing row (0 pods touched) so the
        stats cover every planned batch."""
        st = self.router.stats
        with st._lock:
            st.batches += 1
            st.pods_per_batch.append(0)

    def marshal(self, dp: Dispatch, count: int) -> ResultSet | None:
        st = self.router.stats
        per_pod = np.minimum(dp.out["count"].numpy().astype(np.int64),
                             dp.capacity)
        with st._lock:
            st.pod_hits += per_pod
        return super().marshal(dp, count)


class PodRouter:
    """Per-pod shard routing layer over a :class:`ShardedEngine` — the
    serving-side face of the pod backend.

    The broker (``repro_torch.serve.broker.QueryBroker``) and the deadline
    scheduler hand this object a ticket's batch *groups*; each group fans
    out to the per-pod candidate slices (``_RoutedPodDispatcher``), per-pod
    hits merge into one globally indexed ``ResultSet`` (exact counts
    summed on the device, ≤ 2 host syncs per group), and
    :class:`RoutingStats` records how many pods each batch needed and how
    the hit load balanced across pods.  ``execute`` has the engines'
    contract, so a ``DeadlineScheduler`` can drive a router directly
    (``TrajectoryDB.query_stream(backend="shard")``).
    """

    def __init__(self, engine: ShardedEngine):
        self.engine = engine
        self.stats = RoutingStats(
            num_pods=engine.ways,
            pod_hits=np.zeros(engine.ways, np.int64))

    @property
    def default_capacity(self) -> int:
        """Per-pod capacity (scheduler/executor interop)."""
        return self.engine.capacity_per_shard

    def dispatcher(self, queries_packed: np.ndarray,
                   d: float) -> _RoutedPodDispatcher:
        return _RoutedPodDispatcher(self, queries_packed, float(d))

    def execute(self, queries: SegmentArray, d: float, plan, *,
                pipeline: bool | None = None):
        """Engine-contract execution with routing accounting (the scheduler
        calls this once per batch group) — ``ShardedEngine.execute`` with a
        routed dispatcher substituted."""
        return self.engine.execute(
            queries, d, plan, pipeline=pipeline,
            dispatcher=self.dispatcher(queries.packed(), d))


class PodFallbackDispatcher:
    """Degraded route for a dropped pod: execute a *shard plan*'s batches
    on pod 0's device, off the pods.

    When a pod drops out (:class:`~repro_torch.core.errors.PodFailedError`)
    the broker's ``"route"`` rung swaps a ticket's routed dispatcher for
    this one: each batch's whole candidate range — the dropped pod's
    ownership slice included — is evaluated by one ``ops.query_block``
    dispatch with dense compaction, sliced from the same (possibly
    permuted) packed layout the shard plan addresses, so the rows stay
    those of the pods.  On a CUDA database that dispatch runs the dense
    CUDA kernel (the reference runs its plain oracle here; the port never
    hands a failing path's work to the plain version on the card); a CPU
    database runs the torch oracle, as the reference does.
    """

    def __init__(self, engine: ShardedEngine, q_packed: np.ndarray,
                 d: float):
        self.engine = engine
        self.device = engine.device
        self.use_kernel = self.device.type == "cuda"
        self.q_packed = q_packed
        self.d = float(d)

    def dispatch(self, batch, capacity: int) -> Dispatch:
        se = self.engine
        src = (se._packed_perm if se.plan_pruning == "hierarchical"
               else se._packed)
        e_slice = src[batch.cand_first:batch.cand_last + 1]
        q_slice = self.q_packed[batch.q_first:batch.q_last + 1]
        out = ops.query_block(
            e_slice, q_slice, np.float32(self.d), capacity=capacity,
            device=self.device, use_kernel=self.use_kernel,
            cand_blk=se.cand_blk, qry_blk=se.qry_blk, compaction="dense",
            pruning="none")
        return Dispatch(batch, capacity, _stage_to_host(out, self.device))

    def count(self, dp: Dispatch) -> int:
        return int(dp.out["count"])

    def tile_stats(self, dp: Dispatch) -> tuple[int, int]:
        return 0, 0                     # the dense path has no tile loop

    def retry_capacity(self, dp: Dispatch) -> int | None:
        # Shard-plan capacities are *per pod*; one device holds the whole
        # batch, so the first dispatch may legitimately overflow — one
        # bucketed retry reaches the exact global count.
        count = self.count(dp)
        return bucket_capacity(count) if count > dp.capacity else None

    def marshal(self, dp: Dispatch, count: int) -> ResultSet | None:
        se = self.engine
        db = se.db
        ent = dp.out["entry_idx"].numpy()
        keep = ent >= 0
        if not keep.any():
            return None
        e_global = dp.batch.cand_first + ent[keep].astype(np.int64)
        if se.plan_pruning == "hierarchical" and se._perm is not None:
            e_global = se._perm[e_global]
        q_local = dp.out["query_idx"].numpy()[keep].astype(np.int64)
        return ResultSet(
            entry_idx=e_global,
            entry_traj=db.traj_id[e_global].astype(np.int64),
            entry_seg=db.seg_id[e_global].astype(np.int64),
            query_idx=dp.batch.q_first + q_local,
            t_enter=dp.out["t_enter"].numpy()[keep],
            t_exit=dp.out["t_exit"].numpy()[keep],
        )


class DistributedEngine:
    """Host-side driver for the 2-D sharded query step.

    Pads the candidate slice of each batch to a multiple of the candidate
    shard count, runs :func:`make_sharded_query_fn`'s step, and assembles
    results (one host read per batch).  ``devices`` as in
    :class:`ShardedEngine`; ``cand_ways`` defaults to one per device.
    """

    def __init__(self, db: SegmentArray, *, devices=None,
                 cand_ways: int | None = None, num_bins: int = 1000,
                 capacity_per_shard: int = 4096, use_kernel: bool = False,
                 device="cuda"):
        from repro_torch.core.index import TemporalBinIndex
        devs = _visible_devices(devices, device)
        self.db = db if db.is_sorted() else db.sort_by_tstart()
        self.index = TemporalBinIndex.build(self.db, num_bins)
        self._packed = self.db.packed()
        self.capacity = capacity_per_shard
        self._fn, self.ways = make_sharded_query_fn(
            devs, cand_ways or len(devs), capacity_per_shard,
            use_kernel=use_kernel)

    def query_batch(self, queries_packed: np.ndarray, qt0: float, qt1: float,
                    d: float) -> dict[str, np.ndarray]:
        first, last = self.index.candidate_range(qt0, qt1)
        c = last - first + 1
        if c <= 0:
            return {"entry_idx": np.zeros(0, np.int64),
                    "query_idx": np.zeros(0, np.int64),
                    "t_enter": np.zeros(0, np.float32),
                    "t_exit": np.zeros(0, np.float32)}
        pad = (-c) % self.ways
        e = self._packed[first:last + 1]
        if pad:
            t_pad = float(self.db.te.max()) + 1.0
            rows = np.zeros((pad, 8), np.float32)
            rows[:, 6] = rows[:, 7] = t_pad
            e = np.concatenate([e, rows], axis=0)
        out = self._fn(e, queries_packed, np.float32(d))
        # One host read per batch (the legacy driver's synchronous
        # contract): every tensor below is copied once.
        out = {k: v.cpu().numpy()         # lint: sync-point
               for k, v in out.items()}
        if np.any(out["count"] > self.capacity):
            raise RuntimeError("per-shard result capacity overflow; retry "
                               "with larger capacity_per_shard")
        ent = out["entry_idx"]
        keep = ent >= 0
        return {"entry_idx": ent[keep].astype(np.int64) + first,
                "query_idx": out["query_idx"][keep].astype(np.int64),
                "t_enter": out["t_enter"][keep],
                "t_exit": out["t_exit"][keep]}


__all__ = [
    "DistributedEngine", "POD_BALANCES", "PodFallbackDispatcher",
    "PodRouter", "RoutingStats", "ShardedEngine", "choose_sharding",
    "make_sharded_count_fn", "make_sharded_query_fn", "pod_devices",
    "pod_query_step", "route_query_to_pods", "temporal_pod_partition",
]
