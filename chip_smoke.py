#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit::

    python3 chip_smoke.py

Phases, each printing one JSON line (``"phase": ...``):

1. device  — the card as torch and ``nvidia-smi`` name it, power limit.
2. build   — ``nvcc`` builds ``src/repro_torch/kernels/csrc/*.cu`` (one
   compile per source, all at once; ``ptxas`` registers and spills), and
   ``cuobjdump -sass`` counts each kernel's ``HGMMA`` and ``UTMALDG``
   instructions (every bf16 flash instantiation must have both; null
   where the toolkit has no ``cuobjdump``).
3. kernels — each kernel against its plain PyTorch version on the card.
   The flash kernels (``FLASH_TOL``): head dims 16/32/64/128, g 1 and 4,
   S = T = 77 and 1,000, S = 45 < T = 333, float32 (the CUDA-core
   kernel) and bf16 (the tensor-core kernel), and bf16 at the llm
   phase's prefill shape.  The distance kernels: on
   seeded random tiles with the degenerate cases (zero-length extent, zero
   relative velocity, tangent roots, disjoint intervals), at 256×256,
   64×32, 40×24 and 32×320 tiles (the row-loop kernels' register and
   recompute slots), with ample and overflowing capacity; the compact
   kernels' blocks (``BLOCK_CASES``, chunk sub-tiles and row-loop row
   blocks: S1's largest batch shape, ragged tiles, a last tile shorter
   than one block, an overflow inside a lone block, dead tiles armed);
   and the dense kernel on ``DENSE_CASES`` (Q > 256, one entry, one
   query, ragged row blocks, ``queries_t`` a column slice).  Hit sets,
   ``count`` and ``pruned`` must be exact; intervals agree within
   ``rtol=1e-6, atol=1e-5`` (same float32 operations in the same order,
   built with ``-fmad=false``; the atomic append changes only the row
   order, so rows are compared after a canonical sort).  With ample
   capacity, each entry row's row-loop hits take consecutive slots in
   ascending query order.
4. main    — ``TrajectoryDB.from_scenario("S1", scale=1.0)`` (GALAXY,
   2,500 trajectories × 400 segments = 10^6 entry segments, 100 query
   trajectories, d = 1) under the default policy, ``backend="kernel"``
   against ``backend="torch"``, then the same query with
   ``compaction="dense"`` (phase main_dense); then one warm execution of
   the main path's plan under ``torch.profiler`` (device busy share,
   device time by kernel), and one of the dense path's (profile_dense).
   The profiles execute the plans phase main ran.  Then phase shard:
   the same S1 query through ``backend="shard"`` with the kernels on the
   default devices (one pod on the card), its plan once more through a
   ``PodRouter``, and the same plan on 4 pods sharing the card with
   sparse dispatch; each equal to phase main's rows, launching only
   ``distthresh_compact`` once per live pod per dispatch, with ≤ 2 syncs
   per group, no duplicate pair and ``RoutingStats`` covering every
   batch; the 1-pod plan once more under ``torch.profiler`` (busy
   share).
5. modes   — C1 and C3 at scale 0.1 (C3 as the README configures it),
   pruning none/spatial/hierarchical × compaction
   fused/fused_rowloop/dense, all equal to the torch backend and the
   row-loop rows identical to the fused rows; then S2 at scale 0.02
   against ``backend="brute"``.  Then phase shard_modes: the same C1 and
   C3 matrix through ``backend="shard"`` on 4 pods, equal to the
   single-device rows of each mode, sparse dispatch on and off
   byte-identical (C3 hierarchical launches ``distthresh_compact_live``).
6. serve   — the serving path on the same S1 database at scale 1.0:
   ``db.broker(backend="kernel")`` with a ``SliceCache`` and a
   ``RetryPolicy(degrade_after=1)``, the 100 query trajectories as 4
   tickets of 25.  Ticket 2 runs under a fault plan that fails every
   ``compaction="fused"`` dispatch, so its broker steps down to
   ``kernel/fused_rowloop`` and launches the row-loop kernel.  The union
   of the tickets equals phase main's rows; ticket 1 resubmitted is born
   done from the cache.  One query trajectory whose every kernel
   dispatch fails walks the ladder to ``kernel/dense`` and then fails
   (on the card there is no rung below the kernels).  Then
   ``fit_response_model(quick=True)`` on ticket 1's queries, and ticket
   1's queries rejected under a deadline below the fitted model's priced
   time and served under one above it (phase fit).  Ticket 2 runs once
   more under ``torch.profiler`` on a broker without a cache
   (profile_ticket2: its device time by kernel).  Then phase
   shard_serve: ``db.broker(backend="shard")`` on 4 pods, the same 4
   tickets (slices, ``ticket.routing``, union equal to phase shard's
   rows), and ticket 2 again under a ``shard.pod`` dropout, re-routed
   (stage ``"route"``) through the dense kernel with the same rows.
7. stream  — ``db.query_stream(backend="kernel")`` on S1 at scale 0.3
   against ``db.query``; then phase shard_stream: ``query_stream(
   backend="shard")`` on 4 pods with ``SchedulerStats.routing``; then
   phase rtree: S1 at ``RTREE_SCALE`` through ``backend="rtree"`` (the
   paper's §7.3 CPU baseline, on the host) with 1 thread and the host's
   cores, each against ``backend="kernel"``: both walls (the paper's
   GPU-versus-R-tree speedup on this machine) and the host CPU's name.
8. llm     — LLM serving: granite-3-2b at full width and depth (40
   layers, bf16, seeded random weights made on the card) through
   ``ServeEngine.generate``: 8 seeded prompts of 64 to 1,000 tokens
   (bucket 1024), 32 new tokens, run twice (equal outputs, every token
   below the vocabulary size).  The run launches ``flashattn`` once per
   layer of the prefill and never in decode.  The prefill's last logits
   with the kernel are held against the same weights with the plain
   version patched in (``LLM_LOGIT_ATOL``, and the same argmax for
   every prompt).
9. timing  — each kernel's time on the largest dispatch of the path its
   launches are counted on (CUDA graph of repeated wrapper calls, so host
   overhead is excluded), its plain version's time, and its bound on this
   card; the row-loop kernels at the shapes of their chunk twins (the
   compact kernels with their grid's block count); the flash kernel at
   the llm phase's prefill shape, beside ``scaled_dot_product_attention``
   (``library_ms``, timed here only), and the float32 flash kernel at the
   same shape in float32 (phase timing_flash_f32).

Every ``backend="kernel"`` or ``"shard"`` run sets the launch counters
to 0 just before it and reads them just after (``kernel_path``,
``shard_query``, and per ticket in phases serve and shard_serve): it
fails unless the path's own kernel launched, no other kernel did, and
(on ``db.query``) the launches match the dispatches (for the shard
backend, the live pods' dispatches).

Then the kernel table (``{"kernels": [...]}``), the ``nvidia-smi`` name
and power-limit line, and last ``{"ok": true, "device": {...}}``.  Any
failure raises: the script catches nothing and exits non-zero, also when
CUDA is absent or the repository's ``src/`` is not beside it.
"""
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

#: Kernel-vs-plain tolerance on the card (see phase 3 above).
K_RTOL, K_ATOL = 1e-6, 1e-5
#: Backend-vs-backend tolerance on interval endpoints: the facade tests'
#: (tests/test_torch_api.py), for float32 root solves that are
#: ill-conditioned near tangency.  Index columns are always exact.
B_RTOL, B_ATOL = 1e-4, 1e-3

#: Flash kernel against its plain version on the card, per dtype, as
#: (rtol, atol, vtol): |a - b| <= rtol * max(|a|, |b|) + atol + vtol *
#: max|v| over the row's KV head.  float32: both compute in float32 from
#: the same inputs with sums in another order (about 1e-6 relative at
#: T = 1,000 keys), so they agree within 1e-5.  bf16: the kernel rounds
#: each probability p to bf16 (relative error at most 2^-9) before the
#: value product, as SDPA does, while the plain version keeps it in
#: float32; that moves an output by at most 2^-9 * sum(p |v|) / l <=
#: 2^-9 * max|v|, and vtol = 2^-8 allows twice that.  Both outputs are
#: then rounded once to bf16, half a step each (2^-8 of the value), hence
#: rtol = 2^-7.  The float32 sums' own differences (~1e-6 of max|v|) fit
#: in the slack.  tests/test_torch_flashattn.py holds a plain-torch
#: emulation of the kernel's rounding to the same bound on the CPU.
FLASH_TOL = {torch.float32: (1e-5, 1e-5, 0.0),
             torch.bfloat16: (2.0 ** -7, 0.0, 2.0 ** -8)}
#: The llm phase's last-position logits, kernel against plain version:
#: the two differ only where their float32 attention sums round to bf16
#: differently (one step, on a few outputs per layer), and 40 layers of
#: random-weight blocks carry that to the logits, whose magnitude is
#: about 2 here.  0.25 is an eighth of that; a wrong kernel (a wrong mask,
#: head or scale) moves them by the logits' own size.
LLM_LOGIT_ATOL = 0.25
#: ``scaled_dot_product_attention`` (timed as the flash kernel's
#: yardstick) against the plain version: a sanity bound that it computes
#: the same function on the same layout.
LIBRARY_ATOL = 2.0 ** -4

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): float32
#: outside the tensor cores, bf16 on the tensor cores, and HBM3
#: bandwidth.
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

#: float32 operations of the kernels' interval solve (csrc/distthresh.cu:
#: ``interval_solve``): the temporal test for every pair, the rest of the
#: quadratic path for a pair whose extents overlap.  Per-segment velocity
#: and anchor terms are computed once per row / column and not counted.
OPS_PER_PAIR = 3
OPS_PER_OVERLAP = 45

#: The TPU kernel (its ``pallas_call`` line) each CUDA kernel replaces;
#: the row-loop kernels replace the same calls with ``append="rowloop"``.
REPLACES = {
    "distthresh_dense": "src/repro/kernels/distthresh.py:242",
    "distthresh_compact": "src/repro/kernels/distthresh.py:640",
    "distthresh_compact_live": "src/repro/kernels/distthresh.py:782",
    "distthresh_compact_rowloop": "src/repro/kernels/distthresh.py:640",
    "distthresh_compact_live_rowloop": "src/repro/kernels/distthresh.py:782",
    "flashattn": "src/repro/kernels/flashattn.py:84",
}


def source(name: str) -> str:
    cu = "flashattn" if name == "flashattn" else "distthresh"
    return f"src/repro_torch/kernels/csrc/{cu}.cu"


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase line also says when it ended (``end_s``,
    seconds since the script started)."""
    if "phase" in obj:
        obj = {**obj, "end_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> dict:
    """Registers and spill bytes per compiled kernel, from ``ptxas -v``."""
    out, fn = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
            out[fn] = ""
        elif fn and ("spill" in ln or "registers" in ln):
            out[fn] += ln.split(":", 1)[-1].strip() + "; "
    return out


#: SASS opcodes counted per kernel in the build phase: the tensor-core
#: products and the TMA tile loads of the bf16 flash kernel.
SASS_OPS = ("HGMMA", "UTMALDG")


def sass_counts(lib) -> dict | None:
    """Per compiled kernel, how many ``SASS_OPS`` instructions ``cuobjdump
    -sass`` of the built library shows (names shortened to the kernel and
    its head-dim or prune template argument); None when the toolkit has no
    ``cuobjdump``."""
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if not tool:
        return None
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    counts, fn = {}, None
    for ln in out.splitlines():
        if "Function :" in ln:
            raw = ln.split("Function :", 1)[1].strip()
            m = re.search(r"\d+((?:flashattn|distthresh)\w*?_kernel)"
                          r"(?:I(?:Li|Lb)(\w+?)E)?", raw)
            fn = f"{m.group(1)}<{m.group(2)}>" if m and m.group(2) else (
                m.group(1) if m else raw)
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn:
            for op in SASS_OPS:
                if re.search(rf"\b{op}\b", ln):
                    counts[fn][op] += 1
    return counts


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ----------------------------------------------------------------------
# Inputs for the kernel checks.
# ----------------------------------------------------------------------
def degenerate_rows():
    """Entry i meets query i (d = 2): head-on, parallel within, parallel
    out of reach, zero-length extent, tangent, disjoint extents, linear
    relative motion, zero relative velocity."""
    e = np.array([[0, 0, 0, 10, 0, 0, 0, 10], [0, 0, 0, 10, 0, 0, 0, 10],
                  [0, 0, 0, 10, 0, 0, 0, 10], [5, 0, 0, 5, 0, 0, 3, 3],
                  [0, 0, 0, 10, 0, 0, 0, 10], [0, 0, 0, 1, 0, 0, 0, 1],
                  [0, 0, 0, 10, 0, 0, 0, 10], [3, 1, 0, 3, 1, 0, 0, 10]],
                 np.float32)
    q = np.array([[10, 0, 0, 0, 0, 0, 0, 10], [0, 1, 0, 10, 1, 0, 0, 10],
                  [0, 5, 0, 10, 5, 0, 0, 10], [0, 0, 0, 10, 0, 0, 0, 10],
                  [10, 2, 0, 0, 2, 0, 0, 10], [0, 0, 0, 1, 0, 0, 5, 6],
                  [0, 0, 0, 10, 3, 0, 0, 10], [3, 1, 1, 3, 1, 1, 0, 10]],
                 np.float32)
    return e, q


def clustered(rng, c: int, q: int, groups: int):
    """Entries in ``groups`` clusters along x (so tile boxes separate and
    the early-out has work) and queries at two of them, the degenerate rows
    first."""
    def segs(n, xs):
        s = np.zeros((n, 8), np.float32)
        s[:, 0] = xs + rng.uniform(0, 4, n)
        s[:, 1:3] = rng.uniform(0, 4, (n, 2))
        s[:, 3:6] = s[:, 0:3] + rng.normal(0, 1.5, (n, 3))
        s[:, 6] = rng.uniform(0, 10, n)
        s[:, 7] = s[:, 6] + rng.uniform(0.2, 4, n)
        return s
    de, dq = degenerate_rows()
    e = segs(c, np.sort(rng.integers(0, groups, c)) * 50.0)
    qq = segs(q, rng.choice([0.0, 50.0 * (groups // 2)], q))
    e[:len(de)] = de[:c]
    qq[:len(dq)] = dq[:q]
    return e, qq


def rows(out, n):
    """Canonically sorted (entry, query, t_enter, t_exit) of the first
    ``n`` slots."""
    e, q = out[0][:n].cpu().numpy(), out[1][:n].cpu().numpy()
    o = np.lexsort((q, e))
    return (e[o], q[o], out[2][:n].cpu().numpy()[o],
            out[3][:n].cpu().numpy()[o])


def compare_compact(k, p_full, capacity, label):
    """Kernel output ``k`` against the plain version's ample-capacity
    output ``p_full``; returns the interval error."""
    count = int(k[4])
    check(count == int(p_full[4]), f"{label}: count {count} != "
          f"{int(p_full[4])}")
    pr = rows(p_full, count)
    if count <= capacity:
        kr = rows(k, count)
        for a, b in zip(kr[:2], pr[:2]):
            check(np.array_equal(a, b), f"{label}: hit sets differ")
        for a, b in zip(kr[2:], pr[2:]):
            check(np.allclose(a, b, rtol=K_RTOL, atol=K_ATOL),
                  f"{label}: intervals differ")
        check((k[0][count:] == -1).all().item(), f"{label}: pad rows")
        return max(float(np.abs(kr[2] - pr[2]).max(initial=0)),
                   float(np.abs(kr[3] - pr[3]).max(initial=0)))
    # Overflow: an arbitrary `capacity` of the hits, all distinct and real.
    kr = rows(k, capacity)
    kept = set(zip(kr[0].tolist(), kr[1].tolist()))
    check(len(kept) == capacity, f"{label}: overflow rows not distinct")
    check(kept <= set(zip(pr[0].tolist(), pr[1].tolist())),
          f"{label}: overflow kept a non-hit")
    return 0.0


def check_row_runs(k, qry_blk: int, label) -> None:
    """The row-loop append order (ample capacity): each entry row's hits
    in one query tile take consecutive slots, in ascending
    ``query_idx``."""
    n = int(k[4])
    e = k[0][:n].cpu().numpy().astype(np.int64)
    q = k[1][:n].cpu().numpy().astype(np.int64)
    key = e * (int(q.max(initial=0)) // qry_blk + 1) + q // qry_blk
    same = key[1:] == key[:-1]
    check(int(n > 0) + int((~same).sum()) == len(np.unique(key)),
          f"{label}: an entry row's hits are not consecutive")
    check(bool((q[1:][same] > q[:-1][same]).all()),
          f"{label}: columns not ascending within a row")


def kernel_checks(dev) -> dict:
    from repro_torch.kernels import distthresh as dt
    from repro_torch.kernels import ops
    rng = np.random.default_rng(2026)
    err = {name: 0.0 for name in REPLACES}
    cases = 0
    d = np.float32(2.0)
    # 40×24: a block that is not a whole number of warps; 32×320: more
    # than 8 chunks of 32 columns, the row-loop kernels' recompute path.
    for cb, qb in ((256, 256), (64, 32), (40, 24), (32, 320)):
        e_np, q_np = clustered(rng, 6 * cb + 37, 3 * qb + 5, groups=6)
        e = torch.from_numpy(e_np).to(dev)
        qt = torch.from_numpy(q_np).to(dev).T.contiguous()
        kd = dt.distthresh_dense(e, qt, d, device=dev)
        pd = dt.distthresh_dense_plain(e, qt, d)
        check(torch.equal(kd[2], pd[2]), f"dense {cb}x{qb}: hit masks differ")
        for a, b in zip(kd[:2], pd[:2]):
            check(torch.allclose(a, b, rtol=K_RTOL, atol=K_ATOL),
                  f"dense {cb}x{qb}: intervals differ")
            err["distthresh_dense"] = max(err["distthresh_dense"],
                                          float((a - b).abs().max()))
        hits = int(pd[2].sum())
        check(hits > 0, "no hits in the check tiles")
        prep = ops._host_tile_prune(e_np, q_np, d, cb, qb)
        live = ops._host_live_tiles(e_np, q_np, d, cb, qb)
        check(prep is not None and live is not None,
              "check tiles leave nothing to prune")
        armed = dict(e_mbr=torch.from_numpy(prep[0]).to(dev),
                     q_mbr=torch.from_numpy(prep[1]).to(dev),
                     d_prune=prep[2])
        lists = [torch.from_numpy(x).to(dev) for x in live[:3]]
        kw = dict(cand_blk=cb, qry_blk=qb)
        for append, suffix in (("chunk", ""), ("rowloop", "_rowloop")):
            name = "distthresh_compact" + suffix
            plain = getattr(dt, name + "_plain")
            live_name = "distthresh_compact_live" + suffix
            live_plain = getattr(dt, live_name + "_plain")
            for capacity in (hits + 64, max(hits // 3, 1)):
                for arm in ({}, armed):
                    label = (f"{name} {cb}x{qb} cap={capacity} "
                             f"armed={bool(arm)}")
                    k = dt.distthresh_compact(e, qt, d, capacity=capacity,
                                              append=append, device=dev,
                                              **kw, **arm)
                    p = plain(e, qt, d, capacity=hits + 64, **kw, **arm)
                    check(int(k[5]) == int(p[5]), f"{label}: pruned differs")
                    check(bool(arm) == (int(p[5]) > 0),
                          f"{label}: pruned count")
                    err[name] = max(err[name],
                                    compare_compact(k, p, capacity, label))
                    if append == "rowloop" and capacity > hits:
                        check_row_runs(k, qb, label)
                    cases += 1
                label = f"{live_name} {cb}x{qb} cap={capacity}"
                k = dt.distthresh_compact_live(e, qt, d, *lists,
                                               capacity=capacity,
                                               append=append, device=dev,
                                               **kw)
                p = live_plain(e, qt, d, *lists, capacity=hits + 64, **kw)
                err[live_name] = max(err[live_name],
                                     compare_compact(k, p, capacity, label))
                if append == "rowloop" and capacity > hits:
                    check_row_runs(k, qb, label)
                cases += 1
    for append in ("chunk", "rowloop"):
        cases += block_checks(dev, rng, err, append)
    cases += dense_checks(dev, rng, err)
    torch.cuda.synchronize()
    return {"cases": cases, "max_abs_err": err}


#: The compact kernels' block cases at 256 × 256 tiles, per append mode,
#: as (entries, queries, dead tiles required).  chunk: S1's largest batch
#: (30 tiles of 26 sub-tiles of 10 rows, the last tile 76 rows), two ragged
#: tiles, and a batch of one sub-tile, whose overflow must fall inside that
#: sub-tile.  rowloop: S1's largest batch (30 tiles of 32 row blocks of 8
#: rows), a batch whose last tile (5 rows) is shorter than one row block,
#: and a batch of one row block.
BLOCK_CASES = {"chunk": ((7500, 100, True), (300, 100, False),
                         (10, 100, False)),
               "rowloop": ((7500, 100, True), (517, 100, False),
                           (8, 100, False))}


def block_rows(append: str, q: int) -> int:
    """Entry rows per block at ``q`` <= 256 columns: a chunk sub-tile holds
    1,024 pairs; a row block's 8 warps take 1,024 / (8 · q) rows each,
    within the 8 chunks of 32 columns a warp keeps in registers."""
    if append == "chunk":
        return max(1, 1024 // q)
    chunks = -(-q // 32)
    return 8 * max(1, min(1024 // (8 * q), 8 // chunks))


def blocks_per_tile(c: int, q: int, append: str, blk: int = 256) -> int:
    """Blocks per logical ``blk`` × ``blk`` tile of a compact kernel's
    grid, from the built library's geometry."""
    from repro_torch.kernels import _build
    fn = (_build.load().distthresh_compact_rowloop_blocks
          if append == "rowloop" else
          _build.load().distthresh_compact_subtiles)
    return fn(c, q, blk, blk, c, q)


def block_checks(dev, rng, err, append: str) -> int:
    """``distthresh_compact`` and ``distthresh_compact_live`` with
    ``append`` where one logical tile spans several blocks (chunk
    sub-tiles or row-loop row blocks), with ragged rows and columns,
    ample capacity and capacity that cuts inside a block, armed with dead
    tiles where the batch has them (``pruned`` must equal the plain
    twin's count of logical tiles).  The row loop's ample cases also pass
    the order check.  Adds to ``err``; returns the number of cases."""
    from repro_torch.kernels import distthresh as dt
    from repro_torch.kernels import ops
    suffix = "_rowloop" if append == "rowloop" else ""
    name, live_name = ("distthresh_compact" + suffix,
                       "distthresh_compact_live" + suffix)
    plain = getattr(dt, name + "_plain")
    live_plain = getattr(dt, live_name + "_plain")
    d, cb = np.float32(2.0), 256
    cases = 0
    for c, q, need_dead in BLOCK_CASES[append]:
        e_np, q_np = clustered(rng, c, q, groups=6)
        e = torch.from_numpy(e_np).to(dev)
        qt = torch.from_numpy(q_np).to(dev).T.contiguous()
        per_tile = blocks_per_tile(c, q, append)
        rows_per_block = block_rows(append, q)
        check(per_tile == -(-min(c, cb) // rows_per_block),
              f"{name} {c}x{q}: {per_tile} blocks per tile, expected "
              f"{rows_per_block} rows each")
        blocks = -(-c // cb) * per_tile
        hits = int(plain(e, qt, d, capacity=1)[4])
        check(hits >= 2, f"{c}x{q}: {hits} hits")
        prep = ops._host_tile_prune(e_np, q_np, d, cb, cb)
        check(prep is not None or not need_dead, f"{c}x{q}: no dead tile")
        arms = [{}]
        if prep is not None:
            arms.append(dict(e_mbr=torch.from_numpy(prep[0]).to(dev),
                             q_mbr=torch.from_numpy(prep[1]).to(dev),
                             d_prune=prep[2]))
        live = ops._host_live_tiles(e_np, q_np, d, cb, cb)
        for capacity in (hits + 64, hits // 2):
            for arm in arms:
                label = (f"{name} {c}x{q} ({blocks} blocks) "
                         f"cap={capacity} armed={bool(arm)}")
                k = dt.distthresh_compact(e, qt, d, capacity=capacity,
                                          append=append, device=dev, **arm)
                p = plain(e, qt, d, capacity=hits + 64, **arm)
                check(int(k[5]) == int(p[5]), f"{label}: pruned differs")
                check(bool(arm) == (int(p[5]) > 0), f"{label}: pruned count")
                err[name] = max(err[name],
                                compare_compact(k, p, capacity, label))
                if append == "rowloop" and capacity > hits:
                    check_row_runs(k, cb, label)
                cases += 1
            if live is not None:
                lists = [torch.from_numpy(x).to(dev) for x in live[:3]]
                label = f"{live_name} {c}x{q} cap={capacity}"
                k = dt.distthresh_compact_live(e, qt, d, *lists,
                                               capacity=capacity,
                                               append=append, device=dev)
                p = live_plain(e, qt, d, *lists, capacity=hits + 64)
                err[live_name] = max(err[live_name],
                                     compare_compact(k, p, capacity, label))
                if append == "rowloop" and capacity > hits:
                    check_row_runs(k, cb, label)
                cases += 1
    return cases


#: The dense kernel's edge cases as (entries, queries, column offset of
#: ``queries_t`` in a wider (8, N) array, or None for a contiguous one):
#: more than 256 columns (three column blocks, the last partial), one
#: entry, one query, one of each, 7,501 rows at 100 columns (row blocks of
#: 10, the last of one row), and column slices.
DENSE_CASES = ((70, 600, None), (70, 600, 13), (1, 100, None),
               (300, 1, None), (1, 1, None), (7501, 100, 5), (37, 250, 3))


def dense_checks(dev, rng, err) -> int:
    """``distthresh_dense`` against its plain twin on ``DENSE_CASES``: hit
    masks exact, intervals within ``K_RTOL``/``K_ATOL``.  Adds to ``err``;
    returns the number of cases."""
    from repro_torch.kernels import distthresh as dt
    d = np.float32(2.0)
    for c, q, off in DENSE_CASES:
        e_np, q_np = clustered(rng, c, q + 2 * (off or 0), groups=6)
        e = torch.from_numpy(e_np).to(dev)
        qt = torch.from_numpy(q_np).to(dev).T.contiguous()
        if off is not None:
            qt = qt[:, off:off + q]
        label = f"dense {c}x{q} offset={off}"
        kd = dt.distthresh_dense(e, qt, d, device=dev)
        pd = dt.distthresh_dense_plain(e, qt, d)
        check(torch.equal(kd[2], pd[2]), f"{label}: hit masks differ")
        for a, b in zip(kd[:2], pd[:2]):
            check(torch.allclose(a, b, rtol=K_RTOL, atol=K_ATOL),
                  f"{label}: intervals differ")
            err["distthresh_dense"] = max(err["distthresh_dense"],
                                          float((a - b).abs().max()))
    return len(DENSE_CASES)


def flash_close(a, b, v, g: int, dtype) -> float:
    """Max |a - b|, after checking ``FLASH_TOL`` (``v`` the values, ``g``
    the query heads per KV head)."""
    rtol, atol, vtol = FLASH_TOL[dtype]
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    vmax = v.float().abs().amax(dim=(1, 2)).repeat_interleave(g)
    tol = (rtol * torch.maximum(a.abs(), b.abs()) + atol
           + vtol * vmax[:, None, None])
    check(torch.isfinite(a).all().item(), "flashattn: non-finite output")
    check((diff <= tol).all().item(),
          f"flashattn {dtype}: max |diff| {float(diff.max())}")
    return float(diff.max())


#: The llm phase's prefill shape for the flash kernel (granite-3-2b, 8
#: prompts in the 1024 bucket): (BKV, g, S = T, hd).
SERVE_FLASH = (64, 4, 1024, 64)


def flash_checks(dev) -> dict:
    """The flash kernel against its plain version on seeded normal
    inputs: every head dim, g 1 and 4, S = T ragged, S < T windowed,
    float32 (the CUDA-core kernel) and bf16 (the tensor-core kernel); and
    bf16 at the serving shape."""
    from repro_torch.kernels import flashattn as fa
    gen = torch.Generator(device=dev).manual_seed(2026)
    err = {str(dt): 0.0 for dt in FLASH_TOL}
    cases = 0

    def case(dtype, bkv, g, s, t, hd):
        q = torch.randn((bkv * g, s, hd), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((bkv, t, hd), generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        got = fa.flashattn(q, k, v, g=g)
        check(got.dtype == dtype and got.shape == q.shape,
              "flashattn: output dtype or shape")
        e = flash_close(got, fa.flashattn_plain(q, k, v, g=g), v, g, dtype)
        err[str(dtype)] = max(err[str(dtype)], e)

    for dtype in (torch.float32, torch.bfloat16):
        for hd in fa.HEAD_DIMS:
            for g in (1, 4):
                for s, t in ((77, 77), (1000, 1000), (45, 333)):
                    case(dtype, 2, g, s, t, hd)
                    cases += 1
    bkv, g, s, hd = SERVE_FLASH
    case(torch.bfloat16, bkv, g, s, s, hd)
    cases += 1
    torch.cuda.synchronize()
    return {"cases": cases, "max_abs_err": max(err.values()),
            "max_abs_err_by_dtype": err,
            "tol": {str(k): v for k, v in FLASH_TOL.items()}}


# ----------------------------------------------------------------------
# Whole-path comparisons.
# ----------------------------------------------------------------------
def same_rows(a, b, label) -> float:
    check(len(a) == len(b), f"{label}: {len(a)} rows vs {len(b)}")
    for f in ("entry_idx", "entry_traj", "entry_seg", "query_idx"):
        check(np.array_equal(getattr(a, f), getattr(b, f)),
              f"{label}: {f} differs")
    for f in ("t_enter", "t_exit"):
        x, y = getattr(a, f), getattr(b, f)
        check(np.isfinite(x).all(), f"{label}: non-finite {f}")
        check(np.allclose(x, y, rtol=B_RTOL, atol=B_ATOL),
              f"{label}: {f} differs")
    if len(a) == 0:
        return 0.0
    return max(float(np.abs(a.t_enter - b.t_enter).max()),
               float(np.abs(a.t_exit - b.t_exit).max()))


def reset_launches():
    from repro_torch.kernels import distthresh as dt
    for k in dt.LAUNCHES:
        dt.LAUNCHES[k] = 0


def launches() -> dict:
    from repro_torch.kernels import distthresh as dt
    return dict(dt.LAUNCHES)


def timed_query(db, backend, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = db.query(db.scenario_queries, db.scenario_d, backend=backend, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def allowed_kernels(pruning: str, compaction: str) -> set:
    """The kernels a ``backend="kernel"`` path may launch: the dense path
    only the dense kernel; hierarchical fusion the live-tile kernel, or the
    unarmed compact kernel on a batch where no tile pair is dead; the other
    fused paths only the compact kernel.  A row-loop path launches only
    the row-loop kernels."""
    if compaction == "dense":
        return {"distthresh_dense"}
    suffix = "_rowloop" if compaction == "fused_rowloop" else ""
    if pruning == "hierarchical":
        return {"distthresh_compact_live" + suffix,
                "distthresh_compact" + suffix}
    return {"distthresh_compact" + suffix}


def identical(a, b, label) -> None:
    """Two results of the port: every column equal, bit for bit."""
    for f in ("entry_idx", "entry_traj", "entry_seg", "query_idx",
              "t_enter", "t_exit"):
        check(np.array_equal(getattr(a, f), getattr(b, f)),
              f"{label}: {f} differs")


def kernel_path(db, label: str, require: set, **kw):
    """One ``backend="kernel"`` query with the launch counters set to 0
    just before it and read just after.  Fails unless every kernel in
    ``require`` launched, no kernel outside the path's own launched, and
    (where every dispatch launches exactly one kernel) the launches equal
    the dispatches, overflow re-dispatches included."""
    pol = db.policy.with_(**kw)
    allowed = allowed_kernels(pol.pruning, pol.compaction)
    reset_launches()
    res, wall = timed_query(db, "kernel", **kw)
    counts = {k: n for k, n in launches().items() if n}
    st = res.stats
    check(set(counts) <= allowed, f"{label}: launched {counts}, only "
          f"{sorted(allowed)} belong to this path")
    for k in require:
        check(counts.get(k, 0) > 0, f"{label}: {k} was not launched")
    dispatched = sum(1 for b in st.batches if b.num_candidates) + \
        st.total_retries
    launched = sum(counts.values())
    if len(allowed) == 1:
        check(launched == dispatched,
              f"{label}: {launched} launches for {dispatched} dispatches")
    else:       # a batch whose tiles are all dead launches nothing
        check(0 < launched <= dispatched,
              f"{label}: {launched} launches for {dispatched} dispatches")
    check(st.num_syncs <= 2 * st.num_groups,
          f"{label}: {st.num_syncs} syncs for {st.num_groups} groups")
    return res, wall, counts


def warm_up(db) -> None:
    """One untimed ``backend="kernel"`` query of the first query
    trajectory: the path's first-call costs without a full plan."""
    q = db.scenario_queries
    q = q.take(np.nonzero(q.traj_id == q.traj_id[0])[0])
    db.query(q, db.scenario_d, backend="kernel")
    torch.cuda.synchronize()


def main_path(dev, card):
    """S1 at scale 1.0 under the default policy (the main path), then the
    same query with ``compaction="dense"`` (the dense kernel's path), each
    against ``backend="torch"``."""
    from repro_torch.api import TrajectoryDB
    t0 = time.perf_counter()
    db = TrajectoryDB.from_scenario("S1", scale=1.0, device=dev)
    setup_s = time.perf_counter() - t0
    warm_up(db)
    res, wall, counts = kernel_path(db, "S1 main path",
                                    {"distthresh_compact"})
    st = res.stats
    ref_res, ref_wall = timed_query(db, "torch")
    err = same_rows(res, ref_res, "S1 kernel vs torch")
    check(len(res) > 0, "S1 produced no hits")
    dense_res, dense_wall, dense_counts = kernel_path(
        db, "S1 dense path", {"distthresh_dense"}, compaction="dense")
    dense_err = same_rows(dense_res, ref_res, "S1 dense vs torch")
    emit({"phase": "main", "scenario": "S1", "scale": 1.0,
          "entry_segments": len(db), "query_segments":
          len(db.scenario_queries), "d": db.scenario_d,
          "setup_s": setup_s, "wall_s": wall, "plan_s": st.plan_seconds,
          "execute_s": st.total_seconds,
          "dispatch_s": st.dispatch_seconds, "sync_s": st.sync_seconds,
          "torch_backend_wall_s": ref_wall, "hits": len(res),
          "interactions": st.total_interactions,
          "pruned_interactions": st.pruned_interactions,
          "pruned_tiles": st.pruned_tiles, "total_tiles": st.total_tiles,
          "batches": st.num_invocations, "groups": st.num_groups,
          "syncs": st.num_syncs, "retries": st.total_retries,
          "launches": counts, "interactions_per_s":
          st.total_interactions / wall, "hits_per_s": len(res) / wall,
          "max_abs_err_vs_torch": err, "card": card})
    emit({"phase": "main_dense", "scenario": "S1", "scale": 1.0,
          "compaction": "dense", "wall_s": dense_wall,
          "execute_s": dense_res.stats.total_seconds,
          "batches": dense_res.stats.num_invocations,
          "retries": dense_res.stats.total_retries,
          "syncs": dense_res.stats.num_syncs, "launches": dense_counts,
          "max_abs_err_vs_torch": dense_err, "card": card})
    return db, res, wall, counts, dense_res, dense_counts


def profiled(fn):
    """Run ``fn()`` once under ``torch.profiler`` and synchronize: (wall
    s, device busy s, device events, top device time by kernel / copy
    name).  Busy is the union of the device intervals."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        t_start, t_end = ev.time_range.start, ev.time_range.end
        spans.append((t_start, t_end))
        name = ev.name if len(ev.name) < 60 else ev.name[:57] + "..."
        n, us = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, us + (t_end - t_start))
    check(spans, "the profiler recorded no device activity")
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):           # union of device intervals (us)
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return out, wall, busy * 1e-6, len(spans), {
        k: {"n": n, "us": us} for k, (n, us) in top}


def profile_main(db, res, card, compaction=None):
    """One warm execution of the main path's plan (``res.plan``, the plan
    phase main ran; planning excluded) under ``torch.profiler``, or of
    the dense path's with ``compaction="dense"`` (phase profile_dense):
    the device's busy share of the execution's wall time, and device time
    by kernel / copy name."""
    q, d = db._sorted(db.scenario_queries)[0], db.scenario_d
    pol = db.policy if compaction is None else db.policy.with_(
        compaction=compaction)
    plan = res.plan
    eng = db.engine("kernel", pol)
    eng.execute(q, d, plan)
    torch.cuda.synchronize()
    (_, st), wall, busy, _, top = profiled(lambda: eng.execute(q, d, plan))
    emit({"phase": "profile" + ("" if compaction is None else
                                f"_{compaction}"),
          "execute_wall_s": wall,
          "device_busy_s": busy, "device_busy_share": busy / wall,
          "dispatch_s": st.dispatch_seconds, "sync_s": st.sync_seconds,
          "device_us_by_name": top, "card": card})


def profile_ticket2(db, card):
    """Serve ticket 2 (the second quarter of the query trajectories) once
    more under ``torch.profiler`` on a broker without a cache, under the
    fault plan that steps it to ``kernel/fused_rowloop``: its wall, device
    busy time and device time by kernel / copy name (phase
    profile_ticket2)."""
    from repro_torch import faults
    from repro_torch.serve import RetryPolicy
    qk = ticket_queries(db)[1][0]
    broker = db.broker(backend="kernel",
                       retry=RetryPolicy(degrade_after=1, seed=0))
    plan = fail_fused_plan()

    def run():
        faults.arm(plan)
        try:
            return broker.submit(qk, db.scenario_d).result()
        finally:
            faults.disarm()
    _, wall, busy, _, top = profiled(run)
    check(any("rowloop" in k for k in top), f"ticket 2 profile: {top}")
    emit({"phase": "profile_ticket2", "wall_s": wall,
          "device_busy_s": busy, "device_busy_share": busy / wall,
          "device_us_by_name": top, "card": card})


def mode_matrix(dev, card):
    """C1 and C3 at scale 0.1, every pruning × compaction path against
    ``backend="torch"``, each path's launches counted on its own; then S2
    at scale 0.02 against ``backend="brute"``.  Returns the databases,
    the launches and the rows per (scenario, mode)."""
    from repro_torch.api import ExecutionPolicy, TrajectoryDB
    dbs, summary, path_counts, results = {}, {}, {}, {}
    for name, pol in (("C1", ExecutionPolicy()),
                      ("C3", ExecutionPolicy(num_bins=8, index_kboxes=4,
                                             max_subranges=16))):
        db = TrajectoryDB.from_scenario(name, scale=0.1, policy=pol,
                                        device=dev)
        dbs[name] = db
        base, _ = timed_query(db, "torch")
        check(len(base) > 0, f"{name} produced no hits")
        walls, counts = {}, {}
        for pruning in ("none", "spatial", "hierarchical"):
            fused = None
            for compaction in ("fused", "fused_rowloop", "dense"):
                mode = f"{pruning}/{compaction}"
                require = allowed_kernels(pruning, compaction)
                if len(require) > 1:
                    # C3 is the input whose boxes leave dead tiles.
                    require = ({k for k in require if "live" in k}
                               if name == "C3" else set())
                res, walls[mode], counts[mode] = kernel_path(
                    db, f"{name} {mode}", require, pruning=pruning,
                    compaction=compaction)
                same_rows(res, base, f"{name} {mode}")
                if compaction == "fused":
                    fused = res
                elif compaction == "fused_rowloop":
                    identical(res, fused, f"{name} {mode} vs fused")
                path_counts[(name, mode)] = counts[mode]
                results[(name, mode)] = res
        summary[name] = {"hits": len(base), "wall_s": walls,
                         "launches": counts}
    db = TrajectoryDB.from_scenario("S2", scale=0.02, device=dev)
    res, _, counts = kernel_path(db, "S2 main path", {"distthresh_compact"})
    brute, _ = timed_query(db, "brute")
    check(len(brute) > 0, "S2 produced no hits")
    same_rows(res, brute, "S2 kernel vs brute")
    summary["S2"] = {"hits": len(res), "launches": counts}
    emit({"phase": "modes", "scenarios": summary, "card": card})
    return dbs, path_counts, results


# ----------------------------------------------------------------------
# The serving path: broker, cache, retry and the degradation ladder.
# ----------------------------------------------------------------------
def ticket_queries(db, n_tickets: int = 4):
    """The scenario's query trajectories split into ``n_tickets`` equal
    runs of trajectory ids: per ticket (its queries, their indices in the
    scenario's query order)."""
    q = db.scenario_queries
    ids = np.array_split(np.unique(q.traj_id), n_tickets)
    out = []
    for run in ids:
        idx = np.nonzero(np.isin(q.traj_id, run))[0]
        out.append((q.take(idx), idx))
    return out


def union_rows(parts):
    """Tickets' results with ``query_idx`` mapped back to the scenario's
    query order, as one canonically sorted result (the facade's order)."""
    from repro_torch.api import QueryResult
    from repro_torch.core.executor import ResultSet
    rs = ResultSet.concatenate([
        ResultSet(r.entry_idx, r.entry_traj, r.entry_seg, idx[r.query_idx],
                  r.t_enter, r.t_exit) for r, idx in parts])
    return QueryResult.from_result_set(rs, order=None, d=0.0,
                                       backend="kernel")


def fail_fused_plan():
    """The fault plan that fails every ``compaction="fused"`` dispatch, so
    a broker with a retry policy steps down to ``kernel/fused_rowloop``."""
    from repro_torch import faults
    return faults.FaultPlan([faults.FaultSpec(
        "engine.dispatch", "error", times=None,
        match={"compaction": "fused"})])


def serve_path(db, main_res, card):
    """S1 at scale 1.0 through ``db.broker(backend="kernel")``: 4 tickets
    of 25 query trajectories, ticket 2 under a fault plan that fails every
    ``compaction="fused"`` dispatch; then ticket 1 again from the cache.
    Returns the launches of ticket 2 (the row-loop kernel's path) and the
    tickets' queries."""
    from repro_torch import faults
    from repro_torch.serve import RetryPolicy, SliceCache
    d = db.scenario_d
    cache = SliceCache()
    broker = db.broker(backend="kernel", cache=cache,
                       retry=RetryPolicy(degrade_after=1, seed=0))
    tickets = ticket_queries(db)
    fail_fused = fail_fused_plan()
    parts, report, ladder_counts = [], [], None
    for k, (qk, idx) in enumerate(tickets, start=1):
        plan = fail_fused if k == 2 else None
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if plan is not None:
            faults.arm(plan)
        try:
            t = broker.submit(qk, d)
            submit_s = time.perf_counter() - t0
            res = t.result()
        finally:
            faults.disarm()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {n: c for n, c in launches().items() if c}
        steps = [(g.stage, g.before, g.after, g.group)
                 for g in t.health.degradations]
        check(t.state == "done", f"ticket {k}: {t.state}")
        check(all(sl.num_syncs <= 2 for sl in t.slices()),
              f"ticket {k}: a slice took more than 2 syncs")
        if k == 2:
            check([(g.stage, g.after) for g in t.health.degradations]
                  == [("compaction", "kernel/fused_rowloop")],
                  f"ticket 2 degradations {steps}")
            check(counts.get("distthresh_compact_rowloop", 0) > 0
                  and "distthresh_compact" not in counts,
                  f"ticket 2 launched {counts}")
            check(set(counts) <= {"distthresh_compact_rowloop"},
                  f"ticket 2 launched {counts}")
            check(len(plan.events) == 1 and res.degraded,
                  "ticket 2: the fault fired other than once")
            ladder_counts = counts
        else:
            check(not steps and set(counts) == {"distthresh_compact"},
                  f"ticket {k}: launched {counts}, steps {steps}")
        parts.append((res, idx))
        dispatched = sum(1 for b in t.plan.batches if b.num_candidates)
        report.append({"ticket": k, "query_segments": len(qk),
                       "wall_s": wall, "submit_plan_s": submit_s,
                       "groups": t.num_groups, "batches": dispatched,
                       "overflow_redispatches":
                       sum(counts.values()) - dispatched, "hits": len(res),
                       "retries": t.health.retries,
                       "backoff_s": t.health.backoff_seconds,
                       "launches": counts, "degradations": steps})
    union = union_rows(parts)
    err = same_rows(union, main_res, "serve tickets vs phase main")

    # Ticket 1 again: born done from the cache, no device work.
    reset_launches()
    t0 = time.perf_counter()
    again = broker.submit(tickets[0][0], d)
    cached_s = time.perf_counter() - t0
    check(again.done() and again.slices()[0].num_syncs == 0,
          "ticket 1 resubmitted: not a cache hit")
    check(not any(launches().values()), "cache hit launched a kernel")
    identical(again.result(), parts[0][0], "ticket 1 from the cache")

    # One query trajectory whose every kernel dispatch fails: on the card
    # the ladder ends at kernel/dense, so the ticket fails with the
    # injected error instead of falling back to the plain torch version.
    q5 = tickets[3][0]
    q5 = q5.take(np.nonzero(q5.traj_id == q5.traj_id[0])[0])
    fail_all = faults.FaultPlan([faults.FaultSpec(
        "engine.dispatch", "error", times=None, match={"use_kernel": True})])
    uncached = db.broker(backend="kernel",
                         retry=RetryPolicy(degrade_after=1, seed=0))
    reset_launches()
    faults.arm(fail_all)
    try:
        t5 = uncached.submit(q5, d)
        uncached.run_until_idle()
    finally:
        faults.disarm()
    steps5 = [(g.stage, g.after) for g in t5.health.degradations]
    check(t5.state == "error"
          and isinstance(t5.exception(), faults.InjectedKernelError),
          f"failing ticket: {t5.state}, {t5.exception()!r}")
    check(steps5 == [("compaction", "kernel/fused_rowloop"),
                     ("compaction", "kernel/dense")],
          f"failing ticket's ladder {steps5}")
    check(len(fail_all.events) == uncached.retry.max_attempts
          and all(e.ctx["use_kernel"] for e in fail_all.events),
          "failing ticket: a dispatch ran off the kernels")
    check(not any(launches().values()), "failing ticket launched a kernel")
    failing = {"query_segments": len(q5), "state": t5.state,
               "error": repr(t5.exception()), "degradations": steps5,
               "attempts": t5.health.attempts[0]}
    emit({"phase": "serve", "scenario": "S1", "scale": 1.0,
          "tickets": report, "failing_ticket": failing,
          "cache_hit_s": cached_s,
          "cache": dataclasses.asdict(cache.stats), "union_hits": len(union),
          "max_abs_err_vs_main": err, "card": card})
    return ladder_counts, tickets


#: The fit phase's deadlines, as multiples of the priced time (the
#: model's prediction × the broker's admission slack): one below it, which
#: admission must reject, and one the ticket's execution meets although
#: the model leaves the host's marshal work out.
REJECT_MULT, ADMIT_MULT = 0.5, 20.0


def fit_path(db, tickets, card):
    """``fit_response_model(quick=True)`` on ticket 1's queries; then
    ticket 1's queries priced by the fitted model (a ticket without a
    deadline), rejected under a deadline below the priced time and
    admitted and served under one above it."""
    from repro_torch.serve import AdmissionError
    d = db.scenario_d
    q1 = tickets[0][0]
    t0 = time.perf_counter()
    model = db.fit_response_model(q1, d, quick=True)
    fit_s = time.perf_counter() - t0
    try:
        broker = db.broker(backend="kernel")
        check(broker.predict_seconds == model.predict_batch_seconds,
              "the broker does not price with the fitted model")
        probe = broker.submit(q1, d)
        base = probe.result()
        predicted = probe.predicted_seconds
        check(predicted is not None and predicted > 0,
              f"the model priced ticket 1 at {predicted}")
        priced = predicted * broker.admission_slack
        try:
            broker.submit(q1, d, deadline=REJECT_MULT * priced)
            rejected = False
        except AdmissionError:
            rejected = True
        check(rejected and broker.rejected == 1,
              f"a deadline of {REJECT_MULT} × the priced {priced} s "
              "was admitted")
        deadline = ADMIT_MULT * priced
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t = broker.submit(q1, d, deadline=deadline)
        res = t.result()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        db.response_model = None
    check(t.state == "done" and len(res) > 0, "deadline ticket failed")
    identical(res, base, "deadline ticket vs the same queries undeadlined")
    emit({"phase": "fit", "fit_s": fit_s,
          "alpha_mean": float(np.mean(model.alphas)),
          "alpha_by_epoch": [float(a) for a in model.alphas],
          "theta_s": model.device.theta, "predicted_s": t.predicted_seconds,
          "priced_s": priced, "rejected_deadline_s": REJECT_MULT * priced,
          "deadline_s": deadline, "measured_s": wall,
          "execution_s": wall - (t.submitted_at - t0), "hits": len(res),
          "card": card})


def stream_path(dev, card):
    """``db.query_stream(backend="kernel")`` on S1 at scale 0.3 against
    ``db.query`` on the same database; returns both."""
    from repro_torch.api import TrajectoryDB
    db = TrajectoryDB.from_scenario("S1", scale=0.3, device=dev)
    q, d = db.scenario_queries, db.scenario_d
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, st = db.query_stream(q, d, backend="kernel")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: c for n, c in launches().items() if c}
    check(set(counts) == {"distthresh_compact"},
          f"stream launched {counts}")
    base, base_wall = timed_query(db, "kernel")
    check(len(res) > 0, "stream produced no hits")
    err = same_rows(res, base, "query_stream vs query")
    emit({"phase": "stream", "scenario": "S1", "scale": 0.3,
          "query_segments": len(q), "wall_s": wall,
          "query_wall_s": base_wall, "hits": len(res),
          "groups": st.groups, "group_sizes": st.group_sizes,
          "batches_per_call": st.batches_per_call,
          "reissued": st.reissued,
          "duplicates_dropped": st.duplicates_dropped,
          "scheduler_wall_s": st.wall_seconds, "launches": counts,
          "max_abs_err_vs_query": err, "card": card})
    return db, base


# ----------------------------------------------------------------------
# The temporal-pod backend (backend="shard") and the R-tree baseline.
# ----------------------------------------------------------------------
#: Pods of the multi-pod runs: more pods than the card, so they share it
#: round-robin (``repro_torch.core.distributed.pod_devices``).
SHARD_PODS = 4


def pod_launches(eng, plan, stats) -> int:
    """Kernel launches a shard execution makes when each pod it runs
    launches one kernel: per dispatched batch, its live pods (every pod
    without sparse dispatch) times 1 + its overflow re-dispatches."""
    n = 0
    for b, bs in zip(plan.batches, stats.batches):
        if not b.num_candidates:
            continue
        live = eng.ways
        if eng.sparse:
            live = sum(1 for first, last in eng.pod_slices
                       if min(b.cand_last, last) >= max(b.cand_first, first))
        n += live * (1 + bs.retries)
    return n


def check_shard_run(label: str, require: set, pol, eng, res, counts):
    """A shard run's launches and rows: every kernel in ``require``
    launched, no kernel outside the path's own did, the launches equal
    the live pods' dispatches (overflow re-dispatches included) where
    each pod launches one kernel, ≤ 2 syncs per group, and no (entry,
    query) pair twice.  Returns the pod dispatches."""
    allowed = allowed_kernels(pol.pruning, pol.compaction)
    st = res.stats
    check(set(counts) <= allowed, f"{label}: launched {counts}, only "
          f"{sorted(allowed)} belong to this path")
    for k in require:
        check(counts.get(k, 0) > 0, f"{label}: {k} was not launched")
    expected = pod_launches(eng, res.plan, st)
    launched = sum(counts.values())
    if len(allowed) == 1:
        check(launched == expected,
              f"{label}: {launched} launches for {expected} pod dispatches")
    else:       # a pod whose tiles are all dead launches nothing
        check(0 < launched <= expected,
              f"{label}: {launched} launches for {expected} pod dispatches")
    check(st.num_syncs <= 2 * st.num_groups,
          f"{label}: {st.num_syncs} syncs for {st.num_groups} groups")
    pairs = set(zip(res.entry_idx.tolist(), res.query_idx.tolist()))
    check(len(pairs) == len(res), f"{label}: duplicate (entry, query) pairs")
    return expected


def shard_query(db, label: str, require: set, pol):
    """One ``backend="shard"`` query with the launch counters set to 0
    just before it and read just after, checked by
    :func:`check_shard_run`."""
    eng = db.backend("shard", pol).engine
    reset_launches()
    res, wall = timed_query(db, "shard", policy=pol)
    counts = {k: n for k, n in launches().items() if n}
    expected = check_shard_run(label, require, pol, eng, res, counts)
    return res, wall, counts, expected


def routed_run(db, label: str, pol, plan):
    """``plan`` executed through a ``PodRouter`` over ``pol``'s shard
    engine, launches counted on it alone and checked by
    :func:`check_shard_run`: the result in the caller's query order,
    the execution's wall, launches, pod dispatches and the router's
    ``RoutingStats``."""
    from repro_torch.api import QueryResult
    from repro_torch.core.distributed import PodRouter
    eng = db.backend("shard", pol).engine
    qs, order = db._sorted(db.scenario_queries)
    router = PodRouter(eng)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rs, st = router.execute(qs, db.scenario_d, plan)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: n for k, n in launches().items() if n}
    res = QueryResult.from_result_set(rs, order=order, d=db.scenario_d,
                                      backend="shard", stats=st, plan=plan)
    expected = check_shard_run(label, {"distthresh_compact"}, pol, eng, res,
                               counts)
    rt = router.stats
    check(rt.num_pods == eng.ways and int(rt.pod_hits.sum()) == len(res)
          and rt.batches == plan.num_batches,
          f"{label}: routing {rt.num_pods} pods, {rt.batches} batches, "
          f"{int(rt.pod_hits.sum())} pod hits")
    if eng.ways > 1:
        check(rt.pods_skipped > 0, f"{label}: no pod skipped")
    return res, wall, counts, expected, rt


def profile_shard(db, pol, plan):
    """One warm execution of ``plan`` through a ``PodRouter`` under
    ``torch.profiler``: the busy share and device time by name."""
    from repro_torch.core.distributed import PodRouter
    qs = db._sorted(db.scenario_queries)[0]
    router = PodRouter(db.backend("shard", pol).engine)
    (_, st), wall, busy, events, top = profiled(
        lambda: router.execute(qs, db.scenario_d, plan))
    return {"execute_wall_s": wall, "device_busy_s": busy,
            "device_busy_share": busy / wall, "device_events": events,
            "dispatch_s": st.dispatch_seconds, "sync_s": st.sync_seconds,
            "device_us_by_name": top}


def routing_summary(rt) -> dict:
    return {"num_pods": rt.num_pods, "batches": rt.batches,
            "mean_pods_per_batch": rt.mean_pods_per_batch,
            "pods_skipped": rt.pods_skipped,
            "padded_interactions_avoided": rt.padded_interactions_avoided,
            "pod_hits": rt.pod_hits.tolist(), "hit_balance": rt.hit_balance}


def shard_path(db, main_res, main_wall, card):
    """S1 at scale 1.0 through ``backend="shard"`` with the kernels.

    Run 1 pod: ``db.query`` on the default devices (one pod on the one
    card), its plan executed once more through a ``PodRouter`` (its
    ``RoutingStats``).  Run 4 pods: the same plan (the shard planner's
    plan does not depend on the pods under spatial pruning) executed on 4
    pods sharing the card with sparse dispatch, through a ``PodRouter``.
    Each against phase main's rows; the 1-pod plan once more under
    ``torch.profiler`` (one warm execution; a profile of the 4-pod run's
    31,000 device events would take the script half a minute more).
    Returns (4-pod result, its policy, launches per run)."""
    pol1 = db.policy.with_(shard_use_kernel=True)
    res1, wall1, n1, exp1 = shard_query(db, "S1 shard 1 pod",
                                        {"distthresh_compact"}, pol1)
    plan = res1.plan
    _, exec1, _, _, rt1 = routed_run(db, "S1 shard 1 pod (routed)", pol1,
                                     plan)
    pol4 = pol1.with_(shard_pods=SHARD_PODS, shard_sparse=True)
    res4, exec4, n4, exp4, rt4 = routed_run(
        db, f"S1 shard {SHARD_PODS} pods", pol4, plan)
    runs, counts = [], {}
    for label, pol, res, n, expected, rt, execute_s in (
            ("1 pod", pol1, res1, n1, exp1, rt1, exec1),
            (f"{SHARD_PODS} pods", pol4, res4, n4, exp4, rt4, exec4)):
        check(n == {"distthresh_compact": expected},
              f"S1 shard {label}: launched {n}")
        err = same_rows(res, main_res, f"S1 shard {label} vs kernel")
        st = res.stats
        runs.append({"run": label, "pods": rt.num_pods,
                     "routed_execute_s": execute_s,
                     "dispatch_s": st.dispatch_seconds,
                     "sync_s": st.sync_seconds,
                     "batches": st.num_invocations, "groups": st.num_groups,
                     "syncs": st.num_syncs, "retries": st.total_retries,
                     "launches": n, "pod_dispatches": expected,
                     "hits": len(res), "max_abs_err_vs_kernel": err,
                     "routing": routing_summary(rt)})
        counts[label] = n["distthresh_compact"]
    st1 = res1.stats
    emit({"phase": "shard", "scenario": "S1", "scale": 1.0,
          "query_wall_s": wall1, "kernel_wall_s": main_wall,
          "plan_s": st1.plan_seconds, "plan_share": st1.plan_seconds / wall1,
          "query_execute_s": st1.total_seconds, "runs": runs,
          "profile_1_pod": profile_shard(db, pol1, plan),
          "card": card})
    return res4, pol4, counts


def shard_modes(dbs, mode_results, card):
    """C1 and C3 at scale 0.1 on 4 pods with the kernels: every pruning ×
    compaction against the single-device kernel rows of the same mode,
    sparse dispatch on and off byte-identical.  Returns launches per
    (scenario, mode)."""
    summary, path_counts = {}, {}
    for name, db in dbs.items():
        walls, counts, errs = {}, {}, {}
        for pruning in ("none", "spatial", "hierarchical"):
            for compaction in ("fused", "fused_rowloop", "dense"):
                mode = f"{pruning}/{compaction}"
                require = allowed_kernels(pruning, compaction)
                if len(require) > 1:
                    require = ({k for k in require if "live" in k}
                               if name == "C3" else set())
                pol = db.policy.with_(
                    shard_pods=SHARD_PODS, shard_use_kernel=True,
                    pruning=pruning, compaction=compaction)
                res, walls[mode], counts[mode], _ = shard_query(
                    db, f"{name} shard {mode}", require, pol)
                errs[mode] = same_rows(res, mode_results[(name, mode)],
                                       f"{name} shard {mode} vs kernel")
                dense, _, _, _ = shard_query(
                    db, f"{name} shard {mode} sparse off", require,
                    pol.with_(shard_sparse=False))
                identical(res, dense, f"{name} shard {mode} sparse on/off")
                path_counts[(name, mode)] = counts[mode]
        summary[name] = {"wall_s": walls, "launches": counts,
                         "max_abs_err_vs_kernel": errs}
    emit({"phase": "shard_modes", "scale": 0.1, "pods": SHARD_PODS,
          "scenarios": summary, "card": card})
    return path_counts


def shard_serve(db, shard_res, pol, card):
    """``db.broker(backend="shard")`` on S1 at scale 1.0, 4 pods: the 4
    tickets of 25 query trajectories, each ticket's slices concatenating
    to its result and its ``ticket.routing`` filled, the union equal to
    phase shard's rows; then ticket 2 again under a ``shard.pod``
    dropout, which re-routes it (stage ``"route"``) through the dense
    kernel with the same rows.  Returns the fallback's launches."""
    from repro_torch import faults
    from repro_torch.serve import RetryPolicy
    d = db.scenario_d
    broker = db.broker(backend="shard", policy=pol,
                       retry=RetryPolicy(degrade_after=1, seed=0))
    tickets = ticket_queries(db)
    parts, report = [], []
    for k, (qk, idx) in enumerate(tickets, start=1):
        delivered = []
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t = broker.submit(qk, d, on_slice=lambda tk, sl: delivered.append(sl))
        res = t.result()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {n: c for n, c in launches().items() if c}
        check(t.state == "done" and not t.health.degradations,
              f"shard ticket {k}: {t.state}")
        check(set(counts) == {"distthresh_compact"},
              f"shard ticket {k} launched {counts}")
        for f in ("entry_idx", "query_idx", "t_enter", "t_exit"):
            check(np.array_equal(np.concatenate(
                [getattr(s.result, f) for s in delivered]),
                getattr(res, f)), f"shard ticket {k}: slices' {f}")
        check(all(s.num_syncs <= 2 for s in delivered),
              f"shard ticket {k}: a slice took more than 2 syncs")
        rt = t.routing
        check(rt is not None and rt.num_pods == SHARD_PODS
              and rt.batches == len(t.plan.batches)
              and int(rt.pod_hits.sum()) == len(res),
              f"shard ticket {k}: routing {rt}")
        parts.append((res, idx))
        report.append({"ticket": k, "wall_s": wall, "hits": len(res),
                       "groups": t.num_groups, "launches": counts,
                       "routing": {"batches": rt.batches,
                                   "mean_pods_per_batch":
                                   rt.mean_pods_per_batch,
                                   "pods_skipped": rt.pods_skipped,
                                   "pod_hits": rt.pod_hits.tolist()}})
    err = same_rows(union_rows(parts), shard_res,
                    "shard tickets vs phase shard")

    qk = tickets[1][0]
    plan = faults.FaultPlan([faults.FaultSpec("shard.pod", "pod_dropout",
                                              times=1)])
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    faults.arm(plan)
    try:
        t = broker.submit(qk, d)
        res = t.result()
    finally:
        faults.disarm()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fallback = {n: c for n, c in launches().items() if c}
    steps = [(g.stage, g.before, g.after) for g in t.health.degradations]
    check(steps == [("route", "shard", "single-device")] and res.degraded,
          f"dropped pod: degradations {steps}")
    check(len(plan.events) == 1, "the dropout fired other than once")
    check(fallback.get("distthresh_dense", 0) > 0
          and set(fallback) <= {"distthresh_dense", "distthresh_compact"},
          f"re-routed ticket launched {fallback}")
    route_err = same_rows(res, parts[1][0], "re-routed ticket 2")
    emit({"phase": "shard_serve", "scenario": "S1", "scale": 1.0,
          "pods": SHARD_PODS, "tickets": report,
          "max_abs_err_vs_shard": err,
          "rerouted_ticket": {"wall_s": wall, "degradations": steps,
                              "launches": fallback,
                              "max_abs_err_vs_clean": route_err},
          "card": card})
    return fallback


def shard_stream(db, base, card):
    """``query_stream(backend="shard")`` on 4 pods with the kernels, on
    phase stream's S1 at scale 0.3 database, against its rows."""
    q, d = db.scenario_queries, db.scenario_d
    pol = db.policy.with_(shard_pods=SHARD_PODS, shard_use_kernel=True)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, st = db.query_stream(q, d, backend="shard", policy=pol)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: c for n, c in launches().items() if c}
    check(set(counts) == {"distthresh_compact"},
          f"shard stream launched {counts}")
    rt = st.routing
    check(rt is not None and rt.num_pods == SHARD_PODS
          and rt.batches >= res.plan.num_batches,
          f"shard stream routing {rt}")
    err = same_rows(res, base, "shard query_stream vs kernel query")
    emit({"phase": "shard_stream", "scenario": "S1", "scale": 0.3,
          "pods": SHARD_PODS, "wall_s": wall, "hits": len(res),
          "groups": st.groups, "reissued": st.reissued,
          "launches": counts,
          "routing": {"batches": rt.batches, "pods_skipped":
                      rt.pods_skipped, "hit_balance": rt.hit_balance},
          "max_abs_err_vs_kernel": err, "card": card})


#: S1 scale of the R-tree phase: the R-tree's Python search walk makes
#: scale 1.0 (10^6 segments, 40,000 query segments) take hours; 0.1 is
#: the largest of 1.0 / 0.3 / 0.1 whose two runs fit about two minutes.
RTREE_SCALE = 0.1


def host_cpu() -> str:
    """The host CPU where the R-tree backend runs: ``/proc/cpuinfo``'s
    model name with its vendor, family and model numbers (a virtualized
    host may report the name as unknown), else ``lscpu``'s, else
    ``platform``'s."""
    import platform
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    if info.get("model name"):
        return (f"{info['model name']} ({info.get('vendor_id', '?')}, "
                f"family {info.get('cpu family', '?')}, model "
                f"{info.get('model', '?')}, stepping "
                f"{info.get('stepping', '?')})")
    if shutil.which("lscpu"):
        out = subprocess.run(["lscpu"], capture_output=True,
                             text=True).stdout
        for line in out.splitlines():
            if line.split(":")[0].strip() == "Model name":
                return line.split(":", 1)[1].strip()
    return platform.processor() or platform.machine() or "unknown"


def rtree_path(dev, card):
    """S1 at ``RTREE_SCALE`` through ``backend="rtree"`` (the paper's §7.3
    CPU baseline, on the host) with 1 thread and with the host's cores
    (at most 16), each against ``backend="kernel"`` on the card: the
    paper's GPU-versus-R-tree speedup on this machine."""
    from repro_torch.api import TrajectoryDB
    db = TrajectoryDB.from_scenario("S1", scale=RTREE_SCALE, device=dev)
    timed_query(db, "kernel")                       # warm, untimed
    kres, kwall, _ = kernel_path(db, "S1 rtree-scale kernel",
                                 {"distthresh_compact"})
    threads = min(os.cpu_count() or 1, 16)
    runs = []
    for n in sorted({1, threads}):
        reset_launches()
        res, wall = timed_query(db, "rtree",
                                policy=db.policy.with_(rtree_threads=n))
        check(not any(launches().values()), "the R-tree launched a kernel")
        err = same_rows(res, kres, f"rtree ({n} threads) vs kernel")
        runs.append({"threads": n, "wall_s": wall, "hits": len(res),
                     "speedup_kernel_vs_rtree": wall / kwall,
                     "max_abs_err_vs_kernel": err})
    emit({"phase": "rtree", "scenario": "S1", "scale": RTREE_SCALE,
          "entry_segments": len(db), "query_segments":
          len(db.scenario_queries), "kernel_wall_s": kwall,
          "kernel_plan_s": kres.stats.plan_seconds, "runs": runs,
          "host_cpu": host_cpu(), "host_cores": os.cpu_count(),
          "card": card})


# ----------------------------------------------------------------------
# LLM serving: granite-3-2b at full width and depth.
# ----------------------------------------------------------------------
LLM_ARCH, LLM_PROMPTS, LLM_NEW_TOKENS = "granite-3-2b", 8, 32


def llm_path(dev, card):
    """``ServeEngine.generate`` on granite-3-2b (40 layers, bf16, random
    weights from a seeded generator on the card), run twice; then one
    prefill and the decode steps timed on their own, and the prefill's
    last logits with the plain attention patched in.  Returns the flash
    launches of the first run and the prefill's flash-kernel shape."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import flashattn as fa
    from repro_torch.models import attention
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine
    cfg = ARCHS[LLM_ARCH]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = T.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    norm_scales = (2 * cfg.num_layers + 1) * cfg.d_model
    check(n_params - norm_scales == cfg.param_count(),
          f"{n_params} parameters, {norm_scales} of them norm scales, "
          f"against param_count() {cfg.param_count()}")

    rng = np.random.default_rng(0)
    lens = rng.integers(64, 1001, LLM_PROMPTS)
    lens[0] = 1000                              # bucket 1024
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]
    s = engine._bucket(int(lens.max()))
    check(s == 1024, f"bucket {s}")
    eng = engine.ServeEngine(cfg, model, max_len=s + LLM_NEW_TOKENS,
                             device=dev)
    walls, outs = [], []
    for _ in range(2):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(eng.generate(prompts, LLM_NEW_TOKENS))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = {n: c for n, c in launches().items() if c}
        check(counts == {"flashattn": cfg.num_layers},
              f"generate launched {counts}; one flashattn per layer of "
              f"the prefill and none in decode belong to it")
        if len(walls) == 1:
            gen_counts = counts
    check(outs[0] == outs[1], "generate is not deterministic")
    for p, o in zip(prompts, outs[0]):
        check(o[:len(p)] == p and len(o) == len(p) + LLM_NEW_TOKENS,
              "generate: prompt or length")
        check(all(0 <= t < cfg.vocab_size for t in o[len(p):]),
              "generate: a token outside the vocabulary")

    # The prefill and the decode steps on their own, counted on their own.
    toks = np.full((len(prompts), s), 0, np.int64)
    for i, p in enumerate(prompts):
        toks[i, s - len(p):] = p
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    with torch.inference_mode():
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = T.prefill(cfg, model, batch,
                                  max_len=s + LLM_NEW_TOKENS, last_only=True)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_launches = launches()["flashattn"]
        check(prefill_launches == cfg.num_layers,
              f"prefill launched flashattn {prefill_launches} times")
        last = logits[:, -1]
        nxt = torch.argmax(last, dim=-1)
        check(nxt.cpu().tolist() == [o[len(p)] for p, o in
                                     zip(prompts, outs[0])],
              "prefill's first token differs from generate's")
        reset_launches()
        t0 = time.perf_counter()
        for i in range(LLM_NEW_TOKENS):
            step, cache = T.decode_step(cfg, model, cache, nxt, s + i)
            nxt = torch.argmax(step, dim=-1)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        check(not any(launches().values()), "decode launched a kernel")
        # One more decode step and one prefill under the profiler: device
        # busy share and device work per call.
        _, step_wall, step_busy, step_events, step_top = profiled(
            lambda: T.decode_step(cfg, model, cache, nxt,
                                  s + LLM_NEW_TOKENS - 1))
        _, pre_wall, pre_busy, pre_events, pre_top = profiled(
            lambda: T.prefill(cfg, model, batch, max_len=s, last_only=True))

        # The same prefill with the plain attention in the model.
        try:
            attention.flashattn = fa.flashattn_plain
            plain_logits, _ = T.prefill(cfg, model, batch, max_len=s,
                                        last_only=True)
        finally:
            attention.flashattn = fa.flashattn
        diff = float((plain_logits[:, -1] - last).abs().max())
        agree = int((plain_logits[:, -1].argmax(-1) ==
                     last.argmax(-1)).sum())
    check(torch.isfinite(last).all().item(), "non-finite logits")
    check(diff <= LLM_LOGIT_ATOL, f"prefill logits: kernel vs plain "
          f"{diff} > {LLM_LOGIT_ATOL}")
    check(agree == len(prompts), f"prefill argmax: kernel and plain agree "
          f"on {agree} of {len(prompts)} prompts")
    b, kvh = len(prompts), cfg.num_kv_heads
    g = cfg.num_heads // kvh
    emit({"phase": "llm", "arch": LLM_ARCH, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "dtype": cfg.dtype,
          "parameters": n_params, "param_count": cfg.param_count(),
          "init_s": init_s, "prompts": len(prompts),
          "prompt_tokens": [int(n) for n in lens], "bucket": s,
          "new_tokens": LLM_NEW_TOKENS, "generate_wall_s": walls,
          "prefill_s": prefill_s,
          "prefill_tokens_per_s": b * s / prefill_s,
          "decode_s": decode_s,
          "decode_tokens_per_s": b * LLM_NEW_TOKENS / decode_s,
          "profile": {
              "decode_step": {"wall_s": step_wall, "device_busy_s":
                              step_busy, "device_busy_share":
                              step_busy / step_wall, "device_events":
                              step_events, "device_us_by_name": step_top},
              "prefill": {"wall_s": pre_wall, "device_busy_s": pre_busy,
                          "device_busy_share": pre_busy / pre_wall,
                          "device_events": pre_events,
                          "device_us_by_name": pre_top}},
          "launches_generate": gen_counts,
          "launches_per_prefill": prefill_launches,
          "launches_per_decode_step": 0,
          "logits_max_abs_diff_vs_plain": diff,
          "logits_atol": LLM_LOGIT_ATOL,
          "argmax_agree": f"{agree}/{b}",
          "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
          "card": card})
    shape = dict(bh=b * kvh * g, bkv=b * kvh, s=s, t=s,
                 hd=cfg.resolved_head_dim, g=g, kv_heads=kvh,
                 dtype=T._dtype(cfg))
    return gen_counts["flashattn"], shape


# ----------------------------------------------------------------------
# Kernel timing at the main path's shapes.
# ----------------------------------------------------------------------
def graph_ms(fn, iters: int = 20, reps: int = 3) -> float:
    """Device milliseconds per ``fn()`` call: ``iters`` calls captured in
    one CUDA graph, replayed ``reps`` times; the best replay counts."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    best = float("inf")
    for _ in range(reps):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        t0.record()
        g.replay()
        t1.record()
        t1.synchronize()
        best = min(best, t0.elapsed_time(t1) / iters)
    return best


def event_ms(fn, iters: int = 5) -> float:
    """Milliseconds per ``fn()`` call between two CUDA events (for the
    plain versions, which synchronize and cannot be graph-captured)."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def pair_work(e, qt, tiles=None, cb=256, qb=256):
    """(pairs, temporally overlapping pairs) the data needs evaluated;
    ``tiles`` (ntc, ntq) bool restricts both to live tiles."""
    lo = torch.maximum(e[:, 6][:, None], qt[6][None, :])
    hi = torch.minimum(e[:, 7][:, None], qt[7][None, :])
    mask = torch.ones_like(lo, dtype=torch.bool)
    if tiles is not None:
        mask = tiles.repeat_interleave(cb, 0)[:e.shape[0]].repeat_interleave(
            qb, 1)[:, :qt.shape[1]]
    return int(mask.sum()), int(((lo <= hi) & mask).sum())


def bound(nbytes: float, ops: float, peak_ops: float = PEAK_F32):
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def batch_inputs(db, pruning, accept=None):
    """The largest dispatch of ``db``'s plan under ``pruning`` (the first
    by interactions that ``accept(entries, queries)`` takes): host slices
    and resident device slices, as the engine passes them."""
    pol = db.policy.with_(pruning=pruning)
    queries = db._sorted(db.scenario_queries)[0].packed()
    plan = db.plan(db.scenario_queries, pol, d=db.scenario_d)
    eng = db.engine("kernel", pol)
    perm = pruning == "hierarchical"
    packed = eng._packed_perm if perm else eng._packed
    packed_dev = eng._packed_perm_dev if perm else eng._packed_dev
    for b in sorted(plan.batches, key=lambda x: -x.num_ints):
        cf, cl = b.cand_first, b.cand_last + 1
        q_np = queries[b.q_first:b.q_last + 1]
        if b.num_candidates and (accept is None or accept(packed[cf:cl],
                                                          q_np)):
            qt = torch.from_numpy(q_np).to(db.device).T.contiguous()
            return packed[cf:cl], q_np, packed_dev[cf:cl], qt
    raise AssertionError(f"no dispatch of the {pruning} plan qualifies")


def kernel_timing(dev, s1, c3, counts, card):
    """Each kernel timed on the largest dispatch of the path its launches
    were counted on: ``counts[name] = (label, launches)``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import distthresh as dt
    from repro_torch.kernels import ops
    table = []
    d = np.float32(s1.scenario_d)
    e_np, q_np, e, qt = batch_inputs(s1, "spatial")
    c, q = e.shape[0], qt.shape[1]

    def row(name, shape, err, ms, plain_ms, b, **extra):
        label, n = counts[name]
        return {"name": name, "route": "cuda", "source": source(name),
                "replaces": REPLACES[name], "launches": n,
                "launches_counted_on": label, "shape": shape, **extra,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b[0], "bound_by": b[1], "library_ms": None}

    # distthresh_compact and its row-loop twin, on the main path's largest
    # dispatch.
    prep = ops._host_tile_prune(e_np, q_np, d, 256, 256)
    arm = {} if prep is None else dict(
        e_mbr=torch.from_numpy(prep[0]).to(dev),
        q_mbr=torch.from_numpy(prep[1]).to(dev), d_prune=prep[2])
    tiles = None
    if prep is not None:
        tiles = dt._tile_mbr_live(arm["e_mbr"], arm["q_mbr"], prep[2])
    pairs, overlap = pair_work(e, qt, tiles)
    for append, name in (("chunk", "distthresh_compact"),
                         ("rowloop", "distthresh_compact_rowloop")):
        plain_fn = getattr(dt, name + "_plain")
        plain = plain_fn(e, qt, d, capacity=1 << 20, **arm)
        hits = int(plain[4])
        cap = max(hits, 1)
        k = dt.distthresh_compact(e, qt, d, capacity=cap, append=append,
                                  device=dev, **arm)
        err = compare_compact(k, plain, cap, f"timing {name}")
        table.append(row(
            name, [c, q], err,
            graph_ms(lambda: dt.distthresh_compact(
                e, qt, d, capacity=cap, append=append, device=dev, **arm)),
            event_ms(lambda: plain_fn(e, qt, d, capacity=cap, **arm)),
            bound(32 * (c + q) + 16 * hits + 8,
                  OPS_PER_PAIR * pairs + OPS_PER_OVERLAP * overlap),
            armed=bool(arm),
            grid_blocks=-(-c // 256) * -(-q // 256) * blocks_per_tile(
                c, q, append)))

    # distthresh_dense, on the same dispatch: S1's dense path plans the
    # same batches.
    kd = dt.distthresh_dense(e, qt, d, device=dev)
    pd = dt.distthresh_dense_plain(e, qt, d)
    check(torch.equal(kd[2], pd[2]), "timing dense: hit masks differ")
    err = max(float((kd[0] - pd[0]).abs().max()),
              float((kd[1] - pd[1]).abs().max()))
    pairs, overlap = pair_work(e, qt)
    table.append(row(
        "distthresh_dense", [c, q], err,
        graph_ms(lambda: dt.distthresh_dense(e, qt, d, device=dev)),
        event_ms(lambda: dt.distthresh_dense_plain(e, qt, d)),
        bound(32 * (c + q) + 9 * c * q,
              OPS_PER_PAIR * pairs + OPS_PER_OVERLAP * overlap),
        grid_blocks=_build.load().distthresh_dense_blocks(c, q)))

    # distthresh_compact_live and its row-loop twin, on the largest C3
    # hierarchical dispatch that launches them (one with dead tiles and at
    # least one live tile).
    d3 = np.float32(c3.scenario_d)

    def has_live(e_np, q_np):
        live = ops._host_live_tiles(e_np, q_np, d3, 256, 256)
        return live is not None and int(live[2][0]) > 0
    e_np, q_np, e, qt = batch_inputs(c3, "hierarchical", has_live)
    c, q = e.shape[0], qt.shape[1]
    live = ops._host_live_tiles(e_np, q_np, d3, 256, 256)
    lists = [torch.from_numpy(x).to(dev) for x in live[:3]]
    n_live = int(live[2][0])
    ntc, ntq = -(-c // 256), -(-q // 256)
    tiles = torch.zeros((ntc, ntq), dtype=torch.bool, device=dev)
    tiles[lists[0][:n_live].long(), lists[1][:n_live].long()] = True
    pairs, overlap = pair_work(e, qt, tiles)
    for append, name in (("chunk", "distthresh_compact_live"),
                         ("rowloop", "distthresh_compact_live_rowloop")):
        plain_fn = getattr(dt, name + "_plain")
        plain = plain_fn(e, qt, d3, *lists, capacity=1 << 20)
        hits = int(plain[4])
        cap = max(hits, 1)
        k = dt.distthresh_compact_live(e, qt, d3, *lists, capacity=cap,
                                       append=append, device=dev)
        err = compare_compact(k, plain, cap, f"timing {name}")
        table.append(row(
            name, [c, q], err,
            graph_ms(lambda: dt.distthresh_compact_live(
                e, qt, d3, *lists, capacity=cap, append=append,
                device=dev)),
            event_ms(lambda: plain_fn(e, qt, d3, *lists, capacity=cap)),
            bound(32 * (c + q) + 8 * len(live[0]) + 16 * hits + 4,
                  OPS_PER_PAIR * pairs + OPS_PER_OVERLAP * overlap),
            live_tiles=n_live,
            grid_blocks=len(live[0]) * blocks_per_tile(c, q, append)))
    emit({"phase": "timing", "card": card,
          "note": "ms: device time per wrapper call (its output fills "
                  "included), CUDA graph; plain_ms: CUDA events; "
                  "library_ms: no single PyTorch call computes the join; "
                  "for flashattn, scaled_dot_product_attention in a CUDA "
                  "graph"})
    return table


def flash_timing(dev, shape, n_launches, dtype=None):
    """The flash kernel at the llm phase's prefill shape (seeded normal
    inputs), in the model's dtype or ``dtype``: kernel, plain version and
    ``scaled_dot_product_attention`` on the same tensors (SDPA is the
    yardstick only; the port never calls it)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flashattn as fa
    gen = torch.Generator(device=dev).manual_seed(7)
    bh, bkv, s, t, hd, g = (shape[k] for k in ("bh", "bkv", "s", "t", "hd",
                                                "g"))
    dtype = dtype or shape["dtype"]
    q = torch.randn((bh, s, hd), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((bkv, t, hd), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    err = flash_close(fa.flashattn(q, k, v, g=g),
                      fa.flashattn_plain(q, k, v, g=g), v, g, dtype)
    # SDPA layout: (batch, heads, S, hd) with KV heads grouped; the
    # kernel's bh = (b·KVH + kvh)·g + j is head kvh·g + j of batch b.
    # Its is_causal mask is aligned to the first key, the kernel's to the
    # last: the two agree where S = T, as at the prefill.
    check(s == t, f"S={s} != T={t}")
    n_kv = shape["kv_heads"]
    lib_q = q.view(bkv // n_kv, n_kv * g, s, hd)
    lib_k, lib_v = (x.view(bkv // n_kv, n_kv, t, hd) for x in (k, v))
    lib = F.scaled_dot_product_attention(lib_q, lib_k, lib_v, is_causal=True,
                                         enable_gqa=True)
    # SDPA rounds its probabilities to bf16 before the value product, so
    # it is held to the same function only loosely (a wrong layout would
    # miss by the outputs' own size).
    lib_err = float((lib.reshape(bh, s, hd).float() -
                     fa.flashattn_plain(q, k, v, g=g).float()).abs().max())
    check(lib_err <= LIBRARY_ATOL, f"SDPA vs plain: {lib_err}")
    ms = graph_ms(lambda: fa.flashattn(q, k, v, g=g))
    plain_ms = event_ms(lambda: fa.flashattn_plain(q, k, v, g=g))
    library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        lib_q, lib_k, lib_v, is_causal=True, enable_gqa=True))
    # Work this call needs: each query row i (at key position t - s + i)
    # meets t - s + i + 1 keys; 2·hd flops for the score and 2·hd for the
    # value product per (row, key) pair.
    pairs = bh * sum(t - s + i + 1 for i in range(s))
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    b_ms, b_by = bound(nbytes, 4 * hd * pairs,
                       PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32)
    return {"name": "flashattn", "route": "cuda",
            "source": source("flashattn"), "replaces": REPLACES["flashattn"],
            "launches": n_launches, "launches_counted_on":
            f"{LLM_ARCH} ServeEngine.generate ({LLM_PROMPTS} prompts, "
            f"bucket {s}, {LLM_NEW_TOKENS} new tokens)",
            "shape": {"bh": bh, "bkv": bkv, "s": s, "t": t, "hd": hd,
                      "dtype": str(dtype)},
            "max_abs_err": err, "library_max_abs_err": lib_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    emit({"phase": "device", "torch_device": torch.cuda.get_device_name(0),
          "nvidia_smi": card, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    build_s = time.perf_counter() - t0
    sass = sass_counts(lib)
    if sass is not None:
        wg = {k: v for k, v in sass.items() if "wgmma" in k}
        check(len(wg) == 4 and all(v["HGMMA"] and v["UTMALDG"]
                                   for v in wg.values()),
              f"bf16 flash kernels without HGMMA or UTMALDG: {wg}")
    emit({"phase": "build", "seconds": build_s,
          "nvcc_seconds": _build.build_seconds,
          "built": list(REPLACES), "ptxas": {
              src: ptxas_summary(log)
              for src, log in _build.build_log.items()},
          "sass": sass if sass is not None else
          "null: the toolkit has no cuobjdump"})

    t0 = time.perf_counter()
    checks = kernel_checks(dev)
    flash = flash_checks(dev)
    checks["max_abs_err"]["flashattn"] = flash.pop("max_abs_err")
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0,
          "rtol": K_RTOL, "atol": K_ATOL, **checks, "flashattn": flash})

    (s1, main_res, main_wall, main_counts, dense_res,
     dense_counts) = main_path(dev, card)
    profile_main(s1, main_res, card)
    profile_main(s1, dense_res, card, "dense")
    shard_res, shard_pol, shard_counts = shard_path(s1, main_res, main_wall,
                                                    card)
    dbs, path_counts, mode_results = mode_matrix(dev, card)
    shard_mode_counts = shard_modes(dbs, mode_results, card)
    rtree_path(dev, card)
    ladder_counts, tickets = serve_path(s1, main_res, card)
    profile_ticket2(s1, card)
    route_counts = shard_serve(s1, shard_res, shard_pol, card)
    fit_path(s1, tickets, card)
    stream_db, stream_base = stream_path(dev, card)
    shard_stream(stream_db, stream_base, card)
    flash_launches, flash_shape = llm_path(dev, card)
    c3_live = path_counts[("C3", "hierarchical/fused")]
    c3_live_rowloop = path_counts[("C3", "hierarchical/fused_rowloop")]
    counts = {
        "distthresh_compact": ("S1 scale 1.0, default policy (main path)",
                               main_counts["distthresh_compact"]),
        "distthresh_dense": ("S1 scale 1.0, compaction='dense'",
                             dense_counts["distthresh_dense"]),
        "distthresh_compact_live": (
            "C3 scale 0.1, pruning='hierarchical', compaction='fused'",
            c3_live["distthresh_compact_live"]),
        "distthresh_compact_rowloop": (
            "S1 scale 1.0, serve ticket 2 after the ladder's step to "
            "kernel/fused_rowloop",
            ladder_counts["distthresh_compact_rowloop"]),
        "distthresh_compact_live_rowloop": (
            "C3 scale 0.1, pruning='hierarchical', "
            "compaction='fused_rowloop'",
            c3_live_rowloop["distthresh_compact_live_rowloop"])}
    by_name = {r["name"]: r for r in kernel_timing(dev, s1, dbs["C3"],
                                                     counts, card)}
    by_name["flashattn"] = flash_timing(dev, flash_shape, flash_launches)
    # The float32 flash kernel at the same shape: the kernel float32 inputs
    # run (no model of the main path is float32, so it has no launches
    # there and no row of its own in the table).
    f32 = flash_timing(dev, flash_shape, 0, torch.float32)
    f32["launches_counted_on"] = ("none: the llm phase runs bf16; float32 "
                                  "inputs run this kernel (phase kernels)")
    emit({"phase": "timing_flash_f32", **f32, "card": card})
    # The shard paths' launches of each kernel, each path's counters set
    # to 0 just before it and read just after.
    shard_launches = {
        "distthresh_compact": {
            f"S1 scale 1.0 shard, {k}": n for k, n in shard_counts.items()},
        "distthresh_dense": {
            "S1 scale 1.0 shard serve, ticket 2 re-routed after a pod "
            "dropout": route_counts.get("distthresh_dense", 0),
            f"C1 scale 0.1 shard {SHARD_PODS} pods, dense":
            shard_mode_counts[("C1", "none/dense")].get(
                "distthresh_dense", 0)},
        "distthresh_compact_live": {
            f"C3 scale 0.1 shard {SHARD_PODS} pods, hierarchical/fused":
            shard_mode_counts[("C3", "hierarchical/fused")].get(
                "distthresh_compact_live", 0)},
        "distthresh_compact_rowloop": {
            f"C1 scale 0.1 shard {SHARD_PODS} pods, spatial/fused_rowloop":
            shard_mode_counts[("C1", "spatial/fused_rowloop")].get(
                "distthresh_compact_rowloop", 0)},
        "distthresh_compact_live_rowloop": {
            f"C3 scale 0.1 shard {SHARD_PODS} pods, "
            "hierarchical/fused_rowloop":
            shard_mode_counts[("C3", "hierarchical/fused_rowloop")].get(
                "distthresh_compact_live_rowloop", 0)},
        "flashattn": {}}
    for name, paths in shard_launches.items():
        by_name[name]["launches_shard"] = paths
    table = [by_name[name] for name in REPLACES]
    torch.cuda.synchronize()

    emit({"kernels": table})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
