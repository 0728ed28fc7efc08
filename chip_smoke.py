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
   instructions (every flash instantiation, bf16 and float32, the
   forward's and the backward's dK/dV and dQ kernels, must have both;
   null where the toolkit has no ``cuobjdump``); the flash
   instantiations' registers and spills are printed apart (no bf16
   backward kernel may spill at hd 64).
   Then phase lint: ``python -m repro_torch.lint src/repro_torch
   --format=json`` must report 0 errors, KERN101 reading the very ``.cu``
   sources just built (each ``extern "C"`` function matched to its
   ``_build.SIGNATURES`` argtypes).
3. kernels — each kernel against its plain PyTorch version on the card.
   The flash kernels (``FLASH_TOL``): head dims 16/32/64/112/128, g 1,
   2 and 4, S = T = 77 and 1,000, S = 45 < T = 333, float32 (three
   TF32 products per product) and bf16, bf16 at the prefill shapes of
   the four llm phases (granite hd 64, g 4; qwen3 hd 128, g 8; musicgen
   hd 64, g 1; zamba2-7b hd 112, g 1; S = T = 1,024) and at granite's
   training shape under KV-head replication (BKV 128, g 2), and float32
   at granite's prefill shape.  The flash backward (``BWD_TOL``) against
   the plain backward on the kernel forward's o and lse, at the same
   head dims, g, lengths and dtypes and at granite-3-2b's training
   shapes (BH 256, g 4 and, under replication, g 2; S = T = 1,024, hd
   64; bf16, and float32 at g 4); the worst |diff| / tolerance per dtype,
   forward and backward; the forward's lse against the plain loop's
   (``LSE_ATOL``); a second backward call bit-identical; a ``do`` that
   starts one element past an aligned address (bf16 and float32)
   refused with ``ValueError`` (the TMA copies).  The
   distance kernels: on seeded random tiles with the degenerate cases
   (zero-length extent, zero relative velocity, tangent roots, disjoint
   intervals), at 256×256,
   64×32, 40×24 and 32×320 tiles (the row-loop kernels' register and
   recompute slots), with ample and overflowing capacity; the compact
   kernels' blocks (``BLOCK_CASES``, chunk sub-tiles and row-loop row
   blocks: S1's largest batch shape, ragged tiles, a last tile shorter
   than one block, an overflow inside a lone block, dead tiles armed);
   and the dense kernel on ``DENSE_CASES`` (Q > 256, one entry, one
   query, ragged row blocks, ``queries_t`` a column slice); the
   tile-prune preparation (``distthresh_tile_prep``) on the check tiles
   against the host helpers, and the block cases armed with its
   operands.  Hit sets,
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
   ``compaction="dense"`` (phase main_dense); then phase prep:
   ``distthresh_tile_prep`` against the host helpers (``d_prune`` bit for
   bit, the boxes bit for bit but for the sign of a zero) on every
   dispatched slice of S1 (10 query trajectories under the default
   policy, all 100 at periodic s = 64), of S10 at scale 1.0 (10 query
   trajectories) and of phase properties' near-tangent cases, at float32
   and float64 d (``python3 chip_smoke.py --prep`` builds the kernels and
   runs the distance kernels' checks and this phase alone); then one warm
   execution of the main path's plan under ``torch.profiler`` (device
   busy share, device time by kernel), and one of the dense path's
   (profile_dense).
   The profiles execute the plans phase main ran.  Then phase shard:
   the same S1 query through ``backend="shard"`` with the kernels on the
   default devices (one pod on the card), its plan once more through a
   ``PodRouter``, and the same plan on 4 pods sharing the card with
   sparse dispatch; each equal to phase main's rows, launching only
   ``distthresh_compact`` once per live pod per dispatch, with ≤ 2 syncs
   per group, no duplicate pair and ``RoutingStats`` covering every
   batch; the 1-pod plan once more under ``torch.profiler`` (busy
   share).  Then phase sentinel: the plans phases main and shard made
   run once more under ``repro_torch.lint.sentinel.SyncSentinel`` (S1
   main, S1 dense — also once with the dense path's blocking scalar
   upload as it was before the sentinel found it — shard 1 pod, and 4
   pods through a ``PodRouter``), one line each: the sentinel's fence
   waits equal to the executors' ``num_syncs`` (≤ 2 per group), no
   blocking read, no unfenced read of a staged copy, no synchronize
   outside a fence, and the ATen sync warnings with their source lines;
   then the positive controls (a read behind a 50 ms spin blocks once
   and is blamed on its group scope; a staged copy read before its
   fence is one unfenced read; ``torch.nonzero`` is an ATen sync).  The
   serve tickets and the stream below run under the sentinel too, each
   with a line of its own.
5. modes   — C1 and C3 at scale 0.1 (C3 as the README configures it),
   pruning none/spatial/hierarchical × compaction
   fused/fused_rowloop/dense, all equal to the torch backend and the
   row-loop rows identical to the fused rows; then S2 at scale 0.02
   against ``backend="brute"``.  Then phase shard_modes: the same C1 and
   C3 matrix through ``backend="shard"`` on 4 pods, equal to the
   single-device rows of each mode, sparse dispatch on and off
   byte-identical (C3 hierarchical launches ``distthresh_compact_live``).
   Phase properties (between the two): ``PROP_CASES`` seeded databases
   (``property_inputs``: random, clustered and near-tangent families of
   2,000-20,000 entry segments, 20-200 queries, d 0.2-12) through
   ``db.query(backend="kernel")``: the nine pruning × compaction modes,
   the six batching algorithms and ``backend="torch"`` byte-identical;
   every difference from a float64 host oracle inside its pair's own
   round-off band (``prune_limit`` at the pair's ``solve_scale``, the
   worst ratio reported); rows at d a subset of rows at
   1.5 d; every interval inside its common time; ``count`` exact at a
   capacity below the hits.  Over the sweep tiles must be pruned and
   every distance kernel launch, and with the tile test's slack removed
   the near-tangent family's rows must change (the negative control).
   ``python3 chip_smoke.py --property-case I`` builds the kernels and
   reruns case I alone.
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
   every prompt).  Then phase llm_moe: the granite model freed,
   qwen3-moe-30b-a3b at full width and depth (48 layers, 128 experts,
   top-8, ``qk_norm``, bf16, 61 GB of seeded random weights) through
   ``ServeEngine.generate`` on the same 8 prompt lengths, twice (equal
   tokens, 48 flash launches per prefill, none in decode); every
   layer's flash call held against the plain version on that layer's
   own q, k and v (``FLASH_TOL``); the prefill's last logits and top-k
   routes with the plain attention patched in, printed and not gated
   (one route flip moves a token's whole FFN); prefill and decode
   rates, one prefill and one decode step under ``torch.profiler``,
   the capacity and dropped assignments per layer, and the prefill and
   one decode step under ``SyncSentinel``: no ATen sync from
   ``models/moe.py``.  Then phase llm_embed: musicgen-large (48 layers,
   embedding inputs) through ``transformer.prefill`` on seeded
   embeddings (8 × 1,024) and 32 ``decode_step`` calls on seeded (8,
   2,048) embeddings, twice (equal logits, 48 flash launches per
   prefill, none per step), its last prefill logits within
   ``LLM_LOGIT_ATOL`` of the plain attention's with equal argmax.  Then
   phase llm_hybrid: zamba2-7b at full width and depth (81 Mamba2
   layers, d_model 3,584, ssm_state 64, one shared attention + MLP block
   after each of its 13 groups of 6, 32 heads of 112, bf16, seeded random
   weights) through ``ServeEngine.generate`` on the same prompts, twice
   (equal tokens, 13 flash launches per prefill, none per step); every
   shared-attention flash call held to ``FLASH_TOL`` on its own q, k and
   v; the last prefill logits' mean |Δ| from the plain attention's within
   ``HYBRID_SPREAD_FACTOR`` of a control's (the plain version with 1 % of
   its outputs moved one bf16 step: 81 layers carry any such step to the
   logits in full); a prefill and a decode step under
   ``SyncSentinel``: no ATen sync from ``models/ssm.py``.  Then phase
   llm_xlstm: xlstm-350m (24 layers: 3 groups of 7 mLSTM + 1 sLSTM, bf16)
   through ``generate`` twice (equal tokens, no kernel launch), its
   rates, and no ATen sync from ``models/xlstm.py`` or ``models/ssm.py``.
   Then phase llm_f32: granite-3-2b at full width and depth in float32
   (``dtype="float32"``, 10.1 GB of seeded random weights) through
   ``ServeEngine.generate`` on the same prompts with 8 new tokens (40
   launches of the three-TF32 flash kernel, none in decode), its last
   prefill logits within ``LLM_F32_LOGIT_ATOL`` of the plain attention's
   with equal argmax.
   Then phase train: granite-3-2b at full width and depth (40 layers,
   bf16, seeded random weights made on the card) through
   ``train.step.make_train_step`` (AdamW, ``TRAIN_OPT``, ``remat=True``)
   on ``TokenPipeline`` batches of 8 × 1,024: first the loss and gradient
   norm at the fresh weights with the flash kernels and with the plain
   attention patched into ``FlashAttention`` (``MB_RTOL``); four steps,
   each timed, its peak memory and its launches (80 flash forwards, 40 of
   each backward kernel) recorded; the loss falls (each later step's
   below the first's, and the first batch's after the four updates
   below its own before them); the fourth step again from the same
   state (copied to the host and back) at ``microbatches=2`` (loss and
   gradient norm within ``MB_RTOL``); one step under ``torch.profiler``
   (device time by kind of kernel), one under ``SyncSentinel`` (ATen
   syncs from ``train/`` and ``models/``) and one under
   ``roofline.opcount.CostCounter`` (the step's counted FLOPs, which
   must equal the dry run's below).  Phase train_checkpoint: the
   same model cut to 2 layers, two steps, a save, two more; the restored
   state through the same two steps: master weights equal bit for bit.
   Phase train_kvrep: the same model and state with ``kv_replication=2``
   (each of the 8 KV heads twice, so the kernels run at g 2): the loss
   and gradient norm at the fresh weights within ``MB_RTOL`` of r = 1's,
   one timed step with its peak memory, 80 flash forwards and 40 of each
   backward kernel, every one at g 2.  Phase train_mesh: a single-rank
   NCCL process group (a ``FileStore`` in a temporary directory: no
   network, no port) and a (1, 1) ``("data", "model")`` device mesh; the
   same state placed by ``launch.sharding.train_state_shardings`` and
   two timed steps of ``make_train_step(grad_specs=...)`` under
   ``shardctx.activation_sharding``: the first's loss and gradient norm
   within ``MB_RTOL`` of the unmeshed step from the same state and, as
   every redistribution on a 1 x 1 mesh is a no-op, bit-equal to it, the
   master weights too, the flash kernels launched through
   ``local_map``; at the 2-layer cut, ``save`` and ``restore(shardings=)``
   bit-equal with every leaf on the mesh; ``make_compressed_allreduce``
   over the one rank, both codecs, equal bit for bit to
   ``compress_leaf``'s dequantized payload.  Phase train_f32: granite-3-2b
   at full width and depth in float32 (parameters, gradients, m, v and
   master float32): the loss and gradient norm at the fresh weights with
   the flash kernels and with the plain attention (``F32_TRAIN_RTOL``),
   two timed AdamW steps (80 float32 flash forwards and 40 of each
   backward kernel a step, peak memory), batch 0's loss after them below
   its own before.  Then phase roofline, one
   line per LLM path timed above (the granite-3-2b, qwen3-moe-30b-a3b
   and zamba2-7b prefills, one granite decode step, the granite train
   step at 8 × 1,024): ``roofline.dry_run`` on the ``meta`` device at
   the shape the phase ran (FLOPs by dtype, bytes, collective bytes,
   the terms under ``roofline.HW`` and their bottleneck,
   ``model_flops`` and ``useful_flops_ratio``), the phase's median time
   in this process, ``roofline_share`` (the largest term, the compute
   term with each dtype's FLOPs at its own peak, over the median) and
   ``model_flops`` over the median × the bf16 peak; for the train step
   also the card count of the real step, whose FLOPs must equal the dry
   run's.
9. timing  — each kernel's time on the largest dispatch of the path its
   launches are counted on (CUDA graph of repeated wrapper calls, so host
   overhead is excluded), its plain version's time, and its bound on this
   card (``roofline.kernels``: the work's bytes and operations over the
   card's peaks); the row-loop kernels at the shapes of their chunk twins (the
   compact kernels with their grid's block count); the flash kernel at
   the llm phase's prefill shape, beside ``scaled_dot_product_attention``
   (``library_ms``, timed here only), and the bf16 flash kernel at
   qwen3's prefill shape (phase timing_flash_moe) and at zamba2-7b's (hd
   112, g 1; phase timing_flash_hybrid); the flash forward also with its
   lse written (``ms_with_lse``); the flash backward at granite-3-2b's
   training shape, beside the backward of
   ``scaled_dot_product_attention`` (its ``library_ms``, CUDA events);
   the float32 forward and backward at the same shapes in float32 (rows
   ``flashattn_f32`` and ``flashattn_bwd_f32``, launches counted on
   phases llm_f32 and train_f32).

Every ``backend="kernel"`` or ``"shard"`` run sets the launch counters
to 0 just before it and reads them just after (``kernel_path``,
``shard_query``, and per ticket in phases serve and shard_serve): it
fails unless the path's own kernel launched, no other kernel did, and
(on ``db.query``) the launches match the dispatches (for the shard
backend, the live pods' dispatches); ``distthresh_tile_prep`` must
launch once per compact launch on the spatial fused routes and never on
the others (``check_prep``).

Then the kernel table (``{"kernels": [...]}``), the ``nvidia-smi`` name
and power-limit line, and last ``{"ok": true, "device": {...}}``.  Any
failure raises: the script catches nothing and exits non-zero, also when
CUDA is absent or the repository's ``src/`` is not beside it.
"""
import contextlib
import dataclasses
import gc
import json
import linecache
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
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
#: The flash backward (dq, dk, dv) against its plain version on the card,
#: per dtype, as (rtol, frac): |a - b| <= rtol * max(|a|, |b|) + frac *
#: max|b| over the tensor.  Both compute in float32 from the same inputs
#: (the forward's o and lse included), with sums over up to T keys and g·S
#: query rows in another order: on the CPU the plain version's float32
#: result is within 1.1e-6 of max|grad| of a float64 one at these shapes,
#: so frac = 1e-5 leaves ten times that for two such sums.  bf16: each
#: side then rounds once to bf16, and values that straddle a rounding
#: boundary land one bf16 step apart, at most 2^-7 of their magnitude.
BWD_TOL = {torch.float32: (0.0, 1e-5), torch.bfloat16: (2.0 ** -7, 1e-5)}
#: The forward's lse (m + log l, float32) against the plain loop's: the
#: same float32 terms summed in another order (and, in bf16, scaled after
#: the product), about 1e-6 of lse's magnitude (under 15 here).
LSE_ATOL = 1e-4
#: The llm phase's last-position logits, kernel against plain version:
#: the two differ only where their float32 attention sums round to bf16
#: differently (one step, on a few outputs per layer), and 40 layers of
#: random-weight blocks carry that to the logits, whose magnitude is
#: about 2 here.  0.25 is an eighth of that; a wrong kernel (a wrong mask,
#: head or scale) moves them by the logits' own size.
LLM_LOGIT_ATOL = 0.25
#: zamba2-7b's 81 random-weight Mamba2 layers carry any difference in an
#: attention output to the last logits in full (measured on an H100 80GB
#: HBM3 at 700 W, PERF.md; logits' std 1.2): with the flash kernel, with
#: the kernel's bf16 rounding emulated in plain torch, and with the plain
#: version's outputs moved by one bf16 step at a seeded 1 % of them
#: (``one_step_flash``), the logits moved from the plain attention's by a
#: mean |Δ| of 0.305, 0.305 and 0.300-0.316 (max 2.5-2.9; argmax equal
#: on 2-4 of 8), against 0.015-0.019 at 12 layers.  So ``LLM_LOGIT_ATOL``
#: and argmax 8/8 cannot hold there; phase llm_hybrid instead runs that
#: one-step control in the same call and holds the kernel's mean |Δ| to
#: this factor of the control's.
#: A wrong kernel (mask, head or scale) decorrelates the logits: a mean
#: |Δ| of 2σ/√π ≈ 1.35, 4.5× the control's.
HYBRID_SPREAD_FACTOR = 2.0
#: ``scaled_dot_product_attention`` (timed as the flash kernel's
#: yardstick) against the plain version: a sanity bound that it computes
#: the same function on the same layout.
LIBRARY_ATOL = 2.0 ** -4

#: The TPU kernel (its ``pallas_call`` line) each CUDA kernel replaces;
#: the row-loop kernels replace the same calls with ``append="rowloop"``.
REPLACES = {
    "distthresh_dense": "src/repro/kernels/distthresh.py:242",
    "distthresh_compact": "src/repro/kernels/distthresh.py:640",
    "distthresh_compact_live": "src/repro/kernels/distthresh.py:782",
    "distthresh_compact_rowloop": "src/repro/kernels/distthresh.py:640",
    "distthresh_compact_live_rowloop": "src/repro/kernels/distthresh.py:782",
    "distthresh_tile_prep": "none: the reference builds these operands in "
                            "jnp (src/repro/kernels/ops.py:194-221)",
    "flashattn": "src/repro/kernels/flashattn.py:84",
}
#: The spatial route's tile-prune preparation: one launch before each
#: launch of the compact kernel it arms, counted apart from the distance
#: kernels (``check_prep``).
PREP = "distthresh_tile_prep"


def source(name: str) -> str:
    cu = "flashattn" if name.startswith("flashattn") else "distthresh"
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
#: products and the TMA tile loads of the flash kernels.
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


def host_armed(e_np, q_np, d, cand_blk: int, qry_blk: int, dev) -> dict:
    """The compact kernels' early-out operands from the host helpers, the
    threshold as a number: the wrapper's other ``d_prune`` form."""
    from repro_torch.core.index import dispatch_prune_threshold
    from repro_torch.kernels import ops
    return dict(
        e_mbr=torch.from_numpy(ops._host_tile_mbrs(e_np, cand_blk)).to(dev),
        q_mbr=torch.from_numpy(ops._host_tile_mbrs(q_np, qry_blk)).to(dev),
        d_prune=np.float32(dispatch_prune_threshold(d, e_np, q_np)))


def _zero_sign(a: np.ndarray) -> np.ndarray:
    """``a``'s bits with -0.0 read as +0.0 (the box test cannot tell
    them apart, and numpy's min and max do not fix which zero they keep)."""
    return np.where(a == 0, np.float32(0), a).view(np.uint32)


def prep_equal(e_np, q_np, e, qt, d, label, cand_blk=256,
               qry_blk=256) -> int:
    """``distthresh_tile_prep`` on the card against the host helpers on
    the same rows: ``d_prune`` bit for bit, the boxes bit for bit but for
    the sign of a zero.  Returns the box entries whose bits differ only in
    that sign."""
    from repro_torch.core.index import dispatch_prune_threshold
    from repro_torch.kernels import distthresh as dt
    from repro_torch.kernels import ops
    got = dt.distthresh_tile_prep(e, qt, d, cand_blk=cand_blk,
                                  qry_blk=qry_blk, device=e.device)
    want_d = np.float32(dispatch_prune_threshold(d, e_np, q_np))
    got_d = got[2].cpu().numpy()
    check(got_d.view(np.uint32) == want_d.view(np.uint32),
          f"{label}: d_prune {float(got_d)!r}, host {float(want_d)!r}")
    zeros = 0
    for g, want, what in ((got[0], ops._host_tile_mbrs(e_np, cand_blk),
                           "e_mbr"),
                          (got[1], ops._host_tile_mbrs(q_np, qry_blk),
                           "q_mbr")):
        g = g.cpu().numpy()
        check(g.shape == want.shape and np.array_equal(
            _zero_sign(g), _zero_sign(want)), f"{label}: {what} differs")
        zeros += int((g.view(np.uint32) != want.view(np.uint32)).sum())
    return zeros


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
        live = ops._host_live_tiles(e_np, q_np, d, cb, qb)
        check(live is not None, "check tiles leave nothing to prune")
        armed = host_armed(e_np, q_np, d, cb, qb, dev)
        prep_equal(e_np, q_np, e, qt, d, f"tile prep {cb}x{qb}", cb, qb)
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
        live = ops._host_live_tiles(e_np, q_np, d, cb, cb)
        check(live is not None or not need_dead, f"{c}x{q}: no dead tile")
        arms = [{}]
        if live is not None:
            # Armed with the device-built operands (a 0-dim d_prune).
            arms.append(dict(zip(("e_mbr", "q_mbr", "d_prune"),
                                 dt.distthresh_tile_prep(e, qt, d,
                                                         device=dev))))
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


def flash_over_tol(a, b, v, g: int, dtype) -> tuple[float, float]:
    """(max |a - b|, max |a - b| / tolerance) under ``FLASH_TOL``, after
    checking it (``v`` the values, ``g`` the query heads per KV head)."""
    rtol, atol, vtol = FLASH_TOL[dtype]
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    vmax = v.float().abs().amax(dim=(1, 2)).repeat_interleave(g)
    tol = (rtol * torch.maximum(a.abs(), b.abs()) + atol
           + vtol * vmax[:, None, None])
    check(torch.isfinite(a).all().item(), "flashattn: non-finite output")
    check((diff <= tol).all().item(),
          f"flashattn {dtype}: max |diff| {float(diff.max())}")
    return float(diff.max()), float((diff / tol).max())


def flash_close(a, b, v, g: int, dtype) -> float:
    """Max |a - b|, after checking ``FLASH_TOL``."""
    return flash_over_tol(a, b, v, g, dtype)[0]


#: The llm phases' prefill shapes for the flash kernel (8 prompts in the
#: 1024 bucket), as (BKV, g, S = T, hd): granite-3-2b (phase llm),
#: qwen3-moe-30b-a3b (llm_moe), musicgen-large (llm_embed) and
#: zamba2-7b's shared attention block (llm_hybrid).
SERVE_FLASH = (64, 4, 1024, 64)
MOE_FLASH = (32, 8, 1024, 128)
EMBED_FLASH = (256, 1, 1024, 64)
HYBRID_FLASH = (256, 1, 1024, 112)
#: granite-3-2b's training shape under KV-head replication r = 2 (phase
#: train_kvrep: 8 KV heads repeated twice, so 16 groups of 2 query heads).
KVREP_FLASH = (128, 2, 1024, 64)
#: Query heads per KV head in the small cases: 1 (MHA, zamba2-7b), 2
#: (granite-3-2b under r = 2), 4 (granite-3-2b).
FLASH_GROUPS = (1, 2, 4)


def flash_checks(dev) -> dict:
    """The flash kernel against its plain version on seeded normal
    inputs: every head dim, g 1, 2 and 4, S = T ragged, S < T windowed,
    float32 (the three-TF32 kernel) and bf16; bf16 at the four llm
    phases' prefill shapes and at granite-3-2b's training shape under
    KV-head replication (g 2), and float32 at granite's prefill shape;
    the worst |diff| / tolerance per dtype."""
    from repro_torch.kernels import flashattn as fa
    gen = torch.Generator(device=dev).manual_seed(2026)
    err = {str(dt): 0.0 for dt in FLASH_TOL}
    ratio = {str(dt): 0.0 for dt in FLASH_TOL}
    cases = 0

    def case(dtype, bkv, g, s, t, hd):
        q = torch.randn((bkv * g, s, hd), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((bkv, t, hd), generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        got = fa.flashattn(q, k, v, g=g)
        check(got.dtype == dtype and got.shape == q.shape,
              "flashattn: output dtype or shape")
        e, r = flash_over_tol(got, fa.flashattn_plain(q, k, v, g=g), v, g,
                              dtype)
        err[str(dtype)] = max(err[str(dtype)], e)
        ratio[str(dtype)] = max(ratio[str(dtype)], r)

    for dtype in (torch.float32, torch.bfloat16):
        for hd in fa.HEAD_DIMS:
            for g in FLASH_GROUPS:
                for s, t in ((77, 77), (1000, 1000), (45, 333)):
                    case(dtype, 2, g, s, t, hd)
                    cases += 1
    for bkv, g, s, hd in (SERVE_FLASH, MOE_FLASH, EMBED_FLASH,
                          HYBRID_FLASH, KVREP_FLASH):
        case(torch.bfloat16, bkv, g, s, s, hd)
        cases += 1
    bkv, g, s, hd = SERVE_FLASH
    case(torch.float32, bkv, g, s, s, hd)
    cases += 1
    torch.cuda.synchronize()
    return {"cases": cases, "max_abs_err": max(err.values()),
            "max_abs_err_by_dtype": err, "max_diff_over_tol_by_dtype": ratio,
            "tol": {str(k): v for k, v in FLASH_TOL.items()}}


#: granite-3-2b's training shape for the flash backward (phase train: 8 ×
#: 1,024 tokens), as (BKV, g, S = T, hd).
TRAIN_FLASH = (64, 4, 1024, 64)


def bwd_close(a, b, dtype, what: str) -> tuple[float, float]:
    """(max |a - b|, max |a - b| / tolerance) of one gradient, after
    checking ``BWD_TOL``."""
    rtol, frac = BWD_TOL[dtype]
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    tol = rtol * torch.maximum(a.abs(), b.abs()) + frac * b.abs().max()
    check(torch.isfinite(a).all().item(), f"flashattn_bwd: non-finite {what}")
    check((diff <= tol).all().item(),
          f"flashattn_bwd {dtype} {what}: max |diff| {float(diff.max())}, "
          f"max |plain| {float(b.abs().max())}")
    return float(diff.max()), float((diff / tol).max())


def flash_bwd_checks(dev) -> dict:
    """The flash backward kernels against the plain backward, and the
    forward's lse against the plain loop's, on seeded normal inputs: every
    head dim, g 1, 2 and 4, S = T = 77 and 1,000, S = 45 < T = 333,
    float32 and bf16, bf16 at granite-3-2b's training shape, with and
    without KV-head replication (g 4 and g 2), and float32 at that shape
    (g 4).  Both backwards take the kernel forward's o and lse; a second
    call must give the same bits; the worst |diff| / tolerance shows each
    dtype's margin.  Then a ``do`` view 2 (bf16) or 4 (float32) bytes past
    an aligned start must be refused."""
    from repro_torch.kernels import flashattn as fa
    gen = torch.Generator(device=dev).manual_seed(2027)
    err = {str(dt): 0.0 for dt in BWD_TOL}
    ratio = {str(dt): 0.0 for dt in BWD_TOL}
    lse_err = 0.0
    cases = 0

    def case(dtype, bkv, g, s, t, hd):
        nonlocal lse_err
        q, do = (torch.randn((bkv * g, s, hd), generator=gen, device=dev)
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn((bkv, t, hd), generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        o, lse = fa.flashattn_fwd(q, k, v, g=g)
        _, lse_plain = fa.flashattn_fwd_plain(q, k, v, g=g)
        e = float((lse - lse_plain).abs().max())
        check(e <= LSE_ATOL, f"flashattn lse {dtype} hd {hd}: {e}")
        lse_err = max(lse_err, e)
        got = fa.flashattn_bwd(q, k, v, o, lse, do, g=g)
        want = fa.flashattn_bwd_plain(q, k, v, o, lse, do, g=g)
        for a, b, what, x in zip(got, want, ("dq", "dk", "dv"), (q, k, v)):
            check(a.dtype == dtype and a.shape == x.shape,
                  f"flashattn_bwd {what}: dtype or shape")
            e, r = bwd_close(a, b, dtype, what)
            err[str(dtype)] = max(err[str(dtype)], e)
            ratio[str(dtype)] = max(ratio[str(dtype)], r)
        again = fa.flashattn_bwd(q, k, v, o, lse, do, g=g)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"flashattn_bwd {dtype} hd {hd} g {g}: a second call "
              f"differs")

    for dtype in (torch.float32, torch.bfloat16):
        for hd in fa.HEAD_DIMS:
            for g in FLASH_GROUPS:
                for s, t in ((77, 77), (1000, 1000), (45, 333)):
                    case(dtype, 2, g, s, t, hd)
                    cases += 1
    for bkv, g, s, hd in (TRAIN_FLASH, KVREP_FLASH):
        case(torch.bfloat16, bkv, g, s, s, hd)
        cases += 1
    bkv, g, s, hd = TRAIN_FLASH
    case(torch.float32, bkv, g, s, s, hd)
    cases += 1
    torch.cuda.synchronize()
    misaligned = {str(dt): misaligned_bwd_refused(dev, dt)
                  for dt in (torch.bfloat16, torch.float32)}
    return {"cases": cases, "max_abs_err": max(err.values()),
            "max_abs_err_by_dtype": err, "max_diff_over_tol_by_dtype": ratio,
            "lse_max_abs_err": lse_err, "lse_atol": LSE_ATOL,
            "repeat_bit_identical": True, "misaligned_refused": misaligned,
            "tol": {str(k): v for k, v in BWD_TOL.items()}}


def misaligned_bwd_refused(dev, dtype) -> str:
    """The backward on a ``do`` that is a contiguous view starting one
    element (2 bytes in bf16, 4 in float32) past an aligned address (as
    ``do.contiguous()`` of an offset view is): the wrapper must raise
    ``ValueError`` before any launch.  Returns the error's message."""
    from repro_torch.kernels import flashattn as fa
    from repro_torch.kernels._launch import LAUNCHES
    q, k, v = (torch.randn((2, 77, 64), device=dev).to(dtype)
               for _ in range(3))
    o, lse = fa.flashattn_fwd(q, k, v, g=1)
    do = torch.empty(q.numel() + 1, dtype=dtype, device=dev)[1:]
    do = do.view(q.shape).copy_(q)
    check(do.is_contiguous() and do.data_ptr() % 16 == q.element_size(),
          "the misaligned view is not what the check needs")
    before = dict(LAUNCHES)
    try:
        fa.flashattn_bwd(q, k, v, o, lse, do, g=1)
    except ValueError as e:
        check(LAUNCHES == before, "a refused backward counted a launch")
        return str(e)
    raise AssertionError(f"flashattn_bwd took a misaligned {dtype} do")


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
    """The distance and flash kernels' launch counters, without
    ``PREP``'s (``check_prep`` holds those to the armed launches)."""
    from repro_torch.kernels import distthresh as dt
    return {k: n for k, n in dt.LAUNCHES.items() if k != PREP}


def check_prep(label: str, pol, counts: dict) -> int:
    """The tile-prune preparation's launches since the counters were
    reset: one per launch of the compact kernels (``counts``) on the
    spatial fused routes, none on any other.  Returns them."""
    from repro_torch.kernels import distthresh as dt
    n = dt.LAUNCHES[PREP]
    spatial = pol.pruning == "spatial" and pol.compaction != "dense"
    want = sum(counts.values()) if spatial else 0
    check(n == want, f"{label}: {n} {PREP} launches for {want} armed "
          "launches")
    return n


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
    prep = check_prep(label, pol, counts)
    return res, wall, {**counts, PREP: prep} if prep else counts


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


def profiled(fn, by=None):
    """Run ``fn()`` once under ``torch.profiler`` and synchronize: (wall
    s, device busy s, device events, top device time by kernel / copy
    name; with ``by``, a kernel name → category function, the device time
    of every category and the top 12 names).  Busy is the union of the
    device intervals."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name, by_group = [], {}, {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        t_start, t_end = ev.time_range.start, ev.time_range.end
        spans.append((t_start, t_end))
        name = ev.name if len(ev.name) < 60 else ev.name[:57] + "..."
        for key, table in ((name, by_name),
                           (by(ev.name) if by else None, by_group)):
            if key is not None:
                n, us = table.get(key, (0, 0.0))
                table[key] = (n + 1, us + (t_end - t_start))
    check(spans, "the profiler recorded no device activity")
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):           # union of device intervals (us)
        if b > end:
            busy += b - max(a, end)
            end = b
    def ranked(table, n=None):
        return {k: {"n": c, "us": us} for k, (c, us) in sorted(
            table.items(), key=lambda kv: -kv[1][1])[:n]}
    top = ranked(by_name, 12 if by else 8)
    if by:
        top = {"by_kind": ranked(by_group), "top": top}
    return out, wall, busy * 1e-6, len(spans), top


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
# Phase properties: the exactness properties, a seeded sweep on the card.
# ----------------------------------------------------------------------
#: Case i of phase properties draws everything from
#: ``np.random.default_rng([PROP_SEED, i])``: a failure names its case,
#: and ``python3 chip_smoke.py --property-case i`` reruns that case alone.
PROP_SEED = 25
PROP_CASES = 64
#: Case i's family is ``PROP_FAMILIES[i % 3]``.
PROP_FAMILIES = ("random", "clustered", "near_tangent")
#: The scenarios' time span (``data/trajgen.py``: 0-400).
PROP_T_MAX = 400.0
#: Entry rows of one near-tangent cluster: one 256-row tile.
PROP_CLUSTER_ROWS = 256
#: Near-tangent cases the negative control runs (the first ones).
PROP_NEGATIVE_CASES = 8


def random_segs(rng, n: int, *, t_span=(0.0, 50.0), box: float = 30.0,
                max_len: float = 3.0) -> np.ndarray:
    """``tests/conftest.py::random_segments`` as a packed (n, 8) float32
    array sorted by t_start: the same draws in the same order."""
    ts = rng.uniform(*t_span, n).astype(np.float32)
    te = ts + rng.uniform(0.1, max_len, n).astype(np.float32)
    p0 = rng.uniform(0, box, (n, 3)).astype(np.float32)
    p1 = p0 + rng.normal(0, 2.0, (n, 3)).astype(np.float32)
    out = np.concatenate([p0, p1, ts[:, None], te[:, None]], axis=1)
    return out[np.argsort(ts, kind="stable")]


def clustered_segs(rng, n: int, nq: int, groups: int, *, extent: float,
                   t_max: float = PROP_T_MAX):
    """``n`` entry segments in ``groups`` compact clouds (side extent / 8),
    cloud g in time window g and at one of two sites ``2 × extent``
    apart (g even at the first), so the t_start-sorted tiles are
    cloud-pure and a coarse bin spans both sites: the tile early-out and
    the live-tile lists have work.  Velocities are C1's (~N(0, 1.5) per
    axis a time unit): faster segments this late in time would widen the
    prune slack (``solve_scale``) past the sites' distance.  ``nq``
    queries are drawn inside random clouds of the first site.  Returns
    packed (entries, queries)."""
    span = t_max / groups
    site = np.zeros((2, 3))
    site[1, 0] = 2.0 * extent
    centre = site[np.arange(groups) % 2] + rng.uniform(
        0.0, extent / 8, (groups, 3))

    def segs(g):
        m = g.size
        s = np.zeros((m, 8), np.float32)
        s[:, 6] = (g + rng.uniform(0.0, 0.9, m)) * span
        s[:, 7] = s[:, 6] + rng.uniform(0.1, 3.0, m)
        s[:, 0:3] = centre[g] + rng.uniform(0.0, extent / 8, (m, 3))
        s[:, 3:6] = s[:, 0:3] + rng.normal(0.0, 1.5, (m, 3)) * (
            s[:, 7:8] - s[:, 6:7])
        return s[np.argsort(s[:, 6], kind="stable")]
    return (segs(np.sort(rng.integers(0, groups, n))),
            segs(2 * rng.integers(0, (groups + 1) // 2, nq)))


def near_tangent(rng, d: float, clusters: int, rows: int, *,
                 background: int = 0, bg_queries: int = 0,
                 mag=(1e3, 1e4), t_max: float = PROP_T_MAX):
    """Near-tangent (entry, query) pairs mixed into a random database.

    Time is cut into ``clusters`` windows.  Window k holds a cluster of
    ``rows`` entry segments around a centre at magnitude ``mag`` (where
    float32's ``c = |Δr|² − d²`` loses most) and one query whose float64
    closest approach to the cluster's edge entry is ``d + δ``: δ has a
    random sign and a magnitude log-uniform from 4× the round-off band
    (``prune_limit(d, solve_scale(pair)) − d``) down to 1e-8 of it, or 0
    (one pair in ten).  Half the pairs move in parallel along one axis
    and cross, offset along another, and a fifth are static: their box
    gap equals their closest approach, and the cluster's other rows lie
    beyond the edge entry, so the whole cluster tile's box test is as
    tight as the pair's.  The rest move in random directions.  The
    ``background`` entries and ``bg_queries`` queries (``random_segs``
    near the origin) lie in the gaps between windows.  Returns packed
    (entries, queries), each sorted by t_start.
    """
    from repro_torch.core.index import prune_limit, solve_scale
    span = t_max / clusters
    width = 0.4 * span
    ents, qrys = [], []
    for k in range(clusters):
        t0 = k * span
        kind = rng.choice(["parallel", "static", "general"], p=[0.5, 0.2, 0.3])
        a, b = rng.choice(3, 2, replace=False)
        side = float(rng.choice([-1.0, 1.0]))
        centre = rng.choice([-1.0, 1.0], 3) * np.exp(
            rng.uniform(np.log(mag[0]), np.log(mag[1]), 3))
        ts = t0 + rng.uniform(0.0, 0.3) * width
        te = min(ts + float(np.exp(rng.uniform(np.log(0.1), np.log(10.0)))),
                 t0 + width)
        tc = ts + (te - ts) * rng.uniform(0.25, 0.75)
        off = np.zeros(3)
        off[b] = side
        if kind == "parallel":
            ve, vq = np.zeros(3), np.zeros(3)
            ve[a], vq[a] = rng.choice([-1.0, 1.0], 2) * np.exp(
                rng.uniform(np.log(0.1), np.log(30.0), 2))
            vq[a] += np.sign(vq[a] - ve[a]) * 0.1
        elif kind == "static":
            ve, vq = np.zeros(3), np.zeros(3)
        else:
            ve = rng.normal(0.0, 1.0, 3) * np.exp(rng.uniform(np.log(0.1),
                                                             np.log(30.0)))
            dv = rng.normal(0.0, 1.0, 3)
            dv *= np.exp(rng.uniform(np.log(0.1), np.log(30.0))) \
                / np.linalg.norm(dv)
            vq = ve - dv
            off = np.cross(dv, rng.normal(0.0, 1.0, 3))
            off /= np.linalg.norm(off)

        q0, q1 = ts, te
        if kind == "static":        # a static pair: common time is partial
            q0 = ts + (te - ts) * rng.uniform(0.0, 0.5)
            q1 = min(q0 + (te - ts), t0 + width)

        def pair(sep):
            e = np.r_[centre + ve * (ts - tc), centre + ve * (te - tc), ts, te]
            qc = centre + off * sep
            q = np.r_[qc + vq * (q0 - tc), qc + vq * (q1 - tc), q0, q1]
            return e.astype(np.float32), q.astype(np.float32)
        band = prune_limit(d, solve_scale(np.stack(pair(d)))) - d
        delta = 0.0 if rng.random() < 0.1 else float(
            rng.choice([-1.0, 1.0]) * 4.0 * band
            * 10.0 ** rng.uniform(-8.0, 0.0))
        e, q = pair(max(d + delta, 0.0))
        # The cluster's other rows: beyond the edge entry along b (the
        # side away from the query), inside the window, slow.
        fill = np.zeros((rows - 1, 8), np.float32)
        fill[:, 0:3] = centre + rng.uniform(-30.0, 30.0, (rows - 1, 3))
        fill[:, b] = centre[b] - side * rng.uniform(0.5, 30.0, rows - 1)
        fill[:, 3:6] = fill[:, 0:3] + rng.normal(0.0, 1.0, (rows - 1, 3))
        fill[:, 3 + b] = fill[:, b] - side * rng.uniform(0.0, 1.0, rows - 1)
        fill[:, 6] = t0 + rng.uniform(0.0, width - 3.0, rows - 1)
        fill[:, 7] = fill[:, 6] + rng.uniform(0.1, 3.0, rows - 1)
        ents += [e[None], fill]
        qrys.append(q[None])
    for count, out in ((background, ents), (bg_queries, qrys)):
        if count:       # in [0.55, 0.85] of a span: between two windows
            bg = random_segs(rng, count, t_span=(0.0, 1.0), max_len=0.2)
            win = rng.integers(0, clusters, count)
            bg[:, 6:8] = (bg[:, 6:8] * 0.25 + 0.55 + win[:, None]) * span
            out.append(bg)
    e, q = np.concatenate(ents), np.concatenate(qrys)
    return (e[np.argsort(e[:, 6], kind="stable")],
            q[np.argsort(q[:, 6], kind="stable")])


def segments_of(packed: np.ndarray):
    """The port's ``SegmentArray`` of packed (n, 8) rows (seg_id = row,
    traj_id = row mod 7, as ``random_segments``)."""
    from repro_torch.core.segments import PACKED_COLUMNS, SegmentArray
    n = packed.shape[0]
    return SegmentArray(**{c: np.ascontiguousarray(packed[:, k])
                           for k, c in enumerate(PACKED_COLUMNS)},
                        seg_id=np.arange(n, dtype=np.int32),
                        traj_id=np.arange(n, dtype=np.int32) % 7)


def closest_approach64(entries: np.ndarray, queries: np.ndarray,
                       chunk: int = 1 << 20) -> torch.Tensor:
    """(C, Q) float64 closest approach of every pair over its common time
    (inf without one), on the host: ``tests/_torch_rows.closest_approach``
    for all pairs at once."""
    e = torch.from_numpy(entries.astype(np.float64))
    q = torch.from_numpy(queries.astype(np.float64))

    def motion(s):
        dt = s[:, 7] - s[:, 6]
        v = (s[:, 3:6] - s[:, 0:3]) / torch.where(dt > 0, dt, 1.0)[:, None]
        v = torch.where((dt > 0)[:, None], v, 0.0)
        return s[:, 0:3] - v * s[:, 6:7], v
    ae, ve = motion(e)
    aq, vq = motion(q)
    out = torch.empty((e.shape[0], q.shape[0]), dtype=torch.float64)
    step = max(1, chunk // max(q.shape[0], 1))
    for c0 in range(0, e.shape[0], step):
        sl = slice(c0, c0 + step)
        a = ae[sl, None, :] - aq[None, :, :]
        b = ve[sl, None, :] - vq[None, :, :]
        lo = torch.maximum(e[sl, None, 6], q[None, :, 6])
        hi = torch.minimum(e[sl, None, 7], q[None, :, 7])
        bb = (b * b).sum(-1)
        t = torch.where(bb > 0, -(a * b).sum(-1) / torch.where(
            bb > 0, bb, 1.0), lo)
        t = torch.minimum(torch.maximum(t, lo), hi)
        r = a + b * t[..., None]
        out[sl] = torch.where(hi >= lo, r.norm(dim=-1), torch.inf)
    return out


def pair_keys(res) -> set:
    return set(zip(res.entry_idx.tolist(), res.query_idx.tolist()))


def property_inputs(i: int):
    """Case i's inputs: (family, d, entries, queries, policy fields)."""
    rng = np.random.default_rng([PROP_SEED, i])
    family = PROP_FAMILIES[i % len(PROP_FAMILIES)]
    d = float(rng.uniform(0.2, 12.0))
    n = int(np.exp(rng.uniform(np.log(2000), np.log(20000))))
    nq = int(rng.integers(20, 201))
    # S1's coordinates at scale 1.0 reach ~12.4 (the 10^6-segment GALAXY
    # cloud), so the extents are that and 10× that.
    extent = float(rng.choice([12.4, 124.0]))
    num_bins = int(rng.choice([8, 64, 256, 1024]))
    if family == "random":
        ent = random_segs(rng, n, box=extent)
        qry = random_segs(rng, nq, box=extent)
    elif family == "clustered":
        # Windows of ~512 rows (two tiles) and bins of four windows, so a
        # bin spans both sites and its tiles are mostly window-pure.
        groups = max(2, n // 512)
        ent, qry = clustered_segs(rng, n, nq, groups, extent=extent)
        num_bins = max(1, groups // 4)
    else:
        clusters = max(n // (2 * PROP_CLUSTER_ROWS), 4)
        ent, qry = near_tangent(
            rng, d, clusters, PROP_CLUSTER_ROWS,
            background=n - clusters * PROP_CLUSTER_ROWS,
            bg_queries=max(nq - clusters, 0))
    fields = dict(num_bins=num_bins,
                  index_kboxes=int(rng.choice([1, 2, 4])),
                  capacity=int(rng.choice([4096, 4096, 4096, 64])))
    return family, d, ent, qry, fields


def property_case(i: int, dev) -> dict:
    """Case i through ``db.query(backend="kernel")`` on ``dev``: the nine
    pruning × compaction modes and the six batching algorithms
    byte-identical to each other and to ``backend="torch"``; every
    difference from the float64 host oracle borderline; the rows at d a
    subset of those at 1.5 d; every interval inside the common time with
    t_enter ≤ t_exit; with a small capacity, the overflowing batches
    re-dispatched to the same rows, and one batch's ``count`` exact.
    Raises ``AssertionError`` naming the case."""
    from repro_torch.api import ExecutionPolicy, TrajectoryDB
    from repro_torch.core.batching import ALGORITHMS
    from repro_torch.core.index import prune_limit, solve_scale
    from repro_torch.kernels import ops
    family, d, ent, qry, fields = property_inputs(i)
    label = f"properties case {i} ({family}, seed [{PROP_SEED}, {i}])"
    db = TrajectoryDB.from_segments(segments_of(ent),
                                    policy=ExecutionPolicy(**fields),
                                    device=dev)
    q = segments_of(qry)
    base = db.query(q, d, backend="kernel", pruning="none",
                    compaction="fused")
    pruned = retries = 0
    for pruning in ops.PRUNINGS:
        for compaction in ops.COMPACTIONS:
            res = db.query(q, d, backend="kernel", pruning=pruning,
                           compaction=compaction)
            identical(res, base, f"{label} {pruning}/{compaction}")
            pruned += res.stats.pruned_tiles
            retries += res.stats.total_retries
    for algo in ALGORITHMS:
        if algo == db.policy.batching:      # the spatial/fused run above
            continue
        res = db.query(q, d, backend="kernel", batching=algo)
        identical(res, base, f"{label} {algo}")
        retries += res.stats.total_retries
    identical(db.query(q, d, backend="torch"), base, f"{label} torch")
    # The float64 oracle: every difference inside its pair's own band
    # (prune_limit at the pair's solve_scale; the database's scale, set
    # by its fastest late segment, would be far wider).
    entries = db.segments.packed()
    ca = closest_approach64(entries, qry)
    oracle = set(zip(*[x.tolist() for x in torch.nonzero(
        ca <= d, as_tuple=True)]))
    diff = oracle ^ pair_keys(base)
    ratio = {(e, k): abs(float(ca[e, k]) - d) / (prune_limit(d, solve_scale(
        np.stack([entries[e], qry[k]]))) - d) for e, k in diff}
    far = [(e, k, float(ca[e, k]), r) for (e, k), r in ratio.items()
           if r > 1.0]
    check(not far, f"{label}: {len(far)} differences from the float64 "
          f"oracle beyond their pair's band at d {d} (entry, query, "
          f"closest approach, |ca − d| / band): {far[:5]}")
    # Monotone in d.
    big = db.query(q, 1.5 * d, backend="kernel")
    lost = pair_keys(base) - pair_keys(big)
    check(not lost, f"{label}: {len(lost)} rows at d missing at 1.5 d: "
          f"{sorted(lost)[:5]}")
    # Intervals inside the common time (float32, exact).
    e, k = base.entry_idx, base.query_idx
    lo = np.maximum(entries[e, 6], qry[k, 6])
    hi = np.minimum(entries[e, 7], qry[k, 7])
    check(bool(np.all(base.t_enter >= lo) and np.all(base.t_exit <= hi)
               and np.all(base.t_enter <= base.t_exit)),
          f"{label}: an interval outside its common time")
    # Counts: a batch at a capacity below its hits still counts them all.
    if fields["capacity"] < 4096:
        e_dev = torch.from_numpy(entries).to(dev)
        q_dev = torch.from_numpy(qry).to(dev)
        want = int(ops.count_hits(e_dev, q_dev, d, device=dev,
                                  use_kernel=False))
        if want > 1:
            for compaction in ops.COMPACTIONS:
                out = ops.query_block(entries, qry, d, capacity=want // 2,
                                      device=dev, compaction=compaction)
                check(int(out["count"]) == want,
                      f"{label}: {compaction} count {int(out['count'])} "
                      f"!= {want} at capacity {want // 2}")
    return {"family": family, "d": d, "entries": int(entries.shape[0]),
            "queries": int(qry.shape[0]),
            "pairs": int(entries.shape[0] * qry.shape[0]),
            "hits": len(base), "borderline": len(diff),
            "worst_band_ratio": max(ratio.values(), default=0.0),
            "pruned_tiles": int(pruned), "retries": int(retries)}


def no_slack_mismatches(i: int, dev) -> dict:
    """Case i (near-tangent) with the tile test's slack removed (the
    threshold at d: ``dispatch_prune_threshold`` for the hierarchical
    route, ``distthresh_tile_prep``'s ``d_prune`` for the spatial one):
    per route, the pairs in which its fused rows differ from ``none``'s
    (single-query batches, so each query tile is one query's box)."""
    from repro_torch.api import ExecutionPolicy, TrajectoryDB
    from repro_torch.kernels import distthresh as dt
    from repro_torch.kernels import ops, ref
    _, d, ent, qry, fields = property_inputs(i)
    db = TrajectoryDB.from_segments(
        segments_of(ent), device=dev, policy=ExecutionPolicy(
            **fields, batching="periodic", batch_params={"s": 1}))
    q = segments_of(qry)
    base = pair_keys(db.query(q, d, backend="kernel", pruning="none"))
    host, prep = ops.dispatch_prune_threshold, dt.distthresh_tile_prep

    def prep_no_slack(entries, queries_t, d, **kw):
        e_mbr, q_mbr, _ = prep(entries, queries_t, d, **kw)
        return e_mbr, q_mbr, ref._f32(np.float32(d), entries.device)
    ops.dispatch_prune_threshold = lambda d, entries, queries: float(d)
    dt.distthresh_tile_prep = prep_no_slack
    try:
        return {p: len(base ^ pair_keys(db.query(
            q, d, backend="kernel", pruning=p)))
            for p in ("spatial", "hierarchical")}
    finally:
        ops.dispatch_prune_threshold, dt.distthresh_tile_prep = host, prep


def plan_slices(db, queries, pol, d):
    """Each dispatched batch of ``pol``'s plan of ``queries`` as the
    engine slices it: (host entries, host queries, resident entries, the
    resident queries' column slice of one (8, N) upload)."""
    from repro_torch.kernels import ops
    qs = db._sorted(queries)[0].packed()
    q_dev_t = ops.to_device(qs.T, db.device)
    eng = db.engine("kernel", pol)
    for b in db.plan(queries, pol, d=d).batches:
        if b.num_candidates:
            cf, cl = b.cand_first, b.cand_last + 1
            qf, ql = b.q_first, b.q_last + 1
            yield (eng._packed[cf:cl], qs[qf:ql], eng._packed_dev[cf:cl],
                   q_dev_t[:, qf:ql])


def first_trajectories(queries, n: int):
    """The segments of ``queries``' first ``n`` trajectories."""
    keep = np.isin(queries.traj_id, np.unique(queries.traj_id)[:n])
    return queries.take(np.nonzero(keep)[0])


def prep_path(dev, s1, card) -> dict:
    """Phase prep: ``distthresh_tile_prep`` against the host helpers
    (``prep_equal``) on every dispatched slice of S1 at scale 1.0 (its
    first 10 query trajectories under the default policy, as
    ``s1.search`` dispatches them, and all 100 at periodic s = 64), of S10
    at scale 1.0 (10 query trajectories, default policy) and of the
    near-tangent cases of phase properties (default policy), each at the
    engine's float32 d and at the float64 d."""
    from repro_torch.api import ExecutionPolicy, TrajectoryDB
    t0 = time.perf_counter()
    s10 = TrajectoryDB.from_scenario("S10", scale=1.0, device=dev)
    sets = [("S1 default, 10 trajectories", s1,
             first_trajectories(s1.scenario_queries, 10), s1.policy,
             s1.scenario_d),
            ("S1 periodic s=64", s1, s1.scenario_queries,
             s1.policy.with_(batching="periodic", batch_params={"s": 64}),
             s1.scenario_d),
            ("S10 default, 10 trajectories", s10,
             first_trajectories(s10.scenario_queries, 10), s10.policy,
             s10.scenario_d)]
    for i in range(PROP_CASES):
        if PROP_FAMILIES[i % len(PROP_FAMILIES)] == "near_tangent":
            _, d, ent, qry, fields = property_inputs(i)
            db = TrajectoryDB.from_segments(segments_of(ent), device=dev,
                                            policy=ExecutionPolicy(**fields))
            sets.append((f"near-tangent case {i}", db, segments_of(qry),
                         db.policy, d))
    summary = {}
    for label, db, queries, pol, d in sets:
        n = zeros = widest = 0
        for e_np, q_np, e, qt in plan_slices(db, queries, pol, d):
            for dd in (np.float32(d), float(d)):
                zeros += prep_equal(e_np, q_np, e, qt, dd, f"prep {label}")
            n += 1
            widest = max(widest, len(e_np))
        check(n > 0, f"prep {label}: no dispatched slice")
        summary[label] = {"slices": n, "widest_entries": widest,
                          "box_zero_signs": zeros}
    line = {"phase": "prep", "sets": len(summary),
            "slices": sum(v["slices"] for v in summary.values()),
            "box_zero_signs": sum(v["box_zero_signs"]
                                  for v in summary.values()),
            "by_set": summary, "seconds": time.perf_counter() - t0,
            "card": card}
    emit(line)
    return line


def properties_path(dev, card, cases=range(PROP_CASES)) -> dict:
    """Phase properties: ``property_case`` over ``cases``, the launches
    counted over the sweep (every distance kernel must launch, the
    live-tile kernels included), tiles pruned > 0, and the negative
    control: without the slack, the near-tangent family's rows must
    change in at least one case."""
    t0 = time.perf_counter()
    reset_launches()
    out = [property_case(i, dev) for i in cases]
    counts = {k: n for k, n in launches().items() if n}
    by_family = {f: {"cases": 0, "pairs": 0, "hits": 0, "borderline": 0,
                     "worst_band_ratio": 0.0} for f in PROP_FAMILIES}
    for r in out:
        row = by_family[r["family"]]
        row["cases"] += 1
        for k in ("pairs", "hits", "borderline"):
            row[k] += r[k]
        row["worst_band_ratio"] = max(row["worst_band_ratio"],
                                      r["worst_band_ratio"])
    pruned = sum(r["pruned_tiles"] for r in out)
    check(pruned > 0, "properties: no tile was pruned in the sweep")
    for k in REPLACES:
        if k.startswith("distthresh") and k != PREP:
            check(counts.get(k, 0) > 0, f"properties: {k} never launched")
    tangent = [i for i in cases
               if PROP_FAMILIES[i % len(PROP_FAMILIES)] == "near_tangent"]
    t1 = time.perf_counter()
    negative = {i: no_slack_mismatches(i, dev)
                for i in tangent[:PROP_NEGATIVE_CASES]}
    for route in ("spatial", "hierarchical"):
        check(sum(n[route] for n in negative.values()) > 0,
              f"properties: the negative control (no slack) never changed "
              f"a {route} row")
    line = {"phase": "properties", "cases": len(out),
            "pairs": sum(r["pairs"] for r in out),
            "hits": sum(r["hits"] for r in out),
            "borderline": {f: v["borderline"] for f, v in by_family.items()},
            "worst_band_ratio": max(r["worst_band_ratio"] for r in out),
            "families": by_family, "pruned_tiles": pruned,
            "retries": sum(r["retries"] for r in out),
            "launches": counts,
            "live_tile_launches": sum(n for k, n in counts.items()
                                      if "live" in k),
            "negative_control": {
                "tripped": True, "cases": len(negative),
                "rows_changed": negative,
                "seconds": time.perf_counter() - t1},
            "seconds": time.perf_counter() - t0, "card": card}
    emit(line)
    return line


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

        def run_ticket(plan=plan, qk=qk, t0=t0):
            if plan is not None:
                faults.arm(plan)
            try:
                t = broker.submit(qk, d)
                return t, time.perf_counter() - t0, t.result()
            finally:
                faults.disarm()
        # The ticket runs once, under the sync sentinel (phase sentinel's
        # serve lines).
        (t, submit_s, res), rep, runs, _ = watched(run_ticket)
        wall = time.perf_counter() - t0
        counts = {n: c for n, c in launches().items() if c}
        slice_syncs = sum(sl.num_syncs for sl in t.slices())
        check(slice_syncs == rep.explicit_syncs,
              f"ticket {k}: slices report {slice_syncs} syncs, the "
              f"sentinel counted {rep.explicit_syncs}")
        sentinel_line(f"serve ticket {k}", rep, runs, wall, card,
                      slices=len(t.slices()), slice_syncs=slice_syncs)
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
    # The stream runs once, under the sync sentinel (phase sentinel's
    # stream line); a re-issued straggler's run is waited for inside it.
    (res, st), rep, runs, _ = watched(
        lambda: db.query_stream(q, d, backend="kernel"))
    wall = time.perf_counter() - t0
    counts = {n: c for n, c in launches().items() if c}
    check(set(counts) == {"distthresh_compact"},
          f"stream launched {counts}")
    check(st.groups <= len(runs) <= st.groups + st.reissued,
          f"stream: {len(runs)} executor runs for {st.groups} groups and "
          f"{st.reissued} re-issues")
    sentinel_line("stream", rep, runs, wall, card, scheduler_groups=st.groups,
                  reissued=st.reissued)
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
# The sync sentinel: what really crossed the device→host boundary.
# ----------------------------------------------------------------------
class Executions:
    """Every executor run that starts inside the ``with`` block, with its
    ``ExecStats.num_syncs`` and ``num_groups``, and how many are still
    running: a scheduler's re-issued straggler may outlive the
    ``query_stream`` call that started it."""

    def __init__(self):
        self.lock = threading.Lock()
        self.runs: list = []
        self.running = 0
        self.saved: list = []

    def __enter__(self):
        from repro_torch.core import executor
        for cls in (executor.SyncExecutor, executor.PipelinedExecutor):
            orig = cls.run

            def run(obj, plan, _orig=orig):
                with self.lock:
                    self.running += 1
                try:
                    rs, st = _orig(obj, plan)
                    with self.lock:
                        self.runs.append((st.num_syncs, st.num_groups))
                    return rs, st
                finally:
                    with self.lock:
                        self.running -= 1
            self.saved.append((cls, orig))
            cls.run = run
        return self

    def __exit__(self, *exc):
        for cls, orig in self.saved:
            cls.run = orig
        return False

    def wait_idle(self, timeout: float = 120.0) -> None:
        t_end = time.perf_counter() + timeout
        while True:
            with self.lock:
                if self.running == 0:
                    return
            check(time.perf_counter() < t_end,
                  f"{self.running} executor runs still running")
            time.sleep(0.01)


def watched(fn):
    """``fn()`` under a ``SyncSentinel``, the window closed only once every
    executor run it started has ended (the stream is synchronized just
    outside it, so the window opens on an idle card).  Returns (result,
    report, [(num_syncs, num_groups)] per run, window wall s)."""
    from repro_torch.lint.sentinel import SyncSentinel
    torch.cuda.synchronize()
    with Executions() as ex:
        t0 = time.perf_counter()
        with SyncSentinel() as sen:
            out = fn()
            ex.wait_idle()
        wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return out, sen.report(), list(ex.runs), wall


def aten_sites(rep) -> list:
    """Each ATen sync warning's source line, with its count."""
    out = []
    for site, n in sorted(rep.aten_sites.items(), key=lambda kv: -kv[1]):
        path, _, line = site.rpartition(":")
        out.append({"site": os.path.relpath(path, ROOT)
                    if path.startswith(ROOT) else path, "line": int(line),
                    "count": n,
                    "source": linecache.getline(path, int(line)).strip()})
    return out


def sentinel_line(path: str, rep, runs, wall: float, card: str,
                  **extra) -> dict:
    """Check one watched path and emit its line: the sentinel's explicit
    syncs equal the executors' ``num_syncs`` summed over every run of the
    window, each run within 2 syncs per group (a broker slice and a
    scheduler worker call are one run each), and no blocking read, no
    unfenced read, no synchronize outside a fence and no ATen sync."""
    syncs = sum(n for n, _ in runs)
    groups = sum(g for _, g in runs)
    check(runs, f"sentinel {path}: no executor ran")
    check(rep.explicit_syncs == syncs,
          f"sentinel {path}: {rep.explicit_syncs} fence waits, the "
          f"executors report {syncs}")
    check(all(n <= 2 * g for n, g in runs),
          f"sentinel {path}: a run over 2 syncs per group: {runs}")
    check(rep.blocking_reads == 0 and rep.unfenced_reads == 0
          and rep.other_syncs == 0,
          f"sentinel {path}: {rep.blocking_reads} blocking reads, "
          f"{rep.unfenced_reads} unfenced reads, {rep.other_syncs} other "
          f"syncs ({rep.blocking_by_group}, {rep.unfenced_by_group})")
    check(rep.aten_syncs == 0, f"sentinel {path}: {rep.aten_syncs} ATen "
          f"syncs at {aten_sites(rep)}")
    line = {"phase": "sentinel", "path": path, "groups": groups,
            "num_syncs": syncs, "executions": len(runs),
            "window_s": wall, "report": rep.to_json(),
            "blocking_by_group": rep.to_json()["blocking_by_group"],
            "aten_sites": aten_sites(rep), **extra, "card": card}
    emit(line)
    return line


def sentinel_controls(dev, card) -> dict:
    """Positive controls, so that a zero means something: a read of a
    kernel's output behind a long-running launch blocks once and is
    blamed on its group; a staged pinned copy read before its fence is
    one unfenced read; ``torch.nonzero`` on the card is an ATen sync."""
    from repro_torch.core.engine import _stage_to_host
    from repro_torch.core.executor import Fence, _group_scope
    from repro_torch.kernels.distthresh import distthresh_dense
    from repro_torch.lint.sentinel import SyncSentinel
    e_np, q_np = clustered(np.random.default_rng(7), 2000, 100, 4)
    e = torch.from_numpy(e_np).to(dev)
    qt = torch.from_numpy(q_np).to(dev).T.contiguous()
    spin = int(1e8)                # ~50 ms of a spinning thread on the card
    torch.cuda.synchronize()
    out = {}
    with SyncSentinel() as s:
        with _group_scope("control:blocking"):
            _, _, hit = distthresh_dense(e, qt, 2.0, device=dev)
            torch.cuda._sleep(spin)       # behind the kernel, before the read
            hit[0, 0].item()
    rep = s.report()
    check(rep.blocking_reads == 1
          and rep.blocking_by_group == {"control:blocking": 1}
          and rep.blocked_seconds > 0.01,
          f"blocking control: {rep}")
    out["blocking"] = {"blocking_reads": rep.blocking_reads,
                       "blocking_by_group": rep.to_json()[
                           "blocking_by_group"],
                       "blocked_seconds": rep.blocked_seconds,
                       "aten_syncs": rep.aten_syncs}
    count = hit.sum(dtype=torch.int32)
    torch.empty((), dtype=torch.int32, pin_memory=True)   # a cached block
    torch.cuda.synchronize()
    with SyncSentinel() as s:
        torch.cuda._sleep(spin)
        host = _stage_to_host({"count": count}, dev)
        early = int(host["count"].numpy())      # before the fence
        Fence(dev).wait()
        late = int(host["count"])
    rep = s.report()
    check(rep.unfenced_reads == 1 and rep.ready_reads == 1
          and rep.by_kind.get("unfenced:copy_incomplete") == 1
          and rep.explicit_syncs == 1 and rep.other_syncs == 0,
          f"unfenced control: {rep}")
    check(late == int(hit.sum()), "the fenced read is wrong")
    out["unfenced"] = {"unfenced_reads": rep.unfenced_reads,
                       "copy_incomplete": rep.by_kind.get(
                           "unfenced:copy_incomplete"),
                       "stale_value_read": early != late,
                       "ready_reads": rep.ready_reads}
    torch.cuda.synchronize()
    with SyncSentinel() as s:
        torch.nonzero(hit)
    rep = s.report()
    check(rep.aten_syncs >= 1, f"nonzero control: {rep}")
    out["aten"] = {"aten_syncs": rep.aten_syncs,
                   "sites": aten_sites(rep)}
    emit({"phase": "sentinel", "path": "positive controls", **out,
          "card": card})
    return out


def _legacy_f32(x, device):
    """``kernels.ref._f32`` before this slice: a host scalar copied to the
    card with a blocking ``.to()``.  ``interval_math`` now makes its
    ``inf`` through ``_f32`` too, so this puts back both of the dense
    path's hidden syncs per dispatch (the threshold and ``inf``)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).reshape(())
    return torch.tensor(float(x), dtype=torch.float32).to(device)


def sentinel_path(db, main_res, dense_res, shard_res, shard_pol, card):
    """Phase sentinel: the plans phases main and shard made, run again
    (no planning) under the sentinel — the main path, the dense path (and
    once with the blocking scalar uploads the dense path had before this
    slice, which the sentinel's ATen count must see), the shard plan on 1
    pod and through a ``PodRouter`` on 4 — then the positive controls.
    The serve tickets and the stream are watched in their own phases."""
    from repro_torch.core.distributed import PodRouter
    from repro_torch.kernels import ref
    q, d = db._sorted(db.scenario_queries)[0], db.scenario_d
    lines = {}
    be = db.backend("kernel")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, st = be.run(q, d, main_res.plan)        # unwatched, for the cost
    torch.cuda.synchronize()
    unwatched = (time.perf_counter() - t0, st.total_seconds)
    (rs, st), rep, runs, wall = watched(
        lambda: be.run(q, d, main_res.plan))
    check(len(rs) == len(main_res), "sentinel main: rows differ")
    lines["S1 main"] = sentinel_line(
        "S1 main", rep, runs, wall, card, execute_s=st.total_seconds,
        unwatched_window_s=unwatched[0], unwatched_execute_s=unwatched[1])
    dense = db.backend("kernel", db.policy.with_(compaction="dense"))
    (rs, st), rep, runs, wall = watched(
        lambda: dense.run(q, d, dense_res.plan))
    check(len(rs) == len(dense_res), "sentinel dense: rows differ")
    lines["S1 dense"] = sentinel_line("S1 dense", rep, runs, wall, card,
                                      execute_s=st.total_seconds)
    fixed = ref._f32
    ref._f32 = _legacy_f32
    try:
        (rs, st), rep, runs, wall = watched(
            lambda: dense.run(q, d, dense_res.plan))
    finally:
        ref._f32 = fixed
    check(rep.aten_syncs >= 2 * st.num_invocations and rep.explicit_syncs
          == sum(n for n, _ in runs), f"legacy dense: {rep}")
    emit({"phase": "sentinel", "path": "S1 dense, blocking scalar uploads "
          "(before this slice)", "groups": sum(g for _, g in runs),
          "num_syncs": sum(n for n, _ in runs), "window_s": wall,
          "execute_s": st.total_seconds, "report": rep.to_json(),
          "aten_sites": aten_sites(rep), "card": card})
    pol1 = db.policy.with_(shard_use_kernel=True)
    shard1 = db.backend("shard", pol1)
    (rs, st), rep, runs, wall = watched(
        lambda: shard1.run(q, d, shard_res.plan))
    check(len(rs) == len(shard_res), "sentinel shard 1 pod: rows differ")
    lines["S1 shard 1 pod"] = sentinel_line(
        "S1 shard 1 pod", rep, runs, wall, card, execute_s=st.total_seconds)
    router = PodRouter(db.backend("shard", shard_pol).engine)
    (rs, st), rep, runs, wall = watched(
        lambda: router.execute(q, d, shard_res.plan))
    check(len(rs) == len(shard_res), "sentinel shard 4 pods: rows differ")
    lines[f"S1 shard {SHARD_PODS} pods"] = sentinel_line(
        f"S1 shard {SHARD_PODS} pods", rep, runs, wall, card,
        execute_s=st.total_seconds)
    sentinel_controls(torch.device("cuda", 0), card)
    return lines


def lint_path(card):
    """Phase lint: ``python -m repro_torch.lint src/repro_torch
    --format=json`` must report 0 errors; the ``.cu`` files that its walk
    hands to KERN101 must be the very sources the build phase compiled
    (``_build``'s list)."""
    from repro_torch.kernels import _build
    from repro_torch.lint import _expand
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.lint", "src/repro_torch",
         "--format=json"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    payload = json.loads(proc.stdout)
    check(proc.returncode == 0 and payload["counts"]["error"] == 0,
          f"lint: rc {proc.returncode}, {payload['counts']}: "
          f"{[v for v in payload['violations'] if v['severity'] == 'error']}")
    read = sorted(os.path.relpath(f, ROOT)
                  for p in payload["paths"]
                  for f in _expand([os.path.join(ROOT, p)])
                  if f.endswith(".cu"))
    built = sorted(os.path.relpath(str(p), ROOT) for p in _build._sources())
    check(read == built, f"lint: KERN101 read {read}, the build compiled "
          f"{built}")
    emit({"phase": "lint", "seconds": time.perf_counter() - t0,
          "counts": payload["counts"],
          "warnings": [f"{v['rule']} {v['path']}" for v in
                       payload["violations"]],
          "kern101_sources": read, "card": card})


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
    check_prep(label, pol, counts)
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


def llm_prompts(vocab: int):
    """The llm phases' 8 seeded prompts of 64 to 1,000 tokens below
    ``vocab`` (lengths equal in every phase): (lengths, prompts, bucket
    1024)."""
    from repro_torch.serve import engine
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 1001, LLM_PROMPTS)
    lens[0] = 1000                              # bucket 1024
    prompts = [rng.integers(1, vocab, n).tolist() for n in lens]
    s = engine._bucket(int(lens.max()))
    check(s == 1024, f"bucket {s}")
    return lens, prompts, s


def prompt_batch(prompts, s: int, dev) -> dict:
    """The prompts left-padded with 0 to ``s``, as ``generate`` pads
    them, on the card."""
    toks = np.full((len(prompts), s), 0, np.int64)
    for i, p in enumerate(prompts):
        toks[i, s - len(p):] = p
    return {"tokens": torch.from_numpy(toks).to(dev)}


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
    cfg = ARCHS[LLM_ARCH]
    torch.cuda.reset_peak_memory_stats(dev)
    model, init_s = make_model(cfg, dev)
    runs, batch, last = serve_runs(cfg, model, dev)
    b = runs["prompts"]
    with torch.inference_mode():
        # The same prefill with the plain attention in the model.
        with patched(attention, "flashattn", fa.flashattn_plain):
            plain_logits, _ = T.prefill(cfg, model, batch,
                                        max_len=runs["bucket"],
                                        last_only=True)
        diff = float((plain_logits[:, -1] - last).abs().max())
        agree = int((plain_logits[:, -1].argmax(-1) ==
                     last.argmax(-1)).sum())
    check(diff <= LLM_LOGIT_ATOL, f"prefill logits: kernel vs plain "
          f"{diff} > {LLM_LOGIT_ATOL}")
    check(agree == b, f"prefill argmax: kernel and plain agree on {agree} "
          f"of {b} prompts")
    emit({"phase": "llm", "arch": LLM_ARCH, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "dtype": cfg.dtype,
          "parameters": sum(p.numel() for p in model.parameters()),
          "param_count": cfg.param_count(), "init_s": init_s, **runs,
          "logits_max_abs_diff_vs_plain": diff,
          "logits_atol": LLM_LOGIT_ATOL,
          "argmax_agree": f"{agree}/{b}",
          "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
          "card": card})
    return cfg.num_layers, flash_shape(cfg, b, runs["bucket"]), runs


def flash_shape(cfg, b: int, s: int) -> dict:
    """The flash kernel's shape at a prefill of ``b`` prompts of ``s``
    tokens of ``cfg``."""
    from repro_torch.models import transformer as T
    kvh = cfg.num_kv_heads
    g = cfg.num_heads // kvh
    return dict(bh=b * kvh * g, bkv=b * kvh, s=s, t=s,
                hd=cfg.resolved_head_dim, g=g, kv_heads=kvh,
                dtype=T._dtype(cfg))


def serve_runs(cfg, model, dev, flash=None, profile_prefill=True):
    """``ServeEngine.generate`` on the llm phases' prompts with
    ``LLM_NEW_TOKENS`` new tokens, twice: equal outputs, every new token
    below the vocabulary size, and ``flashattn`` launched ``flash`` times
    in the prefill (default: once per layer; 0 launches nothing) and
    never in decode.  Then one prefill and the decode steps on their own,
    each timed and counted on its own, and one more decode step (and,
    with ``profile_prefill``, prefill) under ``torch.profiler``.  Returns
    (the phase line's fields, the prompts' token batch, the prefill's
    last logits)."""
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine
    lens, prompts, s = llm_prompts(cfg.vocab_size)
    b, n_new = len(prompts), LLM_NEW_TOKENS
    layers = cfg.num_layers if flash is None else flash
    want = {"flashattn": layers} if layers else {}
    eng = engine.ServeEngine(cfg, model, max_len=s + n_new, device=dev)
    walls, outs = [], []
    for _ in range(2):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(eng.generate(prompts, n_new))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = {n: c for n, c in launches().items() if c}
        check(counts == want,
              f"{cfg.name} generate launched {counts}; {want} in the "
              f"prefill and none in decode belong to it")
    check(outs[0] == outs[1], f"{cfg.name} generate is not deterministic")
    for p, o in zip(prompts, outs[0]):
        check(o[:len(p)] == p and len(o) == len(p) + n_new,
              "generate: prompt or length")
        check(all(0 <= t < cfg.vocab_size for t in o[len(p):]),
              "generate: a token outside the vocabulary")

    # The prefill and the decode steps on their own, counted on their own.
    batch = prompt_batch(prompts, s, dev)
    with torch.inference_mode():
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = T.prefill(cfg, model, batch, max_len=s + n_new,
                                  last_only=True)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_launches = launches()["flashattn"]
        check(prefill_launches == layers,
              f"prefill launched flashattn {prefill_launches} times")
        last = logits[:, -1]
        check(torch.isfinite(last).all().item(), "non-finite logits")
        nxt = torch.argmax(last, dim=-1)
        check(nxt.cpu().tolist() == [o[len(p)] for p, o in
                                     zip(prompts, outs[0])],
              "prefill's first token differs from generate's")
        reset_launches()
        # One CUDA event between steps: each step's time on the card's
        # clock (the host runs ahead of the card or the card waits on it;
        # either way the gap is the step's).
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(n_new + 1)]
        t0 = time.perf_counter()
        marks[0].record()
        for i in range(n_new):
            step, cache = T.decode_step(cfg, model, cache, nxt, s + i)
            nxt = torch.argmax(step, dim=-1)
            marks[i + 1].record()
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        decode_step_s = [a.elapsed_time(b) * 1e-3
                         for a, b in zip(marks, marks[1:])]
        check(not any(launches().values()), "decode launched a kernel")
        # One more decode step and one prefill under the profiler: device
        # busy share and device work per call.
        _, step_prof = profile_line(lambda: T.decode_step(
            cfg, model, cache, nxt, s + n_new - 1))
        del cache
        pre_prof = "not profiled" if not profile_prefill else profile_line(
            lambda: T.prefill(cfg, model, batch, max_len=s,
                              last_only=True))[1]
        # Two more prefills as the first was timed: the roofline phase's
        # median of three.
        prefill_runs_s = [prefill_s]
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            T.prefill(cfg, model, batch, max_len=s + n_new, last_only=True)
            torch.cuda.synchronize()
            prefill_runs_s.append(time.perf_counter() - t0)
    return {"prompts": b, "prompt_tokens": [int(n) for n in lens],
            "bucket": s, "new_tokens": n_new, "generate_wall_s": walls,
            "prefill_s": prefill_s, "prefill_tokens_per_s": b * s / prefill_s,
            "prefill_runs_s": prefill_runs_s, "decode_step_s": decode_step_s,
            "decode_s": decode_s, "decode_tokens_per_s": b * n_new / decode_s,
            "profile": {"decode_step": step_prof, "prefill": pre_prof},
            "launches_generate": want,
            "launches_per_prefill": prefill_launches,
            "launches_per_decode_step": 0}, batch, last


def profile_line(fn, by=None):
    """``fn()`` once under ``torch.profiler``: its result, and the wall,
    device busy time and share, device events and top device names (or,
    with ``by``, the device time of each category)."""
    out, wall, busy, events, top = profiled(fn, by)
    return out, {"wall_s": wall, "device_busy_s": busy,
                 "device_busy_share": busy / wall, "device_events": events,
                 "device_us_by_name": top}


# ----------------------------------------------------------------------
# LLM serving: qwen3-moe-30b-a3b (experts) and musicgen-large (embedding
# inputs) at full width and depth.
# ----------------------------------------------------------------------
MOE_ARCH, EMBED_ARCH = "qwen3-moe-30b-a3b", "musicgen-large"


def free_card() -> None:
    """Return the cached blocks of the models an earlier phase dropped,
    so that the next model's weights fit."""
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def patched(owner, name: str, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def uncounted_params(cfg) -> int:
    """The parameters ``param_count()`` (the reference's arithmetic)
    leaves out: the final norm scale and the layers' (two per attention
    layer, with ``qk_norm`` also a q and a k norm of the head dim; one per
    Mamba2, mLSTM and sLSTM layer; zamba's one shared attention layer),
    and the xLSTM forget biases (H per mLSTM layer, D per sLSTM layer)."""
    from repro_torch.models import transformer as T
    d = cfg.d_model
    if cfg.block_pattern == "zamba":
        return (cfg.num_layers + 2 + 1) * d
    if cfg.block_pattern == "xlstm":
        g, m_per, _ = T._xlstm_group_sizes(cfg)
        return (cfg.num_layers + 1) * d + g * m_per * cfg.num_heads + g * d
    norms = (2 * cfg.num_layers + 1) * d
    if cfg.qk_norm:
        norms += 2 * cfg.num_layers * cfg.resolved_head_dim
    return norms


def make_model(cfg, dev):
    """Seeded random weights of ``cfg`` made on the card: (model, init
    s), the parameter count checked against ``param_count()`` plus
    ``uncounted_params``."""
    from repro_torch.models import transformer as T
    t0 = time.perf_counter()
    model = T.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    extra = uncounted_params(cfg)
    check(n_params - extra == cfg.param_count(),
          f"{cfg.name}: {n_params} parameters, {extra} of them norm "
          f"scales or forget biases, against param_count() "
          f"{cfg.param_count()}")
    return model, init_s


def checked_flash(errs: list):
    """A stand-in for the ``flashattn`` name ``models.attention`` calls:
    the kernel, held against the plain version on the same q, k and v
    (``FLASH_TOL``), each call's max |diff| appended to ``errs``."""
    from repro_torch.kernels import flashattn as fa

    def flash(q, k, v, *, g):
        out = fa.flashattn(q, k, v, g=g)
        errs.append(flash_close(out, fa.flashattn_plain(q, k, v, g=g), v,
                                g, q.dtype))
        return out
    return flash


def recording_route(routes: list):
    """A stand-in for ``models.moe.route`` that appends each call's
    (experts (T, K), dropped assignments, capacity) to ``routes``, all
    left on the card."""
    from repro_torch.models import moe
    route = moe.route

    def recorded(*args, **kwargs):
        out = route(*args, **kwargs)
        _, _, experts, slot, cap = out
        routes.append((experts, (slot == kwargs["num_experts"] * cap).sum(),
                       cap))
        return out
    return recorded


def llm_moe_path(dev, card):
    """``ServeEngine.generate`` on qwen3-moe-30b-a3b (48 layers of 128
    experts, top-8, bf16, random weights from a seeded generator on the
    card), run twice; the prefill and the decode steps timed and profiled
    on their own; every layer's flash call checked on its own inputs; the
    prefill's last logits and routes with the plain attention patched in;
    the MoE layers' host syncs.  Returns the flash launches of the first
    run and the prefill's flash-kernel shape."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import flashattn as fa
    from repro_torch.models import attention, moe
    from repro_torch.models import transformer as T
    cfg = ARCHS[MOE_ARCH]
    free_card()
    torch.cuda.reset_peak_memory_stats(dev)
    model, init_s = make_model(cfg, dev)
    runs, batch, last = serve_runs(cfg, model, dev)
    b, s, layers = runs["prompts"], runs["bucket"], cfg.num_layers
    with torch.inference_mode():
        # Every layer's flash call against the plain version on its own
        # inputs; the routes and drops of that prefill, and of the same
        # prefill with the plain attention.
        errs, routes, plain_routes = [], [], []
        with patched(attention, "flashattn", checked_flash(errs)), \
                patched(moe, "route", recording_route(routes)):
            checked, _ = T.prefill(cfg, model, batch, max_len=s,
                                   last_only=True)
        check(len(errs) == layers and len(routes) == layers,
              f"{len(errs)} flash calls, {len(routes)} MoE layers")
        check(torch.equal(checked[:, -1], last),
              "the checked prefill's logits differ from the prefill's")
        with patched(attention, "flashattn", fa.flashattn_plain), \
                patched(moe, "route", recording_route(plain_routes)):
            plain, _ = T.prefill(cfg, model, batch, max_len=s,
                                 last_only=True)
        diff = float((plain[:, -1] - last).abs().max())
        agree = int((plain[:, -1].argmax(-1) == last.argmax(-1)).sum())
        flips = torch.stack([
            (a.sort(-1).values != c.sort(-1).values).any(-1).sum()
            for (a, _, _), (c, _, _) in zip(routes, plain_routes)])
        flips = flips.tolist()
        dropped = torch.stack([d for _, d, _ in routes]).tolist()
        cap = routes[0][2]
        del routes, plain_routes, checked, plain

        # Host syncs of the prefill and one decode step.
        sentinel, moe_syncs = sentinel_syncs(cfg, model, batch, s,
                                             ("models/moe.py",))
        check(moe_syncs == 0, f"models/moe.py made {moe_syncs} host syncs: "
              f"{sentinel['aten_sites']}")
    emit({"phase": "llm_moe", "arch": MOE_ARCH, "layers": layers,
          "d_model": cfg.d_model, "experts": cfg.num_experts,
          "experts_per_token": cfg.experts_per_token, "d_ff": cfg.d_ff,
          "head_dim": cfg.resolved_head_dim, "qk_norm": cfg.qk_norm,
          "dtype": cfg.dtype,
          "parameters": sum(p.numel() for p in model.parameters()),
          "param_count": cfg.param_count(), "init_s": init_s, **runs,
          "flash_max_abs_err_per_layer": errs,
          "flash_tol": list(FLASH_TOL[torch.bfloat16]),
          "capacity_prefill": cap,
          "assignments_per_layer": b * s * cfg.experts_per_token,
          "dropped_per_layer": dropped,
          "plain_attention": {
              "logits_max_abs_diff": diff, "argmax_agree": f"{agree}/{b}",
              "route_flips_per_layer": flips,
              "route_flips": sum(flips), "gated": False},
          "sentinel": sentinel,
          "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
          "card": card})
    return layers, flash_shape(cfg, b, s), runs


def llm_embed_path(dev, card):
    """musicgen-large (48 layers, bf16, embedding inputs, seeded random
    weights made on the card): a prefill on seeded embeddings (8 ×
    1,024 × d) and 32 decode steps, each on a seeded (8, d) embedding,
    run twice (equal logits); then the prefill's last logits with the
    plain attention patched in.  Returns the flash launches per
    prefill."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import flashattn as fa
    from repro_torch.models import attention
    from repro_torch.models import transformer as T
    cfg = ARCHS[EMBED_ARCH]
    free_card()
    torch.cuda.reset_peak_memory_stats(dev)
    model, init_s = make_model(cfg, dev)
    b, s, n_new, layers = LLM_PROMPTS, 1024, LLM_NEW_TOKENS, cfg.num_layers
    gen = torch.Generator(device=dev).manual_seed(1)
    emb = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
    steps = torch.randn((n_new, b, cfg.d_model), generator=gen, device=dev)

    def run():
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = T.prefill(cfg, model, {"embeddings": emb},
                                  max_len=s + n_new, last_only=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pre = dict(launches())
        reset_launches()
        out = [logits[:, -1]]
        for i in range(n_new):
            step, cache = T.decode_step(cfg, model, cache, steps[i], s + i)
            out.append(step)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check({n: c for n, c in pre.items() if c} == {"flashattn": layers},
              f"{EMBED_ARCH} prefill launched {pre}")
        check(not any(launches().values()),
              f"{EMBED_ARCH} decode launched {launches()}")
        return torch.stack(out), t1 - t0, t2 - t1

    with torch.inference_mode():
        runs = [run() for _ in range(2)]
        check(torch.equal(runs[0][0], runs[1][0]),
              f"{EMBED_ARCH}: two runs gave different logits")
        last = runs[0][0][0]
        with patched(attention, "flashattn", fa.flashattn_plain):
            plain, _ = T.prefill(cfg, model, {"embeddings": emb}, max_len=s,
                                 last_only=True)
        diff = float((plain[:, -1] - last).abs().max())
        agree = int((plain[:, -1].argmax(-1) == last.argmax(-1)).sum())
    check(torch.isfinite(runs[0][0]).all().item(), "non-finite logits")
    check(diff <= LLM_LOGIT_ATOL, f"{EMBED_ARCH} prefill logits: kernel "
          f"vs plain {diff} > {LLM_LOGIT_ATOL}")
    check(agree == b, f"{EMBED_ARCH} prefill argmax: kernel and plain "
          f"agree on {agree} of {b}")
    emit({"phase": "llm_embed", "arch": EMBED_ARCH, "layers": layers,
          "d_model": cfg.d_model, "heads": cfg.num_heads,
          "kv_heads": cfg.num_kv_heads, "mlp_type": cfg.mlp_type,
          "input_mode": cfg.input_mode, "dtype": cfg.dtype,
          "parameters": sum(p.numel() for p in model.parameters()),
          "param_count": cfg.param_count(), "init_s": init_s,
          "batch": b, "prompt_len": s, "decode_steps": n_new,
          "prefill_s": [r[1] for r in runs],
          "prefill_tokens_per_s": [b * s / r[1] for r in runs],
          "decode_s": [r[2] for r in runs],
          "decode_tokens_per_s": [b * n_new / r[2] for r in runs],
          "launches_per_prefill": layers, "launches_per_decode_step": 0,
          "logits_max_abs_diff_vs_plain": diff,
          "logits_atol": LLM_LOGIT_ATOL, "argmax_agree": f"{agree}/{b}",
          "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
          "card": card})
    return layers


# ----------------------------------------------------------------------
# LLM serving: zamba2-7b (Mamba2 + a shared attention block) and
# xlstm-350m (mLSTM + sLSTM) at full width and depth.
# ----------------------------------------------------------------------
HYBRID_ARCH, XLSTM_ARCH = "zamba2-7b", "xlstm-350m"


def sentinel_syncs(cfg, model, batch, s: int, modules: tuple):
    """One prefill and one decode step under ``SyncSentinel``: (the
    report's fields, the ATen syncs from the source files ``modules``)."""
    from repro_torch.lint.sentinel import SyncSentinel
    from repro_torch.models import transformer as T
    torch.cuda.synchronize()
    with SyncSentinel() as sen:
        lg, cache = T.prefill(cfg, model, batch, max_len=s + 1,
                              last_only=True)
        T.decode_step(cfg, model, cache, lg[:, -1].argmax(-1), s)
    torch.cuda.synchronize()
    del cache
    rep = sen.report()
    sites = aten_sites(rep)
    ours = sum(x["count"] for x in sites
               if x["site"].endswith(modules))
    return {"aten_syncs": rep.aten_syncs, "aten_sites": sites,
            "syncs_from": {"modules": list(modules), "count": ours},
            "blocking_reads": rep.blocking_reads}, ours


def one_step_flash(q, k, v, *, g):
    """The plain version with a seeded 1 % of its outputs moved one bf16
    step away from zero (phase llm_hybrid's control)."""
    from repro_torch.kernels import flashattn as fa
    out = fa.flashattn_plain(q, k, v, g=g)
    gen = torch.Generator(device=out.device).manual_seed(q.shape[0])
    flip = torch.rand(out.shape, generator=gen, device=out.device) < 0.01
    up = (out.view(torch.int16) + 1).view(out.dtype)
    return torch.where(flip, up, out)


def llm_hybrid_path(dev, card):
    """``ServeEngine.generate`` on zamba2-7b (81 Mamba2 layers in 13
    groups of 6 and a tail of 3, one shared attention + MLP block after
    each group; d_model 3,584, 32 heads of 112, ssm_state 64, bf16,
    random weights from a seeded generator on the card), run twice: 13
    flash launches per prefill, none per step.  Every shared-attention
    flash call held against the plain version on its own inputs; the
    prefill's last logits against those with the plain attention patched
    in, within ``HYBRID_SPREAD_FACTOR`` of the spread the one-step control
    gives; one prefill and one decode step under ``SyncSentinel`` (no
    ATen sync from ``models/ssm.py``).  Returns the flash launches per
    prefill and the prefill's flash-kernel shape."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import flashattn as fa
    from repro_torch.models import attention
    from repro_torch.models import transformer as T
    cfg = ARCHS[HYBRID_ARCH]
    free_card()
    torch.cuda.reset_peak_memory_stats(dev)
    model, init_s = make_model(cfg, dev)
    groups, tail = T._zamba_group_sizes(cfg)
    runs, batch, last = serve_runs(cfg, model, dev, groups)
    b, s = runs["prompts"], runs["bucket"]
    with torch.inference_mode():
        errs = []
        with patched(attention, "flashattn", checked_flash(errs)):
            checked, _ = T.prefill(cfg, model, batch, max_len=s,
                                   last_only=True)
        check(len(errs) == groups, f"{len(errs)} shared-attention flash "
              f"calls, not {groups}")
        check(torch.equal(checked[:, -1], last),
              "the checked prefill's logits differ from the prefill's")
        logits = {}
        for name, fn in (("plain", fa.flashattn_plain),
                         ("control", one_step_flash)):
            with patched(attention, "flashattn", fn):
                out, _ = T.prefill(cfg, model, batch, max_len=s,
                                   last_only=True)
            logits[name] = out[:, -1]
        plain = logits["plain"]

        def spread(x):
            d = (x - plain).abs()
            agree = int((x.argmax(-1) == plain.argmax(-1)).sum())
            return {"mean_abs_diff": float(d.mean()),
                    "max_abs_diff": float(d.max()),
                    "argmax_agree": f"{agree}/{b}"}
        vs_plain = {"kernel": spread(last),
                    "control_one_step": spread(logits["control"]),
                    "logits_std": float(plain.float().std())}
        del checked, logits, plain
        sentinel, ssm_syncs = sentinel_syncs(cfg, model, batch, s,
                                             ("models/ssm.py",))
    check(ssm_syncs == 0, f"models/ssm.py made {ssm_syncs} host syncs: "
          f"{sentinel['aten_sites']}")
    got = vs_plain["kernel"]["mean_abs_diff"]
    ctrl = vs_plain["control_one_step"]["mean_abs_diff"]
    check(got <= HYBRID_SPREAD_FACTOR * ctrl,
          f"{HYBRID_ARCH} prefill logits: kernel vs plain mean |diff| "
          f"{got} > {HYBRID_SPREAD_FACTOR} × the one-step control's {ctrl}")
    emit({"phase": "llm_hybrid", "arch": HYBRID_ARCH,
          "layers": cfg.num_layers, "groups": groups, "tail": tail,
          "shared_attn_every": cfg.shared_attn_every,
          "d_model": cfg.d_model, "ssm_state": cfg.ssm_state,
          "head_dim": cfg.resolved_head_dim, "dtype": cfg.dtype,
          "parameters": sum(p.numel() for p in model.parameters()),
          "param_count": cfg.param_count(), "init_s": init_s, **runs,
          "flash_max_abs_err_per_call": errs,
          "flash_tol": list(FLASH_TOL[torch.bfloat16]),
          "logits_vs_plain": vs_plain,
          "spread_factor": HYBRID_SPREAD_FACTOR,
          "sentinel": sentinel,
          "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
          "card": card})
    return groups, flash_shape(cfg, b, s), runs


# ----------------------------------------------------------------------
# Training: granite-3-2b at full width and depth takes AdamW steps.
# ----------------------------------------------------------------------
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "granite-3-2b", 8, 1024, 4
#: The reference's ``AdamWConfig`` defaults: lr 3e-4 after a linear
#: warmup of 100 steps, so the four steps run at 3e-6 to 1.2e-5.  Its
#: ``test_loss_decreases`` runs lr 3e-3 with 5 warmup steps at the
#: reduced width of 64; at granite's 2,048 Adam's first, sign-like step
#: of lr · sign(g) moves each output of a layer by about lr · d_in, and
#: a short warmup to 3e-3, 1e-3 or 3e-4 makes the loss swing or rise
#: (``chip_train_sweep.py`` runs those settings).
TRAIN_OPT = dict(lr=3e-4, warmup_steps=100, total_steps=10_000)
#: Relative tolerances on a train step's loss and gradient norm computed
#: twice in ways that differ only in bf16 rounding: microbatches=2
#: against 1 (a GEMM over 4,096 rows may sum in another order than over
#: 8,192; each half's gradient rounds to bf16 before the float32 sum), and
#: the flash kernels against the plain attention (the kernel forward
#: rounds P to bf16).  Either lands a few activations per layer one bf16
#: step apart, which 40 layers carry to the logits (about 0.05 each, as
#: the llm phase's kernel-vs-plain logits show); the mean loss over 8,192
#: tokens averages that to ~1e-4 of its value, and elementwise roundings
#: of 2^-9 move the global norm far less than 2^-9.
MB_RTOL = {"loss": 1e-3, "grad_norm": 1e-2}
#: Kernel launches of one training step with remat: each attention
#: layer's forward twice (the step's forward and the backward's
#: recompute) and the three backward kernels once.
TRAIN_LAUNCHES = {"flashattn": 2, "flashattn_bwd_delta": 1,
                  "flashattn_bwd_dkdv": 1, "flashattn_bwd_dq": 1}


def kernel_group(name: str) -> str:
    """The train step profile's categories of device work, by kernel
    name."""
    low = name.lower()
    for key, group in (("flashattn_bwd", "flash backward"),
                       ("flashattn", "flash forward"),
                       ("multi_tensor_apply", "optimizer (foreach)"),
                       ("gemm", "GEMMs"), ("cutlass", "GEMMs"),
                       ("xmma", "GEMMs"), ("cublas", "GEMMs"),
                       ("nvjet", "GEMMs"),
                       ("memcpy", "copies"), ("memset", "copies"),
                       ("logsumexp", "CE (logsumexp, gather)"),
                       ("gather", "CE (logsumexp, gather)"),
                       ("scatter", "CE (logsumexp, gather)"),
                       ("reduce", "reductions"), ("norm", "reductions")):
        if key in low:
            return group
    return "elementwise and other"


def train_batches(vocab: int, seq: int = TRAIN_SEQ) -> list:
    """The phase's ``TokenPipeline`` batches (8 × ``seq``), steps 0 to
    ``TRAIN_STEPS + 1``."""
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=vocab, seq_len=seq, global_batch=TRAIN_BATCH))
    return [pipe.global_batch_at(i) for i in range(TRAIN_STEPS + 2)]


def timed_step(step, state, batch, dev):
    """One train step, synchronized: (state, metrics as floats, wall s,
    the kernels it launched)."""
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: c for n, c in launches().items() if c}
    return state, {k: float(v) for k, v in m.items()}, wall, counts


def train_path(dev, card):
    """granite-3-2b at full width and depth, bf16, seeded random weights
    made on the card: ``TRAIN_STEPS`` AdamW steps (``remat=True``) on
    ``TokenPipeline`` batches of 8 × 1,024, each timed and counted; the
    loss falls (each later step's below the first's, and the first
    batch's after the updates below its own before them).  The last of them taken once more from the same state
    (copied to the host and back) at ``microbatches=2``: loss and
    grad_norm within ``MB_RTOL``.  One more step under
    ``torch.profiler`` (device time by kind of kernel), one under
    ``SyncSentinel`` (the ATen syncs from ``train/`` and ``models/``), one
    under ``roofline.opcount.CostCounter``.  Returns the flash kernels'
    launches counted in the last of the ``TRAIN_STEPS`` steps, its wall,
    and the steps' walls with the counted step's costs."""
    from repro_torch.configs import ARCHS
    from repro_torch.lint.sentinel import SyncSentinel
    from repro_torch.models import transformer as T
    from repro_torch.roofline.opcount import CostCounter
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import step as step_lib
    free_card()
    cfg = ARCHS[TRAIN_ARCH]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = step_lib.init_train_state(
        cfg, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model = state["params"]
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params - uncounted_params(cfg) == cfg.param_count(),
          f"{cfg.name}: {n_params} parameters")
    batches = train_batches(cfg.vocab_size)
    want = {n: k * cfg.num_layers for n, k in TRAIN_LAUNCHES.items()}
    vs_plain = train_vs_plain(cfg, model, batches[0], want)
    state_gib = sum(t.numel() * t.element_size() for t in
                    [*model.parameters(), *state["opt"]["m"].values(),
                     *state["opt"]["v"].values(),
                     *state["opt"]["master"].values()]) / 2**30
    ocfg = opt_lib.AdamWConfig(**TRAIN_OPT)
    step = step_lib.make_train_step(cfg, ocfg, microbatches=1, remat=True)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steps = []
    for i in range(TRAIN_STEPS):
        if i == TRAIN_STEPS - 1:        # the state before the last step
            host = {n: t.to("cpu", copy=True) for n, t in
                    _train_tensors(state).items()}
        torch.cuda.reset_peak_memory_stats(dev)
        state, m, wall, counts = timed_step(step, state, batches[i], dev)
        check(counts == want, f"train step {i} launched {counts}, not "
              f"{want}")
        check(all(np.isfinite(v) for v in m.values()),
              f"train step {i}: non-finite metrics {m}")
        steps.append({"step": i, "wall_s": wall, "tokens_per_s":
                      tokens / wall, "peak_memory_gib":
                      torch.cuda.max_memory_allocated(dev) / 2**30,
                      "launches": counts, **m})
    # The loss falls: every later step's batch scores below the first
    # step's, and the first batch itself scores lower after the updates.
    losses = [x["loss"] for x in steps]
    with torch.no_grad():
        after = float(T.loss_fn(cfg, model, {
            k: torch.as_tensor(v, device=dev)
            for k, v in batches[0].items()})[0])
    check(max(losses[1:]) < losses[0] and after < losses[0],
          f"train loss did not fall: {losses}, batch 0 after {after}")

    # The last step again, from the same state, at microbatches=2.
    with torch.no_grad():
        for n, t in _train_tensors(state).items():
            t.copy_(host[n])
    del host
    step2 = step_lib.make_train_step(cfg, ocfg, microbatches=2, remat=True)
    torch.cuda.reset_peak_memory_stats(dev)
    state, m2, wall2, counts2 = timed_step(step2, state,
                                          batches[TRAIN_STEPS - 1], dev)
    peak2 = torch.cuda.max_memory_allocated(dev) / 2**30
    m1 = steps[-1]
    rel = {k: abs(m2[k] - m1[k]) / abs(m1[k]) for k in MB_RTOL}
    check(all(rel[k] <= MB_RTOL[k] for k in MB_RTOL),
          f"microbatches 2 vs 1: relative differences {rel}")

    # One step under the profiler, one under the sync sentinel; their
    # losses continue the trajectory.
    (state, m5), prof = profile_line(
        lambda: step(state, batches[TRAIN_STEPS]), by=kernel_group)
    torch.cuda.synchronize()
    with SyncSentinel() as sen:
        state, m6 = step(state, batches[TRAIN_STEPS + 1])
    torch.cuda.synchronize()
    rep = sen.report()
    # One more step under the op counter: the FLOPs, bytes and declared
    # kernels of the real step on the card (phase roofline holds its
    # FLOPs to the dry run's).
    counted_s = time.perf_counter()
    with CostCounter() as counter:
        state, _ = step(state, batches[TRAIN_STEPS + 1])
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - counted_s
    later = [float(m5["loss"]), float(m6["loss"])]
    ce_ms = ce_timing(cfg, model, dev)
    sites = aten_sites(rep)
    ours = sum(x["count"] for x in sites if "src/repro_torch/train/" in
               x["site"] or "src/repro_torch/models/" in x["site"])
    emit({"phase": "train", "arch": TRAIN_ARCH, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "dtype": cfg.dtype, "parameters":
          n_params, "param_count": cfg.param_count(), "state_gib":
          state_gib, "init_s": init_s, "batch": [TRAIN_BATCH, TRAIN_SEQ],
          "optimizer": TRAIN_OPT, "remat": True, "steps": steps,
          "loss_batch0_after": after, "losses_after_microbatches_2":
          later, "kernel_vs_plain": vs_plain,
          "microbatches_2": {"wall_s": wall2, "launches": counts2,
                             "peak_memory_gib": peak2, **m2,
                             "rel_diff": rel, "rtol": MB_RTOL},
          "profile": prof, "ce_fwd_bwd_ms": ce_ms,
          "sentinel": {"aten_syncs": rep.aten_syncs, "aten_sites": sites,
                       "from_train_and_models": ours,
                       "blocking_reads": rep.blocking_reads},
          "card": card})
    del state, model
    free_card()
    train_checkpoint(dev, card)
    return steps[-1]["launches"], steps[-1]["wall_s"], {
        "step_s": [x["wall_s"] for x in steps],
        "card_count": counter.costs(), "card_count_wall_s": counted_s}


def ce_timing(cfg, model, dev) -> float:
    """Milliseconds (CUDA events) of one step's cross-entropy alone:
    ``chunked_cross_entropy`` over seeded (8, 1,024, d_model) activations
    and labels with the model's output table, forward and the gradients
    of the activations and the table."""
    from repro_torch.models.layers import chunked_cross_entropy
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model), generator=gen,
                    device=dev).to(getattr(torch, cfg.dtype)).requires_grad_()
    labels = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                           generator=gen, device=dev)
    head = model.output_head()

    def run():
        loss = chunked_cross_entropy(head, x, labels,
                                     true_vocab=cfg.vocab_size)
        return torch.autograd.grad(loss, (x, head.table))
    return event_ms(run, iters=3)


def grads_at(cfg, model, batch, remat: bool = True):
    """The loss, its float32 global gradient norm and the kernels it
    launched, for ``batch`` at the model's weights (no update)."""
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as opt_lib
    reset_launches()
    loss, _ = T.loss_fn(cfg, model, {k: torch.as_tensor(v, device=model.device)
                                     for k, v in batch.items()}, remat=remat)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    norm = float(opt_lib.global_norm(grads))
    torch.cuda.synchronize()
    counts = {n: c for n, c in launches().items() if c}
    return float(loss), norm, counts


def train_vs_plain(cfg, model, batch, want, rtol=MB_RTOL) -> dict:
    """The step's loss and gradient norm at the fresh weights with the
    flash kernels, and with the plain forward and backward patched into
    ``FlashAttention``: within ``rtol`` (in bf16 ``MB_RTOL``: the kernel
    forward rounds P to bf16, the plain one does not)."""
    from repro_torch.kernels import flashattn as fa
    loss, norm, counts = grads_at(cfg, model, batch)
    check(counts == want, f"loss and gradient launched {counts}")
    with patched(fa, "flashattn_fwd", fa.flashattn_fwd_plain), \
            patched(fa, "flashattn_bwd", fa.flashattn_bwd_plain):
        p_loss, p_norm, p_counts = grads_at(cfg, model, batch)
    check(not p_counts, f"the plain attention launched {p_counts}")
    rel = {"loss": abs(loss - p_loss) / abs(p_loss),
           "grad_norm": abs(norm - p_norm) / abs(p_norm)}
    check(all(rel[k] <= rtol[k] for k in rtol),
          f"train loss and gradient, kernels vs plain: {rel}")
    return {"loss": loss, "grad_norm": norm, "plain_loss": p_loss,
            "plain_grad_norm": p_norm, "rel_diff": rel, "rtol": rtol}


def _train_tensors(state: dict) -> dict:
    """Every tensor a train step updates, by a name of its own."""
    out = {f"p.{n}": p for n, p in state["params"].named_parameters()}
    for k in ("m", "v", "master"):
        out.update({f"{k}.{n}": t for n, t in state["opt"][k].items()})
    out["count"] = state["opt"]["count"]
    return out


def train_checkpoint(dev, card):
    """The checkpoint at full width with the depth cut to 2 layers: two
    steps, a save, two more steps; the saved state restored on the card
    and run through the same two steps: master weights equal bit for
    bit."""
    from repro_torch.configs import ARCHS
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import step as step_lib
    cfg = dataclasses.replace(ARCHS[TRAIN_ARCH], num_layers=2)
    state = step_lib.init_train_state(
        cfg, generator=torch.Generator(device=dev).manual_seed(1),
        device=dev)
    step = step_lib.make_train_step(cfg, opt_lib.AdamWConfig(**TRAIN_OPT))
    batches = train_batches(cfg.vocab_size)
    for i in range(2):
        state, _ = step(state, batches[i])
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as root:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = ckpt.save(root, 2, state)
        save_s = time.perf_counter() - t0
        disk = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
        for i in (2, 3):
            state, _ = step(state, batches[i])
        t0 = time.perf_counter()
        resumed, at, _ = ckpt.restore(root, state, device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    check(at == 2, f"restored step {at}")
    for i in range(at, 4):
        resumed, _ = step(resumed, batches[i])
    master, again = state["opt"]["master"], resumed["opt"]["master"]
    equal = all(torch.equal(master[n], again[n]) for n in master)
    check(equal, "resumed master weights differ from the uninterrupted "
          "run's")
    emit({"phase": "train_checkpoint", "arch": TRAIN_ARCH, "layers":
          cfg.num_layers, "parameters": sum(
              p.numel() for p in state["params"].parameters()),
          "disk_bytes": disk, "save_s": save_s, "restore_s": restore_s,
          "leaves": len(master) * 4 + 1, "resumed_master_bit_equal": equal,
          "card": card})
    del state, resumed
    free_card()


#: KV-head replication of phase train_kvrep: granite-3-2b's 8 KV heads
#: each twice, so 16 groups of 2 query heads (the reference's
#: ``kv_replication_for(32, 8, 16)``).
KVREP = 2


@contextlib.contextmanager
def recording_groups(groups: list):
    """Stand-ins for ``kernels.flashattn.flashattn_fwd`` and
    ``flashattn_bwd`` (the calls ``FlashAttention`` makes) that append
    each call's ("fwd" or "bwd", g) to ``groups``."""
    from repro_torch.kernels import flashattn as fa

    def recorder(fn, kind):
        def call(*args, **kw):
            groups.append((kind, kw["g"]))
            return fn(*args, **kw)
        return call
    with patched(fa, "flashattn_fwd", recorder(fa.flashattn_fwd, "fwd")), \
            patched(fa, "flashattn_bwd", recorder(fa.flashattn_bwd, "bwd")):
        yield


def train_kvrep_path(dev, card, train_step_s: float):
    """granite-3-2b at full width and depth with ``kv_replication=2``,
    from phase train's seeded state and batches: the loss and gradient
    norm at the fresh weights within ``MB_RTOL`` of r = 1's, every flash
    call at g 2 (80 forwards and 40 of each backward kernel per step);
    two steps, the second timed without the recording stand-ins, with
    the peak memory.  Returns the launches of a step."""
    from repro_torch.configs import ARCHS
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import step as step_lib
    free_card()
    cfg = ARCHS[TRAIN_ARCH]
    rep = dataclasses.replace(cfg, kv_replication=KVREP)
    g = cfg.num_heads // cfg.num_kv_heads // KVREP
    state = step_lib.init_train_state(
        rep, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev)
    model = state["params"]
    batches = train_batches(cfg.vocab_size)
    want = {n: k * cfg.num_layers for n, k in TRAIN_LAUNCHES.items()}
    calls = want["flashattn"] + want["flashattn_bwd_dq"]
    groups = []
    with recording_groups(groups):
        loss2, norm2, counts2 = grads_at(rep, model, batches[0])
    check(counts2 == want, f"r = {KVREP}: loss and gradient launched "
          f"{counts2}, not {want}")
    check(len(groups) == calls and {x[1] for x in groups} == {g},
          f"r = {KVREP}: flash calls at g {sorted(set(groups))}, "
          f"{len(groups)} of them")
    loss1, norm1, _ = grads_at(cfg, model, batches[0])
    rel = {"loss": abs(loss2 - loss1) / abs(loss1),
           "grad_norm": abs(norm2 - norm1) / abs(norm1)}
    check(all(rel[k] <= MB_RTOL[k] for k in MB_RTOL),
          f"r = {KVREP} against r = 1: relative differences {rel}")
    step = step_lib.make_train_step(rep, opt_lib.AdamWConfig(**TRAIN_OPT))
    groups.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    with recording_groups(groups):
        state, m1, wall1, counts = timed_step(step, state, batches[0], dev)
    check(counts == want and len(groups) == calls
          and {x[1] for x in groups} == {g},
          f"r = {KVREP} step launched {counts} at g {set(groups)}")
    state, m2, wall2, counts_b = timed_step(step, state, batches[1], dev)
    check(counts_b == want, f"r = {KVREP} second step launched {counts_b}")
    check(all(np.isfinite(v) for v in (*m1.values(), *m2.values())),
          f"r = {KVREP}: non-finite metrics {m1} {m2}")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    tokens = TRAIN_BATCH * TRAIN_SEQ
    emit({"phase": "train_kvrep", "arch": TRAIN_ARCH, "layers":
          cfg.num_layers, "kv_replication": KVREP, "g": g,
          "flash_shape": {"bh": TRAIN_BATCH * cfg.num_heads, "bkv":
                          TRAIN_BATCH * cfg.num_kv_heads * KVREP, "g": g,
                          "s": TRAIN_SEQ, "hd": cfg.resolved_head_dim},
          "fresh_weights": {"loss": loss2, "grad_norm": norm2,
                            "loss_r1": loss1, "grad_norm_r1": norm1,
                            "rel_diff": rel, "rtol": MB_RTOL},
          "steps": [{"step": i, "wall_s": w, "tokens_per_s": tokens / w,
                     **mm} for i, (w, mm) in enumerate(((wall1, m1),
                                                         (wall2, m2)))],
          "launches": counts, "flash_calls_by_g": {str(g): len(groups)},
          "peak_memory_gib": peak, "train_step_s_g4": train_step_s,
          "step_s_ratio_g2_over_g4": wall2 / train_step_s, "card": card})
    del state, model
    free_card()
    return counts


def _leaves_equal_on(mesh, got: dict, want: dict) -> bool:
    """Every leaf of ``got`` a DTensor on ``mesh`` whose full value equals
    ``want``'s leaf bit for bit."""
    from torch.distributed.tensor import DTensor
    for name, w in want.items():
        x = got[name]
        check(isinstance(x, DTensor) and x.device_mesh is mesh,
              f"{name}: not a DTensor on the mesh")
        full, ref = x.full_tensor(), w.full_tensor() if isinstance(
            w, DTensor) else w
        if full.dtype != ref.dtype or not torch.equal(full, ref):
            return False
    return True


def train_mesh_path(dev, card):
    """granite-3-2b at full width and depth on a (1, 1) ``("data",
    "model")`` device mesh over a single-rank NCCL process group (a
    ``FileStore`` in a temporary directory): one unmeshed step from the
    seeded state, then the same state placed by
    ``train_state_shardings`` through two timed steps of
    ``make_train_step(grad_specs=grad_specs(...))`` under
    ``activation_sharding``: the first's loss and gradient norm within
    ``MB_RTOL`` of the unmeshed one's and, since every redistribution
    on a 1 x 1 mesh is a no-op, equal to it bit for bit, the master
    weights too, 80 flash forwards and 40 of each backward kernel per step,
    each forward inside ``local_map``.  Then, at 2 layers, ``save`` and
    ``restore(shardings=)`` on the mesh, bit-equal; and
    ``make_compressed_allreduce`` over the one rank, both codecs, equal
    to ``compress_leaf``'s dequantized payload bit for bit.  Returns the
    launches of a meshed step."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.configs import ARCHS
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding as shd
    from repro_torch.models import shardctx
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import compress
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import step as step_lib
    free_card()
    cfg = ARCHS[TRAIN_ARCH]
    ocfg = opt_lib.AdamWConfig(**TRAIN_OPT)
    batches = train_batches(cfg.vocab_size)
    want = {n: k * cfg.num_layers for n, k in TRAIN_LAUNCHES.items()}

    def fresh(c, seed):
        return step_lib.init_train_state(
            c, generator=torch.Generator(device=dev).manual_seed(seed),
            device=dev)

    state = fresh(cfg, 0)
    state, m0, wall0, counts0 = timed_step(
        step_lib.make_train_step(cfg, ocfg), state, batches[0], dev)
    check(counts0 == want, f"unmeshed step launched {counts0}")
    # The unmeshed masters stay on the card for the comparison; the
    # meshed steps' peak is reported with and without them.
    master0 = {n: t.clone() for n, t in state["opt"]["master"].items()}
    copy_gib = sum(t.numel() * t.element_size()
                   for t in master0.values()) / 2**30
    del state
    free_card()
    local_calls = [0]
    local_map = shardctx.local_map

    def counted(*args, **kw):
        local_calls[0] += 1
        return local_map(*args, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1, device_id=dev)
        try:
            mesh = M.make_mesh_compat((1, 1), ("data", "model"))
            specs = step_lib.train_state_specs(cfg)
            sh = shd.train_state_shardings(cfg, mesh, specs)
            state = shd.place(fresh(cfg, 0), sh, mesh)
            step = step_lib.make_train_step(
                cfg, ocfg, grad_specs=shd.grad_specs(cfg, mesh,
                                                     specs["params"]))
            steps, dmaster = [], None
            torch.cuda.reset_peak_memory_stats(dev)
            with shardctx.activation_sharding(mesh), \
                    patched(shardctx, "local_map", counted):
                for i in range(2):
                    local_calls[0] = 0
                    state, m, wall, counts = timed_step(step, state,
                                                        batches[i], dev)
                    check(counts == want, f"meshed step {i} launched "
                          f"{counts}, not {want}")
                    check(local_calls[0] == want["flashattn"],
                          f"meshed step {i}: {local_calls[0]} local_map "
                          f"calls, not {want['flashattn']}")
                    steps.append({"step": i, "wall_s": wall,
                                  "local_map_calls": local_calls[0], **m})
                    if i == 0:
                        dmaster = max(float((t.full_tensor() - master0[n])
                                            .abs().max())
                                      for n, t in
                                      state["opt"]["master"].items())
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            placed_ok = all(
                p.placements == M.to_placements(sh["params"][n], mesh)
                for n, p in state["params"].named_parameters())
            check(placed_ok, "parameters left their placements")
            rel = {k: abs(steps[0][k] - m0[k]) / abs(m0[k]) for k in MB_RTOL}
            check(all(rel[k] <= MB_RTOL[k] for k in MB_RTOL),
                  f"meshed step against unmeshed: relative differences "
                  f"{rel}")
            # On a 1 x 1 mesh every redistribution is a no-op: the first
            # meshed step is the unmeshed one, bit for bit.
            check(dmaster == 0 and all(v == 0.0 for v in rel.values()),
                  f"meshed step against unmeshed on a 1 x 1 mesh: master "
                  f"max |diff| {dmaster}, relative differences {rel}")
            del state, master0
            free_card()

            # Checkpoint at the 2-layer cut, on the mesh.
            small = dataclasses.replace(cfg, num_layers=2)
            sspecs = step_lib.train_state_specs(small)
            ssh = shd.train_state_shardings(small, mesh, sspecs)
            st = shd.place(fresh(small, 1), ssh, mesh)
            build = os.path.join(ROOT, "build")
            os.makedirs(build, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=build) as root:
                t0 = time.perf_counter()
                ckpt.save(root, 2, st)
                save_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                back, at, _ = ckpt.restore(root, st, shardings=ssh,
                                           mesh=mesh, device=dev)
                torch.cuda.synchronize()
                restore_s = time.perf_counter() - t0
            check(at == 2, f"restored step {at}")
            ckpt_equal = _leaves_equal_on(mesh, dict(ckpt._flatten(back)),
                                          dict(ckpt._flatten(st)))
            check(ckpt_equal, "restored leaves differ from the saved ones")
            del st, back
            free_card()

            # Compressed all-reduce over the one rank.
            gen = torch.Generator(device=dev).manual_seed(7)
            shapes = {"wq": (cfg.d_model, cfg.d_model), "ln":
                      (cfg.d_model,), "wo": (cfg.d_model, cfg.d_ff)}

            def dt(x):
                return distribute_tensor(x, mesh, [Shard(0), Replicate()])
            grads = {n: dt(torch.randn((1, *sz), generator=gen, device=dev))
                     for n, sz in shapes.items()}
            errs = {n: dt(torch.randn((1, *sz), generator=gen, device=dev)
                          * 1e-3) for n, sz in shapes.items()}
            codecs = {}
            for codec in ("bf16", "int8"):
                mean, err = compress.make_compressed_allreduce(
                    mesh, ("data",), codec)(grads, errs)
                same = True
                for n in shapes:
                    q, scale, e_new = compress.compress_leaf(
                        grads[n].to_local()[0], errs[n].to_local()[0], codec)
                    same &= torch.equal(mean[n].to_local(),
                                        compress._dequantize(q, scale, codec))
                    same &= torch.equal(err[n].to_local()[0], e_new)
                check(same, f"compressed all-reduce {codec} differs from "
                      f"compress_leaf")
                codecs[codec] = same
        finally:
            dist.destroy_process_group()
    emit({"phase": "train_mesh", "arch": TRAIN_ARCH, "layers":
          cfg.num_layers, "mesh": {"shape": [1, 1], "axes":
                                   ["data", "model"], "backend": "nccl"},
          "unmeshed": {"wall_s": wall0, **m0}, "steps": steps,
          "rel_diff": rel, "rtol": MB_RTOL, "master_max_abs_diff": dmaster,
          "launches": counts, "peak_memory_gib": peak,
          "unmeshed_master_copy_gib": copy_gib,
          "peak_memory_gib_less_copy": peak - copy_gib,
          "step_s_ratio_mesh_over_unmeshed": steps[-1]["wall_s"] / wall0,
          "checkpoint": {"layers": 2, "save_s": save_s, "restore_s":
                         restore_s, "bit_equal_on_mesh": ckpt_equal},
          "compressed_allreduce_bit_equal": codecs, "card": card})
    return counts


def llm_xlstm_path(dev, card):
    """``ServeEngine.generate`` on xlstm-350m (24 layers: 3 groups of 7
    mLSTM and 1 sLSTM, d_model 1,024, 4 heads, bf16, seeded random
    weights made on the card), run twice; no kernel launches (the
    reference's xLSTM has no Pallas kernel); prefill and decode rates;
    one prefill and one decode step under ``SyncSentinel`` (no ATen sync
    from ``models/xlstm.py`` or the ``models/ssm.py`` scan it runs on)."""
    from repro_torch.configs import ARCHS
    cfg = ARCHS[XLSTM_ARCH]
    free_card()
    torch.cuda.reset_peak_memory_stats(dev)
    model, init_s = make_model(cfg, dev)
    # The prefill's sLSTM steps (3 layers × 1,024 tokens, ~20 launches
    # each) would swamp the profiler's event list: the decode step only.
    runs, batch, _ = serve_runs(cfg, model, dev, 0, profile_prefill=False)
    with torch.inference_mode():
        sentinel, syncs = sentinel_syncs(
            cfg, model, batch, runs["bucket"],
            ("models/xlstm.py", "models/ssm.py"))
    check(syncs == 0, f"models/xlstm.py or ssm.py made {syncs} host "
          f"syncs: {sentinel['aten_sites']}")
    emit({"phase": "llm_xlstm", "arch": XLSTM_ARCH,
          "layers": cfg.num_layers, "slstm_every": cfg.xlstm_slstm_every,
          "d_model": cfg.d_model, "heads": cfg.num_heads,
          "dtype": cfg.dtype,
          "parameters": sum(p.numel() for p in model.parameters()),
          "param_count": cfg.param_count(), "init_s": init_s, **runs,
          "sentinel": sentinel,
          "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
          "card": card})


# ----------------------------------------------------------------------
# granite-3-2b in float32: the float32 flash kernels on a model's path.
# ----------------------------------------------------------------------
#: Phase llm_f32's new tokens per prompt.
LLM_F32_NEW_TOKENS = 8
#: Phase llm_f32's last prefill logits, kernel against plain attention,
#: both float32.  Each attention output is within FLASH_TOL[float32]
#: (1e-5 absolute and relative) of the plain version's (the three-TF32
#: products keep about 21 bits: ~5e-7 in the emulation), where the bf16
#: phase's roundings are one bf16 step (4e-3 relative) on a few outputs
#: a layer and move these logits (magnitude ~2) by ~0.05; 40 layers
#: carry a 1e-5 change to at most ~2e-4 at that gain, and 1e-3 leaves
#: five times that.  A wrong kernel (mask, head or scale) moves the
#: logits by their own size.
LLM_F32_LOGIT_ATOL = 1e-3
#: Phase train_f32's loss and gradient norm, kernels against the plain
#: attention, both float32: the gradients differ by at most BWD_TOL's
#: 1e-5 of their largest element and the attention outputs by
#: FLASH_TOL's 1e-5; the mean loss over 8,192 tokens and the global norm
#: over 2.5e9 coordinates average such differences down, so they move
#: well below 1e-5 relative: 1e-5 on the loss, ten times that on the
#: norm (a sum of squares that the largest gradients dominate).  In bf16
#: (``MB_RTOL``) the rounding of P alone sets 1e-3 / 1e-2.  This check is
#: a smoke test of the float32 training path, not a gate on the kernels'
#: precision: at random weights the loss sits near ln(vocab) and barely
#: reacts to attention error, and no control shows that a kernel with one
#: TF32 product per float32 product would miss these bounds.  The gate
#: on precision is phase kernels (``FLASH_TOL``, ``BWD_TOL``).
F32_TRAIN_RTOL = {"loss": 1e-5, "grad_norm": 1e-4}
#: Phase train_f32's AdamW steps (each ~3 s: the float32 products run on
#: the CUDA cores through cuBLAS).
F32_TRAIN_STEPS = 2


def f32_config(arch: str):
    """``arch``'s configuration with ``dtype="float32"`` (the reference's
    ``configs/base.py`` field): every weight, activation and flash call
    in float32."""
    from repro_torch.configs import ARCHS
    return dataclasses.replace(ARCHS[arch], dtype="float32")


def llm_f32_path(dev, card):
    """granite-3-2b at full width and depth in float32 (seeded random
    weights made on the card): ``ServeEngine.generate`` on the llm
    phases' 8 prompts (bucket 1024) with ``LLM_F32_NEW_TOKENS`` new
    tokens, ``flashattn`` launched once per layer of the prefill (the
    three-TF32 kernel) and never in decode; the prefill's last logits
    against the same model with ``flashattn_plain`` patched in
    (``LLM_F32_LOGIT_ATOL``, argmax equal on every prompt).  Returns the
    generate run's flash launches and the prefill's flash shape."""
    from repro_torch.kernels import flashattn as fa
    from repro_torch.models import attention
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine
    free_card()
    cfg = f32_config(LLM_ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    model, init_s = make_model(cfg, dev)
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          "llm_f32: a parameter is not float32")
    lens, prompts, s = llm_prompts(cfg.vocab_size)
    b, n_new = len(prompts), LLM_F32_NEW_TOKENS
    eng = engine.ServeEngine(cfg, model, max_len=s + n_new, device=dev)
    want = {"flashattn": cfg.num_layers}
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.generate(prompts, n_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: c for n, c in launches().items() if c}
    check(counts == want, f"float32 generate launched {counts}; {want} in "
          f"the prefill and none in decode belong to it")
    for p, o in zip(prompts, outs):
        check(o[:len(p)] == p and len(o) == len(p) + n_new and all(
            0 <= t < cfg.vocab_size for t in o[len(p):]),
              "float32 generate: prompt, length or vocabulary")
    batch = prompt_batch(prompts, s, dev)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = T.prefill(cfg, model, batch, max_len=s + n_new,
                              last_only=True)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        last = logits[:, -1]
        check(torch.isfinite(last).all().item(), "non-finite logits")
        check(last.argmax(-1).cpu().tolist() ==
              [o[len(p)] for p, o in zip(prompts, outs)],
              "float32 prefill's first token differs from generate's")
        with patched(attention, "flashattn", fa.flashattn_plain):
            plain, _ = T.prefill(cfg, model, batch, max_len=s + n_new,
                                 last_only=True)
        diff = float((plain[:, -1] - last).abs().max())
        agree = int((plain[:, -1].argmax(-1) == last.argmax(-1)).sum())
    check(diff <= LLM_F32_LOGIT_ATOL, f"float32 prefill logits: kernel vs "
          f"plain {diff} > {LLM_F32_LOGIT_ATOL}")
    check(agree == b, f"float32 prefill argmax: kernel and plain agree on "
          f"{agree} of {b} prompts")
    emit({"phase": "llm_f32", "arch": LLM_ARCH, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "dtype": cfg.dtype,
          "parameters": sum(p.numel() for p in model.parameters()),
          "weights_gb": sum(p.numel() * 4 for p in model.parameters()) / 1e9,
          "init_s": init_s, "prompts": b,
          "prompt_tokens": [int(n) for n in lens], "bucket": s,
          "new_tokens": n_new, "generate_wall_s": wall,
          "prefill_s": prefill_s, "launches_generate": counts,
          "logits_max_abs_diff_vs_plain": diff,
          "logits_magnitude": float(last.abs().max()),
          "logits_atol": LLM_F32_LOGIT_ATOL, "argmax_agree": f"{agree}/{b}",
          "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
          "card": card})
    del model, eng
    free_card()
    return counts["flashattn"], flash_shape(cfg, b, s)


def train_f32_path(dev, card) -> dict:
    """granite-3-2b at full width and depth in float32 (seeded random
    weights made on the card; parameters, gradients, m, v and master all
    float32): the loss and gradient norm at the fresh weights with the
    flash kernels and with the plain attention (``F32_TRAIN_RTOL``), then
    ``F32_TRAIN_STEPS`` AdamW steps (``TRAIN_OPT``, ``remat=True``) of
    ``TRAIN_BATCH`` × ``TRAIN_SEQ`` tokens, each timed, its peak memory
    and its launches recorded (``TRAIN_LAUNCHES`` per layer); the first
    batch's loss after them below its own before.  Returns the last
    step's launches."""
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import step as step_lib
    free_card()
    cfg = f32_config(TRAIN_ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    state = step_lib.init_train_state(
        cfg, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev)
    model = state["params"]
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params - uncounted_params(cfg) == cfg.param_count() and all(
        p.dtype == torch.float32 for p in model.parameters()),
          f"train_f32: {n_params} parameters, or not float32")
    state_gib = sum(t.numel() * t.element_size() for t in
                    [*model.parameters(), *state["opt"]["m"].values(),
                     *state["opt"]["v"].values(),
                     *state["opt"]["master"].values()]) / 2**30
    batches = train_batches(cfg.vocab_size)
    want = {n: k * cfg.num_layers for n, k in TRAIN_LAUNCHES.items()}
    vs_plain = train_vs_plain(cfg, model, batches[0], want, F32_TRAIN_RTOL)
    step = step_lib.make_train_step(cfg, opt_lib.AdamWConfig(**TRAIN_OPT),
                                    microbatches=1, remat=True)
    steps = []
    for i in range(F32_TRAIN_STEPS):
        torch.cuda.reset_peak_memory_stats(dev)
        state, m, wall, counts = timed_step(step, state, batches[i], dev)
        check(counts == want, f"float32 train step {i} launched {counts}, "
              f"not {want}")
        check(all(np.isfinite(v) for v in m.values()),
              f"float32 train step {i}: non-finite metrics {m}")
        steps.append({"step": i, "wall_s": wall, "tokens_per_s":
                      TRAIN_BATCH * TRAIN_SEQ / wall, "peak_memory_gib":
                      torch.cuda.max_memory_allocated(dev) / 2**30,
                      "launches": counts, **m})
    with torch.no_grad():
        after = float(T.loss_fn(cfg, model, {
            k: torch.as_tensor(v, device=dev)
            for k, v in batches[0].items()})[0])
    check(after < steps[0]["loss"], f"float32 train: batch 0's loss "
          f"{after} after the steps, {steps[0]['loss']} before")
    emit({"phase": "train_f32", "arch": TRAIN_ARCH,
          "layers": cfg.num_layers, "d_model": cfg.d_model,
          "dtype": cfg.dtype, "parameters": n_params,
          "state_gib": state_gib, "batch": [TRAIN_BATCH, TRAIN_SEQ],
          "optimizer": TRAIN_OPT, "remat": True, "steps": steps,
          "loss_batch0_after": after, "kernel_vs_plain": vs_plain,
          "card": card})
    del state, model, step
    free_card()
    return steps[-1]["launches"]


# ----------------------------------------------------------------------
# Kernel timing at the main path's shapes.
# ----------------------------------------------------------------------
def roofline_line(rec: dict, runs_s: list, path: str, card: str,
                  **extra) -> dict:
    """The phase roofline line of one path: the dry run's counts and
    terms, the phase's median time over ``runs_s`` (seconds), and the
    shares."""
    from repro_torch.roofline import HW
    rf = rec["roofline"]
    med = float(np.median(runs_s))
    bound_s = max(rec["compute_s_by_dtype"], rf["memory_s"],
                  rf["collective_s"])
    line = {"phase": "roofline", "path": path, "arch": rec["arch"],
            "kind": rec["kind"], "batch": rec["batch"], "seq": rec["seq"],
            "max_len": rec["max_len"], "tokens": rec["tokens"],
            "flops_by_dtype": rec["flops_by_dtype"],
            "flops": rf["hlo_flops_global"], "bytes": rf["hlo_bytes_global"],
            "collective_bytes": rec["collectives_per_device"],
            "terms_s": {k: rf[k] for k in ("compute_s", "memory_s",
                                             "collective_s")},
            "bottleneck": rf["bottleneck"],
            "compute_s_by_dtype": rec["compute_s_by_dtype"],
            "bound_s": bound_s,
            "bound_by": ("compute" if bound_s == rec["compute_s_by_dtype"]
                         else "memory" if bound_s == rf["memory_s"]
                         else "collective"),
            "model_flops": rf["model_flops"],
            "useful_flops_ratio": rf["useful_flops_ratio"],
            "kernels_declared": {k: v["calls"]
                                 for k, v in rec["kernels"].items()},
            "count_s": rec["compile_s"],
            "peak_estimate_gib": rec["memory"]["peak_estimate_bytes"] / 2**30,
            "measured_median_s": med, "measured_runs_s": runs_s,
            "roofline_share": bound_s / med,
            "roofline_share_at_bf16_peak": max(
                rf["compute_s"], rf["memory_s"], rf["collective_s"]) / med,
            "model_flops_share_of_peak": rf["model_flops"] / (
                med * HW["peak_flops"]), **extra, "card": card}
    emit(line)
    return line


def roofline_path(serve: dict, train: dict, card: str) -> None:
    """Phase roofline: each LLM path timed above, dry-run on the ``meta``
    device at the shape its phase ran (``roofline.dry_run``) beside the
    phase's median in this process; the train step also as the card
    counted it (phase train), whose FLOPs must equal the dry run's."""
    from repro_torch.configs import ARCHS
    from repro_torch.roofline import dry_run
    for arch, runs in serve.items():
        cfg, b, s = ARCHS[arch], runs["prompts"], runs["bucket"]
        max_len = s + runs["new_tokens"]
        roofline_line(dry_run(cfg, "prefill", b, s, max_len=max_len),
                      runs["prefill_runs_s"], f"{arch} prefill", card)
        if arch == LLM_ARCH:
            roofline_line(dry_run(cfg, "decode", b, s, max_len=max_len),
                          runs["decode_step_s"], f"{arch} decode step",
                          card)
    rec = dry_run(ARCHS[TRAIN_ARCH], "train", TRAIN_BATCH, TRAIN_SEQ,
                  remat=True)
    got = train["card_count"]
    check(got.flops == rec["cost"]["flops_per_device"],
          f"train step counted on the card: {got.flops} FLOPs "
          f"({got.flops_by_dtype}), the dry run {rec['flops_by_dtype']}")
    roofline_line(rec, train["step_s"], f"{TRAIN_ARCH} train step", card,
                  card_count={
                      "flops": got.flops,
                      "flops_by_dtype": got.flops_by_dtype,
                      "bytes": got.traffic_bytes,
                      "bytes_over_dry_run": got.traffic_bytes
                      - rec["cost"]["traffic_bytes_per_device"],
                      "collective_bytes": got.collective_bytes["total"],
                      "kernels_declared": {k: v["calls"] for k, v in
                                           got.kernels.items()},
                      "warnings": got.warnings[:5],
                      "wall_s": train["card_count_wall_s"],
                      "note": "the whole step: loss_fn forward and "
                              "backward as the dry run, plus the batch "
                              "upload and the AdamW update (no products)"})


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
    from repro_torch.roofline import kernels as costs
    table = []
    d = np.float32(s1.scenario_d)
    e_np, q_np, e, qt = batch_inputs(s1, "spatial")
    c, q = e.shape[0], qt.shape[1]

    def row(name, shape, err, ms, plain_ms, cost, **extra):
        label, n = counts[name]
        b = costs.bound_ms(cost.flops, cost.bytes)
        return {"name": name, "route": "cuda", "source": source(name),
                "replaces": REPLACES[name], "launches": n,
                "launches_counted_on": label, "shape": shape, **extra,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b[0], "bound_by": b[1], "library_ms": None}

    # The tile-prune preparation, then distthresh_compact and its
    # row-loop twin armed with its operands, as the main path runs them,
    # on the main path's largest dispatch.
    zeros = prep_equal(e_np, q_np, e, qt, d, "timing tile prep")
    arm = dict(zip(("e_mbr", "q_mbr", "d_prune"),
                   dt.distthresh_tile_prep(e, qt, d, device=dev)))
    table.append(row(
        PREP, [c, q], 0.0,
        graph_ms(lambda: dt.distthresh_tile_prep(e, qt, d, device=dev)),
        event_ms(lambda: dt.distthresh_tile_prep_plain(e, qt, d)),
        costs.distthresh_tile_prep_cost(c, q, 256, 256),
        box_zero_signs=zeros, grid_blocks=-(-c // 256) + -(-q // 256)))
    tiles = dt._tile_mbr_live(arm["e_mbr"], arm["q_mbr"], arm["d_prune"])
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
            costs.distthresh_cost(c, q, pairs, overlap, hits, "compact"),
            armed=True, dead_tiles=int((~tiles).sum()),
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
        costs.distthresh_cost(c, q, pairs, overlap, 0, "dense"),
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
            costs.distthresh_cost(c, q, pairs, overlap, hits, "live",
                                  slots=len(live[0])),
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
    """The flash kernel at an llm phase's prefill shape (seeded normal
    inputs), in the model's dtype or ``dtype``: kernel, plain version and
    ``scaled_dot_product_attention`` on the same tensors (SDPA is the
    yardstick only; the port never calls it)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flashattn as fa
    from repro_torch.roofline import kernels as costs
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
    ms_lse = graph_ms(lambda: fa.flashattn_fwd(q, k, v, g=g))
    plain_ms = event_ms(lambda: fa.flashattn_plain(q, k, v, g=g))
    library_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        lib_q, lib_k, lib_v, is_causal=True, enable_gqa=True))
    # Work this call needs: 4·hd FLOPs per causal (row, key) pair, q, k
    # and v read and the output written once.
    work = costs.flash_fwd_cost(bh, bkv, s, t, hd, dtype)
    b_ms, b_by = costs.bound_ms(work.flops, work.bytes)
    return {"name": "flashattn", "route": "cuda",
            "source": source("flashattn"), "replaces": REPLACES["flashattn"],
            "launches": n_launches, "launches_counted_on":
            f"{LLM_ARCH} ServeEngine.generate ({LLM_PROMPTS} prompts, "
            f"bucket {s}, {LLM_NEW_TOKENS} new tokens)",
            "shape": {"bh": bh, "bkv": bkv, "s": s, "t": t, "hd": hd,
                      "dtype": str(dtype)},
            "max_abs_err": err, "library_max_abs_err": lib_err, "ms": ms,
            "ms_with_lse": ms_lse, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms}


#: The backward's kernels, as the profiler and ptxas name them, per dtype,
#: by their ``LAUNCHES`` names.
BWD_KERNEL_NAMES = {
    torch.bfloat16: {
        "flashattn_bwd_delta": "flashattn_bwd_delta_kernel<bf16>",
        "flashattn_bwd_dkdv": "flashattn_bwd_dkdv_wgmma_kernel",
        "flashattn_bwd_dq": "flashattn_bwd_dq_wgmma_kernel"},
    torch.float32: {
        "flashattn_bwd_delta": "flashattn_bwd_delta_kernel<float>",
        "flashattn_bwd_dkdv": "flashattn_bwd_dkdv_tf32x3_kernel",
        "flashattn_bwd_dq": "flashattn_bwd_dq_tf32x3_kernel"}}


def flash_ptxas(log: str) -> dict:
    """Registers and spills of every flash instantiation (forward and
    backward, bf16 and float32), from the flashattn.cu compile's ``ptxas
    -v``, by short name; fails if a bf16 backward kernel spills at hd 64
    (granite's training shape)."""
    out = {}
    for raw, info in ptxas_summary(log).items():
        m = re.search(r"\d+(flashattn\w*?_kernel)I(?:Li(\d+)E)?"
                      r"(f|13__nv_bfloat16)?", raw)
        if m:
            arg = m.group(2) or ("float" if m.group(3) == "f" else "bf16")
            out[f"{m.group(1)}<{arg}>"] = info
    for name in ("flashattn_bwd_dkdv_wgmma_kernel<64>",
                 "flashattn_bwd_dq_wgmma_kernel<64>"):
        check(name in out, f"ptxas reported no {name}")
        check(" 0 bytes spill stores" in " " + out[name],
              f"{name} spills: {out[name]}")
    return out


def flash_bwd_timing(dev, launches: dict, counted_on: str,
                     dtype=torch.bfloat16) -> dict:
    """The flash backward at granite-3-2b's training shape
    (``TRAIN_FLASH``, in ``dtype``, seeded normal inputs, the kernel
    forward's o and lse): the three kernels (one wrapper call, and each kernel's
    device time per launch under the profiler), the plain backward, and
    the backward of ``scaled_dot_product_attention(is_causal=True,
    enable_gqa=True)`` on the same tensors (the yardstick only; the port
    never calls it), with the bound of the work."""
    import torch.nn.functional as F

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import flashattn as fa
    from repro_torch.roofline import kernels as costs
    gen = torch.Generator(device=dev).manual_seed(11)
    bkv, g, s, hd = TRAIN_FLASH
    bh, t = bkv * g, s
    q, do = (torch.randn((bh, s, hd), generator=gen, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn((bkv, t, hd), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    o, lse = fa.flashattn_fwd(q, k, v, g=g)
    got = fa.flashattn_bwd(q, k, v, o, lse, do, g=g)
    want = fa.flashattn_bwd_plain(q, k, v, o, lse, do, g=g)
    err = max(bwd_close(a, b, dtype, w)[0]
              for a, b, w in zip(got, want, ("dq", "dk", "dv")))
    # SDPA's layout: (batch, heads, S, hd), the kernel's bh = (b·KVH +
    # kvh)·g + j being head kvh·g + j of batch b; S = T, so its is_causal
    # mask (aligned to the first key) is the kernel's.
    n_kv = ARCHS[LLM_ARCH].num_kv_heads
    lq, lk, lv = (x.detach().view(bkv // n_kv, -1, x.shape[1], hd)
                  .requires_grad_() for x in (q, k, v))
    lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                        enable_gqa=True)
    ldo = do.view(bkv // n_kv, -1, s, hd)

    def library():
        return torch.autograd.grad(lo, (lq, lk, lv), ldo, retain_graph=True)

    # In bf16 SDPA's backward rounds its probabilities and score gradients
    # to bf16: held to the same function only loosely (a wrong layout misses
    # by the gradients' own size).
    lib_err = max(float((a.reshape(b.shape).float() - b.float()).abs().max()
                        / b.float().abs().max())
                  for a, b in zip(library(), want))
    check(lib_err <= LIBRARY_ATOL, f"SDPA backward vs plain: {lib_err}")
    ms = graph_ms(lambda: fa.flashattn_bwd(q, k, v, o, lse, do, g=g))
    plain_ms = event_ms(lambda: fa.flashattn_bwd_plain(q, k, v, o, lse, do,
                                                       g=g))
    library_ms = event_ms(library, iters=20)
    # Each kernel's device time per launch, averaged over the launches
    # the profiler recorded in 20 wrapper calls (on an H100 it has kept
    # as few as 11 of 20 delta launches).
    n_calls = 20
    _, _, _, _, top = profiled(lambda: [
        fa.flashattn_bwd(q, k, v, o, lse, do, g=g) for _ in range(n_calls)],
        by=lambda name: next((n for n in fa.BWD_KERNELS if n in name), None))
    kernel_ms, profiled_launches = {}, {}
    for name in fa.BWD_KERNELS:
        rec = top["by_kind"].get(name, {"n": 0, "us": 0.0})
        check(1 <= rec["n"] <= n_calls,
              f"profiler: {rec['n']} {name} launches in {n_calls} calls")
        kernel_ms[name] = rec["us"] * 1e-3 / rec["n"]
        profiled_launches[name] = rec["n"]
    # Five products of 2·hd flops per causal (row, key) pair (scores,
    # dO·Vᵀ, dV, dQ, dK); q, k, v, o, do and lse read and dq, dk and dv
    # written once.
    work = costs.flash_bwd_cost(bh, bkv, s, t, hd, dtype)
    b_ms, b_by = costs.bound_ms(work.flops, work.bytes)
    return {"name": "flashattn_bwd", "route": "cuda",
            "source": source("flashattn"),
            "replaces": "src/repro/models/attention.py:175",
            "replaces_note": "no pallas_call: the reference's flash "
                             "backward is jnp (_flash_bwd, the custom "
                             "VJP of chunked_causal_attention)",
            "launches": launches["flashattn_bwd_dkdv"],
            "launches_by_kernel": {n: launches[n] for n in fa.BWD_KERNELS},
            "launches_counted_on": counted_on,
            "kernels": {n: k if k.endswith(">") else f"{k}<{hd}>"
                        for n, k in BWD_KERNEL_NAMES[dtype].items()},
            "kernel_ms": kernel_ms,
            "kernel_ms_over_launches": profiled_launches,
            "shape": {"bh": bh, "bkv": bkv, "s": s, "t": t, "hd": hd,
                      "dtype": str(dtype)},
            "max_abs_err": err, "library_max_rel_err": lib_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms,
            "library": "scaled_dot_product_attention backward "
                       "(enable_gqa), CUDA events",
            "note": "ms: one wrapper call (three launches), CUDA graph; "
                    "kernel_ms: device time per launch, torch.profiler"}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build

    from repro_torch.kernels.flashattn import BWD_KERNELS

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
        from repro_torch.kernels.flashattn import HEAD_DIMS
        wg = {k: v for k, v in sass.items()
              if "wgmma" in k or "tf32x3" in k}
        # The forward and the backward's dK/dV and dQ kernels, per hd, in
        # bf16 and in float32.
        check(len(wg) == 6 * len(HEAD_DIMS) and all(
            v["HGMMA"] and v["UTMALDG"] for v in wg.values()),
              f"flash kernels without HGMMA or UTMALDG: {wg}")
    emit({"phase": "build", "seconds": build_s,
          "nvcc_seconds": _build.build_seconds,
          "built": [*REPLACES, *BWD_KERNELS], "ptxas": {
              src: ptxas_summary(log)
              for src, log in _build.build_log.items()},
          "ptxas_flash": flash_ptxas(_build.build_log["flashattn.cu"])
          if _build.build_log else "null: the library came from the cache",
          "sass": sass if sass is not None else
          "null: the toolkit has no cuobjdump"})

    if len(sys.argv) == 3 and sys.argv[1] == "--property-case":
        # Rerun one case of phase properties: its line, or the failure.
        i = int(sys.argv[2])
        emit({"property_case": i, **property_case(i, dev), "card": card})
        return 0
    if sys.argv[1:] == ["--prep"]:
        # The distance kernels' checks and phase prep alone.
        from repro_torch.api import TrajectoryDB
        t0 = time.perf_counter()
        checks = kernel_checks(dev)
        emit({"phase": "kernels", "seconds": time.perf_counter() - t0,
              "rtol": K_RTOL, "atol": K_ATOL, **checks})
        prep_path(dev, TrajectoryDB.from_scenario("S1", scale=1.0,
                                                  device=dev), card)
        emit({"ok": True, "phases": ["kernels", "prep"]})
        return 0

    lint_path(card)

    t0 = time.perf_counter()
    checks = kernel_checks(dev)
    flash = flash_checks(dev)
    checks["max_abs_err"]["flashattn"] = flash.pop("max_abs_err")
    flash_bwd = flash_bwd_checks(dev)
    checks["max_abs_err"]["flashattn_bwd"] = flash_bwd.pop("max_abs_err")
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0,
          "rtol": K_RTOL, "atol": K_ATOL, **checks, "flashattn": flash,
          "flashattn_bwd": flash_bwd})

    (s1, main_res, main_wall, main_counts, dense_res,
     dense_counts) = main_path(dev, card)
    prep_path(dev, s1, card)
    profile_main(s1, main_res, card)
    profile_main(s1, dense_res, card, "dense")
    shard_res, shard_pol, shard_counts = shard_path(s1, main_res, main_wall,
                                                    card)
    sentinel_path(s1, main_res, dense_res, shard_res, shard_pol, card)
    dbs, path_counts, mode_results = mode_matrix(dev, card)
    properties_path(dev, card)
    shard_mode_counts = shard_modes(dbs, mode_results, card)
    rtree_path(dev, card)
    ladder_counts, tickets = serve_path(s1, main_res, card)
    profile_ticket2(s1, card)
    route_counts = shard_serve(s1, shard_res, shard_pol, card)
    fit_path(s1, tickets, card)
    stream_db, stream_base = stream_path(dev, card)
    shard_stream(stream_db, stream_base, card)
    flash_launches, flash_shape, llm_runs = llm_path(dev, card)
    moe_launches, moe_shape, moe_runs = llm_moe_path(dev, card)
    embed_launches = llm_embed_path(dev, card)
    hybrid_launches, hybrid_shape, hybrid_runs = llm_hybrid_path(dev, card)
    llm_xlstm_path(dev, card)
    f32_launches, f32_shape = llm_f32_path(dev, card)
    train_launches, train_step_s, train_runs = train_path(dev, card)
    kvrep_launches = train_kvrep_path(dev, card, train_step_s)
    mesh_launches = train_mesh_path(dev, card)
    train_f32_launches = train_f32_path(dev, card)
    roofline_path({LLM_ARCH: llm_runs, MOE_ARCH: moe_runs,
                   HYBRID_ARCH: hybrid_runs}, train_runs, card)
    c3_live = path_counts[("C3", "hierarchical/fused")]
    c3_live_rowloop = path_counts[("C3", "hierarchical/fused_rowloop")]
    counts = {
        "distthresh_compact": ("S1 scale 1.0, default policy (main path)",
                               main_counts["distthresh_compact"]),
        PREP: ("S1 scale 1.0, default policy (main path)",
               main_counts[PREP]),
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
    # The bf16 flash kernel at qwen3's prefill shape (hd 128, g 8).
    moe_flash = flash_timing(dev, moe_shape, moe_launches)
    moe_flash["launches_counted_on"] = (
        f"{MOE_ARCH} ServeEngine.generate ({LLM_PROMPTS} prompts, bucket "
        f"{moe_shape['s']}, {LLM_NEW_TOKENS} new tokens)")
    emit({"phase": "timing_flash_moe", **moe_flash, "card": card})
    # The bf16 flash kernel at zamba2-7b's prefill shape (hd 112, g 1).
    hybrid_flash = flash_timing(dev, hybrid_shape, hybrid_launches)
    hybrid_flash["launches_counted_on"] = (
        f"{HYBRID_ARCH} ServeEngine.generate ({LLM_PROMPTS} prompts, "
        f"bucket {hybrid_shape['s']}, {LLM_NEW_TOKENS} new tokens)")
    emit({"phase": "timing_flash_hybrid", **hybrid_flash, "card": card})
    train_on = (f"{TRAIN_ARCH} train step ({TRAIN_BATCH} × {TRAIN_SEQ} "
                f"tokens, remat)")
    by_name["flashattn"]["launches_other_paths"] = {
        moe_flash["launches_counted_on"]: moe_launches,
        f"{EMBED_ARCH} prefill (8 × 1,024 embeddings)": embed_launches,
        hybrid_flash["launches_counted_on"]: hybrid_launches,
        train_on + ", with lse": train_launches["flashattn"]}
    kvrep_on = f"{train_on}, kv_replication={KVREP} (g 2), with lse"
    mesh_on = f"{train_on} on a (1, 1) mesh, through local_map, with lse"
    by_name["flashattn"]["launches_other_paths"].update({
        kvrep_on: kvrep_launches["flashattn"],
        mesh_on: mesh_launches["flashattn"]})
    by_name["flashattn_bwd"] = flash_bwd_timing(dev, train_launches,
                                                train_on)
    by_name["flashattn_bwd"]["launches_other_paths"] = {
        kvrep_on: {k: n for k, n in kvrep_launches.items()
                   if k.startswith("flashattn_bwd")},
        mesh_on: {k: n for k, n in mesh_launches.items()
                  if k.startswith("flashattn_bwd")}}
    # The float32 kernels (rows 6-f32 and 6b-f32): the forward at
    # granite's prefill shape, counted on phase llm_f32, and the backward
    # at its training shape, counted on phase train_f32.
    train_f32_on = (f"{TRAIN_ARCH} float32 train step ({TRAIN_BATCH} × "
                    f"{TRAIN_SEQ} tokens, remat)")
    f32 = flash_timing(dev, f32_shape, f32_launches)
    f32.update(name="flashattn_f32", kernel="flashattn_tf32x3_kernel<64>",
               launches_counted_on=(
                   f"{LLM_ARCH} float32 ServeEngine.generate ({LLM_PROMPTS} "
                   f"prompts, bucket {f32_shape['s']}, {LLM_F32_NEW_TOKENS} "
                   f"new tokens)"),
               launches_other_paths={train_f32_on + ", with lse":
                                     train_f32_launches["flashattn"]})
    by_name["flashattn_f32"] = f32
    f32_bwd = flash_bwd_timing(dev, train_f32_launches, train_f32_on,
                               torch.float32)
    f32_bwd["name"] = "flashattn_bwd_f32"
    by_name["flashattn_bwd_f32"] = f32_bwd
    by_name["flashattn"]["other_shapes"] = [{
        k: row[k] for k in ("shape", "launches", "max_abs_err", "ms",
                            "plain_ms", "bound_ms", "bound_by",
                            "library_ms")} for row in (moe_flash,
                                                       hybrid_flash)]
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
        "flashattn": {}, "flashattn_bwd": {}, "flashattn_f32": {},
        "flashattn_bwd_f32": {}}
    for name, paths in shard_launches.items():
        by_name[name]["launches_shard"] = paths
    table = [by_name[name] for name in (*REPLACES, "flashattn_bwd",
                                        "flashattn_f32", "flashattn_bwd_f32")]
    torch.cuda.synchronize()

    emit({"kernels": table})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
