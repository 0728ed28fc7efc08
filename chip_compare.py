#!/usr/bin/env python3
"""Time the port's distance kernels and profile the paths that launch
them, on one CUDA card, for one source tree.

    python3 chip_compare.py [--tree DIR] [--train]

``DIR`` (default: this checkout) is the root of a checkout whose
``src/repro_torch`` is measured, kernels built from its own sources; the
measuring code is this checkout's ``chip_smoke.py``.  To compare two
commits, unpack the older one into a git-ignored directory and run both
on one card in turns::

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    for t in build/parent . . build/parent; do
        python3 chip_compare.py --tree $t; done

Each run prints JSON lines: the tree and the card; for S1's largest batch
at scale 1.0 (7,500 × 100) the chunk, row-loop and dense kernels' time
per wrapper call (CUDA graph) and per launch (``torch.profiler``); then
``chip_smoke.py``'s phases profile_dense (one warm execution of the dense
path), profile_ticket2 (serve ticket 2 on the row-loop rung) and profile
(one warm execution of the main path).  With ``--train`` it times
instead ``chip_smoke.py``'s training path: granite-3-2b at full width
and depth, bf16, seeded weights, ``make_train_step`` with remat at
``chip_smoke.TRAIN_OPT`` over ``chip_smoke.train_batches`` (6 steps of 8
× 1,024 tokens), each step's wall between two synchronizes.
"""
import argparse
import os
import sys
import types

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def kernel_us(fn, n: int = 30) -> dict:
    """Device microseconds per launch of each distance kernel that ``n``
    calls of ``fn`` launch, under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {ev.key[:60]: ev.device_time_total / ev.count
            for ev in prof.key_averages() if "distthresh" in ev.key}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=HERE,
                    help="root of the checkout to measure")
    ap.add_argument("--train", action="store_true",
                    help="time granite-3-2b's train step instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_compare: CUDA is not available", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    sys.path.insert(1, HERE)
    import chip_smoke as cs
    from repro_torch.api import TrajectoryDB
    from repro_torch.kernels import distthresh as dt

    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    cs.emit({"tree": tree, "card": card})
    if args.train:
        return train_steps(cs, dev, card)
    db = TrajectoryDB.from_scenario("S1", scale=1.0, device=dev)
    _, _, e, qt = cs.batch_inputs(db, "spatial")
    d = np.float32(db.scenario_d)
    cap = max(int(dt.distthresh_compact_plain(e, qt, d, capacity=1)[4]), 1)
    calls = {
        "distthresh_compact": lambda: dt.distthresh_compact(
            e, qt, d, capacity=cap, device=dev),
        "distthresh_compact_rowloop": lambda: dt.distthresh_compact(
            e, qt, d, capacity=cap, append="rowloop", device=dev),
        "distthresh_dense": lambda: dt.distthresh_dense(e, qt, d,
                                                        device=dev)}
    for name, fn in calls.items():
        cs.emit({"kernel": name, "shape": [e.shape[0], qt.shape[1]],
                 "ms": cs.graph_ms(fn), "kernel_us": kernel_us(fn),
                 "card": card})
    for compaction in ("dense", None):
        pol = db.policy if compaction is None else db.policy.with_(
            compaction=compaction)
        planned = types.SimpleNamespace(plan=db.plan(
            db.scenario_queries, pol, d=db.scenario_d))
        cs.profile_main(db, planned, card, compaction)
        if compaction:
            cs.profile_ticket2(db, card)
    return 0


def train_steps(cs, dev, card) -> int:
    """Each of ``chip_smoke.train_batches``' steps of granite-3-2b, timed
    as phase train times them."""
    from repro_torch.configs import ARCHS
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import step as step_lib
    cfg = ARCHS[cs.TRAIN_ARCH]
    state = step_lib.init_train_state(
        cfg, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev)
    step = step_lib.make_train_step(cfg, opt_lib.AdamWConfig(**cs.TRAIN_OPT),
                                    remat=True)
    walls, losses = [], []
    for batch in cs.train_batches(cfg.vocab_size):
        state, m, wall, _ = cs.timed_step(step, state, batch, dev)
        walls.append(wall)
        losses.append(m["loss"])
    cs.emit({"train_step": cs.TRAIN_ARCH, "batch": [cs.TRAIN_BATCH,
                                                    cs.TRAIN_SEQ],
             "wall_s": walls, "loss": losses, "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
