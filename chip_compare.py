#!/usr/bin/env python3
"""Time the port's distance kernels and profile the paths that launch
them, on one CUDA card, for one source tree.

    python3 chip_compare.py [--tree DIR]

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
(one warm execution of the main path).
"""
import argparse
import os
import sys

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
    cs.profile_main(db, card, "dense")
    cs.profile_ticket2(db, card)
    cs.profile_main(db, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
