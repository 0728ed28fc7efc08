#!/usr/bin/env python3
"""How much spatial pruning the prune slack leaves, per scenario, on the
CPU, for one source tree.

    python3 prune_scale_report.py [--tree DIR] [--scale S] [--scenarios S1,S3]

``DIR`` (default: this checkout) is the root of a checkout whose
``src/repro_torch`` is measured.  For each of the paper's scenarios
(S1-S10) and C1 and C3, at ``--scale`` (default 0.01), the script builds
``TrajectoryDB.from_scenario(..., device="cpu")`` and prints one JSON
line: the database's and queries' sizes, ``d``, the largest coordinate,
the slack of the index's prune threshold for these queries at ``d``
(``TemporalBinIndex.prune_threshold(d, queries) − d``), and, for
``pruning`` none, spatial and hierarchical (K = 4 boxes), the candidate
interactions the plan dispatches, the interactions the planner pruned,
the kernel tiles the tile test skipped of all tiles, and the hits.  The
kernel path runs its plain twins here, so the tile counts are those the
card's early-out would see.  To compare two commits, unpack the older
one into a git-ignored directory and run both::

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 prune_scale_report.py --tree build/parent
    python3 prune_scale_report.py
"""
import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SCENARIOS = ("S1", "S2", "S3", "S4", "S5", "S6", "S7", "S8", "S9", "S10",
             "C1", "C3")


def report(name: str, scale: float) -> dict:
    from repro_torch.api import ExecutionPolicy, TrajectoryDB
    t0 = time.perf_counter()
    db = TrajectoryDB.from_scenario(name, scale=scale, device="cpu")
    q, d = db.scenario_queries, db.scenario_d
    boxes = TrajectoryDB(db.segments, device="cpu",
                         policy=ExecutionPolicy(index_kboxes=4))
    out = {"scenario": name, "scale": scale, "entries": len(db),
           "queries": len(q), "d": d,
           "coords": max(float(np.abs(db.segments.packed()[:, 0:6]).max()),
                         float(np.abs(q.packed()[:, 0:6]).max()), 1.0),
           "slack": db.index.prune_threshold(d, q.packed()) - d}
    modes = {}
    for pruning, tdb in (("none", db), ("spatial", db),
                         ("hierarchical", boxes)):
        res = tdb.query(q, d, backend="kernel", pruning=pruning)
        st = res.stats
        modes[pruning] = {
            "interactions": int(st.total_interactions),
            "pruned_interactions": int(st.pruned_interactions),
            "pruned_tiles": int(sum(b.pruned_tiles for b in st.batches)),
            "tiles": int(sum(b.num_tiles for b in st.batches)),
            "hits": len(res)}
    out["modes"] = modes
    out["seconds"] = time.perf_counter() - t0
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=HERE,
                    help="root of the checkout to measure")
    ap.add_argument("--scale", type=float, default=0.01)
    ap.add_argument("--scenarios", default=",".join(SCENARIOS))
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    import repro_torch
    print(json.dumps({"tree": tree, "package": repro_torch.__file__}),
          flush=True)
    for name in args.scenarios.split(","):
        print(json.dumps(report(name, args.scale)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
