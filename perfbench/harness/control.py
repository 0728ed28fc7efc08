"""The control of ``correct``: the reference, in bfloat16, in the program's
place.

The configurations state float32; the precision below it is bfloat16.  For
each seed this draws the seed's database and the cell's first
``check_requests`` requests from the seed's stream, as a run does, answers them with the reference computed in bfloat16
(inputs, every step and the outputs rounded), and judges those answers
exactly as a run judges the program's.  A sound comparison reads them as
not correct.  Run from the root of a checkout:

    python3 -m perfbench.harness.control --workload s1.search --seeds 1 2 3
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from perfbench.data import trajgen
from perfbench.harness import spec as spec_mod
from perfbench.harness.check import judge, reference_answer
from perfbench.harness.traffic import RequestStream, query_rows
from perfbench.reference.distthresh import Reference, bf16


def readings(workload: str, seed: int, *, scale: float = 1.0) -> dict:
    cell = spec_mod.load_cell(workload)
    cfg, mix = cell.config, cell.traffic
    d = float(cfg["d"])
    seed = seed % 2 ** 64
    dataset = trajgen.make(cfg["dataset"], cfg["dataset_params"],
                           seed=[seed, 0], scale=scale)
    stream = RequestStream(mix, len(dataset.traj_slices),
                           np.random.default_rng([seed, 1]))
    ref = Reference(dataset.cols)
    samples = []
    for _ in range(int(mix.get("check_requests", 1))):
        rows = query_rows(dataset.traj_slices, next(stream))
        samples.append((rows, reference_answer(ref, dataset.cols,
                                               dataset.take(rows), d, bf16)))
    return judge(samples, dataset, d, cfg["check_limits"], ref)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    for seed in args.seeds:
        got = readings(args.workload, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": got["ok"], **got["numbers"],
                          "rows_compared": got["rows_compared"]}), flush=True)


if __name__ == "__main__":
    main()
