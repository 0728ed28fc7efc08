"""``correct``: the sampled answers of the window against the reference.

Each number of ``perfbench.reference.compare`` is taken as its worst over
the sampled requests and held to the limit the configuration states
(``check_limits``): a run is correct when every number is at or under its
limit and no request failed.
"""
from __future__ import annotations

import time

import numpy as np

from perfbench.reference.compare import compare
from perfbench.reference.distthresh import Reference, exact

NUMBERS = ("row_errors", "flip_ratio", "interval_ratio")


def answer_of(result) -> dict:
    """The rows of a ``QueryResult`` as the comparison reads them."""
    return {"entry_traj": np.asarray(result.entry_traj),
            "entry_seg": np.asarray(result.entry_seg),
            "entry_idx": np.asarray(result.entry_idx),
            "query_idx": np.asarray(result.query_idx),
            "t_enter": np.asarray(result.t_enter),
            "t_exit": np.asarray(result.t_exit)}


def reference_answer(ref: Reference, db: dict, qs: dict, d: float,
                     r=exact) -> dict:
    """The reference's own rows in an answer's form (``r=bf16``: the
    control)."""
    rows = ref.query(qs, d, r)
    return {"entry_traj": db["traj_id"][rows["e"]],
            "entry_seg": db["seg_id"][rows["e"]],
            "entry_idx": rows["e"], "query_idx": rows["q"],
            "t_enter": rows["t_enter"], "t_exit": rows["t_exit"]}


def judge(samples: list, dataset, d: float, limits: dict,
          ref: Reference | None = None) -> dict:
    """Worst numbers over ``samples`` (``(query rows, answer)`` pairs) and
    the verdict."""
    t0 = time.perf_counter()
    ref = ref or Reference(dataset.cols)
    worst = {k: 0 for k in NUMBERS}
    rows = 0
    for q_rows, answer in samples:
        qs = dataset.take(q_rows)
        got = compare(answer, ref.query(qs, d), dataset.cols, qs,
                      dataset.traj_slices, d)
        rows += got["rows"]
        for k in NUMBERS:
            worst[k] = max(worst[k], got[k])
    ok = all(worst[k] <= limits[k] for k in NUMBERS)
    return {"ok": ok, "numbers": worst, "rows_compared": rows,
            "requests_compared": len(samples),
            "seconds": time.perf_counter() - t0}
