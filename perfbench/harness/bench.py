"""One run of one cell: set-up, the measured window, the metrics, the check.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up draws the configuration's database from ``--seed`` with the
benchmark's copy of the paper's generator, hands it to the program
(``TrajectoryDB``, the port's query facade, on the card), and runs the
mix's warm-up requests through the mix's client (``clients/<name>.py``),
so that the kernel library is loaded and every path the window takes has
run once.  The window then runs the closed loop for ``--seconds``: a
request is timed from the client's call to its full answer in the
caller's order, and the window ends with the first answer after the
deadline, so that every rate is the work of whole requests over the time
they took.  With ``--trace 1`` the window's first ``trace_requests``
requests run under ``torch.profiler`` and the span wrappers
(``perfbench.harness.trace``) and the per-layer metrics are read from
them; with ``--trace 0`` nothing is wrapped and the end-to-end metrics are
read.

The requests are drawn from ``--seed`` too.  After the window a seeded
sample of its answers is compared with the NumPy reference
(``perfbench.harness.check``).  The last line of standard output is the
result; the numbers compared, each beside its limit, are the last lines
of standard error and the result's last key.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import gc
import heapq
import json
import resource
import subprocess
import sys
import time

import numpy as np

from perfbench.data import trajgen
from perfbench.harness import spec as spec_mod
from perfbench.harness.check import answer_of, judge
from perfbench.harness.cost import Work
from perfbench.harness.trace import DeviceTrace, Spans, wrapped
from perfbench.harness.traffic import RequestStream, query_rows

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

#: glibc's ``mallopt`` parameters
M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3


def steady_allocator() -> None:
    """Keep freed memory in glibc's heap.  By default each temporary of
    128 KiB or more is its own ``mmap``, returned on ``free``, so every
    request's large numpy and torch temporaries fault their pages in
    afresh and the kernel zeroes them: work whose cost follows the
    machine's memory traffic, not the program's."""
    try:
        libc = ctypes.CDLL(None)
        libc.mallopt(M_MMAP_THRESHOLD, 32 << 20)     # glibc's largest
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)
    except (OSError, AttributeError):
        pass


def steady_collector() -> None:
    """Move what set-up made out of the garbage collector's generations,
    so that a full collection in the window walks only the window's
    objects."""
    gc.collect()
    gc.freeze()


@dataclasses.dataclass
class Traced:
    requests: list             # the traced requests' records
    spans: Spans
    device: DeviceTrace | None


@dataclasses.dataclass
class Observations:
    """What the metric readers read (``metrics/<name>.py``)."""

    setup_s: float
    window_s: float
    requests: list             # every window request: latency_s, trajectories, stats
    peak_window_bytes: int
    traced: Traced | None = None


class Sample:
    """A seeded uniform sample of ``size`` of the window's answers: each
    answer draws a key, and the ``size`` smallest keys are kept."""

    def __init__(self, size: int, rng):
        self.size, self.rng, self.heap = size, rng, []   # (-key, i, item)

    def offer(self, i: int, item) -> None:
        key = self.rng.random()
        if len(self.heap) < self.size:
            heapq.heappush(self.heap, (-key, i, item))
        elif -self.heap[0][0] > key:
            heapq.heapreplace(self.heap, (-key, i, item))

    def items(self) -> list:
        return [item for _, _, item in sorted(self.heap, key=lambda h: h[1])]


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _stats(stats) -> dict | None:
    if stats is None:
        return None
    return {"invocations": stats.num_invocations,
            "retries": stats.total_retries,
            "dispatch_s": stats.dispatch_seconds,
            "execute_s": stats.total_seconds, "sync_s": stats.sync_seconds,
            "syncs": stats.num_syncs, "groups": stats.num_groups,
            "interactions": stats.total_interactions,
            "hits": stats.total_hits}


def _card_info() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def _log_window(records: list, window_s: float, usage: dict,
                verdict: dict) -> None:
    """What the window did, on standard error (for the record)."""
    lat = np.array([r["latency_s"] for r in records] or [0.0])

    def total(key):
        return sum(r["stats"][key] for r in records if r["stats"])

    print(f"perfbench: work segments {sum(r['segments'] for r in records)}, "
          f"rows {sum(r['rows'] for r in records)}, batches "
          f"{total('invocations')}, retries {total('retries')}; host s: "
          f"request {lat.sum():.3f}, execute {total('execute_s'):.3f}, "
          f"dispatch {total('dispatch_s'):.3f}, sync {total('sync_s'):.3f}; "
          f"latency median {np.median(lat):.4f} s, max {lat.max():.4f} s",
          file=sys.stderr)
    print(f"perfbench: window {window_s:.3f} s (this process: user "
          f"{usage['ru_utime']:.3f} s, system {usage['ru_stime']:.3f} s, "
          f"{usage['ru_minflt']} minor and {usage['ru_majflt']} major "
          f"page faults, {usage['ru_nvcsw']} voluntary and "
          f"{usage['ru_nivcsw']} involuntary context switches), "
          f"{len(records)} answers; "
          f"{verdict['requests_compared']} requests, "
          f"{verdict['rows_compared']} rows compared with the reference in "
          f"{verdict['seconds']:.3f} s", file=sys.stderr)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(argv=None, *, t0: float | None = None, device: str = "cuda",
        scale: float = 1.0) -> int:
    """One run; returns the exit code.  ``device`` and ``scale`` exist for
    the CPU tests, which drive a run without a card at a small size."""
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    cell = spec_mod.load_cell(args.workload)

    import torch
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"perfbench: the cell {cell.name} needs {cell.chips} CUDA "
                  f"device(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
    from repro_torch.api import ExecutionPolicy, TrajectoryDB
    from repro_torch.core.segments import SegmentArray

    steady_allocator()
    phases = {"imports": time.perf_counter() - t0}
    cfg, mix = cell.config, cell.traffic
    seed = args.seed % 2 ** 64
    d = float(cfg["d"])
    dataset = trajgen.make(cfg["dataset"], cfg["dataset_params"],
                           seed=[seed, 0], scale=scale)
    phases["data"] = time.perf_counter() - t0 - sum(phases.values())
    db = TrajectoryDB.from_segments(SegmentArray(**dataset.cols),
                                    policy=ExecutionPolicy(**cfg["policy"]),
                                    device=device)
    issue = spec_mod.client(mix["client"])(db, d, mix)
    num_traj = len(dataset.traj_slices)
    phases["database"] = time.perf_counter() - t0 - sum(phases.values())

    def request(traj_ids):
        rows = query_rows(dataset.traj_slices, traj_ids)
        qs = SegmentArray(**dataset.take(rows))
        t = time.perf_counter()
        res = issue(qs)
        return rows, res, time.perf_counter() - t

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    warm = RequestStream(mix, num_traj, np.random.default_rng([seed, 2]))
    for _ in range(int(mix.get("warmup_requests", 1))):
        request(next(warm))
    sync()
    setup_s = time.perf_counter() - t0
    phases["warmup"] = setup_s - sum(phases.values())
    print("perfbench: setup " + ", ".join(f"{k} {v:.3f} s"
                                         for k, v in phases.items()),
          file=sys.stderr)
    setup_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    steady_collector()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()

    stream = RequestStream(mix, num_traj, np.random.default_rng([seed, 1]))
    sample = Sample(int(mix.get("check_requests", 1)),
                    np.random.default_rng([seed, 3]))
    n_trace = int(mix.get("trace_requests", 0)) if args.trace else 0
    records, traced_records = [], []
    spans, prof, failed = Spans(), None, 0

    i = 0
    with contextlib.ExitStack() as tracing:
        # The profiler starts before the window: its start takes seconds.
        if n_trace:
            tracing.enter_context(wrapped(spans))
            if device == "cuda":
                acts = [torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]
                prof = tracing.enter_context(torch.profiler.profile(activities=acts))
        use0 = resource.getrusage(resource.RUSAGE_SELF)
        start = time.perf_counter()
        deadline = start + args.seconds
        while True:
            ids = next(stream)
            try:
                if i < n_trace:
                    with spans.span("request"):
                        rows, res, lat = request(ids)
                else:
                    rows, res, lat = request(ids)
            except Exception as e:  # a failed request counts; the loop goes on
                failed += 1
                print(f"perfbench: request {i} failed: {e!r}", file=sys.stderr)
                res = None
            if res is not None:
                rec = {"latency_s": lat, "trajectories": len(ids),
                       "segments": len(rows), "rows": len(res),
                       "stats": _stats(res.stats)}
                records.append(rec)
                sample.offer(i, (rows, answer_of(res)))
                if i < n_trace:
                    traced_records.append((rec, rows))
            i += 1
            if i == n_trace:
                tracing.close()
            if time.perf_counter() >= deadline:
                break
        sync()
    window_s = time.perf_counter() - start
    use1 = resource.getrusage(resource.RUSAGE_SELF)
    usage = {k: getattr(use1, k) - getattr(use0, k) for k in
             ("ru_utime", "ru_stime", "ru_minflt", "ru_majflt", "ru_nvcsw",
              "ru_nivcsw")}
    peak_window = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    obs = Observations(setup_s, window_s, records, peak_window)
    if args.trace:
        work = Work(dataset.cols)
        traced_records = [dict(rec, least_s=work.least_seconds(
            dataset.take(rows), rec["rows"])) for rec, rows in traced_records]
        obs.traced = Traced(traced_records, spans,
                            DeviceTrace.from_profiler(prof) if prof else None)
    entries = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in entries:
        value = spec_mod.reader(m["name"])(obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": cell.chips,
           "memory_peak_bytes": int(max(setup_peak, peak_window))}
    breakdown = None
    if obs.traced is not None and obs.traced.device is not None:
        tr = obs.traced.device
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        breakdown = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    if device == "cuda":
        print(f"perfbench: card {_card_info()}", file=sys.stderr)

    # The program's state goes before the reference runs.
    answers = sample.items()
    del db, sample, stream, warm, prof, res
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    verdict = judge(answers, dataset, d, cfg["check_limits"])
    correct = bool(verdict["ok"] and failed == 0 and answers)

    bad = forbidden_modules()
    if bad:
        print(f"perfbench: modules loaded that a run may not load: {bad}",
              file=sys.stderr)
        return 4

    limits = cfg["check_limits"]
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in verdict["numbers"].items()}
    checks["failed_requests"] = {"value": failed, "limit": 0}
    _log_window(records, window_s, usage, verdict)
    for k, c in checks.items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    out = {"correct": correct, "attempted": i, "failed": failed,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    sys.stdout.flush()
    print(json.dumps(out))
    return 0
