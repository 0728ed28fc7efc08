"""Response-time performance model (paper §8) — the port's copy of
``repro/core/perfmodel.py``.

Structure follows the paper exactly:

* **Device component** (§8.1): per-invocation time ``T(i, c)`` for ``i``
  interactions against ``c`` candidates, decomposed into the three
  interaction classes — α (temporal+spatial hit), β (temporal miss),
  γ (temporal hit, spatial miss) — with per-class benchmark curves
  ``T1/T2/T3`` and invocation overhead ``Θ``::

      T(i, c) = T1(αi, c) + T2(βi, c) + T3(γi, c) − 2Θ

  The dense kernel evaluates every pair (a temporal miss returns early,
  the rest solve the quadratic) — the model keeps the 3-class split
  because (a) the benchmarks *measure* the classes instead of assuming
  their ratio, and (b) α still drives the result-set transfer term.
  Device times are CUDA-event times on the card (host wall time on the
  CPU).
* **α estimation** (§8.1.2): the database extent is divided into
  ``num_epochs`` epochs (paper uses 50); per epoch, sample batches of
  ``s`` consecutive query segments from a representative query set, run
  the counting kernel, and record the hit fraction.
* **β exact** (§8.1.2): for a batch, β is computed exactly from the
  temporal extremities with two binary searches per query segment
  (the paper's nested loop, vectorized): an entry overlaps iff
  ``e.ts ≤ q.te ∧ e.te ≥ q.ts``.
* **Host component** (§8.2): ``T1_host(s) = A·s^B`` fitted log-log from a
  near-zero-α benchmark (aggregate invocation overhead), and
  ``T2_host(σ) = σ / bw`` for result-set transfer of σ bytes.

The model's purpose (paper §8.3): pick a good PERIODIC batch size ``s``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.batching import periodic
from repro_torch.core.engine import DistanceThresholdEngine
from repro_torch.core.segments import SegmentArray
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

RESULT_ITEM_BYTES = 16   # entry_idx i32 + query_idx i32 + t_enter f32 + t_exit f32


# ----------------------------------------------------------------------
# synthetic single-class workloads for the T1/T2/T3 benchmarks
# ----------------------------------------------------------------------
def _make_class_tiles(c: int, q: int, cls: str, rng: np.random.Generator
                      ) -> tuple[np.ndarray, np.ndarray, float]:
    """Packed (entries, queries, d) where every interaction is class `cls`."""
    d = 1.0
    ets = rng.uniform(0.0, 1.0, c).astype(np.float32)
    qts = rng.uniform(0.0, 1.0, q).astype(np.float32)
    entries = np.zeros((c, 8), np.float32)
    queries = np.zeros((q, 8), np.float32)
    entries[:, 6], entries[:, 7] = ets, ets + 1.0
    if cls == "beta":                      # temporal miss: disjoint extents
        queries[:, 6], queries[:, 7] = qts + 10.0, qts + 11.0
    else:
        queries[:, 6], queries[:, 7] = qts * 0.0, qts * 0.0 + 2.0
    if cls == "alpha":                     # co-located ⇒ spatial hit
        entries[:, 0:6] = 0.0
        queries[:, 0:6] = 0.0
    elif cls == "gamma":                   # far apart ⇒ spatial miss
        entries[:, [0, 3]] = 0.0
        queries[:, [0, 3]] = 100.0
    return entries, queries, d


@dataclasses.dataclass
class DeviceTimeModel:
    """Interpolation tables T1/T2/T3(c, q) seconds + scalar overhead Θ."""

    c_grid: np.ndarray
    q_grid: np.ndarray
    t1: np.ndarray            # (len(c_grid), len(q_grid))
    t2: np.ndarray
    t3: np.ndarray
    theta: float              # per-invocation dispatch overhead, seconds

    def _interp(self, table: np.ndarray, c: float, q: float) -> float:
        """Bilinear interpolation in log2 space, clamped to the grid."""
        lc = np.clip(np.log2(max(c, 1.0)),
                     np.log2(self.c_grid[0]), np.log2(self.c_grid[-1]))
        lq = np.clip(np.log2(max(q, 1.0)),
                     np.log2(self.q_grid[0]), np.log2(self.q_grid[-1]))
        gc = np.log2(self.c_grid)
        gq = np.log2(self.q_grid)
        i = int(np.clip(np.searchsorted(gc, lc) - 1, 0, len(gc) - 2))
        j = int(np.clip(np.searchsorted(gq, lq) - 1, 0, len(gq) - 2))
        wc = (lc - gc[i]) / (gc[i + 1] - gc[i])
        wq = (lq - gq[j]) / (gq[j + 1] - gq[j])
        t = (table[i, j] * (1 - wc) * (1 - wq) + table[i + 1, j] * wc * (1 - wq)
             + table[i, j + 1] * (1 - wc) * wq + table[i + 1, j + 1] * wc * wq)
        return float(t)

    def predict(self, c: float, q: float, alpha: float, beta: float,
                gamma: float) -> float:
        """T(i=c·q, c) via the paper's 3-term decomposition."""
        t = (self._interp(self.t1, c, alpha * q)
             + self._interp(self.t2, c, beta * q)
             + self._interp(self.t3, c, gamma * q)
             - 2.0 * self.theta)
        return max(t, self.theta)


def _timed_count_hits(entries, queries, d, *, use_kernel: bool,
                      device: torch.device) -> float:
    """Seconds of one ``ops.count_hits`` call (its uploads included): on
    the card between two CUDA events recorded around the call, waiting on
    the second; on the CPU, where the call is synchronous, the host
    clock."""
    kw = dict(use_kernel=use_kernel, device=device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        ops.count_hits(entries, queries, np.float32(d), **kw)
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ops.count_hits(entries, queries, np.float32(d), **kw)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3


def benchmark_device_curves(c_values=(256, 1024, 4096, 16384),
                            q_values=(16, 64, 256, 1024),
                            *, use_kernel: bool = True, repeats: int = 3,
                            seed: int = 0, device="cuda") -> DeviceTimeModel:
    """Measure T1/T2/T3 on single-class synthetic workloads (paper §8.1.3)
    through ``ops.count_hits`` (the dense kernel, or the torch oracle with
    ``use_kernel=False``) on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    tables = {}
    for cls_i, cls in enumerate(("alpha", "beta", "gamma")):
        tab = np.zeros((len(c_values), len(q_values)))
        for ci, c in enumerate(c_values):
            for qi, q in enumerate(q_values):
                e, qq, d = _make_class_tiles(c, q, cls, rng)
                _timed_count_hits(e, qq, d, use_kernel=use_kernel,
                                  device=dev)                  # warmup
                ts = [_timed_count_hits(e, qq, d, use_kernel=use_kernel,
                                        device=dev)
                      for _ in range(repeats)]
                tab[ci, qi] = float(np.median(ts))
        tables[cls] = tab
    # Θ: dispatch overhead of the smallest call.
    e, qq, d = _make_class_tiles(c_values[0], q_values[0], "beta", rng)
    ts = [_timed_count_hits(e, qq, d, use_kernel=use_kernel, device=dev)
          for _ in range(max(repeats * 3, 9))]
    theta = float(np.median(ts))
    return DeviceTimeModel(np.asarray(c_values, float), np.asarray(q_values, float),
                           tables["alpha"], tables["beta"], tables["gamma"], theta)


# ----------------------------------------------------------------------
# α estimation per epoch (paper §8.1.2)
# ----------------------------------------------------------------------
def estimate_alpha_by_epoch(engine: DistanceThresholdEngine,
                            sample_queries: SegmentArray, d: float, s: int,
                            *, num_epochs: int = 50, trials: int = 2,
                            seed: int = 0,
                            pruning: str | None = None) -> np.ndarray:
    """Per-epoch hit-fraction estimates from sampled consecutive-s batches.

    Returns (num_epochs,) float array; epochs with no sample queries reuse
    the global mean.

    ``pruning`` (default: the engine's own setting) selects the
    interaction denominator: with ``"spatial"`` the sampled batches count
    (and evaluate) only the candidate sub-ranges surviving the per-bin MBR
    pruning — the α the *pruned* workload actually exhibits (spatially
    pruned bins contribute zero hits by construction, so the numerator is
    unchanged while the denominator shrinks; pruned-workload α ≥ unpruned
    α).  Predictions fed by these α values therefore track the pruned
    interaction counts carried by the plans.
    """
    rng = np.random.default_rng(seed)
    t0, t1 = engine.db.temporal_extent
    edges = np.linspace(t0, t1, num_epochs + 1)
    q_packed = sample_queries.packed()
    qts = sample_queries.ts
    if pruning is None:
        pruning = getattr(engine, "pruning", "none")
    qlo = qhi = None
    if pruning == "spatial":
        qlo, qhi = sample_queries.mbrs()
    alphas = np.full(num_epochs, np.nan)
    for ep in range(num_epochs):
        in_ep = np.nonzero((qts >= edges[ep]) & (qts < edges[ep + 1]))[0]
        if in_ep.size == 0:
            continue
        hits = ints = 0
        for _ in range(trials):
            start = int(rng.choice(in_ep))
            start = min(start, len(sample_queries) - 1)
            stop = min(start + s, len(sample_queries))
            qt0 = float(qts[start])
            qt1 = float(sample_queries.te[start:stop].max())
            if pruning == "spatial":
                ranges = engine.index.candidate_subranges(
                    qt0, qt1, qlo[start:stop].min(axis=0),
                    qhi[start:stop].max(axis=0), float(d))
            else:
                first, last = engine.index.candidate_range(qt0, qt1)
                ranges = [(first, last)] if last >= first else []
            for first, last in ranges:
                c = last - first + 1
                n = int(ops.count_hits(engine._packed[first:last + 1],
                                       q_packed[start:stop], np.float32(d),
                                       use_kernel=False,
                                       device=engine.device))
                hits += n
                ints += c * (stop - start)
        if ints > 0:
            alphas[ep] = hits / ints
    mean = np.nanmean(alphas) if np.isfinite(alphas).any() else 0.0
    return np.where(np.isnan(alphas), mean, alphas)


def exact_beta(engine: DistanceThresholdEngine, queries: SegmentArray,
               q_first: int, q_last: int, cand_first: int,
               cand_last: int) -> float:
    """Exact temporal-miss fraction β for one batch (paper: computable
    precisely with two nested loops; here two binary searches/query)."""
    c = cand_last - cand_first + 1
    s = q_last - q_first + 1
    if c <= 0 or s <= 0:
        return 0.0
    ets = engine.db.ts[cand_first:cand_last + 1]         # sorted
    ete_sorted = np.sort(engine.db.te[cand_first:cand_last + 1])
    qts = queries.ts[q_first:q_last + 1]
    qte = queries.te[q_first:q_last + 1]
    # overlap iff e.ts <= q.te  AND  e.te >= q.ts
    n_ts_ok = np.searchsorted(ets, qte, side="right")
    n_te_lt = np.searchsorted(ete_sorted, qts, side="left")
    overlaps = np.maximum(n_ts_ok - n_te_lt, 0)          # inclusion-exclusion
    return float(1.0 - overlaps.sum() / (c * s))


# ----------------------------------------------------------------------
# host component (paper §8.2)
# ----------------------------------------------------------------------
@dataclasses.dataclass
class HostTimeModel:
    coef_a: float          # T1_host(s) = A * s^B  (total over all invocations)
    coef_b: float
    transfer_bw: float     # bytes/second for result marshalling

    def invocation_time(self, s: int) -> float:
        return max(self.coef_a * s ** self.coef_b, 0.0)

    def transfer_time(self, sigma_bytes: float) -> float:
        return sigma_bytes / self.transfer_bw


def benchmark_host_curves(engine: DistanceThresholdEngine,
                          queries: SegmentArray,
                          s_values=(16, 32, 64, 128, 256),
                          *, seed: int = 0) -> HostTimeModel:
    """Fit the host model from a near-zero-α run (paper: synthetic α≈0).

    We execute the engine with d≈0 (nothing within threshold ⇒ empty result
    sets) and attribute the measured host time to invocation overhead; then
    measure marshalling bandwidth with one large compaction.

    Always runs the engine's *sync* executor (``pipeline=False``): the model
    is per-invocation, and ``BatchStats.kernel_seconds`` is only measured
    per batch when every batch is individually synced (the pipelined
    executor deliberately has no per-batch timings to read).  The second
    run of each ``s`` is the one kept (the first warms the caches).
    """
    totals = []
    for s in s_values:
        plan = periodic(engine.index, queries, s)
        _, stats = engine.execute(queries, 0.0, plan, pipeline=False)  # α ≈ 0
        _, stats = engine.execute(queries, 0.0, plan, pipeline=False)  # warm
        totals.append(max(stats.host_seconds, 1e-6))
    # log-log least squares: log T = log A + B log s
    ls = np.log(np.asarray(s_values, float))
    lt = np.log(np.asarray(totals))
    bmat = np.polyfit(ls, lt, 1)
    coef_b, log_a = float(bmat[0]), float(bmat[1])
    # transfer bandwidth: marshal a known-size result set
    n = 1 << 16
    arrs = [np.zeros(n, np.int32), np.zeros(n, np.int32),
            np.zeros(n, np.float32), np.zeros(n, np.float32)]
    t0 = time.perf_counter()
    _ = [np.ascontiguousarray(a) .copy() for a in arrs]
    dt = max(time.perf_counter() - t0, 1e-7)
    bw = n * RESULT_ITEM_BYTES / dt
    return HostTimeModel(float(np.exp(log_a)), coef_b, bw)


# ----------------------------------------------------------------------
# the full model
# ----------------------------------------------------------------------
@dataclasses.dataclass
class ResponseTimeModel:
    """The full §8 model — and, once :meth:`fit_alphas` has run, the one
    object feeding the whole serving stack:
    :meth:`predict_batch_hits` is the planner's ``predict_hits`` (dispatch-
    group sizing — replaces the constant ``AUTO_GROUP_HIT_FRACTION``
    heuristic) and :meth:`predict_batch_seconds` the broker/scheduler
    ``predict_seconds`` (admission pricing, deadlines).  Both consume
    ``QueryBatch.num_ints``, the *pruned* interaction count — predictions
    track the workload actually dispatched.
    ``repro_torch.api.TrajectoryDB.fit_response_model`` builds + attaches
    one."""

    device: DeviceTimeModel
    host: HostTimeModel
    num_epochs: int = 50
    #: per-epoch α fit (:meth:`fit_alphas`); None until fitted.
    alphas: np.ndarray | None = None
    #: temporal extent the α epochs divide; set by :meth:`fit_alphas`.
    extent: tuple[float, float] | None = None

    # -- per-batch predictors (planner / broker / scheduler hooks) -------
    def fit_alphas(self, engine: DistanceThresholdEngine,
                   sample_queries: SegmentArray, d: float,
                   s: int = 64, *, trials: int = 2,
                   seed: int = 0) -> "ResponseTimeModel":
        """Fit the per-epoch hit fractions against a representative
        workload (α measured over the engine's pruned candidate ranges —
        see :func:`estimate_alpha_by_epoch`) and return self."""
        self.alphas = estimate_alpha_by_epoch(
            engine, sample_queries, d, s, num_epochs=self.num_epochs,
            trials=trials, seed=seed)
        self.extent = engine.db.temporal_extent
        return self

    def _alpha_for(self, batch) -> float:
        """The fitted α of the epoch holding the batch's temporal midpoint
        (the fleet mean when the batch falls outside the fitted extent)."""
        if self.alphas is None:
            raise ValueError("call fit_alphas (or TrajectoryDB."
                             "fit_response_model) before predicting batches")
        t0, t1 = self.extent
        width = max(t1 - t0, 1e-30)
        ep = int(np.clip((0.5 * (batch.qt0 + batch.qt1) - t0) / width
                         * self.num_epochs, 0, self.num_epochs - 1))
        return float(self.alphas[ep])

    def predict_batch_hits(self, batch) -> float:
        """Predicted result rows of one ``QueryBatch``: epoch-α ×
        ``num_ints`` (pruned).  The planner's ``predict_hits`` hook."""
        return self._alpha_for(batch) * batch.num_ints

    def predict_batch_seconds(self, batch) -> float:
        """Predicted device + transfer seconds of one ``QueryBatch`` —
        the broker's admission / the scheduler's deadline unit.  β is
        taken as 0 (the batch's candidates are temporally selected — see
        the module docstring); the per-invocation host
        overhead is in the curves' floor ``Θ``."""
        c, q = batch.num_candidates, batch.size
        if c <= 0 or q <= 0:
            return 0.0
        a = min(max(self._alpha_for(batch), 0.0), 1.0)
        dev = self.device.predict(c, q, a, 0.0, 1.0 - a)
        return dev + self.host.transfer_time(
            a * batch.num_ints * RESULT_ITEM_BYTES)

    def predict(self, engine: DistanceThresholdEngine, queries: SegmentArray,
                d: float, s: int, alphas: np.ndarray | None = None,
                *, seed: int = 0) -> dict:
        """Predicted response time for PERIODIC with batch size s."""
        if alphas is None:
            alphas = estimate_alpha_by_epoch(engine, queries, d, s,
                                             num_epochs=self.num_epochs,
                                             seed=seed)
        t0, t1 = engine.db.temporal_extent
        width = max(t1 - t0, 1e-30)
        plan = periodic(engine.index, queries, s)
        dev = 0.0
        total_hits = 0.0
        for b in plan.batches:
            c = b.num_candidates
            if c == 0:
                continue
            ep = int(np.clip((0.5 * (b.qt0 + b.qt1) - t0) / width
                             * self.num_epochs, 0, self.num_epochs - 1))
            alpha = float(alphas[ep])
            beta = exact_beta(engine, queries, b.q_first, b.q_last,
                              b.cand_first, b.cand_last)
            gamma = max(1.0 - alpha - beta, 0.0)
            dev += self.device.predict(c, b.size, alpha, beta, gamma)
            total_hits += alpha * b.num_ints
        host = (self.host.invocation_time(s)
                + self.host.transfer_time(total_hits * RESULT_ITEM_BYTES))
        return {"s": s, "device_seconds": dev, "host_seconds": host,
                "total_seconds": dev + host,
                "predicted_hits": total_hits, "num_batches": plan.num_batches}

    def pick_batch_size(self, engine: DistanceThresholdEngine,
                        queries: SegmentArray, d: float,
                        candidates=(16, 32, 48, 64, 96, 128, 192, 256),
                        *, seed: int = 0) -> tuple[int, list[dict]]:
        """Model-driven batch-size selection (the paper's Table 3 use)."""
        preds = [self.predict(engine, queries, d, s, seed=seed)
                 for s in candidates]
        best = min(preds, key=lambda p: p["total_seconds"])
        return int(best["s"]), preds
