"""The benchmark's copy of the GALAXY and RANDWALK-EXP generators.

The paper's §7.1 datasets, written operation for operation as
``repro_torch.data.trajgen`` writes them, so that at the port's default
seeds (GALAXY 0, RANDWALK-EXP 4, the query draw ``seed + 1000``) they give
the same arrays (``perfbench/tests/test_perfbench_data.py`` holds them
equal).  Two things differ: every seed is an argument (a configuration
names its dataset's seed), and the result is plain numpy columns, so the
NumPy reference reads the same inputs as the program without importing
any of it.

Columns are those of the port's packed segment (``xs ys zs xe ye ze ts
te``, float32) plus ``seg_id`` and ``traj_id`` (int32); ``traj_slices``
is each trajectory's ``[start, end)`` into them.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import pathlib

import numpy as np

COLUMNS = ("xs", "ys", "zs", "xe", "ye", "ze", "ts", "te")


@dataclasses.dataclass
class Dataset:
    name: str
    cols: dict                 # COLUMNS (float32) + seg_id, traj_id (int32)
    traj_slices: np.ndarray    # (num_traj, 2) int64, [start, end)

    def __len__(self) -> int:
        return int(self.cols["xs"].shape[0])

    def take(self, idx) -> dict:
        return {k: v[idx] for k, v in self.cols.items()}

    def trajectory_lengths(self) -> np.ndarray:
        return self.traj_slices[:, 1] - self.traj_slices[:, 0]


def _to_dataset(name: str, points: list, times: list) -> Dataset:
    """Each consecutive pair of a polyline's points is one segment; the
    coordinates are rounded to float32 per trajectory, as the port's
    ``SegmentArray.from_trajectories`` does."""
    parts = {c: [] for c in COLUMNS}
    seg_ids, traj_ids, slices = [], [], []
    ofs = 0
    for k, (pts, tms) in enumerate(zip(points, times)):
        pts = np.asarray(pts, dtype=np.float32)
        tms = np.asarray(tms, dtype=np.float32)
        m = pts.shape[0] - 1
        slices.append((ofs, ofs + max(m, 0)))
        if m <= 0:
            continue
        ofs += m
        for j, c in enumerate(("xs", "ys", "zs")):
            parts[c].append(pts[:-1, j])
        for j, c in enumerate(("xe", "ye", "ze")):
            parts[c].append(pts[1:, j])
        parts["ts"].append(tms[:-1])
        parts["te"].append(tms[1:])
        seg_ids.append(np.arange(m, dtype=np.int32))
        traj_ids.append(np.full(m, k, dtype=np.int32))
    cols = {c: np.concatenate(parts[c]) for c in COLUMNS}
    cols["seg_id"] = np.concatenate(seg_ids)
    cols["traj_id"] = np.concatenate(traj_ids)
    return Dataset(name, cols, np.asarray(slices, dtype=np.int64))


def galaxy(num_traj: int = 2500, num_segments: int = 400, *, seed=0,
           scale: float = 1.0) -> Dataset:
    """Disk-galaxy stellar orbits (flat rotation curve + epicycles)."""
    rng = np.random.default_rng(seed)
    nt = max(int(num_traj * scale), 4)
    steps = num_segments + 1
    t = np.linspace(0.0, 400.0, steps, dtype=np.float64)
    r0 = rng.uniform(4.0, 12.0, nt)
    v0 = 0.22
    omega = v0 / r0
    phi0 = rng.uniform(0.0, 2 * np.pi, nt)
    a_r = rng.uniform(0.0, 0.6, nt)
    kappa = np.sqrt(2.0) * omega
    psi0 = rng.uniform(0.0, 2 * np.pi, nt)
    a_z = rng.uniform(0.0, 0.3, nt)
    nu = 2.0 * omega
    zeta0 = rng.uniform(0.0, 2 * np.pi, nt)

    tt = t[None, :]
    r = r0[:, None] + a_r[:, None] * np.cos(kappa[:, None] * tt + psi0[:, None])
    ang = phi0[:, None] + omega[:, None] * tt
    x = r * np.cos(ang)
    y = r * np.sin(ang)
    z = a_z[:, None] * np.sin(nu[:, None] * tt + zeta0[:, None])

    pts = [np.stack([x[k], y[k], z[k]], axis=1) for k in range(nt)]
    tms = [t.copy() for _ in range(nt)]
    return _to_dataset("galaxy", pts, tms)


def randwalk_exp(num_traj: int = 10_000, *, seed=4, scale: float = 1.0,
                 box: float = 400.0, step_sigma: float = 2.0,
                 mean_length: float = 70.0, min_length: int = 2,
                 max_length: int = 1000, start_max: float = 20.0) -> Dataset:
    """Brownian trajectories with Exp(1/mean_length) lengths truncated to
    [min_length, max_length] steps and start times U[0, start_max]; the
    start box and the step's sigma are the port's (the paper gives
    neither)."""
    rng = np.random.default_rng(seed)
    nt = max(int(num_traj * scale), 8)
    lengths = np.clip(rng.exponential(mean_length, nt), min_length,
                      max_length).astype(np.int64)
    starts = rng.uniform(0.0, start_max, nt)
    pts, tms = [], []
    for st, m in zip(starts, lengths):
        m = int(m)
        steps = rng.normal(0.0, step_sigma, size=(m, 3))
        p0 = rng.uniform(0.0, box, size=(1, 3))
        p = np.concatenate([p0, p0 + np.cumsum(steps, axis=0)], axis=0)
        tms.append(st + np.arange(m + 1, dtype=np.float64))
        pts.append(p)
    return _to_dataset("randwalk-exp", pts, tms)


DATASETS = {"galaxy": galaxy, "randwalk-exp": randwalk_exp}


def make(name: str, params: dict, *, seed, scale: float = 1.0) -> Dataset:
    """The dataset ``name`` with a configuration's ``params``: one of
    :data:`DATASETS`, else ``generate`` of ``perfbench/data/<name>.py``
    (how a later configuration brings a dataset of its own)."""
    gen = DATASETS.get(name)
    if gen is None:
        path = pathlib.Path(__file__).with_name(f"{name}.py")
        spec = importlib.util.spec_from_file_location(
            "perfbench.data." + name.replace("-", "_").replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        gen = mod.generate
    return gen(**params, seed=seed, scale=scale)


def sort_by_tstart(cols: dict) -> dict:
    order = np.argsort(cols["ts"], kind="stable")
    return {k: v[order] for k, v in cols.items()}


def scenario(ds: Dataset, num_query_traj: int, *, scale: float = 1.0,
             seed: int = 0) -> tuple[dict, dict]:
    """The port's ``make_scenario`` over ``ds``: (database sorted by
    t_start, the segments of ``num_query_traj`` trajectories drawn with
    ``default_rng(seed + 1000)``, sorted by t_start)."""
    n_traj = len(ds.traj_slices)
    nq = max(min(int(num_query_traj * scale), n_traj), 1)
    rng = np.random.default_rng(seed + 1000)
    chosen = rng.choice(n_traj, size=nq, replace=False)
    idx = np.concatenate([np.arange(*ds.traj_slices[int(k)])
                          for k in chosen])
    return sort_by_tstart(ds.cols), sort_by_tstart(ds.take(idx))
