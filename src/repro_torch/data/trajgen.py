"""Dataset generators faithful to the paper's §7.1.

Five datasets, all 4-D (3 space + 1 time):

* GALAXY — stars orbiting in a Milky-Way-like gravitational field: flat
  rotation curve circular orbits + radial epicycles + vertical oscillation.
  2,500 trajectories × 400 segments = 10^6 entry segments; all trajectories
  share the same temporal extent, so the active-trajectory profile is
  roughly uniform (paper Fig. 4e).
* RANDWALK-UNIFORM — Brownian trajectories of 400 timesteps (399 segments),
  start times ~ U[0, 100].  2,500 trajectories = 997,500 segments.
* RANDWALK-NORMAL — start times ~ N(200, 200) truncated to [0, 400].
  2,500 × 400 = 10^6 segments.
* RANDWALK-NORMAL5 — one of 5 normal distributions per trajectory ⇒
  distinct active/inactive phases (paper's rush-hour analogy).
* RANDWALK-EXP — 10,000 trajectories with Exp(λ=1/70) lengths truncated to
  [2, 1000] timesteps, start times ~ U[0, 20].

The paper does not specify the spatial parameters of the random walks; we
pick an initial box and step size such that the query distances of the
paper's scenarios (d = 1 … 150) produce small-but-nonzero hit fractions α,
matching the paper's observation that "only a small fraction of the
interactions add to the result set" (§5).

Every generator takes a ``scale`` factor: scale=1.0 reproduces the paper's
counts; CI and CPU benchmarks use scale≈0.02–0.1.  Generation is fully
deterministic given (seed, scale).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.segments import SegmentArray


@dataclasses.dataclass
class TrajectoryDataset:
    name: str
    segments: SegmentArray           # unsorted; the engine sorts by t_start
    traj_slices: list[tuple[int, int]]  # per-trajectory [start, end) into segments


def _to_dataset(name: str, points: list[np.ndarray],
                times: list[np.ndarray]) -> TrajectoryDataset:
    segs = SegmentArray.from_trajectories(points, times)
    slices = []
    ofs = 0
    for p in points:
        m = max(p.shape[0] - 1, 0)
        slices.append((ofs, ofs + m))
        ofs += m
    return TrajectoryDataset(name, segs, slices)


# ----------------------------------------------------------------------
# GALAXY
# ----------------------------------------------------------------------
def galaxy(num_traj: int = 2500, num_segments: int = 400, *,
           seed: int = 0, scale: float = 1.0) -> TrajectoryDataset:
    """Disk-galaxy stellar orbits (flat rotation curve + epicycles)."""
    rng = np.random.default_rng(seed)
    nt = max(int(num_traj * scale), 4)
    steps = num_segments + 1
    t = np.linspace(0.0, 400.0, steps, dtype=np.float64)        # shared extent
    # Galactocentric radius (kpc), flat rotation curve v0.
    r0 = rng.uniform(4.0, 12.0, nt)
    v0 = 0.22                                  # kpc per timestep unit
    omega = v0 / r0
    phi0 = rng.uniform(0.0, 2 * np.pi, nt)
    # Radial epicycle (kappa ≈ sqrt(2)·omega for a flat curve) + vertical
    # oscillation.
    a_r = rng.uniform(0.0, 0.6, nt)
    kappa = np.sqrt(2.0) * omega
    psi0 = rng.uniform(0.0, 2 * np.pi, nt)
    a_z = rng.uniform(0.0, 0.3, nt)
    nu = 2.0 * omega
    zeta0 = rng.uniform(0.0, 2 * np.pi, nt)

    tt = t[None, :]                            # (1, steps)
    r = r0[:, None] + a_r[:, None] * np.cos(kappa[:, None] * tt + psi0[:, None])
    ang = phi0[:, None] + omega[:, None] * tt
    x = r * np.cos(ang)
    y = r * np.sin(ang)
    z = a_z[:, None] * np.sin(nu[:, None] * tt + zeta0[:, None])

    pts = [np.stack([x[k], y[k], z[k]], axis=1) for k in range(nt)]
    tms = [t.copy() for _ in range(nt)]
    return _to_dataset("galaxy", pts, tms)


# ----------------------------------------------------------------------
# RANDWALK family
# ----------------------------------------------------------------------
_BOX = 400.0        # initial positions ~ U[0, _BOX]^3
_STEP_SIGMA = 2.0   # Brownian step std per coordinate per timestep


def _randwalk(name: str, start_times: np.ndarray, lengths: np.ndarray,
              rng: np.random.Generator) -> TrajectoryDataset:
    """Brownian trajectories with given per-trajectory start times/lengths."""
    pts, tms = [], []
    for st, m in zip(start_times, lengths):
        m = int(m)
        steps = rng.normal(0.0, _STEP_SIGMA, size=(m, 3))
        p0 = rng.uniform(0.0, _BOX, size=(1, 3))
        p = np.concatenate([p0, p0 + np.cumsum(steps, axis=0)], axis=0)
        tms.append(st + np.arange(m + 1, dtype=np.float64))
        pts.append(p)
    return _to_dataset(name, pts, tms)


def randwalk_uniform(num_traj: int = 2500, *, seed: int = 1,
                     scale: float = 1.0) -> TrajectoryDataset:
    rng = np.random.default_rng(seed)
    nt = max(int(num_traj * scale), 4)
    starts = rng.uniform(0.0, 100.0, nt)
    lengths = np.full(nt, 399)                  # 997,500 segments at scale=1
    return _randwalk("randwalk-uniform", starts, lengths, rng)


def randwalk_normal(num_traj: int = 2500, *, seed: int = 2,
                    scale: float = 1.0) -> TrajectoryDataset:
    rng = np.random.default_rng(seed)
    nt = max(int(num_traj * scale), 4)
    starts = np.clip(rng.normal(200.0, 200.0, nt), 0.0, 400.0)
    lengths = np.full(nt, 400)                  # 10^6 segments at scale=1
    return _randwalk("randwalk-normal", starts, lengths, rng)


def randwalk_normal5(num_traj: int = 2500, *, seed: int = 3,
                     scale: float = 1.0) -> TrajectoryDataset:
    rng = np.random.default_rng(seed)
    nt = max(int(num_traj * scale), 5)
    # Five modes spread over the extent ⇒ distinct active/inactive phases.
    means = np.array([50.0, 150.0, 250.0, 350.0, 450.0])
    sigmas = np.array([15.0, 15.0, 15.0, 15.0, 15.0])
    mode = rng.integers(0, 5, nt)
    starts = np.clip(rng.normal(means[mode], sigmas[mode]), 0.0, 500.0)
    lengths = np.full(nt, 400)
    return _randwalk("randwalk-normal5", starts, lengths, rng)


def randwalk_exp(num_traj: int = 10_000, *, seed: int = 4,
                 scale: float = 1.0) -> TrajectoryDataset:
    rng = np.random.default_rng(seed)
    nt = max(int(num_traj * scale), 8)
    lengths = np.clip(rng.exponential(70.0, nt), 2, 1000).astype(np.int64)
    starts = rng.uniform(0.0, 20.0, nt)
    return _randwalk("randwalk-exp", starts, lengths, rng)


# ----------------------------------------------------------------------
# DRIFT — the spatially-clustered migration workload (beyond-paper)
# ----------------------------------------------------------------------
#: the drifting swarm travels from the origin to this point over its extent.
#: The span is kept moderate on purpose: float32 round-off in the interval
#: kernels grows with the square of the coordinate magnitude, and pairs
#: whose true minimum distance sits within that error of ``d`` can be
#: classified differently by the Pallas kernel and the jnp oracle (a
#: pre-existing borderline-f32 property the equivalence tests must not
#: trip over).
_DRIFT_SPAN = np.array([600.0, 400.0, 0.0])
_DRIFT_RADIUS = 15.0      # swarm half-width around the moving center
_DRIFT_T_END = 400.0


def drift_center(t) -> np.ndarray:
    """Swarm center position at time(s) ``t`` — an out-and-back patrol:
    the swarm travels to ``_DRIFT_SPAN`` over the first half of the extent
    and retraces the path over the second half, so it passes any point of
    the path at *two* disjoint times (which is what makes a sensor's
    pruned candidate set a genuine multi-sub-range split, not one run)."""
    frac = np.asarray(t, np.float64) / _DRIFT_T_END
    tri = 1.0 - np.abs(2.0 * frac - 1.0)        # 0 → 1 → 0 triangle wave
    return tri[..., None] * _DRIFT_SPAN


def drift(num_traj: int = 2500, num_segments: int = 400, *, seed: int = 5,
          scale: float = 1.0) -> TrajectoryDataset:
    """A compact swarm patrolling out-and-back across space over the
    temporal extent.

    Every trajectory stays within ``_DRIFT_RADIUS`` (plus small Brownian
    jitter) of a shared center that drifts along a long line and back —
    think bird migration, a storm system, or a convoy's round trip.  At
    any instant activity is spatially localized, so *time correlates with
    space*: the temporal-bin index's per-bin MBRs are tight boxes marching
    along the path — the regime where spatiotemporal candidate pruning
    bites — and the return leg means a fixed observer sees the swarm in
    two disjoint temporal windows.  (Contrast GALAXY / RANDWALK, whose
    per-instant activity covers the whole box, making one-box-per-bin
    pruning a no-op by construction.)
    """
    rng = np.random.default_rng(seed)
    nt = max(int(num_traj * scale), 4)
    steps = num_segments + 1
    t = np.linspace(0.0, _DRIFT_T_END, steps, dtype=np.float64)
    centers = drift_center(t)                       # (steps, 3)
    offsets = rng.uniform(-_DRIFT_RADIUS, _DRIFT_RADIUS, (nt, 3))
    pts, tms = [], []
    for k in range(nt):
        jitter = np.cumsum(rng.normal(0.0, 0.3, (steps, 3)), axis=0)
        pts.append(centers + offsets[k] + jitter)
        tms.append(t.copy())
    return _to_dataset("drift", pts, tms)


def sensor_queries(num_sensors: int, d: float, *, seed: int = 0,
                   num_clusters: int = 8) -> SegmentArray:
    """Static range-monitoring sensors for the DRIFT dataset (scenario C1).

    Each sensor is one zero-velocity query segment spanning the *whole*
    temporal extent — "watch this point for the whole day" (geofencing /
    proximity monitoring).  Temporal indexing alone makes every database
    segment a candidate for every sensor; spatially, the patrolling swarm
    passes any given sensor only briefly (twice — once per leg), so almost
    all of that work is prunable, and each batch's pruned candidate set is
    a genuine *split* into two disjoint sub-ranges.  Sensors sit in
    ``num_clusters`` spatial clusters strung along the outbound leg at
    perpendicular offsets from ``0.5·d`` (hits when the swarm passes) up
    to tens of ``d`` (pure pruning fodder); clusters are emitted
    contiguously, and all sensors share ``t_start = 0``, so the (stable)
    sort keeps clusters contiguous and batches of consecutive sensors stay
    spatially coherent — which is what lets the pruning-aware planner keep
    per-batch MBRs tight.
    """
    rng = np.random.default_rng(seed + 2000)
    num_sensors = max(int(num_sensors), num_clusters)
    per = [num_sensors // num_clusters] * num_clusters
    for i in range(num_sensors - sum(per)):
        per[i] += 1
    # Unit vector perpendicular to the (planar) migration path.
    path = _DRIFT_SPAN / np.linalg.norm(_DRIFT_SPAN)
    perp = np.array([-path[1], path[0], 0.0])
    positions = []
    for ci, n in enumerate(per):
        # anchor on the outbound leg (first half of the extent)
        t_anchor = (ci + 0.5) / num_clusters * (_DRIFT_T_END / 2.0)
        center = drift_center(np.array([t_anchor]))[0]
        offs = rng.uniform(0.5, 30.0, n) * d * rng.choice([-1.0, 1.0], n)
        spread = rng.uniform(-2.0 * d, 2.0 * d, (n, 3))
        positions.append(center[None] + offs[:, None] * perp[None]
                         + spread)
    pos = np.concatenate(positions, axis=0).astype(np.float32)
    n = pos.shape[0]
    zeros = np.zeros(n, np.float32)
    return SegmentArray(
        xs=pos[:, 0], ys=pos[:, 1], zs=pos[:, 2],
        xe=pos[:, 0], ye=pos[:, 1], ze=pos[:, 2],
        ts=zeros, te=np.full(n, _DRIFT_T_END, np.float32),
        seg_id=np.arange(n, dtype=np.int32),
        traj_id=np.arange(n, dtype=np.int32),
    )


# ----------------------------------------------------------------------
# TWINSWARM — the multi-modal occupancy workload (beyond-paper)
# ----------------------------------------------------------------------
#: center of the far swarm; ~550 from the origin, kept well under the
#: coordinate magnitude where float32 interval round-off starts flipping
#: borderline pairs between backends (see the _DRIFT_SPAN note above).
_TWIN_FAR_CENTER = np.array([520.0, 180.0, 0.0])
_TWIN_RADIUS = 60.0       # half-width of each swarm's footprint
_TWIN_NEAR_FRAC = 0.25    # fraction of trajectories in the near swarm
_TWIN_T_END = 400.0


def twinswarm(num_traj: int = 2500, num_segments: int = 400, *,
              seed: int = 6, scale: float = 1.0) -> TrajectoryDataset:
    """Two *stationary* jittering swarms sharing one temporal extent.

    ~25% of the trajectories hover around the origin (the "near" swarm,
    where scenario C3's sensors sit); the rest hover around a center ~550
    away.  Because both swarms are active in every temporal bin, each
    bin's *union* MBR always contains the near swarm — any sensor inside
    it sees a spatial gap of zero, so one-box-per-bin pruning
    prunes ~0% here by construction.  The occupied space is *bimodal*,
    though: a K ≥ 2 per-bin spatial split separates the swarms into
    disjoint boxes, making the far swarm's ~75% of segments prunable at
    the box level (planner sub-ranges) and the tile level (live-tile
    lists).  This is the workload the hierarchical index exists for —
    one box per bin summarizes multi-modal occupancy arbitrarily badly.
    """
    rng = np.random.default_rng(seed)
    nt = max(int(num_traj * scale), 8)
    n_near = max(int(round(nt * _TWIN_NEAR_FRAC)), 2)
    steps = num_segments + 1
    t = np.linspace(0.0, _TWIN_T_END, steps, dtype=np.float64)
    pts, tms = [], []
    for k in range(nt):
        center = np.zeros(3) if k < n_near else _TWIN_FAR_CENTER
        offset = rng.uniform(-_TWIN_RADIUS, _TWIN_RADIUS, 3)
        jitter = np.cumsum(rng.normal(0.0, 0.3, (steps, 3)), axis=0)
        pts.append(center + offset + jitter)
        tms.append(t.copy())
    return _to_dataset("twinswarm", pts, tms)


def twin_sensor_queries(num_sensors: int, d: float, *, seed: int = 0,
                        num_clusters: int = 8) -> SegmentArray:
    """Static full-extent sensors inside TWINSWARM's near-swarm footprint
    (scenario C3).

    Every sensor lies within the near swarm's MBR, so the per-bin *union*
    box (which always contains the near swarm — see :func:`twinswarm`)
    overlaps every sensor and bin-level pruning removes nothing.  All the
    prunable work is the far swarm, and only the K-box level can see it.
    Sensors sit in ``num_clusters`` clusters so consecutive batches stay
    spatially coherent, same as C1.
    """
    rng = np.random.default_rng(seed + 3000)
    num_sensors = max(int(num_sensors), num_clusters)
    per = [num_sensors // num_clusters] * num_clusters
    for i in range(num_sensors - sum(per)):
        per[i] += 1
    centers = rng.uniform(-0.5 * _TWIN_RADIUS, 0.5 * _TWIN_RADIUS,
                          (num_clusters, 3))
    positions = []
    for ci, n in enumerate(per):
        spread = rng.uniform(-3.0 * d, 3.0 * d, (n, 3))
        positions.append(centers[ci][None] + spread)
    pos = np.concatenate(positions, axis=0).astype(np.float32)
    n = pos.shape[0]
    zeros = np.zeros(n, np.float32)
    return SegmentArray(
        xs=pos[:, 0], ys=pos[:, 1], zs=pos[:, 2],
        xe=pos[:, 0], ye=pos[:, 1], ze=pos[:, 2],
        ts=zeros, te=np.full(n, _TWIN_T_END, np.float32),
        seg_id=np.arange(n, dtype=np.int32),
        traj_id=np.arange(n, dtype=np.int32),
    )


DATASETS = {
    "galaxy": galaxy,
    "randwalk-uniform": randwalk_uniform,
    "randwalk-normal": randwalk_normal,
    "randwalk-normal5": randwalk_normal5,
    "randwalk-exp": randwalk_exp,
    "drift": drift,
    "twinswarm": twinswarm,
}


# ----------------------------------------------------------------------
# Experimental scenarios S1–S10 (paper §7.2)
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    dataset: str
    d: float
    num_query_traj: int


SCENARIOS: dict[str, Scenario] = {
    "S1": Scenario("S1", "galaxy", 1.0, 100),
    "S2": Scenario("S2", "galaxy", 5.0, 100),
    "S3": Scenario("S3", "randwalk-uniform", 5.0, 100),
    "S4": Scenario("S4", "randwalk-uniform", 25.0, 100),
    "S5": Scenario("S5", "randwalk-normal", 50.0, 100),
    "S6": Scenario("S6", "randwalk-normal", 150.0, 100),
    "S7": Scenario("S7", "randwalk-normal5", 50.0, 100),
    "S8": Scenario("S8", "randwalk-normal5", 150.0, 100),
    "S9": Scenario("S9", "randwalk-exp", 50.0, 1000),
    "S10": Scenario("S10", "randwalk-exp", 100.0, 1000),
    # beyond-paper: the spatially-clustered range-monitoring scenario —
    # DRIFT swarm database, static clustered sensor queries (see
    # sensor_queries).  The selectivity scenario spatial pruning
    # benchmarks sweep.
    "C1": Scenario("C1", "drift", 5.0, 128),
    # beyond-paper: the multi-modal occupancy scenario — TWINSWARM
    # bimodal database, clustered static sensors inside the near swarm
    # (see twin_sensor_queries).  One-box-per-bin pruning removes ~0%
    # here by construction; the K-box hierarchical index is what
    # makes the far swarm's ~75% of segments prunable.
    "C3": Scenario("C3", "twinswarm", 8.0, 128),
}


def make_scenario(name: str, *, scale: float = 1.0, seed: int = 0
                  ) -> tuple[SegmentArray, SegmentArray, float]:
    """Build (database, sorted query segments, d) for a paper scenario.

    Queries are the segments of ``num_query_traj`` randomly chosen
    trajectories of the dataset (paper §7.2: "100 trajectories are
    processed"), scaled alongside the dataset — except C1/C3, whose
    queries are clustered static sensors (:func:`sensor_queries` /
    :func:`twin_sensor_queries`; sensor count does not scale down below
    32 so batching structure survives small scales).
    """
    sc = SCENARIOS[name]
    ds = DATASETS[sc.dataset](scale=scale)
    if sc.name in ("C1", "C3"):
        nq = max(int(sc.num_query_traj * scale), 32)
        make_sensors = sensor_queries if sc.name == "C1" else twin_sensor_queries
        queries = make_sensors(nq, sc.d, seed=seed)
        return ds.segments.sort_by_tstart(), queries, sc.d
    n_traj = len(ds.traj_slices)
    nq = max(min(int(sc.num_query_traj * scale), n_traj), 1)
    rng = np.random.default_rng(seed + 1000)
    chosen = rng.choice(n_traj, size=nq, replace=False)
    parts = [ds.segments.take(np.s_[a:b]) for a, b in
             (ds.traj_slices[int(k)] for k in chosen)]
    queries = SegmentArray.concatenate(parts).sort_by_tstart()
    return ds.segments.sort_by_tstart(), queries, sc.d
