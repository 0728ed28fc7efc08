"""The slice as a whole: ``repro_torch.api.TrajectoryDB.query`` on the CPU
against the reference's ``backend="jnp"`` on the same scenarios.

Index columns (``entry_idx``, ``entry_traj``, ``entry_seg``,
``query_idx``) must be equal.  ``t_enter``/``t_exit`` are compared with
``rtol=1e-4, atol=1e-3``, the tolerance the reference's own facade test
holds its pallas and jnp backends to (``tests/test_api.py``).  The
reference's jnp path runs jit-fused XLA, which may contract products into
FMAs, while the port rounds every operation separately; near tangency the
float32 root solve with absolute-time anchors is ill-conditioned, and on
C1 both float32 results lie up to ~0.07 (t ≈ 390) from a float64 solve,
while they differ from each other by at most 0.012 (5.8e-5 relative).
"""
import dataclasses

import numpy as np
import pytest

import repro.api as R
from repro.core.index import TemporalBinIndex as RefIndex
from repro.data import trajgen as ref_trajgen
from repro_torch import state
from repro_torch.api import ExecutionPolicy, QueryResult, TrajectoryDB
from repro_torch.core.errors import CapacityError
from repro_torch.core.index import TemporalBinIndex
from repro_torch.data import trajgen

RTOL, ATOL = 1e-4, 1e-3
CPU = "cpu"
MODES = [(backend, pruning, compaction)
         for backend in ("kernel", "torch")
         for pruning in ("none", "spatial", "hierarchical")
         for compaction in ("fused", "dense")]

#: (scenario, scale, policy fields): S2 with the reference facade tests'
#: policy, C1 (drifting swarm × clustered sensors) and C3 (twin swarm, the
#: README's hierarchical configuration).
SCENARIOS = {
    "S2": (0.01, dict(batching="periodic", batch_params={"s": 32},
                      num_bins=200)),
    "C1": (0.02, dict(num_bins=100)),
    "C3": (0.02, dict(num_bins=8, index_kboxes=4, max_subranges=16)),
}


def _rows(result):
    return (result.entry_idx, result.entry_traj, result.entry_seg,
            result.query_idx)


def assert_same_result(got, want, label=""):
    assert len(got) == len(want), (label, len(got), len(want))
    for a, b in zip(_rows(got), _rows(want)):
        np.testing.assert_array_equal(a, b, err_msg=str(label))
    np.testing.assert_allclose(got.t_enter, want.t_enter, rtol=RTOL,
                               atol=ATOL, err_msg=str(label))
    np.testing.assert_allclose(got.t_exit, want.t_exit, rtol=RTOL, atol=ATOL,
                               err_msg=str(label))


@pytest.fixture(scope="module")
def pairs():
    """Per scenario: (reference jnp result, port database on the CPU)."""
    out = {}
    for name, (scale, fields) in SCENARIOS.items():
        rdb = R.TrajectoryDB.from_scenario(
            name, scale=scale, policy=R.ExecutionPolicy(**fields))
        base = rdb.query(rdb.scenario_queries, rdb.scenario_d, backend="jnp")
        assert len(base) > 0, name
        tdb = TrajectoryDB.from_scenario(
            name, scale=scale, policy=ExecutionPolicy(**fields), device=CPU)
        out[name] = (base, tdb)
    return out


@pytest.mark.parametrize("mode", MODES, ids="-".join)
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_port_equals_reference_jnp(pairs, scenario, mode):
    backend, pruning, compaction = mode
    base, tdb = pairs[scenario]
    res = tdb.query(tdb.scenario_queries, tdb.scenario_d, backend=backend,
                    pruning=pruning, compaction=compaction)
    assert res.backend == backend
    assert_same_result(res, base, (scenario,) + mode)
    st = res.stats
    assert st.pipelined and st.num_syncs <= 2 * st.num_groups
    if backend == "kernel" and compaction == "fused" and pruning != "none":
        assert st.total_tiles > 0


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_brute_equals_reference_jnp(pairs, scenario):
    base, tdb = pairs[scenario]
    res = tdb.query(tdb.scenario_queries, tdb.scenario_d, backend="brute")
    assert res.stats is None
    assert_same_result(res, base, scenario)


def test_hierarchical_prunes_tiles_on_c3(pairs):
    """On C3's bimodal bins the K-box plan and the live-tile dispatch skip
    work, and the result does not change."""
    base, tdb = pairs["C3"]
    res = tdb.query(tdb.scenario_queries, tdb.scenario_d, backend="kernel",
                    pruning="hierarchical")
    none = tdb.query(tdb.scenario_queries, tdb.scenario_d, backend="kernel",
                     pruning="none")
    assert res.stats.total_interactions < none.stats.total_interactions
    assert_same_result(res, base)


# ----------------------------------------------------------------------
# Executor: syncs, groups, retries.
# ----------------------------------------------------------------------
def test_syncs_per_group(pairs):
    base, tdb = pairs["S2"]
    res = tdb.query(tdb.scenario_queries, tdb.scenario_d, backend="kernel",
                    policy=tdb.policy.with_(group_size=2))
    st = res.stats
    assert st.num_groups > 1 and st.num_syncs <= 2 * st.num_groups
    assert_same_result(res, base)
    seq = tdb.query(tdb.scenario_queries, tdb.scenario_d, backend="kernel",
                    pipeline=False)
    nonempty = sum(b.num_candidates > 0 for b in seq.stats.batches)
    assert not seq.stats.pipelined
    assert seq.stats.num_syncs == nonempty + seq.stats.total_retries
    assert_same_result(seq, base)


@pytest.mark.parametrize("pipeline", [True, False])
def test_overflow_retry_keeps_exact_rows(pairs, pipeline):
    base, tdb = pairs["S2"]
    pol = tdb.policy.with_(capacity=256, pipeline=pipeline)
    res = tdb.query(tdb.scenario_queries, tdb.scenario_d, backend="kernel",
                    policy=pol)
    assert res.stats.total_retries > 0
    assert_same_result(res, base)
    with pytest.raises(CapacityError) as err:
        tdb.query(tdb.scenario_queries, tdb.scenario_d, backend="kernel",
                  policy=pol.with_(max_capacity_retries=0))
    assert err.value.count > err.value.capacity


def test_caller_order_and_validation(pairs):
    base, tdb = pairs["S2"]
    queries = tdb.scenario_queries
    perm = np.random.default_rng(0).permutation(len(queries))
    res = tdb.query(queries.take(perm), tdb.scenario_d, backend="kernel")
    inv = np.argsort(perm)
    mapped = QueryResult.from_result_set(
        res.to_result_set(), order=perm, d=res.d, backend="kernel")
    assert_same_result(mapped, base)
    assert set(inv[base.query_idx]) == set(res.query_idx)
    with pytest.raises(ValueError, match="threshold"):
        tdb.query(queries, -1.0)
    assert_same_result(tdb.query(queries, tdb.scenario_d,
                                 compaction="fused_rowloop"), base)
    assert len(tdb.query(queries.take(np.s_[0:0]), 1.0)) == 0


# ----------------------------------------------------------------------
# Data and state carried across.
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(trajgen.SCENARIOS))
def test_make_scenario_equals_reference(name):
    got = trajgen.make_scenario(name, scale=0.005, seed=3)
    want = ref_trajgen.make_scenario(name, scale=0.005, seed=3)
    assert got[2] == want[2]
    for g, w in zip(got[:2], want[:2]):
        for f in dataclasses.fields(w):
            np.testing.assert_array_equal(getattr(g, f.name),
                                          getattr(w, f.name), err_msg=f.name)


@pytest.mark.parametrize("kboxes", [1, 4])
def test_state_carry_over(kboxes):
    segs, queries, d = ref_trajgen.make_scenario("C3", scale=0.02)
    ref_index = RefIndex.build(segs, 8, kboxes=kboxes)
    port_segs = state.segments_from_numpy(vars(segs))
    port_index = state.index_from_numpy(vars(ref_index))
    own = TemporalBinIndex.build(port_segs, 8, kboxes=kboxes)
    for f in dataclasses.fields(TemporalBinIndex):
        a, b = getattr(port_index, f.name), getattr(own, f.name)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    pol = dict(num_bins=8, index_kboxes=kboxes, max_subranges=16,
               pruning="hierarchical")
    tdb = TrajectoryDB.from_segments(
        port_segs, policy=ExecutionPolicy(**pol), device=CPU,
        index=port_index)
    rdb = R.TrajectoryDB.from_segments(segs, policy=R.ExecutionPolicy(**pol))
    q_port = state.segments_from_numpy(vars(queries))
    assert_same_result(tdb.query(q_port, d), rdb.query(queries, d,
                                                       backend="jnp"))
    with pytest.raises(KeyError):
        state.index_from_numpy({"t0": 0.0})
