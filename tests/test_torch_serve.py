"""The port's serving tier (``repro_torch.serve``) against the reference's
(``repro.serve``) on one world, built from the same numpy seed in both
packages: 700 random entry segments, 96 queries, d = 4, periodic s = 16,
64 bins (the world of ``tests/test_broker.py``).

The port runs ``backend="kernel"`` on the CPU (the kernels' plain
twins), the reference ``backend="jnp"``.  Index columns must be equal;
``t_enter``/``t_exit`` agree within ``rtol=1e-4, atol=1e-3``, the
tolerance the facade tests hold the two packages to
(``tests/test_torch_api.py``).  Within the port, a broker's rows are
held to the port's own ``db.query`` bit for bit.
"""
import numpy as np
import pytest

import repro.api as R
from conftest import random_segments
from repro.serve.broker import AdmissionError as RefAdmissionError
from repro.serve.cache import SliceCache as RefSliceCache
from repro_torch import state
from repro_torch.api import ExecutionPolicy, TrajectoryDB
from repro_torch.serve import AdmissionError, SliceCache

RTOL, ATOL = 1e-4, 1e-3
CPU = "cpu"
INDEX_FIELDS = ("entry_idx", "entry_traj", "entry_seg", "query_idx")
TIME_FIELDS = ("t_enter", "t_exit")
POLICY = dict(num_bins=64, batching="periodic", batch_params={"s": 16})


def assert_same_rows(got, want, label=""):
    """Port result against the reference's: indices exact, intervals
    within the cross-package tolerance."""
    assert len(got) == len(want), (label, len(got), len(want))
    for f in INDEX_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f"{label}:{f}")
    for f in TIME_FIELDS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"{label}:{f}")


def assert_identical(got, want, label=""):
    for f in INDEX_FIELDS + TIME_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f"{label}:{f}")


@pytest.fixture(scope="module")
def worlds():
    """(port db, port queries, reference db, reference queries, d)."""
    rng = np.random.default_rng(42)
    segs = random_segments(rng, 700)
    queries = random_segments(rng, 96)         # sorted by construction
    rdb = R.TrajectoryDB.from_segments(segs,
                                       policy=R.ExecutionPolicy(**POLICY))
    tdb = TrajectoryDB.from_segments(state.segments_from_numpy(vars(segs)),
                                     policy=ExecutionPolicy(**POLICY),
                                     device=CPU)
    return (tdb, state.segments_from_numpy(vars(queries)), rdb, queries,
            4.0)


def test_slices_concatenate_to_canonical_result(worlds):
    tdb, tq, rdb, rq, d = worlds
    base = tdb.query(tq, d, backend="kernel")
    ticket = tdb.broker(backend="kernel").submit(tq, d, group_size=2)
    ticket.broker.run_until_idle()
    ref = rdb.broker(backend="jnp").submit(rq, d, group_size=2)
    ref_res = ref.result()
    assert ticket.num_groups == ref.num_groups >= 2
    assert [s.batch_indices for s in ticket.slices()] == [
        s.batch_indices for s in ref.slices()]
    for f in INDEX_FIELDS + TIME_FIELDS:
        concat = np.concatenate(
            [getattr(s.result, f) for s in ticket.slices()])
        np.testing.assert_array_equal(concat, getattr(base, f), err_msg=f)
    assert all(s.num_syncs <= 2 for s in ticket.slices())
    assert_identical(ticket.result(), base)
    assert_same_rows(ticket.result(), ref_res)
    for mine, theirs in zip(ticket.slices(), ref.slices()):
        assert_same_rows(mine.result, theirs.result, mine.group_index)


def test_unsorted_queries_finalize_to_caller_order(worlds):
    tdb, tq, rdb, rq, d = worlds
    perm = np.random.default_rng(7).permutation(len(tq))
    shuffled = tq.take(perm)
    assert not shuffled.is_sorted()
    got = tdb.broker(backend="kernel").submit(shuffled, d,
                                             group_size=2).result()
    assert_identical(got, tdb.query(shuffled, d, backend="kernel"))
    want = rdb.broker(backend="jnp").submit(rq.take(perm), d,
                                            group_size=2).result()
    assert_same_rows(got, want)


def test_cache_hit_subset_and_epoch_invalidation(worlds):
    tdb, tq, rdb, rq, d = worlds
    cache, ref_cache = SliceCache(), RefSliceCache()
    broker = tdb.broker(backend="kernel", cache=cache)
    ref_broker = rdb.broker(backend="jnp", cache=ref_cache)
    full = broker.submit(tq, d).result()
    ref_broker.submit(rq, d).result()

    again = broker.submit(tq, d)                  # repeat: born done
    assert again.done() and again.slices()[0].num_syncs == 0
    assert_identical(again.result(), full)

    pick = np.arange(0, len(tq), 3)                # byte-exact subset
    sub = broker.submit(tq.take(pick), d)
    assert sub.done()
    assert_identical(sub.result(), tdb.query(tq.take(pick), d,
                                             backend="kernel"))
    assert_same_rows(sub.result(),
                     ref_broker.submit(rq.take(pick), d).result())
    ref_broker.submit(rq, d).result()
    tdb.data_epoch += 1
    rdb.data_epoch += 1
    try:
        stale = broker.submit(tq.take(pick), d)    # new epoch: a miss
        assert not stale.done()
        assert_identical(stale.result(), sub.result())
        ref_broker.submit(rq.take(pick), d).result()
    finally:
        tdb.data_epoch -= 1
        rdb.data_epoch -= 1
    for f in ("lookups", "hits", "superset_hits", "misses", "insertions"):
        assert getattr(cache.stats, f) == getattr(ref_cache.stats, f), f
    assert (cache.stats.hits, cache.stats.superset_hits) == (2, 1)


def test_backpressure_rejection_and_recovery(worlds):
    tdb, tq, rdb, rq, d = worlds
    probe = tdb.broker(backend="kernel").submit(tq, d)
    ref_probe = rdb.broker(backend="jnp").submit(rq, d)
    assert probe.interactions == ref_probe.interactions > 0
    budget = probe.interactions + probe.interactions // 2   # fits 1, not 2
    broker = tdb.broker(backend="kernel", max_inflight_interactions=budget)
    t1 = broker.submit(tq, d)
    assert broker.inflight_interactions == t1.interactions
    with pytest.raises(AdmissionError, match="budget"):
        broker.submit(tq, d)
    assert broker.rejected == 1 and broker.pending == 1
    broker.run_until_idle()
    assert broker.inflight_interactions == 0
    assert_identical(broker.submit(tq, d).result(), t1.result())


def test_deadline_admission_and_edf_order(worlds):
    """Deadline pricing rejects what the reference rejects, and the pump
    serves a tight-deadline ticket before a queued loose one."""
    tdb, tq, rdb, rq, d = worlds

    def predict(b):
        return 1e-6 * b.num_ints
    broker = tdb.broker(backend="kernel", admission_slack=4.0,
                        predict_seconds=predict)
    ref_broker = rdb.broker(backend="jnp", admission_slack=4.0,
                            predict_seconds=predict)
    with pytest.raises(AdmissionError, match="deadline"):
        broker.submit(tq, d, deadline=1e-12)
    with pytest.raises(RefAdmissionError, match="deadline"):
        ref_broker.submit(rq, d, deadline=1e-12)
    assert broker.rejected == ref_broker.rejected == 1

    order = []
    loose = broker.submit(tq, d, deadline=3600.0, group_size=1,
                          on_slice=lambda tk, sl: order.append(tk.uid))
    tight = broker.submit(tq, d, deadline=600.0, group_size=1,
                          on_slice=lambda tk, sl: order.append(tk.uid))
    ref_loose = ref_broker.submit(rq, d, deadline=3600.0, group_size=1)
    assert loose.predicted_seconds == pytest.approx(
        ref_loose.predicted_seconds)
    assert loose.num_groups == ref_loose.num_groups >= 2
    broker.run_until_idle()
    assert order == ([tight.uid] * tight.num_groups
                     + [loose.uid] * loose.num_groups)
    assert_identical(tight.result(), loose.result())
    assert_same_rows(loose.result(), ref_loose.result())


def test_trajectory_query_service_shim(worlds, monkeypatch):
    """The deprecated submit/drain shim against the reference's: sorted
    and shuffled requests give the reference's rows, and a request whose
    execution raises comes back errored while the queue drains on."""
    from repro.serve import TrajectoryQueryService as RefService
    from repro_torch.serve import TrajectoryQueryService
    tdb, tq, rdb, rq, d = worlds
    perm = np.random.default_rng(3).permutation(len(tq))
    with pytest.warns(DeprecationWarning, match="QueryBroker"):
        svc = TrajectoryQueryService(tdb, backend="kernel")
    with pytest.warns(DeprecationWarning, match="QueryBroker"):
        ref = RefService(rdb, backend="jnp")
    uids = [svc.submit(tq, d), svc.submit(tq.take(perm), d)]
    assert uids == [ref.submit(rq, d), ref.submit(rq.take(perm), d)]
    assert svc.pending == ref.pending == 2
    got, want = svc.drain(), ref.drain()
    assert svc.pending == 0 and svc.completed == ref.completed == 2
    for u in uids:
        assert got[u].ok and want[u].ok and got[u].latency_seconds > 0
        assert_same_rows(got[u].result, want[u].result, u)
    assert_identical(got[uids[1]].result,
                     tdb.query(tq.take(perm), d, backend="kernel"))

    orig, calls = tdb.query_stream, []

    def flaky(q, dd, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected executor failure")
        return orig(q, dd, **kw)
    monkeypatch.setattr(tdb, "query_stream", flaky)
    bad, ok = svc.submit(tq, d), svc.submit(tq, d)
    out = svc.drain()
    assert not out[bad].ok and out[bad].result is None
    assert isinstance(out[bad].error, RuntimeError)
    assert out[ok].ok and svc.failed == 1
    assert_identical(out[ok].result, got[uids[0]].result)
    with pytest.warns(DeprecationWarning):
        with pytest.raises(ValueError):
            TrajectoryQueryService(tdb, backend="brute")
