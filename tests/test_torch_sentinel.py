"""The port's runtime sync-sentinel and the executor seam it reads:
pipelined S2 on the CPU makes exactly ``ExecStats.num_syncs`` fence waits,
≤ 2 per group, with the same syncs, groups and group-label sequence as the
reference under its own ``SyncSentinel``; reads are classified (blocking,
ready, unfenced) and attributed to ``_group_scope`` labels; every patch
and the sync-debug mode are restored; the staging hook is dormant while no
sentinel watches."""
import threading
import warnings

import numpy as np
import pytest
import torch

import repro.core.executor as ref_executor
from repro.api import ExecutionPolicy as RefPolicy
from repro.api import TrajectoryDB as RefDB
from repro.lint.sentinel import SyncSentinel as RefSentinel
from repro_torch.api import ExecutionPolicy, TrajectoryDB
from repro_torch.core import engine as port_engine
from repro_torch.core import executor as port_executor
from repro_torch.core.executor import (Fence, _group_scope,
                                       current_group_label, watch_staged)
from repro_torch.lint.sentinel import SYNC_WARNING, SyncSentinel

CPU = torch.device("cpu")
S2_POLICY = dict(batching="periodic", batch_params={"s": 32}, num_bins=200)


def _recording_scopes(monkeypatch, module):
    """Record the labels ``module``'s executors enter, in order."""
    labels = []
    orig = module._group_scope

    def scope(label):
        labels.append(label)
        return orig(label)
    monkeypatch.setattr(module, "_group_scope", scope)
    return labels


class _Stream:
    def __init__(self, idle):
        self.idle = idle

    def query(self):
        return self.idle


@pytest.fixture(scope="module", params=[None, 3],
                ids=["reference_policy", "group_size_3"])
def s2(request):
    """S2 at scale 0.01 under the reference test's policy (one dispatch
    group), and the same with groups of 3 batches."""
    pol = dict(S2_POLICY, group_size=request.param)
    db = TrajectoryDB.from_scenario("S2", scale=0.01, device="cpu",
                                    policy=ExecutionPolicy(**pol))
    ref = RefDB.from_scenario("S2", scale=0.01, policy=RefPolicy(**pol))
    d = float(db.scenario_d)
    qs, _ = db._sorted(db.scenario_queries)
    rqs, _ = ref._sorted(ref.scenario_queries)
    plan = db._make_plan(qs, db.policy, "kernel", d=d)
    ref_plan = ref._make_plan(rqs, ref.policy, "jnp", d=d)
    return db, qs, plan, ref, rqs, ref_plan, d


def test_plans_equal(s2):
    _, _, plan, _, _, ref_plan, _ = s2
    assert plan.num_batches == ref_plan.num_batches > 1
    assert plan.groups == ref_plan.groups
    assert list(plan.capacities) == list(ref_plan.capacities)


def test_pipelined_run_sync_budget(s2):
    db, qs, plan, _, _, _, d = s2
    be = db.backend("kernel")
    with SyncSentinel(watch=()) as s:
        rs, stats = be.run(qs, d, plan)
    rep = s.report()
    assert stats.pipelined and len(rs) > 0
    assert rep.explicit_syncs == stats.num_syncs <= 2 * stats.num_groups
    assert stats.num_groups == max(len(plan.groups), 1)
    assert rep.blocking_reads == rep.unfenced_reads == rep.other_syncs == 0
    assert rep.by_kind == {"Fence.wait": stats.num_syncs}


def test_sync_executor_counts_every_batch(s2):
    db, qs, plan, _, _, _, d = s2
    eng = db.engine("kernel")
    with SyncSentinel(watch=()) as s:
        _, stats = eng.execute(qs, d, plan, pipeline=False)
    live = sum(1 for b in plan.batches if b.num_candidates)
    assert s.report().explicit_syncs == stats.num_syncs >= live


def test_syncs_groups_and_labels_equal_reference(s2, monkeypatch):
    """Same plan, same counts and the same label sequence in both
    packages: the port's seam is the reference's."""
    db, qs, plan, ref, rqs, ref_plan, d = s2
    port_labels = _recording_scopes(monkeypatch, port_executor)
    ref_labels = _recording_scopes(monkeypatch, ref_executor)
    be, rbe = db.backend("kernel"), ref.backend("jnp")
    rbe.run(rqs, d, ref_plan)                  # warm-up: tracing/compiles
    del ref_labels[:]
    with SyncSentinel(watch=()) as s:
        _, stats = be.run(qs, d, plan)
    with RefSentinel() as rs:
        _, rstats = rbe.run(rqs, d, ref_plan)
    assert s.report().explicit_syncs == stats.num_syncs
    assert rs.report().explicit_syncs == rstats.num_syncs
    assert (stats.num_syncs, stats.num_groups) == (rstats.num_syncs,
                                                   rstats.num_groups)
    assert port_labels == ref_labels
    g = stats.num_groups
    assert port_labels == ["pipelined:dispatch:0"] + [
        label for i in range(1, g) for label in (
            f"pipelined:dispatch:{i}", f"pipelined:finish:{i - 1}")] + [
        f"pipelined:finish:{g - 1}"]


def test_sync_executor_labels_equal_reference(s2, monkeypatch):
    db, qs, plan, ref, rqs, ref_plan, d = s2
    port_labels = _recording_scopes(monkeypatch, port_executor)
    ref_labels = _recording_scopes(monkeypatch, ref_executor)
    db.engine("kernel").execute(qs, d, plan, pipeline=False)
    ref.engine("jnp").execute(rqs, d, ref_plan, pipeline=False)
    assert port_labels == ref_labels
    assert port_labels == [f"sync:{i}" for i in range(len(plan.groups))]


def test_group_label_is_thread_local():
    seen = {}

    def worker():
        seen["other"] = current_group_label()
    with _group_scope("pipelined:finish:3"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
        assert current_group_label() == "pipelined:finish:3"
        with _group_scope("sync:0"):
            assert current_group_label() == "sync:0"
        assert current_group_label() == "pipelined:finish:3"
    assert not t.is_alive() and seen == {"other": None}
    assert current_group_label() is None


def test_reads_counted_and_attributed(monkeypatch):
    """A read of a watched tensor while the stream is busy blocks, and is
    blamed on the group scope it ran in; reads outside any scope land
    under ``None``; a read on an idle stream is a ready read."""
    stream = _Stream(idle=False)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None:
                        stream)
    x = torch.arange(4.0)
    with SyncSentinel(watch=("cpu",)) as s:
        with _group_scope("pipelined:dispatch:7"):
            x[0].item()
            np.asarray(x)            # __array__ → numpy(): one read
        x.tolist()
        stream.idle = True
        float(x[1])
        x.to(torch.float64)          # a cast, not a transfer
    rep = s.report()
    assert rep.blocking_reads == 3 and rep.ready_reads == 1
    assert rep.blocking_by_group == {"pipelined:dispatch:7": 2, None: 1}
    assert rep.by_kind == {"item": 1, "__array__": 1, "tolist": 1,
                           "__float__": 1}
    assert rep.blocked_seconds >= 0.0
    assert rep.total_syncs == rep.explicit_syncs + 3


def test_unwatched_tensors_not_counted():
    x = torch.arange(4.0)
    with SyncSentinel(watch=("cuda",)) as s:
        x.sum().item()
        x.numpy()
        int(x[0])
    rep = s.report()
    assert (rep.blocking_reads, rep.ready_reads, rep.by_kind) == (0, 0, {})


def test_staged_reads_fenced_and_unfenced():
    a, b = torch.arange(3), torch.zeros(2)
    with SyncSentinel(watch=()) as s:
        watch_staged([a, b], CPU)
        with _group_scope("pipelined:dispatch:0"):
            a.numpy()                      # before the fence: unfenced
        fence = Fence(CPU)
        int(b[0].sum())                    # a view: not the staged tensor
        fence.wait()
        a.numpy()
        int(b.sum())                       # a new tensor: not staged
        b.tolist()
        watch_staged([b], CPU)             # re-staged after the fence
        b.tolist()
    rep = s.report()
    assert rep.unfenced_reads == 2 and rep.ready_reads == 2
    assert rep.unfenced_by_group == {"pipelined:dispatch:0": 1, None: 1}
    assert rep.explicit_syncs == 1


def test_copy_staged_while_a_fence_records_is_not_covered(monkeypatch):
    """A copy another thread stages after a fence's event was recorded
    (but before the constructor returns) is not covered by that fence:
    reading it after the wait is an unfenced read."""
    late = torch.arange(4)
    orig_init = Fence.__init__

    def init(fence, device):
        orig_init(fence, device)          # the event is recorded here
        t = threading.Thread(target=watch_staged, args=([late], CPU))
        t.start()
        t.join()
    monkeypatch.setattr(Fence, "__init__", init)
    with SyncSentinel(watch=()) as s:
        fence = Fence(CPU)
        fence.wait()
        late.numpy()
    rep = s.report()
    assert (rep.unfenced_reads, rep.ready_reads) == (1, 0)
    assert rep.explicit_syncs == 1


def test_stage_to_host_registers_only_under_a_sentinel(monkeypatch):
    """``_stage_to_host``'s hook: dormant without a sentinel; under one,
    every staged tensor (not the host ints) is registered, so a read
    before the fence is unfenced and one after it is ready."""
    class Event:
        """Stands in for a CUDA event: the copy it covers never ends."""

        def record(self, stream=None):
            pass

        def query(self):
            return False

        def synchronize(self):
            pass

    orig_empty = torch.empty
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: _Stream(True))
    monkeypatch.setattr(torch, "empty", lambda shape, dtype, pin_memory:
                        orig_empty(shape, dtype=dtype))
    cuda = torch.device("cuda", 0)
    out = {"count": torch.tensor(5, dtype=torch.int32), "num_tiles": 3}
    assert port_executor._staging_hook is None
    before = port_engine._stage_to_host(out, cuda)     # no sentinel
    with SyncSentinel(watch=()) as s:
        assert port_executor._staging_hook == s._stage
        int(before["count"])                           # never registered
        host = port_engine._stage_to_host(out, cuda)
        assert host["num_tiles"] == 3 and host["count"] is not out["count"]
        assert len(s._staged) == 1
        int(host["count"])
        Fence(cuda).wait()
        int(host["count"])
    port_engine._stage_to_host(out, cuda)             # after the sentinel
    rep = s.report()
    assert len(s._staged) == 1
    assert rep.unfenced_reads == 1 and rep.ready_reads == 1
    assert rep.explicit_syncs == 1 and rep.other_syncs == 0
    assert rep.by_kind["unfenced:copy_incomplete"] == 1
    assert port_executor._staging_hook is None


def test_other_syncs_counted_outside_fence(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))
    with SyncSentinel(watch=()) as s:
        torch.cuda.synchronize()
        Fence(CPU).wait()
    rep = s.report()
    assert rep.other_syncs == 1 and rep.explicit_syncs == 1
    assert rep.by_kind == {"torch.cuda.synchronize": 1, "Fence.wait": 1}
    assert calls == [None]


def test_sync_debug_warnings_counted(monkeypatch):
    modes = ["default"]
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: {"default": 0, "warn": 1}[modes[-1]])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: modes.append(
                            {0: "default", 1: "warn"}.get(m, m)))
    with SyncSentinel(watch=(), sync_debug=True) as s:
        assert modes[-1] == "warn"
        for _ in range(3):          # one source line, every time counted
            warnings.warn(SYNC_WARNING, UserWarning)
        with _group_scope("pipelined:dispatch:2"):
            warnings.warn(SYNC_WARNING, UserWarning)
        with pytest.warns(DeprecationWarning):
            warnings.warn("unrelated", DeprecationWarning)
    assert modes[-1] == "default"
    rep = s.report()
    assert rep.aten_syncs == 4
    assert rep.aten_by_group == {None: 3, "pipelined:dispatch:2": 1}
    assert len(rep.aten_sites) == 2
    assert all(site.startswith(__file__) for site in rep.aten_sites)
    assert rep.to_json()["aten_by_group"] == {"None": 3,
                                              "pipelined:dispatch:2": 1}


def test_missing_sync_debug_mode_raises(monkeypatch):
    monkeypatch.delattr(torch.cuda, "set_sync_debug_mode")
    before = torch.Tensor.item
    with pytest.raises(RuntimeError, match="set_sync_debug_mode"):
        with SyncSentinel(sync_debug=True):
            pass
    assert torch.Tensor.item is before
    assert port_executor._staging_hook is None


def test_sentinel_restores_patches(monkeypatch):
    modes = [0]
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    names = SyncSentinel._METHODS + ("to",)
    owned = {n: n in vars(torch.Tensor) for n in names}
    before = ([getattr(torch.Tensor, n) for n in names],
              torch.cuda.synchronize, torch.cuda.Event.synchronize,
              torch.cuda.Stream.synchronize, Fence.__init__, Fence.wait,
              port_executor._staging_hook, warnings.showwarning,
              list(warnings.filters))
    with SyncSentinel(watch=("cuda",), sync_debug=True):
        assert torch.Tensor.item is not before[0][0]
        assert Fence.wait is not before[5]
    after = ([getattr(torch.Tensor, n) for n in names],
             torch.cuda.synchronize, torch.cuda.Event.synchronize,
             torch.cuda.Stream.synchronize, Fence.__init__, Fence.wait,
             port_executor._staging_hook, warnings.showwarning,
             list(warnings.filters))
    assert after == before
    assert owned == {n: n in vars(torch.Tensor) for n in names}
    assert modes == [0, "warn", 0]


def test_patches_restored_after_an_error():
    before = (torch.Tensor.item, Fence.wait)
    with pytest.raises(ValueError):
        with SyncSentinel(watch=()):
            raise ValueError("boom")
    assert (torch.Tensor.item, Fence.wait) == before


def _device_uploads(monkeypatch):
    """Record every host value sent to a device: ``torch.tensor(...,
    device=...)`` and ``Tensor.to`` with a device target (on the card a
    pageable upload waits for the stream to drain)."""
    seen = []
    orig_tensor, orig_to = torch.tensor, torch.Tensor.to

    def tensor(data, *args, **kwargs):
        if kwargs.get("device") is not None:
            seen.append(("torch.tensor", data))
        return orig_tensor(data, *args, **kwargs)

    def to(t, *args, **kwargs):
        if kwargs.get("device") is not None or any(
                isinstance(a, (str, torch.device)) for a in args):
            seen.append(("to", t))
        return orig_to(t, *args, **kwargs)
    monkeypatch.setattr(torch, "tensor", tensor)
    monkeypatch.setattr(torch.Tensor, "to", to)
    return seen


@pytest.mark.parametrize("x", [0.1, 3.0, 1e-30, float("inf")])
def test_scalar_operand_filled_on_the_device(monkeypatch, x):
    """``ref._f32`` makes a host scalar on its target device, with
    ``np.float32``'s bits."""
    from repro_torch.kernels import ref
    uploads = _device_uploads(monkeypatch)
    out = ref._f32(x, CPU)
    assert uploads == []
    assert out.dtype == torch.float32 and out.shape == ()
    assert out.numpy().tobytes() == np.float32(x).tobytes()


def test_interval_solve_uploads_nothing(monkeypatch):
    """The dense path's interval recompute (``ref.pair_intervals``, once
    per dispatch) sends no host value to the device: neither the
    threshold nor the solve's ``inf``."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(3)
    e = torch.from_numpy(rng.random((16, 8), dtype=np.float32))
    q = torch.from_numpy(rng.random((16, 8), dtype=np.float32))
    uploads = _device_uploads(monkeypatch)
    enter, exit_, hit = ref.pair_intervals(e, q, 0.5)
    assert uploads == []
    assert enter.shape == exit_.shape == hit.shape == (16,)
