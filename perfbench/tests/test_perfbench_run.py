"""Whole runs: on the CPU at a small size (the harness's look for a card
skipped), with the timed path broken underneath, without a card, and
without the program."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench.harness import bench, spec

ROOT = spec.ROOT
WORKLOADS = [w["name"] for w in
             json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def cpu_run(capsys, workload, *, trace=0, seed=2 ** 31 + 5, seconds=0.5,
            scale=0.05):
    rc = bench.run(["--workload", workload, "--seed", str(seed), "--seconds",
                    str(seconds), "--trace", str(trace)], device="cpu",
                   scale=scale)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out else None)


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cpu_run_is_correct_and_reports_its_metrics(capsys, workload, trace):
    rc, res = cpu_run(capsys, workload, trace=trace)
    assert rc == 0 and res["correct"] is True, res
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    cell = spec.load_cell(workload)
    want = cell.per_layer if trace else cell.end_to_end
    # the CPU has no device peak and no device trace
    cpu_only = {"peak_device_gib", "distance_kernel_roofline",
                "device_idle_share"}
    if trace and res["attempted"] <= cell.traffic["trace_requests"]:
        # a short CPU window holds no request outside the profiler
        cpu_only.add("searches_per_s")
    assert set(res["metrics"]) == {m["name"] for m in want
                                   if m["name"].split(".")[0] not in cpu_only}


@pytest.mark.parametrize("trace", [0, 1])
def test_a_mix_on_another_backend_needs_only_its_data(capsys, monkeypatch,
                                                      trace):
    """A mix naming ``backend="rtree"`` runs through the harness as it is;
    the counters only an engine backend keeps are left out."""
    load = spec.load_cell

    def rtree_cell(name):
        cell = load(name)
        cell.traffic = dict(cell.traffic, query_kwargs={"backend": "rtree"})
        return cell

    monkeypatch.setattr(spec, "load_cell", rtree_cell)
    rc, res = cpu_run(capsys, "s1.search", trace=trace)
    assert rc == 0 and res["correct"] is True, res
    want = {"searches_per_s", "setup_s"} if not trace else {"search_p95_ms"}
    assert set(res["metrics"]) == want


def broken(fault):
    """``ops.query_block`` with ``fault`` applied to what it returns."""
    from repro_torch.kernels import ops
    original = ops.query_block

    def query_block(entries, queries, d, **kw):
        out = dict(original(entries, queries, d, **kw))
        e, q = out["entry_idx"].clone(), out["query_idx"].clone()
        t_exit = out["t_exit"].clone()
        n = int(out["count"])
        if fault == "unchanged":         # the step leaves its buffers as made
            e.fill_(-1)
            n = 0
        elif fault == "half_batch":      # half of the batch's queries left out
            drop = q >= (queries.shape[0] + 1) // 2
            n -= int((drop & (e >= 0)).sum())
            e[drop] = -1
        elif fault == "altered":         # one answer changed where produced
            live = torch.nonzero(e >= 0)
            if len(live):
                t_exit[live[0, 0]] += 0.5
        out.update(entry_idx=e, query_idx=q, t_exit=t_exit,
                   count=torch.tensor(n, dtype=torch.int32))
        return out

    return query_block


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_broken_timed_path_is_not_correct(capsys, monkeypatch, workload,
                                            fault):
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "query_block", broken(fault))
    rc, res = cpu_run(capsys, workload, seed=17)
    assert rc == 0 and res["correct"] is False, res["checks"]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        WORKLOADS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        WORKLOADS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


RUN_CPU = """
import json, sys
sys.path[0:0] = [{root!r}, {src!r}]
{prelude}
from perfbench.harness import bench
rc = bench.run(["--workload", "s1.search", "--seed", "3", "--seconds", "0.3",
                "--trace", "1"], device="cpu", scale=0.01)
print("TOP", json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
sys.exit(rc)
"""


@pytest.mark.parametrize("prelude,rc", [("", 0), (
    "import types; sys.modules['repro'] = types.ModuleType('repro')", 4)])
def test_a_run_loads_no_jax_and_no_reference_package(prelude, rc):
    code = RUN_CPU.format(root=str(ROOT), src=str(ROOT / "src"),
                          prelude=prelude)
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == rc, p.stderr[-2000:]
    top = set(json.loads(p.stdout.split("TOP ", 1)[1]))
    assert "repro_torch" in top and "perfbench" in top
    assert not ({"jax", "jaxlib", "flax"} & top)
    assert ("repro" in top) == (rc == 4)
    if rc:
        assert '"correct"' not in p.stdout


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import perfbench.reference.compare, perfbench.harness.control; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    top = set(eval(p.stdout))
    assert not ({"repro_torch", "repro", "jax", "torch"} & top), top


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cells_run_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for trace in (0, 1):
        p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                            workload, "--seed", "2147483659", "--seconds", "3",
                            "--trace", str(trace)], cwd=ROOT,
                           capture_output=True, text=True, timeout=1200)
        assert p.returncode == 0, p.stderr[-4000:]
        res = json.loads(p.stdout.strip().splitlines()[-1])
        assert res["correct"] is True, res["checks"]
        assert res["device"]["platform"] == "gpu"
        if trace:
            assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
