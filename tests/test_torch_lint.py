"""``repro_torch.lint``: the torch-aware SYNC rules, the CUDA launch
contract (KERN101–103), FAULT001 and DEAD001, suppressions, the CLI/JSON
contract, plants in copies of the port's real sources, the port's own
error-clean baseline — and, on the same synthetic inputs, the rules the
two linters share held against the reference's ``repro.lint``."""
import json
import os
import textwrap

import pytest

import repro.lint
import repro_torch.lint  # noqa: F401  (DEAD001 reachability root)
from repro.lint.__main__ import main as ref_main
from repro_torch.lint import LintConfig, lint_paths, lint_sources, summarize
from repro_torch.lint.__main__ import main as lint_main
from repro_torch.lint.rules import RULES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Synthetic paths that land in the configured rule scopes.
SYNC_PATH = "src/repro_torch/core/executor.py"
KERN_PATH = "src/repro_torch/kernels/distthresh.py"
BUILD_PATH = "src/repro_torch/kernels/_build.py"
CU_PATH = "src/repro_torch/kernels/csrc/k.cu"


def run(path, source, *rules):
    vs = lint_sources([(path, textwrap.dedent(source))], select=rules)
    return [(v.rule, v.line) for v in vs]


def rules_of(path, source, *rules):
    return {r for r, _ in run(path, source, *rules)}


def _read(rel):
    with open(os.path.join(ROOT, rel), encoding="utf-8") as fh:
        return fh.read()


# ----------------------------------------------------------------------
# SYNC001/002 on torch snippets.
# ----------------------------------------------------------------------
class TestSyncRules:
    def test_materializers_flagged(self):
        src = """\
        import numpy as np
        import torch

        def phase_a():
            out = torch.zeros(4, device="cuda")
            a = np.asarray(out)
            b = float(out[0])
            c = out[0].item()
            d = out.tolist()
            e = out.cpu()
            f = out.numpy()
            return a, b, c, d, e, f
        """
        hits = run(SYNC_PATH, src, "SYNC001")
        assert hits == [("SYNC001", n) for n in range(6, 12)]

    @pytest.mark.parametrize("call", [
        'out.to("cpu")', 'out.to(device="cpu")',
        'out.to(torch.device("cpu"))', "torch.nonzero(out)",
        "out.nonzero()", "torch.masked_select(out, out > 0)",
        "out.unique()", "torch.cuda.synchronize()"])
    def test_host_syncing_aten_calls_flagged(self, call):
        src = f"""\
        import torch

        def phase_a():
            out = torch.zeros(4, device="cuda")
            return {call}
        """
        assert run(SYNC_PATH, src, "SYNC001") == [("SYNC001", 5)]

    def test_device_to_device_copy_clean(self):
        src = """\
        import torch

        def phase_a(dev0):
            out = torch.zeros(4, device="cuda")
            moved = out.to(dev0, non_blocking=True)
            return moved.to(torch.int8)
        """
        assert run(SYNC_PATH, src, "SYNC001") == []

    def test_iteration_and_comprehension_flagged(self):
        src = """\
        import torch

        def phase_a():
            out = torch.arange(4)
            for x in out:
                pass
            ys = [v for v in out]
            zs = list(out)
        """
        hits = run(SYNC_PATH, src, "SYNC002")
        assert [r for r, _ in hits] == ["SYNC002"] * 3

    @pytest.mark.parametrize("read", [
        'int(dp.out["count"])', 'dp.out["entry_idx"].numpy()',
        'dp.out["count"].item()', 'dp.out["t_enter"].cpu()'])
    def test_dispatch_out_read_before_fence_flagged(self, read):
        src = f"""\
        from repro_torch.core.executor import Fence

        def finish(disp, batch):
            dp = disp.dispatch(batch, 16)
            n = {read}
            Fence(disp.device).wait()
            return n
        """
        assert run(SYNC_PATH, src, "SYNC001") == [("SYNC001", 5)]

    @pytest.mark.parametrize("read", [
        'int(dp.out["count"])', 'dp.out["entry_idx"].numpy()',
        'dp.out["count"].item()', 'dp.out["t_enter"].cpu()'])
    def test_dispatch_out_read_after_fence_clean(self, read):
        src = f"""\
        from repro_torch.core.executor import Fence

        def finish(disp, batch):
            dp = disp.dispatch(batch, 16)
            Fence(disp.device).wait()
            return {read}
        """
        assert run(SYNC_PATH, src, "SYNC001") == []

    def test_fence_bound_name_and_container_wait(self):
        src = """\
        from repro_torch.core.executor import Fence

        def run(disp, batches):
            fences = {}
            slots = {}

            def dispatch_group(gi):
                slots[gi] = disp.dispatch(batches[gi], 16)
                fences[gi] = Fence(disp.device)

            def finish_group(gi):
                fences.pop(gi).wait()
                return int(slots[gi].out["count"])

            def finish_named(gi):
                fence = Fence(disp.device)
                fence.wait()
                return int(slots[gi].out["count"])
        """
        assert run(SYNC_PATH, src, "SYNC001") == []

    def test_event_synchronize_is_the_sanctioned_sync(self):
        src = """\
        import torch

        def finish(disp, batch):
            dp = disp.dispatch(batch, 16)
            ev = torch.cuda.Event()
            ev.record()
            ev.synchronize()
            return int(dp.out["count"])
        """
        assert run(SYNC_PATH, src, "SYNC001") == []

    def test_futures_wait_is_a_taint_root_not_a_sync(self):
        """``concurrent.futures.wait`` returns futures of device work:
        iterating its done-set and blocking on one are flagged."""
        src = """\
        from concurrent.futures import wait

        def drain(pool, work):
            futures = [pool.submit(w) for w in work]
            done, _ = wait(futures, timeout=0.01)
            for fut in done:
                rs = fut.result()
        """
        hits = run("src/repro_torch/core/scheduler.py", src,
                   "SYNC001", "SYNC002")
        assert ("SYNC002", 6) in hits and ("SYNC001", 7) in hits

    def test_futures_wait_through_module_alias(self):
        src = """\
        import concurrent.futures as cf

        def drain(pool, work):
            done, _ = cf.wait([pool.submit(w) for w in work])
            for f in done:
                f.result()
        """
        hits = run("src/repro_torch/core/scheduler.py", src,
                   "SYNC001", "SYNC002")
        assert {r for r, _ in hits} == {"SYNC001", "SYNC002"}

    def test_fence_wait_is_a_sync_not_a_taint_root(self):
        """The fence's ``.wait()`` (receiver bound to a Fence) syncs; it
        returns no device value, so nothing after it is flagged."""
        src = """\
        from repro_torch.core.executor import Fence

        def finish(disp, batch):
            dp = disp.dispatch(batch, 16)
            done = Fence(disp.device).wait()
            return int(dp.out["count"]), done
        """
        assert run(SYNC_PATH, src, "SYNC001", "SYNC002") == []

    def test_other_wait_neither_syncs_nor_taints(self):
        src = """\
        import threading

        def finish(disp, batch):
            dp = disp.dispatch(batch, 16)
            flag = threading.Event()
            flag.wait()
            return int(dp.out["count"])
        """
        assert run(SYNC_PATH, src, "SYNC001") == [("SYNC001", 7)]

    def test_sync_inside_loop_body_respected(self):
        src = """\
        from repro_torch.core.executor import Fence

        def group(disp, batches):
            for b in batches:
                dp = disp.dispatch(b, 16)
                Fence(disp.device).wait()
                n = dp.out["count"].item()
        """
        assert run(SYNC_PATH, src, "SYNC001") == []

    def test_post_sync_methods_skipped(self):
        src = """\
        import torch

        class Disp:
            def count(self, dp):
                return int(dp.out["count"])          # post-sync by contract

            def marshal(self, dp, n):
                return dp.out["entry_idx"].numpy()   # post-sync by contract

            def helper(self, dp):
                return int(dp.out["count"])          # NOT in the protocol
        """
        assert run(SYNC_PATH, src, "SYNC001") == [("SYNC001", 11)]

    def test_scope_limited_to_sync_modules(self):
        src = """\
        import torch

        def anywhere():
            return torch.zeros(4).item()
        """
        assert run("src/repro_torch/core/index.py", src, "SYNC001") == []
        assert run("src/repro_torch/kernels/ops.py", src, "SYNC001") == [
            ("SYNC001", 4)]

    def test_default_sync_modules(self):
        mods = LintConfig().sync_modules
        for m in ("executor", "engine", "distributed", "scheduler"):
            assert f"repro_torch/core/{m}.py" in mods
        assert "repro_torch/serve/broker.py" in mods
        assert "repro_torch/kernels/ops.py" in mods

    def test_host_metadata_not_tainted(self):
        src = """\
        import numpy as np
        import torch

        def meta(dev):
            out = torch.zeros((4, 2), device=dev)
            n = int(out.shape[0]) + int(out.numel()) + int(out.stride(0))
            s = torch.cuda.current_stream(dev)
            ok = bool(s.query())
            return n, ok, np.asarray(torch.device("cpu").type)
        """
        assert run(SYNC_PATH, src, "SYNC001") == []

    def test_pinned_staging_copy_is_tainted(self):
        """A pinned host tensor filled by a non-blocking copy holds its
        values only after the fence: reading it before is flagged."""
        src = """\
        import torch

        def stage(v):
            h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            h.copy_(v, non_blocking=True)
            return h.numpy()
        """
        assert run(SYNC_PATH, src, "SYNC001") == [("SYNC001", 6)]


# ----------------------------------------------------------------------
# Suppression syntax (shared with the reference linter).
# ----------------------------------------------------------------------
class TestSuppressions:
    SRC = """\
    import torch

    def f():
        out = torch.zeros(4)
        return out.item()  # lint: ignore[SYNC001]
    """

    def test_line_ignore(self):
        assert run(SYNC_PATH, self.SRC, "SYNC001") == []

    def test_def_line_ignore_covers_body(self):
        src = """\
        import torch

        def f():  # lint: ignore[SYNC001]
            out = torch.zeros(4)
            return out.item(), out.cpu()
        """
        assert run(SYNC_PATH, src, "SYNC001") == []

    def test_star_ignores_everything(self):
        src = self.SRC.replace("ignore[SYNC001]", "ignore[*]")
        assert run(SYNC_PATH, src, "SYNC001", "SYNC002") == []

    def test_wrong_rule_id_does_not_suppress(self):
        src = self.SRC.replace("ignore[SYNC001]", "ignore[KERN101]")
        assert rules_of(SYNC_PATH, src, "SYNC001") == {"SYNC001"}

    def test_sync_point_annotation(self):
        src = """\
        import torch

        def f():
            out = torch.zeros(4)
            n = int(out[0])  # lint: sync-point — deliberate early read
            return out.numpy()   # post-sync from here on
        """
        assert run(SYNC_PATH, src, "SYNC001") == []


# ----------------------------------------------------------------------
# KERN101–103: the ctypes launch contract.
# ----------------------------------------------------------------------
BUILD_SRC = """\
import ctypes

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

SIGNATURES = {
    "k_launch": (_P, _I, _L, _F, _P),
}
SIGNATURES["k2_launch"] = SIGNATURES["k_launch"]
SIGNATURES["k_blocks"] = (_I,) * 2
"""

CU_SRC = """\
namespace {
__global__ void k_kernel(const float* x, int n) {}
}  // namespace

extern "C" {

// The launch: returns its cudaError_t.
int k_launch(const float* x, int n, long long ld, float d, void* stream) {
  k_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(x, n);
  return (int)cudaGetLastError();
}

int k_blocks(int c, int q) { return c * q; }

}  // extern "C"

extern "C" int k2_launch(const float* x, int n, long long ld, float d,
                         void* stream) {
  return 0;
}
"""

WRAPPER_SRC = """\
from repro_torch.kernels._launch import raise_on as _raise_on


def _outs(n):
    return (n, n + 1)


def launch(x, n, d, dev, fast):
    from repro_torch.kernels import _build
    err = _build.load().k_launch(x, n, 1, d, dev)
    _raise_on(err, "k")
    lib = _build.load()
    fn = lib.k_launch if fast else lib.k2_launch
    err = fn(x, n, 1, d, dev)
    _raise_on(err, "k")
    name = "k2" if fast else "k"
    err = getattr(_build.load(), name + "_launch")(x, *_outs(n), d, dev)
    _raise_on(err, "k")
    return lib.k_blocks(n, n)
"""


def kern(build=BUILD_SRC, cu=CU_SRC, wrapper=WRAPPER_SRC, *rules):
    items = [(BUILD_PATH, build), (KERN_PATH, wrapper)]
    if cu is not None:
        items.append((CU_PATH, cu))
    vs = lint_sources(items, select=rules or ("KERN101", "KERN102",
                                              "KERN103"))
    return [(v.rule, v.path, v.line) for v in vs]


class TestKernRules:
    def test_consistent_contract_clean(self):
        assert kern() == []

    def test_parameter_kind_mismatch(self):
        cu = CU_SRC.replace("int k_launch(const float* x, int n,",
                            "int k_launch(const float* x, float n,")
        assert kern(cu=cu) == [("KERN101", BUILD_PATH, 6)]

    def test_parameter_count_mismatch(self):
        cu = CU_SRC.replace("float d,\n                         void* stream",
                            "void* stream")
        assert kern(cu=cu) == [("KERN101", BUILD_PATH, 8)]

    def test_launch_missing_from_c(self):
        cu = CU_SRC.replace("extern \"C\" int k2_launch", "int k2_launch")
        assert kern(cu=cu) == [("KERN101", BUILD_PATH, 8)]

    def test_helper_missing_from_c(self):
        cu = CU_SRC.replace("int k_blocks(int c, int q) { return c * q; }",
                            "")
        assert kern(cu=cu) == [("KERN101", BUILD_PATH, 9)]

    def test_launch_missing_from_signatures(self):
        cu = CU_SRC + ('extern "C" int k3_launch(int n) { return 0; }\n')
        hits = kern(cu=cu)
        assert hits == [("KERN101", BUILD_PATH, 5)]

    def test_double_parameter_kind(self):
        """A ``double`` is its own kind: declared where SIGNATURES says
        ``float``, it is a mismatch; matched by ``c_double``, clean."""
        cu = CU_SRC.replace("long long ld, float d, void* stream",
                            "long long ld, double d, void* stream")
        assert kern(cu=cu) == [("KERN101", BUILD_PATH, 6)]
        build = BUILD_SRC.replace(
            '_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, '
            'ctypes.c_longlong, ctypes.c_float',
            '_P, _I, _L, _F, _D = ctypes.c_void_p, ctypes.c_int, '
            'ctypes.c_longlong, ctypes.c_float, ctypes.c_double').replace(
            '"k_launch": (_P, _I, _L, _F, _P),',
            '"k_launch": (_P, _I, _L, _D, _P),')
        cu = cu.replace("long long ld, float d,\n",
                        "long long ld, double d,\n")
        assert kern(build=build, cu=cu) == []

    def test_unparsable_prototype_skipped(self):
        cu = CU_SRC.replace("int k_launch(const float* x, int n,",
                            "int k_launch(const float* x, size_t n,")
        assert kern(cu=cu) == []

    def test_no_c_sources_no_kern101(self):
        assert kern(cu=None) == []

    def test_dropped_argument(self):
        wrapper = WRAPPER_SRC.replace("k_launch(x, n, 1, d, dev)",
                                      "k_launch(x, n, d, dev)")
        assert kern(wrapper=wrapper) == [("KERN102", KERN_PATH, 10)]

    def test_conditional_target_each_arm_checked(self):
        build = BUILD_SRC.replace(
            'SIGNATURES["k2_launch"] = SIGNATURES["k_launch"]',
            'SIGNATURES["k2_launch"] = SIGNATURES["k_launch"] + (_I,)')
        cu = CU_SRC.replace("float d,\n                         void* stream",
                            "float d, void* stream, int extra")
        assert kern(build=build, cu=cu) == [
            ("KERN102", KERN_PATH, 14), ("KERN102", KERN_PATH, 17)]

    def test_getattr_target_with_starred_length(self):
        wrapper = WRAPPER_SRC.replace("*_outs(n)", "*_outs(n)[:1]")
        assert kern(wrapper=wrapper) == [("KERN102", KERN_PATH, 17)] * 2

    def test_unresolvable_star_skipped(self):
        wrapper = WRAPPER_SRC.replace("*_outs(n)", "*unknown")
        assert kern(wrapper=wrapper) == []

    def test_unchecked_launch_error(self):
        wrapper = WRAPPER_SRC.replace(
            '    err = fn(x, n, 1, d, dev)\n    _raise_on(err, "k")\n',
            "    fn(x, n, 1, d, dev)\n")
        assert kern(wrapper=wrapper) == [("KERN103", KERN_PATH, 14)]

    def test_return_before_check(self):
        wrapper = WRAPPER_SRC.replace(
            '    err = fn(x, n, 1, d, dev)\n',
            '    err = fn(x, n, 1, d, dev)\n    return err\n')
        assert kern(wrapper=wrapper) == [("KERN103", KERN_PATH, 14)]

    def test_check_wrapping_the_call(self):
        wrapper = WRAPPER_SRC.replace(
            '    err = fn(x, n, 1, d, dev)\n    _raise_on(err, "k")\n',
            '    _raise_on(fn(x, n, 1, d, dev), "k")\n')
        assert kern(wrapper=wrapper) == []

    def test_geometry_calls_need_no_check(self):
        assert "lib.k_blocks(n, n)" in WRAPPER_SRC
        assert kern(BUILD_SRC, CU_SRC, WRAPPER_SRC, "KERN103") == []

    def test_suppression_on_signatures_line(self):
        cu = CU_SRC.replace("int k_launch(const float* x, int n,",
                            "int k_launch(const float* x, float n,")
        build = BUILD_SRC.replace('"k_launch": (_P, _I, _L, _F, _P),',
                                  '"k_launch": (_P, _I, _L, _F, _P),'
                                  '  # lint: ignore[KERN101]')
        assert kern(build=build, cu=cu) == []


# ----------------------------------------------------------------------
# Plants in copies of the port's real sources.
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def real_sources():
    paths = ("src/repro_torch/core/engine.py",
             "src/repro_torch/kernels/distthresh.py",
             "src/repro_torch/kernels/flashattn.py",
             "src/repro_torch/kernels/_build.py",
             "src/repro_torch/kernels/csrc/distthresh.cu",
             "src/repro_torch/kernels/csrc/flashattn.cu")
    return {p: _read(p) for p in paths}


class TestPlants:
    def test_plant_item_in_dispatch(self, real_sources):
        path = "src/repro_torch/core/engine.py"
        anchor = ("        return Dispatch(batch, capacity, "
                  "_stage_to_host(out, self.device))")
        assert real_sources[path].count(anchor) == 1
        mutated = real_sources[path].replace(
            anchor, '        _dbg = out["count"].item()\n' + anchor)
        vs = lint_sources([(path, mutated)], select=("SYNC001",))
        assert [(v.rule, v.message.split(":")[0]) for v in vs] == [
            ("SYNC001", "in _QueryBlockDispatcher.dispatch")]
        vs = lint_sources([(path, real_sources[path])], select=("SYNC001",))
        assert vs == []

    def test_plant_dropped_dense_launch_argument(self, real_sources):
        path = "src/repro_torch/kernels/distthresh.py"
        anchor = "_ptr(t_enter), _ptr(t_exit), _ptr(hit), _stream(dev))"
        assert real_sources[path].count(anchor) == 1
        mutated = real_sources[path].replace(
            anchor, "_ptr(t_enter), _ptr(hit), _stream(dev))")
        items = [(p, s) for p, s in real_sources.items() if p != path]
        vs = lint_sources(items + [(path, mutated)], select=("KERN102",))
        assert [(v.rule, v.path) for v in vs] == [("KERN102", path)]
        assert "distthresh_dense_launch takes 10" in vs[0].message

    def test_plant_int_turned_float_in_cu(self, real_sources):
        path = "src/repro_torch/kernels/csrc/distthresh.cu"
        anchor = "int distthresh_dense_launch(const float* entries, int C,"
        assert real_sources[path].count(anchor) == 1
        mutated = real_sources[path].replace(
            anchor, anchor.replace("int C,", "float C,"))
        items = [(p, s) for p, s in real_sources.items() if p != path]
        vs = lint_sources(items + [(path, mutated)], select=("KERN101",))
        assert [v.rule for v in vs] == ["KERN101"]
        assert "distthresh_dense_launch" in vs[0].message

    def test_plant_unchecked_flash_launch(self, real_sources):
        path = "src/repro_torch/kernels/flashattn.py"
        anchor = '        raise_on(err, "flashattn")\n'
        assert real_sources[path].count(anchor) == 1
        mutated = real_sources[path].replace(anchor, "")
        items = [(p, s) for p, s in real_sources.items() if p != path]
        vs = lint_sources(items + [(path, mutated)], select=("KERN103",))
        assert [(v.rule, v.path) for v in vs] == [("KERN103", path)]

    def test_real_contract_clean(self, real_sources):
        vs = lint_sources(list(real_sources.items()),
                          select=("KERN101", "KERN102", "KERN103"))
        assert vs == []


# ----------------------------------------------------------------------
# FAULT001 and DEAD001.
# ----------------------------------------------------------------------
class TestFaultAndDead:
    PATH = "src/repro_torch/core/engine.py"

    def test_unguarded_call_flagged(self):
        src = """\
            from repro_torch import faults

            def dispatch(batch):
                faults.inject("engine.dispatch", batch=batch.index)
            """
        assert rules_of(self.PATH, src, "FAULT001") == {"FAULT001"}

    def test_guarded_call_clean(self):
        src = """\
            from repro_torch import faults

            def dispatch(batch):
                if faults.armed():
                    faults.inject("engine.dispatch", batch=batch.index)
            """
        assert run(self.PATH, src, "FAULT001") == []

    def test_bare_port_hook_flagged(self):
        src = """\
            from repro_torch.faults import corrupt as _fc

            def count(n):
                return _fc("engine.count", n)
            """
        assert rules_of(self.PATH, src, "FAULT001") == {"FAULT001"}

    def test_faults_package_exempt(self):
        src = """\
            def inject(site, ctx):
                _PLAN.inject(site, ctx)
            """
        assert run("src/repro_torch/faults/__init__.py", src,
                   "FAULT001") == []

    def test_unreachable_module_flagged(self, tmp_path):
        items = [
            ("src/repro_torch/api.py", "import repro_torch.core.used\n"),
            ("src/repro_torch/core/__init__.py", ""),
            ("src/repro_torch/core/used.py", "X = 1\n"),
            ("src/repro_torch/core/orphan.py", "Y = 2\n"),
        ]
        vs = lint_sources(items, select=("DEAD001",), root=str(tmp_path))
        assert [(v.rule, v.path, v.severity) for v in vs] == [
            ("DEAD001", "src/repro_torch/core/orphan.py", "warn")]

    def test_test_imports_are_roots(self, tmp_path):
        (tmp_path / "tests").mkdir()
        (tmp_path / "tests" / "test_x.py").write_text(
            "from repro_torch.core import orphan\n")
        items = [("src/repro_torch/api.py", ""),
                 ("src/repro_torch/core/__init__.py", ""),
                 ("src/repro_torch/core/orphan.py", "Y = 2\n")]
        assert lint_sources(items, select=("DEAD001",),
                            root=str(tmp_path)) == []


# ----------------------------------------------------------------------
# Held against the reference linter on the same inputs: the rules the two
# packages share (FAULT001, DEAD001), the suppression handling and the CLI
# schema.  Each linter scopes itself to its own package, so the synthetic
# files are written once with ``PKG`` and given to each under its name.
# ----------------------------------------------------------------------
FAULT_CASES = {
    "unguarded": """\
        from PKG import faults

        def dispatch(batch):
            faults.inject("engine.dispatch", batch=batch.index)
            return batch
        """,
    "guarded": """\
        from PKG import faults

        def dispatch(batch):
            if faults.armed():
                faults.inject("engine.dispatch")
        """,
    "ifexp": """\
        from PKG import faults

        def count(n):
            return faults.corrupt("engine.count", n) if faults.armed() else n
        """,
    "bare": """\
        from PKG.faults import inject as _fi

        def pump():
            _fi("broker.plan", uid=0)
        """,
    "wrong_guard": """\
        from PKG import faults

        def dispatch(batch, chaos):
            if chaos:
                faults.inject("engine.dispatch")
        """,
    "line_ignore": """\
        from PKG import faults

        def dispatch(batch):
            faults.inject("engine.dispatch")  # lint: ignore[FAULT001]
        """,
    "def_ignore": """\
        from PKG import faults

        def dispatch(batch):  # lint: ignore[FAULT001]
            faults.inject("engine.dispatch")
            faults.corrupt("engine.count", 1)
        """,
    "star_ignore": """\
        from PKG import faults

        def dispatch(batch):
            faults.inject("engine.dispatch")  # lint: ignore[*]
        """,
    "wrong_id_ignore": """\
        from PKG import faults

        def dispatch(batch):
            faults.inject("engine.dispatch")  # lint: ignore[SYNC001]
        """,
    "unrelated": """\
        def pump(container):
            container.inject("dependency")
            corrupt = lambda x: x
            corrupt(3)
        """,
}

DEAD_TREE = [
    ("src/PKG/__init__.py", ""),
    ("src/PKG/api.py", "import PKG.core.used\nfrom PKG.core import rel\n"),
    ("src/PKG/core/__init__.py", ""),
    ("src/PKG/core/used.py", "from . import sibling\n"),
    ("src/PKG/core/sibling.py", "X = 1\n"),
    ("src/PKG/core/rel.py", "Y = 1\n"),
    ("src/PKG/core/orphan.py", "Z = 2\n"),
    ("src/PKG/core/quiet.py", "# lint: ignore[DEAD001]\nW = 3\n"),
    ("src/PKG/serve/__init__.py", "from PKG.serve import broker\n"),
    ("src/PKG/serve/broker.py", ""),
    ("src/PKG/tool/__init__.py", ""),
    ("src/PKG/tool/cli.py", ""),
]


def _both(items, rules, root=None):
    """The two linters' violations on ``items`` written for each package,
    with the package name put back to ``PKG``."""
    out = []
    for pkg, lint in (("repro", repro.lint.lint_sources),
                      ("repro_torch", lint_sources)):
        given = [(p.replace("PKG", pkg), textwrap.dedent(s).replace(
            "PKG", pkg)) for p, s in items]
        vs = lint(given, select=rules, root=root)
        out.append([(v.rule, v.severity, v.path.replace(pkg, "PKG"),
                     v.line, v.col, v.message.replace(pkg, "PKG"))
                    for v in vs])
    return out


class TestAgainstReference:
    @pytest.mark.parametrize("case", sorted(FAULT_CASES))
    def test_fault001_equal(self, case):
        ref, port = _both([("src/PKG/core/engine.py", FAULT_CASES[case])],
                          ("FAULT001",))
        assert port == ref

    def test_fault001_cases_not_all_clean(self):
        ref, _ = _both([(f"src/PKG/core/m{i}.py", s) for i, s in
                        enumerate(FAULT_CASES.values())], ("FAULT001",))
        assert 3 <= len(ref) < len(FAULT_CASES) + 1

    def test_dead001_equal(self, tmp_path):
        (tmp_path / "tests").mkdir()
        for pkg in ("repro", "repro_torch"):
            (tmp_path / "tests" / f"test_{pkg}.py").write_text(
                f"import {pkg}.tool.cli\n")
        ref, port = _both(DEAD_TREE, ("DEAD001",), root=str(tmp_path))
        assert port == ref
        assert [v[2] for v in port] == ["src/PKG/core/orphan.py"]

    def test_parse_error_equal(self):
        ref, port = _both([("src/PKG/core/broken.py", "def f(:\n")],
                          ("FAULT001",))
        assert port == ref and [v[0] for v in port] == ["PARSE"]

    def test_cli_schema_equal(self, tmp_path, capsys):
        payloads = []
        for pkg, main in (("repro", ref_main), ("repro_torch", lint_main)):
            d = tmp_path / pkg / "src" / pkg / "core"
            d.mkdir(parents=True)
            (d / "engine.py").write_text(textwrap.dedent(
                FAULT_CASES["unguarded"]).replace("PKG", pkg))
            code = main([str(d), "--format=json", "--select", "FAULT001",
                         "--root", str(tmp_path / pkg)])
            payload = json.loads(capsys.readouterr().out)
            payloads.append((code, payload))
        (rc, ref), (pc, port) = payloads
        assert rc == pc == 1
        assert set(port) == set(ref) == {"tool", "schema_version", "paths",
                                         "counts", "violations"}
        assert port["schema_version"] == ref["schema_version"] == 1
        assert port["counts"] == ref["counts"] == {"error": 1, "warn": 0}
        assert [set(v) for v in port["violations"]] == [
            set(v) for v in ref["violations"]]
        strip = [(v["rule"], v["line"], v["col"]) for v in ref["violations"]]
        assert [(v["rule"], v["line"], v["col"])
                for v in port["violations"]] == strip
        assert (ref["tool"], port["tool"]) == ("repro-lint",
                                               "repro-torch-lint")


# ----------------------------------------------------------------------
# The registry, the CLI and the port's own baseline.
# ----------------------------------------------------------------------
class TestCliAndBaseline:
    def test_registry_families(self):
        """SYNC, KERN1xx, DEAD and FAULT; no TRACE (nothing in the port
        is traced, so the family has no subject)."""
        assert sorted(RULES) == ["DEAD001", "FAULT001", "KERN101",
                                 "KERN102", "KERN103", "SYNC001", "SYNC002"]
        assert not any(r.startswith("TRACE") for r in RULES)

    def test_port_is_error_clean(self):
        vs = lint_paths([os.path.join(ROOT, "src", "repro_torch")],
                        root=ROOT)
        errors = [v for v in vs if v.severity == "error"]
        assert errors == [], "\n".join(v.format() for v in errors)

    def test_kern101_sees_the_real_sources(self):
        """The baseline is not vacuous: the CUDA sources are among the
        inputs, and a planted mismatch there is found from disk."""
        vs = lint_paths([os.path.join(ROOT, "src", "repro_torch",
                                      "kernels")], root=ROOT,
                        select=("KERN101",))
        assert vs == []
        csrc = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
        assert sorted(f for f in os.listdir(csrc) if f.endswith(".cu"))

    def test_cli_json_schema(self, capsys):
        code = lint_main([os.path.join(ROOT, "src", "repro_torch"),
                          "--format=json", "--root", ROOT])
        payload = json.loads(capsys.readouterr().out)
        assert code == 0
        assert payload["tool"] == "repro-torch-lint"
        assert payload["schema_version"] == 1
        assert payload["counts"]["error"] == 0
        for v in payload["violations"]:
            assert set(v) == {"rule", "severity", "path", "line", "col",
                              "message"}

    def test_cli_exit_code_on_error(self, tmp_path, capsys):
        d = tmp_path / "src" / "repro_torch" / "core"
        d.mkdir(parents=True)
        (d / "executor.py").write_text(textwrap.dedent("""\
            import torch

            def f():
                return torch.zeros(4).item()
            """))
        code = lint_main([str(d / "executor.py"), "--root", str(tmp_path)])
        out = capsys.readouterr().out
        assert code == 1 and "SYNC001" in out

    def test_cli_rules_listing(self, capsys):
        assert lint_main(["--rules"]) == 0
        out = capsys.readouterr().out
        assert "KERN101" in out and "TRACE" not in out

    def test_select_and_ignore_filters(self):
        src = textwrap.dedent("""\
            import torch

            def f():
                out = torch.zeros(4)
                return out.item(), list(out)
            """)
        both = lint_sources([(SYNC_PATH, src)])
        assert {v.rule for v in both} >= {"SYNC001", "SYNC002"}
        assert {v.rule for v in lint_sources([(SYNC_PATH, src)],
                                             select=("SYNC001",))} == {
            "SYNC001"}
        assert "SYNC001" not in {v.rule for v in lint_sources(
            [(SYNC_PATH, src)], ignore=("SYNC001",))}

    def test_summarize(self):
        counts = summarize(lint_paths([os.path.join(ROOT, "src",
                                                    "repro_torch")],
                                      root=ROOT))
        assert counts["error"] == 0 and counts["warn"] >= 0

    def test_config_overrides(self):
        cfg = LintConfig(sync_modules=("repro_torch/core/index.py",))
        src = """\
            import torch

            def f():
                return torch.zeros(4).item()
            """
        vs = lint_sources([("src/repro_torch/core/index.py",
                            textwrap.dedent(src))], config=cfg,
                          select=("SYNC001",))
        assert [v.rule for v in vs] == ["SYNC001"]
