"""Configuration for ``repro_torch.lint``: the defaults, over the port's
paths.  They live in code; a caller that needs other scopes (the tests
do) passes its own :class:`LintConfig`.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LintConfig:
    """Knobs for the rule families."""

    #: rule-id filters applied before per-line suppressions
    select: tuple = ()
    ignore: tuple = ()

    #: files (repo-relative suffixes) on the pipelined dispatch path —
    #: the §5 O(1)-sync discipline (SYNC001/002) is enforced only here.
    #: ``kernels/ops.py`` builds every dispatch's inputs.
    sync_modules: tuple = (
        "repro_torch/core/executor.py",
        "repro_torch/core/engine.py",
        "repro_torch/core/distributed.py",
        "repro_torch/core/scheduler.py",
        "repro_torch/serve/broker.py",
        "repro_torch/kernels/ops.py",
    )
    #: dispatcher-protocol methods the executor only calls *after* waiting
    #: on the group's fence (see ``repro_torch.core.executor.
    #: BatchDispatcher``) — host reads inside them are post-sync by contract
    post_sync_functions: tuple = (
        "count", "marshal", "tile_stats", "retry_capacity",
    )
    #: call names whose results are device values (taint roots beyond the
    #: ``torch.``/``ref.`` namespaces); ``submit`` covers the scheduler's
    #: and the broker's futures and tickets, handles to device-bound work
    #: whose ``.result()`` blocks
    device_calls: tuple = (
        "query_block", "dispatch", "redispatch", "to_device",
        "distthresh_dense", "distthresh_compact", "distthresh_compact_live",
        "flashattn", "submit",
    )
    #: attribute names that hold device values (``Dispatch.out``: pinned
    #: host tensors whose copies complete only behind the group's fence)
    device_attrs: tuple = ("out",)

    #: the kernel wrappers whose ctypes calls KERN102/KERN103 check
    kern_modules: tuple = (
        "repro_torch/kernels/distthresh.py",
        "repro_torch/kernels/flashattn.py",
    )
    #: the module holding ``SIGNATURES``, the C interface's argtypes
    kern_build_module: str = "repro_torch/kernels/_build.py"
    #: the directory of the CUDA sources whose ``extern "C"`` prototypes
    #: KERN101 holds against ``SIGNATURES``
    kern_csrc: str = "repro_torch/kernels/csrc/"

    #: import-graph roots for DEAD001 (module names, plus every module
    #: imported from the files under ``dead_root_dirs``)
    dead_roots: tuple = ("repro_torch.api", "repro_torch.serve")
    dead_root_dirs: tuple = ("tests", "benchmarks")
    #: modules never reported (e.g. kept deliberately as examples)
    dead_ignore: tuple = ()
