"""SYNC rules: host↔device sync discipline on the pipelined dispatch path.

The engine's §5 batching claim — O(1) host round-trips per dispatch group
(``ExecStats.num_syncs`` ≤ 2) — dies the moment someone reads a device
value mid-phase-A: ``.item()``, ``.cpu()``, ``.numpy()``, ``.tolist()``,
``int()``/``float()``, ``np.asarray``, a data-dependent ATen op
(``nonzero``, ``masked_select``, ``unique``), a ``.to("cpu")`` or a
``torch.cuda.synchronize()`` all block until the card catches up, turning
the asynchronous pipeline back into a per-batch sync loop without changing
a single test result.  A read of ``Dispatch.out`` is worse on the card:
its pinned host tensors are filled by copies enqueued with
``non_blocking=True``, so a read before the fence does not wait at all —
it returns stale bytes.  These rules make both a *static* error on the
configured dispatch modules.

A host materialization of a device-tainted value is allowed only when:

* it is lexically **after** a sanctioned sync in the same function — a
  fence's ``.wait()`` or a ``torch.cuda.Event``'s ``.synchronize()`` (the
  executors' phase B), or
* its line carries a ``# lint: sync-point`` annotation (an explicit,
  audited sync), or
* it lives in one of the dispatcher-protocol *post-sync* methods
  (``count`` / ``marshal`` / ``tile_stats`` / ``retry_capacity``), which
  the executor contract only invokes after waiting on the group's fence.

The ids are the reference linter's, so one ``# lint: ignore[SYNC001]`` or
``# lint: sync-point`` comment serves both linters.
"""
from __future__ import annotations

import ast

from repro_torch.lint import astutils
from repro_torch.lint.astutils import (MATERIALIZER_BUILTINS,
                                       MATERIALIZER_METHODS,
                                       MATERIALIZER_NP_FUNCS, SYNCING_ATEN,
                                       TaintEnv)
from repro_torch.lint.rules import ERROR, Violation, rule


def _cpu_target(call: ast.Call) -> bool:
    """Does a ``.to(...)`` call name the CPU (``"cpu"``, ``"cpu:0"``,
    ``torch.device("cpu")``, positionally or as ``device=``)?"""
    def is_cpu(node) -> bool:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value.split(":")[0] == "cpu"
        if isinstance(node, ast.Call) and astutils.call_name(node) == \
                "device" and node.args:
            return is_cpu(node.args[0])
        return False
    cands = list(call.args[:1])
    dev = astutils.kwarg(call, "device")
    if dev is not None:
        cands.append(dev)
    return any(is_cpu(c) for c in cands)


def _materializations(expr, env: TaintEnv):
    """Yield (node, rule_id, description) for device→host transfers inside
    one expression tree (nested function bodies excluded)."""
    skip: set = set()
    for node in ast.walk(expr):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and node is not expr:
            for sub in ast.walk(node):
                skip.add(id(sub))
    for node in ast.walk(expr):
        if id(node) in skip:
            continue
        if isinstance(node, ast.Call):
            name = astutils.call_name(node)
            root = astutils.call_root(node)
            func = node.func
            if (root in ("np", "numpy") and name in MATERIALIZER_NP_FUNCS
                    and node.args and env.tainted(node.args[0])):
                yield node, "SYNC001", f"np.{name}() on a device value"
            elif (isinstance(func, ast.Name)
                    and func.id in MATERIALIZER_BUILTINS
                    and node.args and env.tainted(node.args[0])):
                yield node, "SYNC001", f"{func.id}() on a device value"
            elif (isinstance(func, ast.Attribute)
                    and func.attr in MATERIALIZER_METHODS
                    and env.tainted(func.value)):
                yield node, "SYNC001", f".{func.attr}() on a device value"
            elif (isinstance(func, ast.Attribute) and func.attr == "to"
                    and _cpu_target(node) and env.tainted(func.value)):
                yield node, "SYNC001", ".to() the CPU of a device value"
            elif name in SYNCING_ATEN and (
                    (root == "torch" and node.args
                     and env.tainted(node.args[0]))
                    or (root != "torch" and isinstance(func, ast.Attribute)
                        and env.tainted(func.value))):
                yield node, "SYNC001", (f"{name}() on a device value (its "
                                        "output size is read on the host)")
            elif astutils.dotted(func) == "torch.cuda.synchronize":
                yield node, "SYNC001", "torch.cuda.synchronize()"
            elif (isinstance(func, ast.Name) and func.id in ("list", "tuple")
                    and node.args and env.tainted(node.args[0])):
                yield node, "SYNC002", (f"{func.id}() materializes a device "
                                        "tensor element-wise")
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for gen in node.generators:
                if env.tainted(gen.iter):
                    yield node, "SYNC002", "comprehension over a device tensor"


def _has_sync_call(stmt, env: TaintEnv) -> bool:
    for n in ast.walk(stmt):
        if isinstance(n, ast.Call) and (
                env.syncs.wait_kind(n) == "fence"
                or env.syncs.is_event_sync(n)):
            return True
    return False


class _FunctionScan:
    """Lexical single pass over one function: taint + sync state."""

    def __init__(self, ctx, cfg, func, syncs, report):
        self.ctx = ctx
        self.cfg = cfg
        self.report = report
        self.env = TaintEnv(cfg.device_calls, cfg.device_attrs, syncs)
        self.synced = False
        for stmt in func.body:
            self.visit(stmt)

    def _check_expr(self, expr, anchor_line: int) -> None:
        if expr is None or self.synced:
            return
        for node, rule_id, what in _materializations(expr, self.env):
            line = getattr(node, "lineno", anchor_line)
            if line in self.ctx.sync_points:
                continue
            self.report(rule_id, line, getattr(node, "col_offset", 0),
                        f"{what} before the dispatch group's fence wait — "
                        "an implicit host sync (or, on a staged host copy, "
                        "an unfenced read) on the pipelined path (annotate "
                        "'# lint: sync-point' if this sync is deliberate)")

    def _walrus(self, expr) -> None:
        for node in ast.walk(expr):
            if isinstance(node, ast.NamedExpr):
                self.env.assign(node.target, self.env.tainted(node.value))

    def visit(self, stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return                       # analyzed as their own functions
        # Compound statements: check only their header expressions here —
        # body statements recurse below, so the sync state they see is the
        # one in effect at *their* position, not at the block's entry.
        if isinstance(stmt, ast.For):
            self._check_expr(stmt.iter, stmt.lineno)
            if not self.synced and self.env.tainted(stmt.iter) \
                    and stmt.lineno not in self.ctx.sync_points:
                self.report("SYNC002", stmt.lineno, stmt.col_offset,
                            "iteration over a device tensor before the "
                            "dispatch group's fence wait — an implicit "
                            "host sync on the pipelined path")
            self._walrus(stmt.iter)
            self.env.assign(stmt.target, self.env.tainted(stmt.iter))
            for s in stmt.body + stmt.orelse:
                self.visit(s)
            return
        if isinstance(stmt, (ast.While, ast.If)):
            self._check_expr(stmt.test, stmt.lineno)
            self._walrus(stmt.test)
            for s in stmt.body + stmt.orelse:
                self.visit(s)
            return
        if isinstance(stmt, ast.With):
            for item in stmt.items:
                self._check_expr(item.context_expr, stmt.lineno)
                self._walrus(item.context_expr)
                if item.optional_vars is not None:
                    self.env.assign(item.optional_vars,
                                    self.env.tainted(item.context_expr))
            for s in stmt.body:
                self.visit(s)
            return
        if isinstance(stmt, ast.Try):
            for s in (stmt.body + [h for handler in stmt.handlers
                                   for h in handler.body]
                      + stmt.orelse + stmt.finalbody):
                self.visit(s)
            return
        # Simple statements: full expression scan, then state updates.
        self._check_expr(stmt, stmt.lineno)
        if _has_sync_call(stmt, self.env) \
                or stmt.lineno in self.ctx.sync_points:
            self.synced = True
        if isinstance(stmt, ast.Assign):
            tainted = self.env.tainted(stmt.value)
            for target in stmt.targets:
                self.env.assign(target, tainted)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            self.env.assign(stmt.target, self.env.tainted(stmt.value))
        elif isinstance(stmt, ast.AugAssign):
            if self.env.tainted(stmt.value):
                self.env.assign(stmt.target, True)
        self._walrus(stmt)


def _scan_file(ctx, cfg, rule_id):
    if not ctx.matches(cfg.sync_modules):
        return []
    syncs = astutils.sync_names(ctx.tree)
    out: list[Violation] = []

    for func, qualname in astutils.iter_functions(ctx.tree):
        short = qualname.rsplit(".", 1)[-1]
        if short in cfg.post_sync_functions:
            # dispatcher post-sync protocol method: reads are post-sync by
            # the executor contract (BatchDispatcher docstring)
            continue

        def report(rid, line, col, message, _q=qualname):
            if rid != rule_id:
                return
            if ctx.is_suppressed(rid, line):
                return
            out.append(Violation(rid, ERROR, ctx.path, line, col,
                                 f"in {_q}: {message}"))

        _FunctionScan(ctx, cfg, func, syncs, report)
    return out


@rule("SYNC001", ERROR,
      "implicit device→host materialization before the group's fence wait")
def check_sync001(ctx, cfg):
    return _scan_file(ctx, cfg, "SYNC001")


@rule("SYNC002", ERROR,
      "element-wise iteration over a device tensor on the dispatch path")
def check_sync002(ctx, cfg):
    return _scan_file(ctx, cfg, "SYNC002")
