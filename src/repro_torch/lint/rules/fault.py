"""FAULT rules: fault-injection hooks must be free when disarmed.

The port's fault-injection sites (``repro_torch.faults``) live on the
serving hot path — dispatchers, marshalling, the broker pump.  The
contract that keeps them free in production is lexical: every
``faults.inject(...)`` / ``faults.corrupt(...)`` call sits behind an
``if faults.armed():`` guard, so the disarmed cost is one function call
returning a cached ``False`` — no plan lookup, no context-dict
allocation (the ``**ctx`` kwargs of an unguarded call would be built even
with no plan armed).

FAULT001 makes that contract static: an ``inject``/``corrupt`` call (the
``faults.``-qualified form, or the bare names imported from
``repro_torch.faults``) whose enclosing statement chain contains no
``if`` (or conditional expression) testing ``armed()`` is an error.  The
``repro_torch.faults`` package itself is exempt — it *defines* the
wrappers.
"""
from __future__ import annotations

import ast

from repro_torch.lint import astutils
from repro_torch.lint.rules import ERROR, Violation, rule

_HOOKS = ("inject", "corrupt")


def _imported_hook_names(tree: ast.Module) -> set:
    """Bare names that alias repro_torch.faults hooks in this module."""
    names: set = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and \
                node.module == "repro_torch.faults":
            for alias in node.names:
                if alias.name in _HOOKS:
                    names.add(alias.asname or alias.name)
    return names


def _is_hook_call(node: ast.Call, bare_names: set) -> str | None:
    name = astutils.call_name(node)
    if name not in _HOOKS and name not in bare_names:
        return None
    func = node.func
    if isinstance(func, ast.Attribute):
        # faults.inject(...) / repro_torch.faults.corrupt(...) — accept any
        # dotted chain whose head segment is named "faults".
        root = astutils.call_root(node)
        if root == "faults" or (isinstance(func.value, ast.Attribute)
                                and func.value.attr == "faults"):
            return name
        return None
    if isinstance(func, ast.Name) and func.id in bare_names:
        return func.id
    return None


def _test_calls_armed(test: ast.expr) -> bool:
    return any(isinstance(n, ast.Call)
               and astutils.call_name(n) == "armed"
               for n in ast.walk(test))


@rule("FAULT001", ERROR,
      "fault-injection hook call outside an `if faults.armed():` guard")
def check_fault001(ctx, cfg):
    if "repro_torch/faults" in ctx.path:
        return []
    bare = _imported_hook_names(ctx.tree)
    parents: dict = {}
    for parent in ast.walk(ctx.tree):
        for child in ast.iter_child_nodes(parent):
            parents[id(child)] = parent
    out: list[Violation] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        hook = _is_hook_call(node, bare)
        if hook is None:
            continue
        guarded = False
        anc = node
        while anc is not None:
            anc = parents.get(id(anc))
            if isinstance(anc, ast.If) and _test_calls_armed(anc.test):
                guarded = True
                break
            if isinstance(anc, ast.IfExp) and _test_calls_armed(anc.test):
                guarded = True
                break
        if guarded or ctx.is_suppressed("FAULT001", node.lineno):
            continue
        out.append(Violation(
            "FAULT001", ERROR, ctx.path, node.lineno, node.col_offset,
            f"faults.{hook}() outside an `if faults.armed():` guard — "
            "the disarmed hot path must cost one cached-False check, "
            "not a context-dict build"))
    return out
