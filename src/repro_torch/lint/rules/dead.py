"""DEAD001: import-graph reachability from the public surfaces.

A module under ``src/repro_torch`` that no chain of imports connects to
the public API (``repro_torch.api``), the serving tier
(``repro_torch.serve``), the tests or the benchmarks is dead freight: it
rots silently (nothing exercises it), pins stale idioms, and misleads
readers about what the system actually uses.  This rule builds the
static import graph over the linted ``repro_torch`` modules, seeds it
with the configured roots plus every ``repro_torch`` module imported
from the files under ``dead_root_dirs`` (``tests/``, ``benchmarks/`` —
parsed fresh from disk, they need not be linted themselves), and reports
every unreachable module file.

Heuristic by nature (``importlib``-style dynamic imports are invisible),
hence **warn** severity — act on it deliberately rather than letting CI
delete code for you.
"""
from __future__ import annotations

import ast
import os

from repro_torch.lint.rules import WARN, Violation, rule

#: the package whose modules this rule reports
PACKAGE = "repro_torch"


def module_name(path: str) -> str | None:
    """Dotted ``repro_torch.*`` module name of a source path, if it has
    one."""
    parts = path.replace("\\", "/").split("/")
    if PACKAGE not in parts:
        return None
    idx = parts.index(PACKAGE)
    mods = parts[idx:]
    if not mods[-1].endswith(".py"):
        return None
    mods[-1] = mods[-1][:-3]
    if mods[-1] == "__init__":
        mods = mods[:-1]
    return ".".join(mods)


def _imports_of(tree: ast.Module, importer: str | None) -> set:
    """Absolute module names imported by a parsed file (``repro_torch.*``
    only; relative imports resolved against the importer's package)."""
    out: set = set()
    pkg_parts = importer.split(".")[:-1] if importer else []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                out.add(alias.name)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                base = node.module or ""
            else:
                anchor = pkg_parts[:len(pkg_parts) - (node.level - 1)]
                base = ".".join(anchor + ([node.module] if node.module
                                          else []))
            if base:
                out.add(base)
            for alias in node.names:
                if base:
                    out.add(f"{base}.{alias.name}")
    return {m for m in out if m == PACKAGE or m.startswith(PACKAGE + ".")}


def _ancestors(mod: str):
    parts = mod.split(".")
    for i in range(1, len(parts) + 1):
        yield ".".join(parts[:i])


@rule("DEAD001", WARN,
      "module unreachable from repro_torch.api / repro_torch.serve / tests / "
      "benchmarks",
      project=True)
def check_dead001(ctxs, cfg, root=None):
    modules: dict[str, object] = {}
    for ctx in ctxs:
        mod = module_name(ctx.path)
        if mod is not None:
            modules[mod] = ctx
    if not modules:
        return []

    edges: dict[str, set] = {}
    for mod, ctx in modules.items():
        edges[mod] = _imports_of(ctx.tree, mod)

    roots: set = set(cfg.dead_roots)
    root = root or os.getcwd()
    for dirname in cfg.dead_root_dirs:
        base = os.path.join(root, dirname)
        if not os.path.isdir(base):
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames if not d.startswith((".",
                           "__pycache__"))]
            for fname in filenames:
                if not fname.endswith(".py"):
                    continue
                try:
                    with open(os.path.join(dirpath, fname),
                              encoding="utf-8") as fh:
                        tree = ast.parse(fh.read())
                except (OSError, SyntaxError):
                    continue
                roots |= _imports_of(tree, None)

    # BFS; importing a module also imports (and so reaches) every ancestor
    # package, whose __init__ imports count as edges too.
    reachable: set = set()
    frontier = [m for r in roots for m in _ancestors(r)]
    while frontier:
        mod = frontier.pop()
        if mod in reachable:
            continue
        reachable.add(mod)
        for dep in edges.get(mod, ()):
            for anc in _ancestors(dep):
                if anc not in reachable:
                    frontier.append(anc)

    out: list[Violation] = []
    for mod in sorted(modules):
        if mod in reachable or mod in cfg.dead_ignore:
            continue
        ctx = modules[mod]
        if ctx.is_suppressed("DEAD001", 1):
            continue
        out.append(Violation(
            "DEAD001", WARN, ctx.path, 1, 0,
            f"module {mod} is unreachable from the import roots "
            f"({', '.join(sorted(cfg.dead_roots))} + {'/'.join(cfg.dead_root_dirs)}) "
            "— delete it, quarantine it, or add a real import path"))
    return out
