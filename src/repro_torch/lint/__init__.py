"""``repro_torch.lint`` — invariant-aware static analysis for the port.

The engine's §5 performance claim (O(1) host syncs per dispatch group) and
the ctypes contract between the kernel wrappers and the CUDA sources are
*invariants*, not emergent properties — so they are checked statically
instead of hoped-for at run time.  Four rule families (see
``repro_torch.lint.rules``):

==========  ========  =====================================================
rule        severity  checks
==========  ========  =====================================================
SYNC001     error     implicit device→host materialization (``.item()``,
                      ``.cpu()``, ``.numpy()``, ``.tolist()``,
                      ``int()``/``float()``, ``np.asarray``, ``nonzero``,
                      ``.to("cpu")``, ``torch.cuda.synchronize``) or a read
                      of ``Dispatch.out`` before the dispatch group's fence
                      wait on the pipelined path
SYNC002     error     element-wise iteration over a device tensor there
KERN101     error     every ``_build.SIGNATURES`` entry is an ``extern "C"``
                      prototype of ``kernels/csrc/*.cu`` with the same
                      argtypes, and every ``extern "C"`` ``*_launch`` has
                      an entry
KERN102     error     every library call in the kernel wrappers passes
                      ``len(SIGNATURES[name])`` positional arguments
KERN103     error     every ``*_launch`` result reaches ``_launch.raise_on``
DEAD001     warn      modules unreachable from repro_torch.api /
                      repro_torch.serve / tests / benchmarks
FAULT001    error     ``faults.inject``/``faults.corrupt`` call outside an
                      ``if faults.armed():`` guard
==========  ========  =====================================================

The reference's TRACE family is not ported: nothing in the port is traced
(no ``torch.compile``, ``torch.jit`` or graph capture), so it has no
subject.  The SYNC and FAULT ids and the suppression syntax are the
reference's, so one comment serves both linters: ``# lint:
ignore[RULE]`` (comma-separated ids or ``*``) on the offending line, or on
a ``def`` line to cover the whole function; ``# lint: sync-point`` marks a
line as a deliberate, audited host sync (it also makes every later read in
that function post-sync).

Use as a library (tests do)::

    from repro_torch.lint import lint_paths, lint_sources
    violations = lint_paths(["src/repro_torch"])       # files / dirs
    violations = lint_sources([(path, source_text)])   # in-memory

or as a tool: ``python -m repro_torch.lint [paths] [--format=json|text]
[--select RULE,...] [--ignore RULE,...]`` — exit code 1 iff any
error-severity violation survives filtering.  ``.cu`` files among the
inputs are read for KERN101, not parsed as Python.

``repro_torch.lint.sentinel`` is the runtime counterpart: it patches
torch's device→host transfer points to *count actual transfers* and lets
a run pin the measured number against ``ExecStats.num_syncs``.
"""
from __future__ import annotations

import os

from repro_torch.lint.astutils import CSource, FileContext
from repro_torch.lint.config import LintConfig
from repro_torch.lint.rules import ERROR, RULES, WARN, Rule, Violation

__all__ = [
    "ERROR", "WARN", "RULES", "Rule", "Violation", "LintConfig",
    "lint_paths", "lint_sources", "summarize",
]

_SKIP_DIRS = {"__pycache__", ".git", ".venv", "node_modules", ".claude"}
#: file suffixes the linter reads: Python sources, and the CUDA sources
#: whose ``extern "C"`` prototypes KERN101 checks
_SUFFIXES = (".py", ".cu")


def _expand(paths) -> list:
    files: list[str] = []
    for path in paths:
        if os.path.isdir(path):
            for dirpath, dirnames, filenames in os.walk(path):
                dirnames[:] = sorted(d for d in dirnames
                                     if d not in _SKIP_DIRS
                                     and not d.startswith("."))
                for fname in sorted(filenames):
                    if fname.endswith(_SUFFIXES):
                        files.append(os.path.join(dirpath, fname))
        elif path.endswith(_SUFFIXES):
            files.append(path)
    return files


def _rule_enabled(rule: Rule, cfg: LintConfig, select, ignore) -> bool:
    sel = tuple(select) if select else cfg.select
    ign = tuple(ignore) if ignore else cfg.ignore
    if sel and rule.id not in sel:
        return False
    if rule.id in ign:
        return False
    return True


def _run(ctxs, csrcs, cfg, select, ignore, root) -> list:
    violations: list[Violation] = []
    for rule in RULES.values():
        if not _rule_enabled(rule, cfg, select, ignore):
            continue
        if rule.project:
            violations.extend(rule.check(ctxs + csrcs, cfg, root))
        else:
            for ctx in ctxs:
                violations.extend(rule.check(ctx, cfg))
    violations.sort(key=lambda v: (v.path, v.line, v.col, v.rule))
    return violations


def lint_sources(items, *, config: LintConfig | None = None,
                 select=(), ignore=(), root: str | None = None) -> list:
    """Lint in-memory ``(path, source)`` pairs.

    ``path`` is only used for rule scoping (the SYNC/KERN families match
    on configured path suffixes) and for reporting — tests hand in real
    file contents under synthetic paths, or mutated copies of real files.
    A ``.cu`` path is kept as a CUDA source for KERN101.  Python files
    that fail to parse surface as an error-severity ``PARSE``
    pseudo-violation instead of raising.
    """
    cfg = config or LintConfig()
    ctxs, csrcs, violations = [], [], []
    for path, source in items:
        path = path.replace("\\", "/")
        if path.endswith(".cu"):
            csrcs.append(CSource(path, source))
            continue
        try:
            ctxs.append(FileContext.parse(path, source))
        except SyntaxError as exc:
            violations.append(Violation(
                "PARSE", ERROR, path, exc.lineno or 1, exc.offset or 0,
                f"syntax error: {exc.msg}"))
    violations.extend(_run(ctxs, csrcs, cfg, select, ignore,
                           root or os.getcwd()))
    return violations


def lint_paths(paths, *, config: LintConfig | None = None,
               select=(), ignore=(), root: str | None = None) -> list:
    """Lint files/directories on disk (the CLI entrypoint's engine);
    ``config`` defaults to :class:`LintConfig`'s defaults."""
    cfg = config or LintConfig()
    items = []
    for fname in _expand(paths):
        try:
            with open(fname, encoding="utf-8") as fh:
                items.append((os.path.relpath(fname, root or os.getcwd()),
                              fh.read()))
        except OSError:
            continue
    return lint_sources(items, config=cfg, select=select, ignore=ignore,
                        root=root)


def summarize(violations) -> dict:
    counts = {"error": 0, "warn": 0}
    for v in violations:
        counts[v.severity] = counts.get(v.severity, 0) + 1
    return counts
