"""Rule registry for ``repro_torch.lint``.

A rule is a pure function from a parsed file (or, for project-level rules,
the whole file set) to :class:`Violation` rows.  Rules register themselves
into :data:`RULES` at import time; the runner (``repro_torch.lint``) filters
by select/ignore and per-line suppressions, so rule code never needs to
know about either.

The port's families are SYNC, KERN (the ctypes launch contract, ids
KERN101–103), DEAD and FAULT.  The reference's TRACE family has no
subject here: nothing in the port is traced or compiled into a graph.

Severity is two-tiered:

* ``error`` — breaks an invariant the engine's correctness or its §5
  O(1)-sync performance claim rests on; CI fails on any of these.
* ``warn``  — advisory (heuristic reachability, budget estimates); shown,
  counted, never fatal.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

ERROR = "error"
WARN = "warn"


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding: rule id, severity, location and message."""

    rule: str
    severity: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.severity[0].upper()}:{self.rule} {self.message}")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Rule:
    """Registry entry: id, default severity, one-line summary, checker.

    ``check(ctx, cfg)`` receives a ``repro_torch.lint.astutils.FileContext``
    for per-file rules; project-level rules (``project=True``) instead
    receive every file once per run: the ``FileContext`` list followed by
    the ``CSource`` list.
    """

    id: str
    severity: str
    summary: str
    check: Callable[..., Iterable[Violation]]
    project: bool = False


RULES: dict[str, Rule] = {}


def register(rule: Rule) -> Rule:
    if rule.id in RULES:
        raise ValueError(f"duplicate rule id {rule.id!r}")
    RULES[rule.id] = rule
    return rule


def rule(id: str, severity: str, summary: str, *, project: bool = False):
    """Decorator: ``@rule("SYNC001", ERROR, "...")`` over a check function."""
    def deco(fn):
        register(Rule(id, severity, summary, fn, project=project))
        return fn
    return deco


# Importing the family modules populates RULES (import order fixes the
# default report order within one line).
from repro_torch.lint.rules import sync    # noqa: E402,F401
from repro_torch.lint.rules import kern    # noqa: E402,F401
from repro_torch.lint.rules import dead    # noqa: E402,F401
from repro_torch.lint.rules import fault   # noqa: E402,F401

__all__ = ["ERROR", "WARN", "RULES", "Rule", "Violation", "register", "rule"]
