"""CLI for ``repro_torch.lint``: ``python -m repro_torch.lint [paths]
[options]``.

Exit status is 1 iff any **error**-severity violation survives
select/ignore filtering and per-line suppressions — warnings are reported
(and counted in the JSON) but never fatal, so the advisory DEAD001
cannot block CI by itself.  The JSON schema is the reference linter's,
under the tool name ``repro-torch-lint``.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.lint import RULES, lint_paths, summarize

_JSON_SCHEMA_VERSION = 1


def _split_ids(values) -> tuple:
    out = []
    for value in values or ():
        out.extend(p.strip() for p in value.split(",") if p.strip())
    return tuple(out)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="Invariant-aware static analysis of the PyTorch/CUDA "
                    "port: sync discipline, the ctypes launch contract, "
                    "import-graph reachability, fault-hook guards.")
    parser.add_argument("paths", nargs="*", default=["src/repro_torch"],
                        help="files or directories to lint "
                             "(default: src/repro_torch)")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text", help="output format")
    parser.add_argument("--select", action="append", metavar="RULE[,RULE]",
                        help="only run these rule ids")
    parser.add_argument("--ignore", action="append", metavar="RULE[,RULE]",
                        help="skip these rule ids")
    parser.add_argument("--root", default=None,
                        help="project root (DEAD001's test/benchmark "
                             "roots); default: cwd")
    parser.add_argument("--rules", action="store_true",
                        help="list registered rules and exit")
    args = parser.parse_args(argv)

    if args.rules:
        for rule in sorted(RULES.values(), key=lambda r: r.id):
            print(f"{rule.id:9s} {rule.severity:5s} {rule.summary}")
        return 0

    violations = lint_paths(args.paths,
                            select=_split_ids(args.select),
                            ignore=_split_ids(args.ignore), root=args.root)
    counts = summarize(violations)

    if args.format == "json":
        print(json.dumps({
            "tool": "repro-torch-lint",
            "schema_version": _JSON_SCHEMA_VERSION,
            "paths": list(args.paths),
            "counts": counts,
            "violations": [v.to_json() for v in violations],
        }, indent=2))
    else:
        for v in violations:
            print(v.format())
        total = counts["error"] + counts["warn"]
        print(f"{total} violation(s): {counts['error']} error(s), "
              f"{counts['warn']} warning(s)")
    return 1 if counts["error"] else 0


if __name__ == "__main__":
    sys.exit(main())
