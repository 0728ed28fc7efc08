"""KERN rules: the ctypes launch contract of the hand-written CUDA kernels.

The port has no Pallas BlockSpecs, grids or ``pl.when`` (the reference's
KERN001–006).  Its kernels are ``extern "C"`` functions in
``kernels/csrc/*.cu``, compiled into one library and called through
``ctypes`` with the argtypes of ``kernels/_build.py``'s ``SIGNATURES``.
Nothing checks that contract at run time: a parameter dropped, added or
given the wrong kind shifts every later argument, and the kernel reads
and writes memory it was never given, silently, on the card.  These rules
re-derive the contract from the sources, under ids of their own so none
reads as the Pallas rule of the same number:

* ``KERN101`` (error) — every name in ``SIGNATURES`` is an ``extern
  "C"`` function with the same parameter count and kinds (a pointer is
  ``_P``, ``int`` ``_I``, ``long long`` ``_L``, ``float`` ``_F``,
  ``double`` ``_D``), and
  every ``extern "C"`` ``*_launch`` has a ``SIGNATURES`` entry.  Prototypes are
  read with a small regex over the ``extern "C"`` blocks; a prototype
  that does not parse is skipped, never guessed.
* ``KERN102`` (error) — every call of a library function in the kernel
  wrappers passes ``len(SIGNATURES[name])`` positional arguments:
  ``_build.load().NAME(...)``, ``lib.NAME(...)`` for ``lib =
  _build.load()``, ``launch = lib.A if c else lib.B; launch(...)`` and
  ``getattr(_build.load(), name + "_launch")(...)``.
* ``KERN103`` (error) — the integer a ``*_launch`` call returns (its
  ``cudaError_t``) goes to ``_launch.raise_on`` before the wrapper
  returns: a refused launch never runs, and no later synchronize reports
  it.

Resolution is *candidate-based*: conditional names (``a if c else b``,
re-binding) give several candidates, each checked; a call whose target,
or whose starred argument's length, does not resolve is skipped.
"""
from __future__ import annotations

import ast
import re

from repro_torch.lint import astutils
from repro_torch.lint.astutils import CSource, FileContext, SymbolEnv
from repro_torch.lint.rules import ERROR, Violation, rule

#: ctypes type → the kind letter KERN101 compares
_CTYPES_KINDS = {"c_void_p": "P", "c_int": "I", "c_longlong": "L",
                 "c_float": "F", "c_double": "D"}
#: C scalar types (qualifiers dropped) → kind letter
_C_KINDS = {"int": "I", "long long": "L", "float": "F", "double": "D"}
_C_QUALIFIERS = ("const", "volatile", "__restrict__", "restrict")


# ----------------------------------------------------------------------
# SIGNATURES (Python side).
# ----------------------------------------------------------------------
def _kind_aliases(tree: ast.Module) -> dict:
    """Module names bound to ctypes types: ``_P, _I = ctypes.c_void_p,
    ctypes.c_int`` → ``{"_P": "P", "_I": "I"}``."""
    out = {}

    def kind(node):
        name = node.attr if isinstance(node, ast.Attribute) else (
            node.id if isinstance(node, ast.Name) else None)
        return _CTYPES_KINDS.get(name)

    for node in tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        target = node.targets[0]
        if isinstance(target, ast.Name) and kind(node.value):
            out[target.id] = kind(node.value)
        elif isinstance(target, ast.Tuple) and isinstance(node.value,
                                                           ast.Tuple):
            for t, v in zip(target.elts, node.value.elts):
                if isinstance(t, ast.Name) and kind(v):
                    out[t.id] = kind(v)
    return out


def signatures(ctx: FileContext) -> dict:
    """``SIGNATURES`` of a ``_build.py`` as ``{name: (kinds, line)}``:
    the dict literal, then ``SIGNATURES["x"] = ...`` stores in module
    order.  An entry whose value does not evaluate is left out."""
    kinds = _kind_aliases(ctx.tree)
    table: dict = {}

    def evaluate(node):
        if isinstance(node, ast.Tuple):
            out = []
            for elt in node.elts:
                if not isinstance(elt, ast.Name) or elt.id not in kinds:
                    return None
                out.append(kinds[elt.id])
            return tuple(out)
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
            seq, n = node.left, node.right
            if isinstance(seq, ast.Constant):
                seq, n = n, seq
            base = evaluate(seq)
            if base is None or not isinstance(n, ast.Constant) \
                    or not isinstance(n.value, int):
                return None
            return base * n.value
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            left, right = evaluate(node.left), evaluate(node.right)
            return None if left is None or right is None else left + right
        if _is_signatures_item(node):
            entry = table.get(node.slice.value)
            return None if entry is None else entry[0]
        return None

    for node in ctx.tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        target = node.targets[0]
        if isinstance(target, ast.Name) and target.id == "SIGNATURES" \
                and isinstance(node.value, ast.Dict):
            for k, v in zip(node.value.keys, node.value.values):
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    val = evaluate(v)
                    if val is not None:
                        table[k.value] = (val, k.lineno)
        elif _is_signatures_item(target):
            val = evaluate(node.value)
            if val is not None:
                table[target.slice.value] = (val, node.lineno)
    return table


def _is_signatures_item(node) -> bool:
    return (isinstance(node, ast.Subscript)
            and isinstance(node.value, ast.Name)
            and node.value.id == "SIGNATURES"
            and isinstance(node.slice, ast.Constant)
            and isinstance(node.slice.value, str))


def _signatures_line(ctx: FileContext) -> int:
    for node in ctx.tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "SIGNATURES"
                for t in node.targets):
            return node.lineno
    return 1


# ----------------------------------------------------------------------
# extern "C" prototypes (CUDA side).
# ----------------------------------------------------------------------
_COMMENT_RE = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_PROTO_RE = re.compile(
    r"(?:[A-Za-z_][\w:<>]*[\s*&]+)+?"
    r"(?P<name>[A-Za-z_]\w*)\s*\((?P<params>[^()]*)\)\s*[{;]")


def _blank(text: str, start: int, end: int) -> str:
    """``text[start:end]`` with the bodies of nested braces blanked
    (newlines kept, so offsets still map to lines): what is left is the
    region's top level, its function heads."""
    out, depth = [], 0
    for ch in text[start:end]:
        if ch == "}":
            depth -= 1
        out.append(ch if depth == 0 or ch == "\n" else " ")
        if ch == "{":
            depth += 1
    return "".join(out)


def _param_kind(param: str) -> str | None:
    if "*" in param:
        return "P"
    words = [w for w in re.findall(r"[A-Za-z_]\w*", param)
             if w not in _C_QUALIFIERS]
    if len(words) < 2:
        return None                 # a type without a name: not ours
    return _C_KINDS.get(" ".join(words[:-1]))


def _prototype(m) -> tuple | None:
    params = [p.strip() for p in m.group("params").split(",") if p.strip()]
    if params == ["void"]:
        params = []
    kinds = [_param_kind(p) for p in params]
    return None if None in kinds else tuple(kinds)


def extern_functions(src: CSource) -> dict:
    """Every ``extern "C"`` function of one CUDA source, defined or
    declared in a braced ``extern "C" { ... }`` block or after a bare
    ``extern "C"``: ``{name: (kinds or None, line)}``, kinds None when a
    parameter's type is not one KERN101 knows."""
    text = _COMMENT_RE.sub(lambda m: re.sub(r"[^\n]", " ", m.group(0)),
                           src.source)
    out: dict = {}
    for m in re.finditer(r'extern\s+"C"\s*', text):
        start = m.end()
        if text.startswith("{", start):
            depth, end = 0, len(text)
            for j in range(start, len(text)):
                depth += {"{": 1, "}": -1}.get(text[j], 0)
                if depth == 0:
                    end = j
                    break
            region = _blank(text, start + 1, end)
            heads = [(pm, start + 1) for pm in _PROTO_RE.finditer(region)]
        else:
            pm = _PROTO_RE.match(text, start)
            heads = [(pm, 0)] if pm is not None else []
        for pm, offset in heads:
            line = text.count("\n", 0, offset + pm.start("name")) + 1
            out.setdefault(pm.group("name"), (_prototype(pm), line))
    return out


# ----------------------------------------------------------------------
# KERN101: SIGNATURES against the extern "C" prototypes.
# ----------------------------------------------------------------------
def _split_inputs(files, cfg):
    """The ``_build.py`` context and the kernel sources among the files."""
    build, csrc = None, []
    for f in files:
        if isinstance(f, CSource):
            if cfg.kern_csrc in f.path.replace("\\", "/"):
                csrc.append(f)
        elif f.matches((cfg.kern_build_module,)):
            build = f
    return build, csrc


_KIND_NAMES = {"P": "pointer", "I": "int", "L": "long long", "F": "float",
               "D": "double"}


def _fmt(kinds) -> str:
    return "(" + ", ".join(_KIND_NAMES[k] for k in kinds) + ")"


@rule("KERN101", ERROR,
      "SIGNATURES argtypes differ from the extern \"C\" prototype",
      project=True)
def check_kern101(files, cfg, root=None):
    build, csrc = _split_inputs(files, cfg)
    if build is None or not csrc:
        return []
    sigs = signatures(build)
    protos: dict = {}
    for src in csrc:
        for name, (kinds, line) in extern_functions(src).items():
            protos[name] = (kinds, f"{src.path}:{line}")
    out: list[Violation] = []

    def report(line, message):
        if not build.is_suppressed("KERN101", line):
            out.append(Violation("KERN101", ERROR, build.path, line, 0,
                                 message))

    for name, (kinds, line) in sorted(sigs.items()):
        if name not in protos:
            report(line, f"SIGNATURES[{name!r}] names no extern \"C\" "
                         "function of the CUDA sources")
            continue
        c_kinds, where = protos[name]
        if c_kinds is None:
            continue                    # unparsable prototype: skipped
        if c_kinds != kinds:
            report(line, f"SIGNATURES[{name!r}] is {_fmt(kinds)} "
                         f"({len(kinds)} arguments) but {where} declares "
                         f"{_fmt(c_kinds)} ({len(c_kinds)}): ctypes would "
                         "pass every later argument in the wrong slot")
    sig_line = _signatures_line(build)
    for name, (_, where) in sorted(protos.items()):
        if name.endswith("_launch") and name not in sigs:
            report(sig_line, f"extern \"C\" {name} ({where}) has no "
                             "SIGNATURES entry: the library loads it "
                             "without argtypes")
    return out


# ----------------------------------------------------------------------
# KERN102 / KERN103: the wrappers' library calls.
# ----------------------------------------------------------------------
def _is_load_call(node) -> bool:
    return (isinstance(node, ast.Call) and astutils.call_name(node) == "load"
            and astutils.call_root(node) == "_build")


def _lib_value(node, env: SymbolEnv) -> bool:
    """Is ``node`` the loaded library (``_build.load()`` or a name bound
    to it)?"""
    if _is_load_call(node):
        return True
    if isinstance(node, ast.Name):
        cands = env.candidates(node)
        return bool(cands) and all(_is_load_call(c) for c in cands)
    return False


def _targets(func, env: SymbolEnv) -> list | None:
    """Library function names a call target may be, or None when it is
    not a library call (or does not resolve)."""
    if isinstance(func, ast.Attribute):
        return [func.attr] if _lib_value(func.value, env) else None
    if isinstance(func, ast.Call) and astutils.call_name(func) == "getattr" \
            and isinstance(func.func, ast.Name) and len(func.args) == 2 \
            and _lib_value(func.args[0], env):
        return env.strings(func.args[1])
    if isinstance(func, ast.Name):
        out = []
        for cand in env.candidates(func):
            names = _targets(cand, env)
            if names is None:
                return None
            out.extend(names)
        return out or None
    return None


def _raise_on_names(tree: ast.Module) -> set:
    names = {"raise_on"}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.endswith("kernels._launch"):
            for alias in node.names:
                if alias.name == "raise_on":
                    names.add(alias.asname or alias.name)
    return names


def _lib_calls(ctx, cfg):
    """Yield (func def, call, candidate names, env) for every library call
    of a kernel wrapper module."""
    if not ctx.matches(cfg.kern_modules):
        return
    for func, _ in astutils.iter_functions(ctx.tree):
        env = SymbolEnv(ctx.tree, func)
        for node in ast.walk(func):
            if isinstance(node, ast.Call):
                names = _targets(node.func, env)
                if names:
                    yield func, node, names, env


def _project_sigs(files, cfg) -> dict | None:
    build, _ = _split_inputs(files, cfg)
    return None if build is None else signatures(build)


@rule("KERN102", ERROR,
      "library call passes a different number of arguments than SIGNATURES",
      project=True)
def check_kern102(files, cfg, root=None):
    sigs = _project_sigs(files, cfg)
    if sigs is None:
        return []
    out: list[Violation] = []
    for ctx in files:
        if not isinstance(ctx, FileContext):
            continue
        for _, call, names, env in _lib_calls(ctx, cfg):
            n_args = 0
            for arg in call.args:
                if isinstance(arg, ast.Starred):
                    n = env.seq_len(arg.value)
                    if n is None:
                        n_args = None
                        break
                    n_args += n
                else:
                    n_args += 1
            if n_args is None:
                continue               # unresolvable star: skipped
            for name in names:
                if name not in sigs:
                    continue
                want = len(sigs[name][0])
                if (n_args != want or call.keywords) and \
                        not ctx.is_suppressed("KERN102", call.lineno):
                    kw = (f" and {len(call.keywords)} keyword(s), which "
                          "ctypes refuses" if call.keywords else "")
                    out.append(Violation(
                        "KERN102", ERROR, ctx.path, call.lineno,
                        call.col_offset,
                        f"{name} takes {want} arguments (SIGNATURES) but "
                        f"this call passes {n_args}{kw}"))
    return out


@rule("KERN103", ERROR,
      "a *_launch call's cudaError_t is not handed to _launch.raise_on",
      project=True)
def check_kern103(files, cfg, root=None):
    out: list[Violation] = []
    for ctx in files:
        if not isinstance(ctx, FileContext):
            continue
        checkers = _raise_on_names(ctx.tree)
        for func, call, names, _ in _lib_calls(ctx, cfg):
            if not any(n.endswith("_launch") for n in names):
                continue
            if _checked(func, call, checkers):
                continue
            if ctx.is_suppressed("KERN103", call.lineno):
                continue
            out.append(Violation(
                "KERN103", ERROR, ctx.path, call.lineno, call.col_offset,
                f"the cudaError_t of {'/'.join(names)} never reaches "
                "raise_on: a refused launch would pass silently (no later "
                "synchronize reports it)"))
    return out


def _is_check(node, checkers) -> bool:
    return (isinstance(node, ast.Call)
            and astutils.call_name(node) in checkers)


def _checked(func, call, checkers) -> bool:
    """Is ``call``'s result checked: passed straight to ``raise_on``, or
    bound to a name that a later statement of the same block hands to
    ``raise_on`` before any ``return``/``raise`` of that block?"""
    parents = {}
    for node in ast.walk(func):
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node
    parent = parents.get(id(call))
    if _is_check(parent, checkers) and parent.args and parent.args[0] is call:
        return True
    stmt = parent
    if not isinstance(stmt, ast.Assign) or stmt.value is not call \
            or len(stmt.targets) != 1 \
            or not isinstance(stmt.targets[0], ast.Name):
        return False
    var = stmt.targets[0].id
    block = parents.get(id(stmt))
    for field in ("body", "orelse", "finalbody"):
        body = getattr(block, field, None)
        if isinstance(body, list) and stmt in body:
            break
    else:
        return False
    for later in body[body.index(stmt) + 1:]:
        if isinstance(later, (ast.Return, ast.Raise)):
            return False
        if isinstance(later, ast.Expr) and _is_check(later.value, checkers) \
                and later.value.args \
                and isinstance(later.value.args[0], ast.Name) \
                and later.value.args[0].id == var:
            return True
    return False
