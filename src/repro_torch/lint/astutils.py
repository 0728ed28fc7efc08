"""Shared AST machinery for ``repro_torch.lint``: parsing, suppression
comments, the device-taint engine, the fence discovery the SYNC rules
need, and a small symbolic resolver for the launch-contract checks.

Taint model (SYNC rules)
------------------------
A value is *device-tainted* when it (transitively) comes from work
enqueued on the card: a ``torch.*`` call (apart from the host-metadata
calls in :data:`HOST_TORCH_CALLS`), a call into the port's plain oracle
(``ref.*``), a call to one of the configured ``device_calls`` (e.g.
``ops.query_block``, a dispatcher's ``dispatch``), an attribute named in
``device_attrs`` (``Dispatch.out`` — pinned host tensors that hold their
values only once a later fence has passed), or the result of
``concurrent.futures.wait`` (futures of device-bound group work).
Taint propagates through names, subscripts, arithmetic and attribute
access; it is dropped by metadata reads (``.shape``, ``.dtype``,
``.device``, ``.numel()``), identity comparisons (``x is None``) and by
the host materializers themselves (the result of ``x.item()`` is a host
value).

The engine is a deliberately simple lexical pass: statements are visited in
source order per function, which matches how the executors are written
(phase A dispatches first, phase B waits on a fence then reads).  Loops
are not fixpointed — a taint introduced on a later line does not flow back
to an earlier one — which keeps the rules predictable enough to annotate.

The sanctioned sync is the port's fence: ``Fence(...).wait()``, ``.wait()``
on a name bound to a ``Fence``, and ``.synchronize()`` on a
``torch.cuda.Event``.  ``wait`` is resolved by receiver: the
``concurrent.futures`` function is a taint root, a fence's method is the
sync, any other ``.wait()`` is neither.
"""
from __future__ import annotations

import ast
import dataclasses
import re

SUPPRESS_RE = re.compile(r"#\s*lint:\s*ignore\[([A-Za-z0-9_*,\s]+)\]")
SYNC_POINT_RE = re.compile(r"#\s*lint:\s*sync-point")

#: attribute reads that yield host metadata, never a device buffer
UNTAINT_ATTRS = frozenset({
    "shape", "ndim", "dtype", "device", "is_cuda", "layout", "itemsize",
    "nbytes", "requires_grad", "is_leaf",
})

#: tensor methods whose result is host metadata
HOST_METHODS = frozenset({
    "size", "dim", "numel", "stride", "data_ptr", "is_contiguous",
    "element_size", "get_device", "storage_offset", "nelement",
    "is_pinned", "query",
})

#: namespaces whose call results are device values: torch itself and the
#: port's plain oracle (``repro_torch.kernels.ref``, imported as ``ref``)
_DEVICE_NAMESPACES = ("torch", "ref")

#: ``torch.*`` calls that return host objects (devices, events, streams,
#: flags), never a tensor
HOST_TORCH_CALLS = frozenset({
    "device", "from_numpy", "is_tensor", "is_available", "device_count",
    "current_device", "current_stream", "default_stream", "Event", "Stream",
    "Generator", "get_device_name", "get_default_dtype", "set_num_threads",
    "get_num_threads", "iinfo", "finfo", "no_grad", "inference_mode",
    "set_sync_debug_mode", "get_sync_debug_mode", "manual_seed",
    "get_device_properties", "device_of",
})

#: host materializers: builtins / np functions that force a device→host
#: transfer of their (tensor) argument
MATERIALIZER_BUILTINS = frozenset({"int", "float", "bool", "complex"})
MATERIALIZER_NP_FUNCS = frozenset({
    "asarray", "array", "asanyarray", "ascontiguousarray", "copy",
})
#: ``result`` covers concurrent futures of device-bound work (the
#: scheduler's worker calls): blocking on one is a host sync exactly like
#: materializing a pending tensor.
MATERIALIZER_METHODS = frozenset({
    "item", "tolist", "cpu", "numpy", "__array__", "result",
})
#: ATen calls whose output size depends on the data: the host reads a
#: count from the device before it can allocate the result
SYNCING_ATEN = frozenset({"nonzero", "masked_select", "unique"})


# ----------------------------------------------------------------------
# File contexts.
# ----------------------------------------------------------------------
@dataclasses.dataclass
class FileContext:
    """One parsed file plus its suppression/sync-point annotations."""

    path: str                 # display path (posix-ish, repo-relative)
    source: str
    tree: ast.Module
    suppressions: dict       # line -> set of rule ids ("*" = all)
    sync_points: set         # lines annotated ``# lint: sync-point``
    func_suppressions: list  # (start, end, rule ids) of def-line ignores

    @classmethod
    def parse(cls, path: str, source: str) -> "FileContext":
        tree = ast.parse(source, filename=path)
        suppressions: dict[int, set] = {}
        sync_points: set[int] = set()
        for lineno, text in enumerate(source.splitlines(), start=1):
            m = SUPPRESS_RE.search(text)
            if m:
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                suppressions.setdefault(lineno, set()).update(rules)
            if SYNC_POINT_RE.search(text):
                sync_points.add(lineno)
        # An ignore anywhere on a ``def`` signature (which may span lines)
        # or one of its decorator lines suppresses the rule for the whole
        # function body.
        func_suppressions = []
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                sig_end = (node.body[0].lineno - 1 if node.body
                           else node.lineno)
                head_lines = (list(range(node.lineno, sig_end + 1))
                              + [d.lineno for d in node.decorator_list])
                rules: set = set()
                for ln in head_lines:
                    rules |= suppressions.get(ln, set())
                if rules:
                    func_suppressions.append(
                        (node.lineno, node.end_lineno or node.lineno, rules))
        return cls(path, source, tree, suppressions, sync_points,
                   func_suppressions)

    def is_suppressed(self, rule: str, line: int) -> bool:
        direct = self.suppressions.get(line, set())
        if rule in direct or "*" in direct:
            return True
        for start, end, rules in self.func_suppressions:
            if start <= line <= end and (rule in rules or "*" in rules):
                return True
        return False

    def matches(self, suffixes) -> bool:
        """Does this file's path end with any of the configured
        module-relative suffixes (e.g. ``repro_torch/core/executor.py``)?"""
        p = self.path.replace("\\", "/")
        return any(p.endswith(s) for s in suffixes)


@dataclasses.dataclass
class CSource:
    """One CUDA C++ source handed to the linter (``.cu``): not parsed as
    Python; the launch-contract rule reads its ``extern "C"`` prototypes."""

    path: str
    source: str


def iter_functions(tree: ast.Module):
    """Yield every (async) function def with its dotted qualname."""
    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = f"{prefix}{child.name}"
                yield child, name
                yield from walk(child, f"{name}.")
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.")
            else:
                yield from walk(child, prefix)
    yield from walk(tree, "")


# ----------------------------------------------------------------------
# Call-name helpers.
# ----------------------------------------------------------------------
def call_name(call: ast.Call) -> str | None:
    """Terminal name of a call target: ``ops.query_block(...)`` →
    ``query_block``; ``_build.load().NAME(...)`` → ``NAME`` (an inner call
    is unwrapped — its result is what is being called)."""
    func = call.func
    while isinstance(func, ast.Call):
        func = func.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def call_root(call: ast.Call) -> str | None:
    """Leftmost name of a dotted call target: ``np.asarray`` → ``np``."""
    return expr_root(call.func)


def expr_root(node) -> str | None:
    """Leftmost name under calls, attributes and subscripts:
    ``fences.pop(gi)`` → ``fences``, ``torch.cuda.Event`` → ``torch``."""
    while isinstance(node, (ast.Call, ast.Attribute, ast.Subscript)):
        node = node.func if isinstance(node, ast.Call) else node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def dotted(node) -> str | None:
    """``a.b.c`` → ``"a.b.c"`` for a pure attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def kwarg(call: ast.Call, name: str):
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


# ----------------------------------------------------------------------
# Fences, events and concurrent.futures.wait (per-file discovery).
# ----------------------------------------------------------------------
_FENCE_CTORS = frozenset({"Fence"})
_EVENT_CTORS = frozenset({"Event"})


@dataclasses.dataclass
class SyncNames:
    """What one file binds to fences and events, and how it names
    ``concurrent.futures.wait``."""

    fences: set      # names/attributes bound to a Fence (or a dict of them)
    events: set      # names/attributes bound to a torch.cuda.Event
    futures_waits: set    # bare names of concurrent.futures.wait
    futures_modules: set  # aliases of the concurrent.futures module

    def wait_kind(self, call: ast.Call) -> str | None:
        """``"fence"`` for a fence's ``.wait()``, ``"futures"`` for
        ``concurrent.futures.wait``, else None."""
        func = call.func
        if isinstance(func, ast.Name):
            return "futures" if func.id in self.futures_waits else None
        if not isinstance(func, ast.Attribute) or func.attr != "wait":
            return None
        recv = func.value
        if dotted(recv) in self.futures_modules:
            return "futures"
        if _is_bound(recv, self.fences, _FENCE_CTORS):
            return "fence"
        return None

    def is_event_sync(self, call: ast.Call) -> bool:
        func = call.func
        return (isinstance(func, ast.Attribute)
                and func.attr == "synchronize"
                and _is_bound(func.value, self.events, _EVENT_CTORS))


def _ctor_name(node) -> str | None:
    if isinstance(node, ast.Call):
        return call_name(node)
    return None


def _binding_key(target) -> str | None:
    """The name a binding is tracked under: a plain name, the terminal
    attribute of ``self.x``, or the container of ``x[k] = ...``."""
    if isinstance(target, ast.Name):
        return target.id
    if isinstance(target, ast.Attribute):
        return target.attr
    if isinstance(target, ast.Subscript):
        return _binding_key(target.value)
    return None


def _is_bound(recv, bound: set, ctors) -> bool:
    """Is ``recv`` a constructor call in ``ctors``, or rooted (through
    ``.pop(k)``, ``[k]``, ``.get(k)``) in a name or attribute bound to one?"""
    if _ctor_name(recv) in ctors:
        return True
    node = recv
    while True:
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("pop", "get")):
            node = node.func.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        else:
            break
    if isinstance(node, ast.Name):
        return node.id in bound
    if isinstance(node, ast.Attribute):
        return node.attr in bound
    return False


def sync_names(tree: ast.Module) -> SyncNames:
    """One pass over a file: every binding of a ``Fence``/``Event`` (to a
    name, an attribute or a container item) and every import of
    ``concurrent.futures.wait`` or its module."""
    fences, events, waits, modules = set(), set(), set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            ctor = _ctor_name(node.value)
            for target in node.targets:
                key = _binding_key(target)
                if key is not None and ctor in _FENCE_CTORS:
                    fences.add(key)
                elif key is not None and ctor in _EVENT_CTORS:
                    events.add(key)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "concurrent.futures":
                for alias in node.names:
                    if alias.name == "wait":
                        waits.add(alias.asname or alias.name)
            elif node.module == "concurrent":
                for alias in node.names:
                    if alias.name == "futures":
                        modules.add(alias.asname or alias.name)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "concurrent.futures":
                    modules.add(alias.asname or alias.name)
    return SyncNames(fences, events, waits, modules)


# ----------------------------------------------------------------------
# Taint engine.
# ----------------------------------------------------------------------
class TaintEnv:
    """Name → device-taint map for one function, driven lexically."""

    def __init__(self, device_calls, device_attrs,
                 syncs: SyncNames | None = None):
        self.names: set[str] = set()
        self.device_calls = frozenset(device_calls)
        self.device_attrs = frozenset(device_attrs)
        self.syncs = syncs or SyncNames(set(), set(), set(), set())

    # -- expression taint ----------------------------------------------
    def tainted(self, node) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Call):
            return self._call_tainted(node)
        if isinstance(node, ast.Attribute):
            if node.attr in UNTAINT_ATTRS:
                return False
            if node.attr in self.device_attrs:
                return True
            return self.tainted(node.value)
        if isinstance(node, ast.Subscript):
            return self.tainted(node.value)
        if isinstance(node, ast.BinOp):
            return self.tainted(node.left) or self.tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.tainted(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.tainted(v) for v in node.values)
        if isinstance(node, ast.Compare):
            # identity checks never read the tensor
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False
            return (self.tainted(node.left)
                    or any(self.tainted(c) for c in node.comparators))
        if isinstance(node, ast.IfExp):
            return self.tainted(node.body) or self.tainted(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.tainted(e) for e in node.elts)
        if isinstance(node, ast.Starred):
            return self.tainted(node.value)
        if isinstance(node, ast.NamedExpr):
            return self.tainted(node.value)
        return False

    def _call_tainted(self, node: ast.Call) -> bool:
        name = call_name(node)
        root = call_root(node)
        kind = self.syncs.wait_kind(node)
        if kind is not None:
            return kind == "futures"
        if root == "torch":
            path = dotted(node.func) or ""
            return not (name in HOST_TORCH_CALLS or name == "synchronize"
                        or path.startswith("torch.cuda."))
        if root in _DEVICE_NAMESPACES:
            return True
        if name in self.device_calls:
            return True
        if name in MATERIALIZER_METHODS or name in MATERIALIZER_BUILTINS:
            return False          # a materializer's result lives on host
        if root == "np" or root == "numpy":
            return False
        func = node.func
        if isinstance(func, ast.Attribute):
            if func.attr in HOST_METHODS:
                return False
            # method call on a tainted object keeps the taint (e.g.
            # ``hit.to(torch.int8)`` on a device tensor)
            return self.tainted(func.value)
        return False

    # -- statement-driven updates --------------------------------------
    def assign(self, target, value_tainted: bool) -> None:
        if isinstance(target, ast.Name):
            if value_tainted:
                self.names.add(target.id)
            else:
                self.names.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self.assign(elt, value_tainted)
        elif isinstance(target, ast.Subscript):
            # writing a device value into a container taints the container
            if value_tainted and isinstance(target.value, ast.Name):
                self.names.add(target.value.id)
        elif isinstance(target, ast.Starred):
            self.assign(target.value, value_tainted)
        # attribute targets (self.x = ...) are not tracked per-name


# ----------------------------------------------------------------------
# Small symbolic resolver (launch-contract rules).
# ----------------------------------------------------------------------
class SymbolEnv:
    """Name → candidate AST value(s) within one function (plus the module
    scope).  Re-binding and conditional expressions produce *multiple*
    candidates; a name with no binding in scope resolves to nothing, so
    unresolvable dynamism is skipped, never guessed."""

    def __init__(self, module: ast.Module, func=None):
        self.values: dict[str, list] = {}
        self.func_defs: dict[str, ast.AST] = {}
        for node in module.body:
            self._bind_stmt(node)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.func_defs.setdefault(node.name, node)
        if func is not None:
            for node in ast.walk(func):
                if isinstance(node, (ast.Assign, ast.AnnAssign)):
                    self._bind_stmt(node)

    def _bind_stmt(self, node) -> None:
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    self.values.setdefault(target.id, []).append(node.value)
        elif isinstance(node, ast.AnnAssign):
            if isinstance(node.target, ast.Name) and node.value is not None:
                self.values.setdefault(node.target.id, []).append(node.value)

    def candidates(self, node, depth: int = 0) -> list:
        """Resolve an expression to candidate value nodes: name chains
        followed, both arms of ``a if c else b`` taken."""
        if depth > 6:
            return []
        if isinstance(node, ast.IfExp):
            return (self.candidates(node.body, depth + 1)
                    + self.candidates(node.orelse, depth + 1))
        if isinstance(node, ast.Name):
            out = []
            for value in self.values.get(node.id, []):
                out.extend(self.candidates(value, depth + 1))
            return out
        return [node]

    def strings(self, node, depth: int = 0) -> list | None:
        """Every string ``node`` may evaluate to (constants, names bound
        to them, conditional arms, ``+`` concatenation), or None when any
        part is unresolvable."""
        if depth > 6:
            return None
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return [node.value]
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            left = self.strings(node.left, depth + 1)
            right = self.strings(node.right, depth + 1)
            if left is None or right is None:
                return None
            return [a + b for a in left for b in right]
        if isinstance(node, (ast.Name, ast.IfExp)):
            cands = self.candidates(node, depth + 1)
            if not cands:
                return None
            out = []
            for cand in cands:
                vals = self.strings(cand, depth + 1)
                if vals is None:
                    return None
                out.extend(vals)
            return out
        return None

    def seq_len(self, node, depth: int = 0) -> int | None:
        """Length of a sequence expression (tuple/list literals, a
        generator over one, a slice of one, a name bound to one, or a call
        of a module function whose every ``return`` is a tuple of one
        length), or None when unresolvable or ambiguous."""
        if depth > 8:
            return None
        if isinstance(node, (ast.Tuple, ast.List)):
            total = 0
            for elt in node.elts:
                if isinstance(elt, ast.Starred):
                    n = self.seq_len(elt.value, depth + 1)
                    if n is None:
                        return None
                    total += n
                else:
                    total += 1
            return total
        if isinstance(node, (ast.GeneratorExp, ast.ListComp)):
            if len(node.generators) != 1 or node.generators[0].ifs:
                return None
            return self.seq_len(node.generators[0].iter, depth + 1)
        if isinstance(node, ast.Subscript) and isinstance(node.slice,
                                                          ast.Slice):
            n = self.seq_len(node.value, depth + 1)
            sl = node.slice
            if n is None or sl.step is not None:
                return None
            bounds = []
            for b, default in ((sl.lower, 0), (sl.upper, n)):
                if b is None:
                    bounds.append(default)
                elif isinstance(b, ast.Constant) and isinstance(b.value, int):
                    bounds.append(b.value)
                else:
                    return None
            return len(range(n)[bounds[0]:bounds[1]])
        if isinstance(node, ast.Name):
            lens = {self.seq_len(c, depth + 1)
                    for c in self.candidates(node, depth + 1)}
            return lens.pop() if len(lens) == 1 else None
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            fn = self.func_defs.get(node.func.id)
            if fn is None:
                return None
            lens = {self.seq_len(r.value, depth + 1) for r in ast.walk(fn)
                    if isinstance(r, ast.Return) and r.value is not None}
            return lens.pop() if len(lens) == 1 else None
        return None
