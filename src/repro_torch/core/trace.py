"""Spans of the query path on the profiler's clock, and the dispatch-group
labels.

Two per-thread seams that observability layers read without the layers
they observe knowing of them:

* :func:`current_group_label` — the dispatch group the calling thread is
  executing (``"pipelined:finish:3"``), published by the executors through
  :func:`_group_scope`.  ``repro_torch.lint.sentinel`` blames a
  device→host stall on it.  Always on; a group scope opens no profiler
  range.
* :func:`span` — a named piece of host work in the planner, the
  dispatcher or the facade.  Tracing is on exactly while
  ``torch.profiler`` records in this process.  Then a span is a range
  ``repro_torch.<name>`` among the profiler's events, on the profiler's
  clock, and adds one call and its host seconds to the accumulator the
  thread's :func:`collect` opened (``QueryPlan.spans``,
  ``ExecStats.spans``).  Off, a span is one check and a shared null
  context: no range, no clock read, no write.

The ranges are operator-level ranges (``_RecordFunctionFast``), not user
annotations: the profiler copies a user annotation onto the device's
timeline, spanning every device operation launched inside it, and a
reader that sums device intervals then counts the host's gaps as device
work.

============================  ==============================================
span                          host work
============================  ==============================================
``plan.price_setup``          ``SpatialInteractionCounter``: the queries'
                              MBRs and prune threshold
``plan.batching``             the batching algorithm, its merges and
                              their pricing calls
``plan.subranges``            ``QueryPlanner._prune_batches``
``plan.refine``               capacities and dispatch groups
``dispatch.prep``             the enqueue of the spatial route's
                              ``distthresh_tile_prep`` (tile boxes and
                              threshold on the device) /
                              ``ops._host_live_tiles``
``dispatch.upload``           ``ops.to_device`` of live-tile lists, or
                              inputs not resident
``dispatch.launch``           the kernel wrapper call: checks, output
                              allocation, launch (on the dense path every
                              launch of the compaction)
``dispatch.stage``            ``engine._stage_to_host``: pinned buffers and
                              the asynchronous copies into them
``order.rank``                ``api._caller_rank``: the rank into the
                              caller's order by one sort of packed int64
                              (query, entry, row) values
``order.rank_lexsort``        the two-key ``np.lexsort`` it falls back to
                              where the values would pass int64; its
                              calls count the fallbacks
============================  ==============================================

Beside the spans, one counter of the planner's pricing, always on (two
integer sums a pricing call, no clock read):
``QueryPlan.priced_cells_per_row``, carried into
``ExecStats.priced_cells_per_row``, the coarse cells
``SpatialInteractionCounter`` evaluated per row it priced under
``plan.batching``.  A row is priced over the cells its temporal range
overlaps, so it reads ``COARSE_GRID_BINS`` (128) only where every row
spans the grid, and 0.0 where nothing was priced (periodic batching, or
no ``d``).
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch

#: prefix of every span's profiler range
PREFIX = "repro_torch."

#: per-thread state: ``label`` (the dispatch group) and ``spans`` (the open
#: accumulator, name -> (calls, host seconds)).  Thread-local because the
#: deadline scheduler runs whole groups on pool threads concurrently.
_context = threading.local()

_profiling = torch._C._autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()


def current_group_label() -> str | None:
    """The calling thread's active dispatch-group label (e.g.
    ``"pipelined:finish:3"``), or ``None`` outside any group scope."""
    return getattr(_context, "label", None)


@contextlib.contextmanager
def _group_scope(label: str):
    prev = getattr(_context, "label", None)
    _context.label = label
    try:
        yield
    finally:
        _context.label = prev


class _Span:
    __slots__ = ("name", "range", "t0")

    def __init__(self, name: str):
        self.name = name
        self.range = _range(PREFIX + name)

    def __enter__(self):
        self.range.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        self.range.__exit__(*exc)
        acc = getattr(_context, "spans", None)
        if acc is not None:
            calls, total = acc.get(self.name, (0, 0.0))
            acc[self.name] = (calls + 1, total + seconds)
        return False


def span(name: str):
    """A context manager around one piece of host work (table above)."""
    if not _profiling():
        return _OFF
    return _Span(name)


@contextlib.contextmanager
def collect(initial: dict | None = None):
    """Open the calling thread's span accumulator, seeded with
    ``initial``, for the block; yields it.  Spans go to the innermost open
    accumulator; one of another thread never sees them."""
    prev = getattr(_context, "spans", None)
    acc = dict(initial or {})
    _context.spans = acc
    try:
        yield acc
    finally:
        _context.spans = prev


__all__ = ["PREFIX", "collect", "current_group_label", "span"]
