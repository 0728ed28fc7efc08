"""searches_per_s.fixed: query trajectories answered in full per second
of request time, over the requests of the ``--trace 1`` run's window that
ran outside the profiler.  The end-to-end rate, read per layer where the
host's drift spreads it past any bound (PERF.md §2)."""


def read(obs):
    traced = len(obs.traced.requests) if obs.traced is not None else 0
    rest = obs.requests[traced:]
    seconds = sum(r["latency_s"] for r in rest)
    if not rest or seconds <= 0:
        return None
    return sum(r["trajectories"] for r in rest) / seconds
