"""dispatch_ms_per_batch: the executor's host time enqueueing dispatches
(``ExecStats.dispatch_seconds``) per planned batch, in ms."""


def read(obs):
    tr = obs.traced
    if tr is None or any(r["stats"] is None for r in tr.requests):
        return None
    batches = sum(r["stats"]["invocations"] for r in tr.requests)
    if not batches:
        return None
    return sum(r["stats"]["dispatch_s"] for r in tr.requests) / batches * 1e3
