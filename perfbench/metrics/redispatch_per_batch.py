"""redispatch_per_batch: overflow re-dispatches per planned batch over the
traced requests (``ExecStats.total_retries`` / ``num_invocations``)."""


def read(obs):
    tr = obs.traced
    if tr is None or any(r["stats"] is None for r in tr.requests):
        return None
    batches = sum(r["stats"]["invocations"] for r in tr.requests)
    if not batches:
        return None
    return sum(r["stats"]["retries"] for r in tr.requests) / batches
