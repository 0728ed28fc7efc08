"""plan_ms: ms per traced request inside ``QueryPlanner.plan`` (the
benchmark's span around it)."""


def read(obs):
    tr = obs.traced
    if tr is None or not tr.requests:
        return None
    plan_s = tr.spans.total("plan")
    if plan_s is None:
        return None
    return plan_s / len(tr.requests) * 1e3
