"""searches_per_s: query trajectories answered in full per second of the
window (the window ends with the first answer after its deadline)."""


def read(obs):
    if not obs.requests:
        return None
    return sum(r["trajectories"] for r in obs.requests) / obs.window_s
