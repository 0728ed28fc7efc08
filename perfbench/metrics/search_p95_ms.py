"""search_p95_ms: the 95th percentile of every request's time in the
window, from its ``db.query`` call to its full answer, in ms."""
import numpy as np


def read(obs):
    if not obs.requests:
        return None
    return float(np.percentile([r["latency_s"] for r in obs.requests], 95)) * 1e3
