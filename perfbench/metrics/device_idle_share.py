"""device_idle_share: the share of the traced window (first traced
request's start to the last one's end) in which no operation ran on the
card: 1 − the union of the profiler's device operations / the window."""


def read(obs):
    tr = obs.traced
    if tr is None or tr.device is None:
        return None
    return 1.0 - tr.device.busy_s() / tr.device.window_s
