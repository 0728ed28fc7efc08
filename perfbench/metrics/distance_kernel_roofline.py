"""distance_kernel_roofline: the least time the traced requests' distance
work needs on the card (``perfbench.harness.cost``: operations of the
temporally overlapping pairs at the float32 peak, or bytes read and
written once, whichever is larger) over the device time of the
``distthresh_*`` kernels in the profiler's trace, in %."""


def read(obs):
    tr = obs.traced
    if tr is None or tr.device is None:
        return None
    kernel_s = tr.device.time_by_kernel("distthresh")
    if kernel_s <= 0:
        return None
    return 100.0 * sum(r["least_s"] for r in tr.requests) / kernel_s
