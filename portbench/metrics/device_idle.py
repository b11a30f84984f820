"""``device_idle``: the share of the profiled steps' wall time in which no
kernel, copy or set ran on the card (``torch.profiler``, CUDA activity)."""


def read(r):
    if r.trace is None or not r.trace["window_s"]:
        return None
    return 100.0 * (1.0 - r.trace["busy_s"] / r.trace["window_s"])
