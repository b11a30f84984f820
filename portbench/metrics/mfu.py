"""``mfu``: the UNet's operations in the window over its wall time, as a share
of the chips' peak rate. The operations of each forward are the frozen
reference's count at that forward's batch (``flops.count_unet``)."""


def read(r):
    if not r.forwards or not r.wall_s:
        return None
    ops = sum(r.counts(b)["total"] for b in r.forwards)
    return 100.0 * ops / r.wall_s / (r.chips * r.peak_flops)
