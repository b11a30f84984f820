"""``unet_fwd_ms``: the mean device time of one UNet forward at the cell's
microbatch, between CUDA events in forward hooks on ``UNet3D`` (launch
gaps inside the forward included)."""


def read(r):
    full = max(r.forwards, default=0)
    ms = [t for t, b in zip(r.unet_ms, r.forwards) if b == full]
    return sum(ms) / len(ms) if ms else None
