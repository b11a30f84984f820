"""``outside_unet_ms``: per step, the device-timed step (CUDA events at the
step's boundaries) less the UNet forwards' spans inside it: the window
step's gather, masks, CFG pack and combine, DDIM, re-noise and scatter,
and the host gaps between them."""


def read(r):
    if not r.step_ms:
        return None
    return sum(step - unet for step, unet in r.step_ms) / len(r.step_ms)
