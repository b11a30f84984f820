"""``post_unet_ms``: per profiled step, the device time of the program's
``step.update`` and ``step.scatter`` spans (the CFG combine, DDIM, the
merge with the previous latent, the static paste and the scatter), from
their CUDA events (``portbench/spans.py``)."""

from portbench import spans


def read(r):
    p = spans.load(r)
    return None if p is None else spans.step_ms(p, spans.POST)
