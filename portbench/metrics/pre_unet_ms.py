"""``pre_unet_ms``: per profiled step, the device time of the program's
``step.gather``, ``step.masks`` and ``step.renoise`` spans (the window
gather and resize, the earlier-coverage masks, the re-noise and the CFG
pack), from their CUDA events (``portbench/spans.py``)."""

from portbench import spans


def read(r):
    p = spans.load(r)
    return None if p is None else spans.step_ms(p, spans.PRE)
