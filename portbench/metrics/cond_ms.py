"""``cond_ms``: per profiled step, the device time of the program's
``step.concat`` (each window row's crop of the panorama's latent, joined to
the UNet's input) and ``step.rescale`` (the guidance rescale and the v
conversions of the DDIM update, inside ``step.update``) spans, from their
CUDA events (``portbench/spans.py``). A program without those spans gives
nothing."""

from portbench import spans

NAMES = ("step.concat", "step.rescale")


def read(r):
    p = spans.load(r)
    if p is None or not p.steps:
        return None
    parent = {s["id"]: s["parent"] for s in p.spans}
    steps = {s["id"] for s in p.steps}

    def in_step(s):
        at = s["parent"]
        while at is not None and at not in steps:
            at = parent.get(at)
        return at is not None
    kids = [s["device_ms"] for s in p.spans if s["name"] in NAMES and in_step(s)]
    if not kids or any(v is None for v in kids):
        return None
    return sum(kids) / len(p.steps)
