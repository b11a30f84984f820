"""``transformer_roofline``: the least time of every SpatialTransformer and
TemporalTransformer call in the window (the larger of its operations over
the peak rate and its bytes over the peak bandwidth, from the frozen
reference's count) over their device time between CUDA events in their
forward hooks."""

CLASSES = ("SpatialTransformer", "TemporalTransformer")


def read(r):
    spent = sum(r.span_s.get(c, 0.0) for c in CLASSES)
    if not spent:
        return None
    least = sum(r.counts(b)[c]["least_s"] for b in r.forwards for c in CLASSES)
    return 100.0 * least / spent
