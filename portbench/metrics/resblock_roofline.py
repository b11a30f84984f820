"""``resblock_roofline``: the least time of every ResBlock call in the window
(its convolutions, GroupNorms and temporal convs; operations over the peak
rate or bytes over the peak bandwidth, from the frozen reference's count)
over their device time between CUDA events in their forward hooks."""


def read(r):
    spent = r.span_s.get("ResBlock", 0.0)
    if not spent:
        return None
    return 100.0 * sum(r.counts(b)["ResBlock"]["least_s"] for b in r.forwards) / spent
