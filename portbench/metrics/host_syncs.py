"""``host_syncs``: per profiled step, the host ops inside the program's
``step`` spans that make the host wait for the card: a synchronising CUDA
runtime call or a copy to or from pageable host memory, counted once per
op (``portbench/spans.py``)."""

from portbench import spans


def read(r):
    p = spans.load(r)
    return None if p is None else spans.host_syncs(p)
