"""Operations and bytes of one UNet forward, counted on the frozen reference
UNet on the ``meta`` device: nothing is allocated and nothing of the program
is run, so the count is the same whatever implements the forward.

``count_unet`` splits the count by module class: every top-level instance
of a class in ``CLASSES`` (a ResBlock's temporal convs count with the
ResBlock) gets the operations ``FlopCounterMode`` records inside it, and
its bytes are its inputs, its context, its weights and its output, each
read or written once at the served element size. The least time of a class
is the sum over its instances of the larger of operations over the peak
rate and bytes over the peak bandwidth.
"""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import nets

CLASSES = ("SpatialTransformer", "TemporalTransformer", "ResBlock")


def _tensor_bytes(xs, elem: int) -> int:
    return sum(t.numel() * elem for t in xs if torch.is_tensor(t))


def count_unet(unet_cfg: dict, batch: int, frames: int, h: int, w: int, ctx_len: int, elem: int = 2,
               peak_flops: float = 989e12, peak_bytes: float = 3.35e12) -> dict:
    """{"total": flops, class: {"flops", "bytes", "least_s", "calls"}} of one
    forward of ``batch`` clips of ``frames`` x h x w latents with a
    ``ctx_len``-token context, bytes at ``elem`` bytes an element."""
    return json.loads(_count(json.dumps(unet_cfg, sort_keys=True), batch, frames, h, w, ctx_len, elem, peak_flops,
                             peak_bytes))


@functools.lru_cache(maxsize=None)
def _count(cfg_json, batch, frames, h, w, ctx_len, elem, peak_flops, peak_bytes) -> str:
    cfg = nets.namespace(json.loads(cfg_json))
    with torch.device("meta"):
        unet = nets.UNet(cfg)
        x = torch.empty(batch, frames, h, w, cfg.in_channels)
        t = torch.empty(batch, dtype=torch.long)
        ctx = torch.empty(batch, ctx_len, cfg.context_dim)
    per = {c: {"flops": 0, "bytes": 0, "least_s": 0.0, "calls": 0} for c in CLASSES}
    counter = FlopCounterMode(display=False)
    open_ = {}

    def pre(mod, args):
        if not open_:
            open_[id(mod)] = counter.get_total_flops()

    def post(mod, args, out):
        start = open_.pop(id(mod), None)
        if start is None:
            return
        d = per[type(mod).__name__]
        fl = counter.get_total_flops() - start
        by = _tensor_bytes([args[0], out], elem) + _tensor_bytes(mod.parameters(), elem)
        if isinstance(mod, nets.SpatialTransformer):  # the context of a clip is repeated over its frames: once
            by += args[0].shape[0] // frames * ctx_len * cfg.context_dim * elem
        d["flops"] += fl
        d["bytes"] += by
        d["least_s"] += max(fl / peak_flops, by / peak_bytes)
        d["calls"] += 1

    for m in unet.modules():
        if type(m).__name__ in CLASSES:
            m.register_forward_pre_hook(pre)
            m.register_forward_hook(post)
    with counter, torch.no_grad():
        unet(x, t, ctx, 8)
    return json.dumps({"total": counter.get_total_flops(), **per})
