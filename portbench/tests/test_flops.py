"""The meta-device operation count against a hand count of the tiny UNet's
convolutions, linear layers and attention products."""

import math

import pytest
import torch
from torch import nn

from portbench import flops
from portbench.reference import nets
from portbench.tests.tiny import tiny_model


def hand_count(unet_cfg, B, Fn, h, w, L, monkeypatch):
    """(total, {class: ops}, outside): 2 * multiply-adds of every linear
    layer and convolution from its weight and output shape, 2 * 2 * N * M *
    d a head for the two attention products, each charged to its top-level
    module of ``flops.CLASSES`` (or outside)."""
    cfg = nets.namespace(unet_cfg)
    with torch.device("meta"):
        unet = nets.UNet(cfg)
    owner = {}
    for name, m in unet.named_modules():
        top = next((n for n in sorted(owner, key=len) if name.startswith(n + ".")), None)
        if top is None and type(m).__name__ in flops.CLASSES:
            owner[name] = type(m).__name__
    parent = {}
    for name, m in unet.named_modules():
        parent[id(m)] = next((owner[n] for n in owner if name == n or name.startswith(n + ".")), "outside")
    counts = {c: 0 for c in (*flops.CLASSES, "outside")}
    stack = []

    def leaf(mod, args, out):
        if isinstance(mod, nn.Linear):
            ops = 2 * out.numel() * mod.in_features
        else:
            ops = 2 * out.numel() * mod.in_channels // mod.groups * math.prod(mod.kernel_size)
        counts[parent[id(mod)]] += ops

    real = nets.attention

    def counted(q, k, v, scale, causal=False):
        Bq, H, N, d = q.shape
        counts[stack[-1] if stack else "outside"] += 2 * 2 * Bq * H * N * k.shape[2] * d
        return real(q, k, v, scale, causal)
    monkeypatch.setattr(nets, "attention", counted)
    for m in unet.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)):
            m.register_forward_hook(leaf)
        if type(m).__name__ in flops.CLASSES:
            m.register_forward_pre_hook(lambda mod, a: stack.append(parent[id(mod)]))
            m.register_forward_hook(lambda mod, a, o: stack.pop() and None)
    with torch.device("meta"), torch.no_grad():
        unet(torch.empty(B, Fn, h, w, cfg.in_channels), torch.empty(B, dtype=torch.long),
             torch.empty(B, L, cfg.context_dim), 8)
    return sum(counts.values()), counts


@pytest.mark.parametrize("i2v", [True, False])
def test_count_matches_hand_count(i2v, monkeypatch):
    cfg = tiny_model(i2v)["unet"]
    L = 81 if i2v else 77
    got = flops.count_unet(cfg, 3, 4, 8, 8, L)
    total, parts = hand_count(cfg, 3, 4, 8, 8, L, monkeypatch)
    assert got["total"] == total
    for c in flops.CLASSES:
        assert got[c]["flops"] == parts[c]
    assert sum(got[c]["flops"] for c in flops.CLASSES) + parts["outside"] == got["total"]


def test_count_is_linear_in_batch_and_bytes_are_not():
    cfg = tiny_model(True)["unet"]
    one, four = flops.count_unet(cfg, 1, 4, 8, 8, 81), flops.count_unet(cfg, 4, 4, 8, 8, 81)
    assert four["total"] == 4 * one["total"]
    for c in flops.CLASSES:
        assert one[c]["bytes"] < four[c]["bytes"] < 4 * one[c]["bytes"]  # the weights are read once a call
        assert one[c]["least_s"] > 0
