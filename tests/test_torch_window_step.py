"""The shared core of the window step (``pipelines/window_step.py``) on the
CPU: a 0 re-noise ratio draws nothing and returns its input; the CFG update
opens ``step.rescale`` only where a guidance rescale or a v conversion
runs, and equals the combine and DDIM step written out; the CFG pack at
guidance 1 returns the rows and contexts alone; the concat join repeats
the crops over the CFG rows inside ``step.concat``."""

import pytest
import torch

from dynamicscaler_tpu_torch.ops.blend import mix_with_mask
from dynamicscaler_tpu_torch.ops.ddim import ddim_step, guided, make_ddim_schedule, re_noise
from dynamicscaler_tpu_torch.pipelines.window_step import cfg_pack, cfg_update, check_overlap_mode, join, renoise
from dynamicscaler_tpu_torch.utils import timing


def rows(n, f=3, c=4, seed=0):
    return torch.randn(n, f, 2, 5, c, generator=torch.Generator().manual_seed(seed))


def spans(fn):
    timing.take()
    with timing.tracing():
        out = fn()
    return out, [(s.name, s.counts) for s in timing.take().spans]


def test_renoise_at_ratio_0_draws_nothing():
    sched = make_ddim_schedule(4)
    wins = rows(2)

    def draw(shape):
        raise AssertionError("a draw at ratio 0")
    assert renoise(sched, wins, 2, 0.0, torch.ones(2, 3, 2, 5, 1), draw) is wins


@pytest.mark.parametrize("index", [0, 3])
def test_renoise_mixes_the_draw_where_masked(index):
    sched = make_ddim_schedule(4)
    wins, noise = rows(2), rows(2, seed=1)
    mask = (torch.arange(5) < 2).float().reshape(1, 1, 1, 5, 1).expand(2, 3, 2, 5, 1)
    drawn = []

    def draw(shape):
        drawn.append(shape)
        return noise
    got = renoise(sched, wins, index, 0.4, mask, draw)
    want = mix_with_mask(wins, re_noise(sched, wins, max(index - 1, 0), index, noise=noise), mask, 0.4)
    assert drawn == [wins.shape] and torch.equal(got, want)
    assert torch.equal(got[..., 2:, :], wins[..., 2:, :])  # unmasked pixels keep their values


@pytest.mark.parametrize("parameterization,rescale,opens", [("eps", 0.0, False), ("eps", 0.7, True),
                                                           ("v", 0.0, True), ("v", 0.7, True)])
@pytest.mark.parametrize("guidance", [1.0, 7.5])
def test_cfg_update_opens_rescale_only_under_a_rescale_or_v(parameterization, rescale, opens, guidance):
    sched = make_ddim_schedule(4, parameterization=parameterization)
    wins = rows(2)
    eps = rows(2 if guidance == 1.0 else 4, seed=2)
    (new, den), got = spans(lambda: cfg_update(sched, wins, eps, 1, guidance, rescale))
    assert got == ([("step.rescale", {"rows": 2})] if opens else [])
    out = eps if guidance == 1.0 else guided(eps[:2], eps[2:], guidance, rescale)
    want = ddim_step(sched, wins, out, torch.full((3,), 1, dtype=torch.long))
    assert torch.equal(new, want[0]) and torch.equal(den, want[1])


def test_cfg_pack_at_guidance_1_returns_the_rows_alone():
    wins, ctx, uncond = rows(3), torch.randn(3, 7, 8), torch.randn(1, 7, 8)
    x, c = cfg_pack(wins, ctx, uncond, 1.0)
    assert x is wins and c is ctx


def test_cfg_pack_puts_cond_rows_then_uncond_rows():
    wins, ctx, uncond = rows(3), torch.randn(3, 7, 8), torch.randn(1, 7, 8)
    x, c = cfg_pack(wins, ctx, uncond, 7.5)
    assert torch.equal(x, torch.cat([wins, wins])) and torch.equal(c, torch.cat([ctx, uncond.expand(3, 7, 8)]))


def test_join_repeats_the_crops_over_the_cfg_rows():
    x, crops = rows(4), rows(2, c=2, seed=3)
    out, got = spans(lambda: join(x, lambda: crops))
    assert got == [("step.concat", {"rows": 4})]
    assert torch.equal(out, torch.cat([x, torch.cat([crops, crops])], dim=-1))


def test_an_unknown_overlap_mode_is_refused():
    for mode in ("last", "average", "sequential"):
        check_overlap_mode(mode)
    with pytest.raises(ValueError, match="overlap_mode 'blend'"):
        check_overlap_mode("blend")
