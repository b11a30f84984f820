"""The port's window data parallel (``parallel/mesh.py``) on the CPU: gloo
ranks, each a spawned process with one torch thread.

* The share rule at 1-96 rows, 1-4 ranks, microbatch 0, 2 and 8: every row
  once and in order, whole microbatches where there are at least as many
  as ranks.
* The tiny samplers of ``tests/torch_mesh_cases.py`` (t2v planar in the
  ``last``, ``average`` and ``sequential`` modes, i2v planar, one stage-1
  sphere step) at 2 and 4 ranks: every rank's latents equal rank 0's bit
  for bit; against the one-process port run exactly where every batch's
  shares are whole microbatches (and in ``sequential``, which runs whole on
  every rank), else within ``close_fp32_chain``. The i2v run takes the JAX
  sampler's draws, and the 4-rank run is held against the JAX sampler on
  a (data 2, seq 2) mesh of the conftest's virtual CPU devices.
* ``replicate`` making two differently seeded tiny UNets equal;
  ``parallel/dryrun.py::dryrun_multichip(4)``; the ranks' time limit.

Each spawn of ranks has a time limit of its own (``RANK_TIMEOUT_S``) past
which its processes are killed. Alone:
``python -m pytest tests/test_torch_mesh.py -q`` (about a minute).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax

from dynamicscaler_tpu.models.lvdm import LatentVideoDiffusion as JLVDM
from dynamicscaler_tpu.parallel import mesh as jmesh
from dynamicscaler_tpu.pipelines import i2v as ji2v
from dynamicscaler_tpu_torch.config import tiny_test_config
from dynamicscaler_tpu_torch.models.lvdm import LatentVideoDiffusion
from dynamicscaler_tpu_torch.parallel import dryrun
from dynamicscaler_tpu_torch.parallel import mesh as mesh_lib
from dynamicscaler_tpu_torch.utils.tokenizer import HashTokenizer
import torch_mesh_cases as cases
from torch_port_helpers import close_fp32_chain, i2v_twin_models, jax_noise, smooth_pano

RANK_TIMEOUT_S = 120
JAX_KEY = 3


@pytest.mark.parametrize("microbatch", [0, 2, 8])
def test_share_rule(microbatch):
    for n in range(1, 97):
        for ranks in range(1, 5):
            bounds = mesh_lib.share_bounds(n, ranks, microbatch)
            assert len(bounds) == ranks and bounds[0][0] == 0 and bounds[-1][1] == n
            assert all(a <= b for a, b in bounds) and all(b == a2 for (_, b), (a2, _) in zip(bounds, bounds[1:]))
            sizes = [b - a for a, b in bounds]
            n_mb = -(-n // microbatch) if microbatch else 1
            if microbatch and n_mb >= ranks:  # runs of whole microbatches, the first ranks one more
                assert all(a % microbatch == 0 for a, _ in bounds) and all(s > 0 for s in sizes)
                mbs = [-(-s // microbatch) for s in sizes]
                assert sum(mbs) == n_mb and max(mbs) - min(mbs) <= 1 and mbs == sorted(mbs, reverse=True)
            else:  # near-equal runs of rows
                assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes, reverse=True)
    # stage 1 of the CLI on 4 cards: 88 rows in microbatches of 8 split 3/3/3/2
    assert mesh_lib.share_bounds(88, 4, 8) == [(0, 24), (24, 48), (48, 72), (72, 88)]
    assert mesh_lib.share_bounds(8, 4, 8) == [(0, 2), (2, 4), (4, 6), (6, 8)]


def test_no_mesh_is_one_share():
    x = torch.arange(10.0)
    assert mesh_lib.window_sharding(None, 10, 8) == [(0, 10)]
    assert mesh_lib.constrain_window_batch(x, None) is x and mesh_lib.constrain_latent(x, None) is x
    assert mesh_lib.latent_sharding(None) is None and mesh_lib.replicate(x, None) is x
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.make_mesh(1)


@pytest.fixture(scope="module")
def reference():
    """The one-process port runs of every case (the i2v sampler handed the
    JAX sampler's draws, recorded by name for the ranks), the rows of each
    UNet batch they ran, the bundles' weights and the twins' JAX model."""
    jmodel, i2v_model = i2v_twin_models()
    t2v_model = LatentVideoDiffusion.init_random(tiny_test_config(False), torch.Generator().manual_seed(5),
                                                 device="cpu", tokenizer=HashTokenizer(512))
    models = {"t2v": t2v_model, "i2v": i2v_model}
    panos = {"i2v": smooth_pano(1, 48, 64), "sphere": smooth_pano(2, 32, 64)}
    noise, draws = jax_noise(jax.random.PRNGKey(JAX_KEY)), {}

    def recorded(name, shape):
        draws[name] = noise(name, shape)
        return draws[name]

    rows, outs = {}, {}
    for name in cases.CASES:
        for m in models.values():
            m.apply_unet_microbatched = _counting(m, rows.setdefault(name, []))
        outs[name] = cases.run_case(models, name, panos, recorded)
        for m in models.values():
            del m.apply_unet_microbatched
    state = {k: {n: mod.state_dict() for n, mod in m.components()} for k, m in models.items()}
    return dict(outs=outs, rows=rows, state=state, panos=panos, draws=draws, jmodel=jmodel)


def _counting(model, rows):
    """``model.apply_unet_microbatched`` recording each batch's rows."""
    fn = type(model).apply_unet_microbatched.__get__(model)

    def wrapped(x, *a, **kw):
        rows.append(x.shape[0])
        return fn(x, *a, **kw)
    return wrapped


@pytest.fixture(scope="module")
def ranks_out(reference, tmp_path_factory):
    """Every case on 2 and on 4 gloo ranks: ``{ranks: [rank -> {case:
    arrays}]}``."""
    dirs = {n: str(tmp_path_factory.mktemp(f"ranks{n}")) for n in (2, 4)}
    with ThreadPoolExecutor(2) as pool:  # both groups at once
        for job in [pool.submit(mesh_lib.launch, cases.rank_main, n, device_type="cpu", timeout=RANK_TIMEOUT_S,
                                args=(reference["state"], reference["panos"], reference["draws"], d))
                    for n, d in dirs.items()]:
            job.result()
    return {n: [{name: list(np.load(f"{d}/{r}/{name}.npz").values()) for name in [*cases.CASES, "unet", "inputs"]}
                for r in range(n)] for n, d in dirs.items()}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(cases.CASES))
def test_ranks_agree_and_match_one_process(reference, ranks_out, name, n):
    _, _, mode, mb, _ = cases.CASES[name]
    rows = reference["rows"][name]
    assert rows  # the case ran UNet batches through the microbatched call
    # whole microbatches on every rank, or the sequential mode's whole run on each
    exact = mode == "sequential" or all(-(-r // mb) >= n for r in rows)
    for got_rank in ranks_out[n][1:]:
        for a, b in zip(got_rank[name], ranks_out[n][0][name]):
            assert np.array_equal(a, b)  # every rank holds rank 0's latents, bit for bit
    for got, ref in zip(ranks_out[n][0][name], reference["outs"][name]):
        assert got.shape == ref.shape and np.isfinite(got).all()
        if exact:
            assert np.array_equal(got, ref)
        else:
            close_fp32_chain(torch.from_numpy(got), ref)


def test_cases_cover_both_share_kinds(reference):
    """At 2 ranks the mb2 cases split whole microbatches and the mb8 ones
    cut rows; one window is 2 rows; the stage-1 step holds 5 views, 10 CFG
    rows."""
    rows = reference["rows"]
    assert all(-(-r // 2) >= 4 for r in rows["t2v last mb2"] + rows["i2v last mb2"])
    assert all(-(-r // 8) < 2 for r in rows["i2v last mb8"])
    assert set(rows["t2v last one window"]) == {2}  # fewer rows than 4 ranks: two shares empty
    assert rows["sphere last mb2"] == [10]


def test_i2v_ranks_match_jax_on_a_data_seq_mesh(reference, ranks_out):
    """The 4-rank i2v run against the JAX sampler on make_mesh(n_data=2,
    n_seq=2) of the conftest's virtual CPU devices, the same draws."""
    jm = reference["jmodel"]
    mesh = jmesh.make_mesh(n_data=2, n_seq=2, devices=jax.devices()[:4])
    sharded = JLVDM(config=jm.config, params=jmesh.replicate(jm.params, mesh), tokenizer=jm.tokenizer)
    _, jd = ji2v.sample_shift_multi_windows(sharded, "a lake", reference["panos"]["i2v"],
                                            key=jax.random.PRNGKey(JAX_KEY), mesh=mesh, unet_microbatch=2,
                                            **cases.I2V)
    close_fp32_chain(torch.from_numpy(ranks_out[4][0]["i2v last mb2"][0]), np.asarray(jd))


@pytest.mark.parametrize("n", [2, 4])
def test_replicate_makes_differently_seeded_unets_equal(ranks_out, n):
    unets = [r["unet"] for r in ranks_out[n]]
    assert not np.array_equal(unets[0][0], unets[1][0])  # before: seeded by rank
    for before, after in unets:
        assert np.array_equal(after, unets[0][0])  # after: rank 0's


@pytest.mark.parametrize("n", [2, 4])
def test_shares_are_cut_from_rank_0s_batch(ranks_out, n):
    """Ranks that hold different batches and contexts all get rank 0's
    rows' results (the CPU stands in for the card, where a rank's own
    conditioning can differ in its last bits)."""
    want = (np.arange(48.0).reshape(6, 2, 4) * np.arange(18.0).reshape(6, 3).sum(-1)[:, None, None]).astype(np.float32)
    for r in ranks_out[n]:
        assert np.array_equal(r["inputs"][0], want)


def test_dryrun_multichip_on_four_gloo_ranks(capfd):
    dryrun.dryrun_multichip(4)
    out = capfd.readouterr().out
    assert "dryrun_multichip ok: mesh={'data': 2, 'seq': 2} on cpu" in out and "equal on 4 ranks" in out


def test_launch_kills_ranks_past_their_time_limit():
    with pytest.raises(TimeoutError, match="2 ranks still running"):
        mesh_lib.launch(cases.sleeper, 2, args=(60.0,), device_type="cpu", timeout=2)
