"""The port's models/vae_aux.py against the JAX package's, on the CPU.

Each class of ``dynamicscaler_tpu_torch/models/vae_aux.py`` at tiny widths
(channels multiples of 32, GroupNorm(32)), in fp32, three ways:

* twins: random JAX parameters (zero leaves perturbed) through the JAX
  module and, converted by ``weights.from_jax_*``, through the port's
  (relative max error 2e-5, the tolerance of ``tests/test_vae_aux.py``);
* names: the port module's own random weights, its state_dict fed through
  the JAX package's converter (``convert_aux_*``, which reads the
  reference's names) and run by the JAX module, against the port's output;
* round trip: the JAX converter of ``from_jax_*``'s state dict gives the
  JAX parameters back bit for bit.
"""

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamicscaler_tpu.config import VAEConfig as JVAEConfig
from dynamicscaler_tpu.models import vae_aux as J
from dynamicscaler_tpu.utils import weights as jweights
from dynamicscaler_tpu_torch.config import VAEConfig
from dynamicscaler_tpu_torch.models import vae_aux as P
from dynamicscaler_tpu_torch.utils import weights
from dynamicscaler_tpu_torch.utils.weights import _lin_attn, _Out, _resnet_t, perturb_zero_params
from torch_port_helpers import random_jax_params

TOL = 2e-5


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    rel = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12)
    assert rel <= tol, f"relative max error {rel:.3e} > {tol}"


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


class Case(NamedTuple):
    jax_module: object  # the flax module
    inputs: tuple  # numpy inputs of both twins (None passes through)
    port: Callable  # () -> the port module on the CPU, default torch init
    from_jax: Callable  # JAX tree -> the port's state dict
    to_jax: Callable  # a state dict -> the JAX tree (the JAX package's converter)


MODEL_CFG = dict(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=16)


def _model_case(attn_type, use_timestep=True, context=False):
    cfg = J.AuxModelConfig(**MODEL_CFG, in_channels=5 if context else 3, use_timestep=use_timestep,
                           attn_type=attn_type)
    pcfg = P.AuxModelConfig(**dataclasses.asdict(cfg))
    inputs = (_rand(1, 2, 16, 16, 3), np.array([5, 900]) if use_timestep else None,
              _rand(2, 2, 16, 16, 2) if context else None)
    return Case(J.Model(cfg), inputs, lambda: P.Model(pcfg, device="cpu"),
                lambda t: weights.from_jax_aux_model(t, pcfg), lambda sd: jweights.convert_aux_model(sd, cfg))


def _merged_cfg():
    return dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=())


CASES = {
    "model_vanilla": lambda: _model_case("vanilla"),
    "model_linear": lambda: _model_case("linear"),
    "model_none": lambda: _model_case("none"),
    "model_context_no_timestep": lambda: _model_case("vanilla", use_timestep=False, context=True),
    "simple_decoder": lambda: Case(
        J.SimpleDecoder(3), (_rand(3, 1, 6, 6, 32),), lambda: P.SimpleDecoder(32, 3, device="cpu"),
        weights.from_jax_simple_decoder, jweights.convert_simple_decoder),
    "upsample_decoder": lambda: Case(
        J.UpsampleDecoder(out_channels=3, ch=32, num_res_blocks=1, ch_mult=(1, 2)), (_rand(4, 1, 4, 4, 32),),
        lambda: P.UpsampleDecoder(32, 3, 32, 1, (1, 2), device="cpu"),
        lambda t: weights.from_jax_upsample_decoder(t, (1, 2), 1),
        lambda sd: jweights.convert_upsample_decoder(sd, (1, 2), 1)),
    **{f"latent_rescaler_{f}": (lambda f=f: Case(
        J.LatentRescaler(f, 32, 8, depth=1), (_rand(5, 1, 6, 8, 8),),
        lambda: P.LatentRescaler(f, 8, 32, 8, depth=1, device="cpu"),
        lambda t: weights.from_jax_latent_rescaler(t, depth=1),
        lambda sd: jweights.convert_latent_rescaler(sd, depth=1))) for f in (1.0, 1.5, 2.0)},
    **{f"merged_rescale_encoder_{f}": (lambda f=f: Case(
        J.MergedRescaleEncoder(JVAEConfig(**_merged_cfg(), in_channels=3, z_channels=64, double_z=False),
                               out_ch=8, rescale_factor=f),
        (_rand(6, 1, 16, 16, 3),),
        lambda: P.MergedRescaleEncoder(VAEConfig(**_merged_cfg(), in_channels=3, z_channels=64, double_z=False),
                                       out_ch=8, rescale_factor=f, device="cpu"),
        lambda t: weights.from_jax_merged_rescale_encoder(
            t, VAEConfig(**_merged_cfg(), z_channels=64, double_z=False)),
        lambda sd: jweights.convert_merged_rescale_encoder(
            sd, JVAEConfig(**_merged_cfg(), z_channels=64, double_z=False)))) for f in (1.0, 2.0)},
    "merged_rescale_decoder": lambda: Case(
        J.MergedRescaleDecoder(JVAEConfig(**_merged_cfg(), out_ch=3, z_channels=16)), (_rand(7, 1, 4, 4, 16),),
        lambda: P.MergedRescaleDecoder(VAEConfig(**_merged_cfg(), out_ch=3, z_channels=16), device="cpu"),
        lambda t: weights.from_jax_merged_rescale_decoder(t, VAEConfig(**_merged_cfg(), out_ch=3, z_channels=16)),
        lambda sd: jweights.convert_merged_rescale_decoder(sd, JVAEConfig(**_merged_cfg(), out_ch=3,
                                                                          z_channels=16))),
    "upsampler": lambda: Case(
        J.Upsampler(in_size=8, out_size=16, in_channels=32, out_channels=3), (_rand(8, 1, 8, 8, 32),),
        lambda: P.Upsampler(8, 16, 32, 3, device="cpu"),
        lambda t: weights.from_jax_upsampler(t, VAEConfig(z_channels=32, ch=32, ch_mult=(2, 2), out_ch=3)),
        lambda sd: jweights.convert_upsampler(sd, JVAEConfig(z_channels=32, ch=32, ch_mult=(2, 2), out_ch=3))),
    "first_stage_post": lambda: Case(
        J.FirstStagePostProcessor(ch_mult=(1, 2), n_channels=32, do_reshape=True), (_rand(9, 1, 16, 16, 4),),
        lambda: P.FirstStagePostProcessor((1, 2), 4, 32, do_reshape=True, device="cpu"),
        lambda t: weights.from_jax_first_stage_post(t, (1, 2)),
        lambda sd: jweights.convert_first_stage_post(sd, (1, 2))),
}


def _jax_run(case, params):
    args = [None if a is None else jnp.asarray(a) for a in case.inputs]
    return np.asarray(case.jax_module.apply(params, *args))


def _port_run(module, case):
    with torch.no_grad():
        return module(*[None if a is None else torch.tensor(np.asarray(a)) for a in case.inputs]).numpy()


def _jax_params(case, seed):
    args = [None if a is None else jnp.asarray(a) for a in case.inputs]
    return random_jax_params(case.jax_module.init, *args, seed=seed)


@pytest.mark.parametrize("name", list(CASES))
def test_port_matches_jax(name):
    """The port's module loaded through ``from_jax_*`` against the JAX
    module on the same random parameters."""
    case = CASES[name]()
    params = _jax_params(case, seed=11)
    port = case.port().eval()
    port.load_state_dict(case.from_jax(params))
    _close(_port_run(port, case), _jax_run(case, params))


@pytest.mark.parametrize("name", [n for n in CASES if n != "model_none"])
def test_port_names_are_the_references(name):
    """The port module's own state_dict through the JAX package's
    converter (the reference's names) gives the JAX module the port's
    function. (``convert_aux_model`` reads attention weights for every
    ``attn_type``, so "none" has no JAX converter to feed.)"""
    case = CASES[name]()
    torch.manual_seed(3)
    port = case.port().eval()
    perturb_zero_params(port, torch.Generator().manual_seed(4))
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    _close(_jax_run(case, case.to_jax(sd)), _port_run(port, case))


@pytest.mark.parametrize("name", [n for n in CASES if n != "model_none"])
def test_from_jax_round_trips(name):
    """``convert_*(from_jax_*(tree))`` is the JAX tree, bit for bit, and
    ``from_jax_*`` names exactly the port module's parameters."""
    case = CASES[name]()
    params = _jax_params(case, seed=12)
    sd = case.from_jax(params)
    assert set(sd) == set(case.port().state_dict())
    back = case.to_jax(sd)
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert [p for p, _ in flat] == [p for p, _ in jax.tree_util.tree_leaves_with_path(back)]
    for (path, a), b in zip(flat, jax.tree_util.tree_leaves(back)):
        assert np.array_equal(np.asarray(a), np.asarray(b)), path


def test_model_none_has_no_attention_parameters():
    case = CASES["model_none"]()
    sd = case.port().state_dict()
    assert not any(".attn" in k for k in sd)
    assert set(case.from_jax(_jax_params(case, seed=13))) == set(sd)


@pytest.mark.parametrize("temb", [False, True])
def test_resnet_block_t_matches_jax(temb):
    x = jnp.asarray(_rand(20, 2, 5, 6, 32))
    e = jnp.asarray(_rand(21, 2, 48)) if temb else None
    jm = J.ResnetBlockT(64)
    params = random_jax_params(jm.init, x, e, seed=22)
    pm = P.ResnetBlockT(32, 64, 48 if temb else 0).eval()
    out = _Out()
    _resnet_t(out, "b", params["params"])
    pm.load_state_dict({k[2:]: v for k, v in out.items()})
    with torch.no_grad():
        got = pm(torch.tensor(np.asarray(x)), None if e is None else torch.tensor(np.asarray(e)))
    _close(got.numpy(), jm.apply(params, x, e))


def test_lin_attn_block_matches_jax():
    x = jnp.asarray(_rand(23, 2, 5, 6, 32))
    jm = J.LinAttnBlock()
    params = random_jax_params(jm.init, x, seed=24)
    pm = P.LinAttnBlock(32).eval()
    out = _Out()
    _lin_attn(out, "b", params["params"])
    pm.load_state_dict({k[2:]: v for k, v in out.items()})
    assert pm.to_qkv.bias is None
    with torch.no_grad():
        got = pm(torch.tensor(np.asarray(x)))
    _close(got.numpy(), jm.apply(params, x))


@pytest.mark.parametrize("dim", [64, 33])
def test_ddpm_timestep_embedding_matches_jax(dim):
    """Sin first, a zero column for odd ``dim``. The twins' fp32 ``exp``
    may round a frequency one ulp apart, which moves ``sin(t * f)`` by up
    to ulp(t * f) (6e-5 at t 999); each element is held within 4 ulps of
    its argument (and 1e-6)."""
    t = np.array([0, 7, 999])
    got = P.ddpm_timestep_embedding(torch.from_numpy(t), dim).numpy()
    ref = np.asarray(J.ddpm_timestep_embedding(jnp.asarray(t), dim))
    assert got.shape == ref.shape == (3, dim) and got.dtype == np.float32
    half = dim // 2
    freqs = np.exp(np.arange(half) * -(np.log(10000.0) / (half - 1)))
    arg = np.abs(t[:, None] * freqs[None])
    bound = 4 * np.finfo(np.float32).eps * np.concatenate([arg, arg] + ([arg[:, :1] * 0] if dim % 2 else []), 1)
    assert (np.abs(got - ref) <= bound + 1e-6).all()
    _close(got[:2], ref[:2])
    if dim % 2:
        assert not got[:, -1].any()


@pytest.mark.parametrize("factor", [2.0, 1.75, 0.5, 0.3])
def test_torch_nearest_resize_matches_jax(factor):
    x = _rand(25, 2, 8, 10, 3)
    oh, ow = int(round(8 * factor)), int(round(10 * factor))
    got = P.torch_nearest_resize(torch.from_numpy(x), oh, ow)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(J.torch_nearest_resize(jnp.asarray(x), oh, ow)))
    ref = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=(oh, ow), mode="nearest")
    np.testing.assert_array_equal(got.numpy(), ref.permute(0, 2, 3, 1).numpy())


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("factor", [0.5, 0.75, 1.5, 2.0])
def test_resize_2d_matches_jax(mode, factor):
    """Both shrinking (where ``jax.image.resize`` antialiases) and
    enlarging."""
    x = _rand(26, 2, 12, 16, 3)
    got = P.resize_2d(torch.from_numpy(x), factor, mode)
    _close(got.numpy(), J.resize_2d(jnp.asarray(x), factor, mode))


def test_resize_2d_learned_raises_and_factor_one_is_identity():
    x = torch.ones(1, 4, 4, 2)
    with pytest.raises(NotImplementedError):
        P.resize_2d(x, 2.0, learned=True)
    assert P.resize_2d(x, 1.0) is x


def test_modules_take_their_dtype_and_refuse_others():
    m = P.LatentRescaler(1.0, 8, 32, 8, depth=1, dtype=torch.bfloat16, device="cpu")
    assert {p.dtype for p in m.parameters()} == {torch.bfloat16}
    assert m(torch.randn(1, 4, 4, 8)).dtype == torch.bfloat16
    with pytest.raises(ValueError):
        P.SimpleDecoder(32, 3, dtype=torch.float16, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            P.SimpleDecoder(32, 3)
