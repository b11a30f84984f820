"""The port's models/x_transformer.py against the JAX package's, on the CPU.

The knob combinations of ``tests/test_x_transformer.py`` and a few more, at
dim 32, 4 heads of 8, 10 tokens, in fp32, three ways: twins (random JAX
parameters through both modules, the port's loaded by
``weights.from_jax_x_transformer``; relative max error 2e-5, the tolerance of
``tests/test_x_transformer.py``), names (the port's own random weights fed
through the JAX package's ``convert_attention_layers`` /
``convert_transformer_wrapper``, which read the reference's names), and the
converters' round trip bit for bit.
"""

from typing import NamedTuple, Optional

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamicscaler_tpu.models import x_transformer as J
from dynamicscaler_tpu_torch.models import x_transformer as P
from dynamicscaler_tpu_torch.utils import weights
from dynamicscaler_tpu_torch.utils.weights import perturb_zero_params
from torch_port_helpers import random_jax_params

B, N, D = 2, 10, 32
TOL = 2e-5
HEAD = {"dim_head": 8}


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    rel = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12)
    assert rel <= tol, f"relative max error {rel:.3e} > {tol}"


def _rng(seed):
    return np.random.default_rng(seed)


def _mask(n, tail):
    m = np.ones((B, n), bool)
    m[:, n - tail:] = False
    return m


class Case(NamedTuple):
    layers: dict  # AttentionLayers keyword arguments (both packages)
    call: dict  # numpy keyword arguments of the forward
    wrapper: Optional[dict] = None  # TransformerWrapper keyword arguments besides attn_layers_cfg
    wrapper_call: Optional[dict] = None  # and of its forward (not the tokens)


CASES = {
    "plain": Case(dict(dim=D, depth=2, heads=4, attn_kwargs=HEAD), {}),
    "talking_heads_memkv_topk_geglu_gru": Case(
        dict(dim=D, depth=2, heads=4, gate_residual=True, ff_kwargs={"glu": True},
             attn_kwargs={**HEAD, "talking_heads": True, "num_mem_kv": 3, "sparse_topk": 6}), {}),
    "causal_rms_residual_attn_pia_mask": Case(
        dict(dim=D, depth=3, heads=4, causal=True, use_rmsnorm=True, residual_attn=True,
             position_infused_attn=True, attn_kwargs=HEAD), {"mask": _mask(N, 3)}),
    "causal_memkv_mems_topk": Case(
        dict(dim=D, depth=2, heads=4, causal=True, attn_kwargs={**HEAD, "num_mem_kv": 2, "sparse_topk": 4}),
        {"mems": [_rng(30).standard_normal((B, 4, D)).astype(np.float32) for _ in range(2)]}),
    "macaron_postnorm": Case(dict(dim=D, depth=2, heads=4, macaron=True, pre_norm=False, attn_kwargs=HEAD), {}),
    "cross_rezero_postnorm_sandwich_onattn": Case(
        dict(dim=D, depth=3, heads=4, cross_attend=True, use_rezero=True, pre_norm=False, sandwich_coef=1,
             attn_kwargs={**HEAD, "on_attn": True}),
        {"context": _rng(31).standard_normal((B, 7, D)).astype(np.float32), "context_mask": _mask(7, 2)}),
    "only_cross_residual_scalenorm": Case(
        dict(dim=D, depth=2, heads=4, cross_attend=True, only_cross=True, cross_residual_attn=True,
             use_scalenorm=True, attn_kwargs={**HEAD, "talking_heads": True}),
        {"context": _rng(32).standard_normal((B, 5, D)).astype(np.float32), "mask": _mask(N, 2)}),
    "scalenorm_par_ratio": Case(dict(dim=D, depth=4, heads=4, use_scalenorm=True, par_ratio=4, attn_kwargs=HEAD), {}),
    "custom_layers_ff_mult": Case(
        dict(dim=D, depth=1, heads=4, custom_layers=("a", "f", "f", "a"), attn_kwargs=HEAD,
             ff_kwargs={"mult": 2, "glu": True}), {}),
    "wrapper_project_emb_memory_tokens": Case(
        dict(dim=D, depth=2, heads=4, attn_kwargs=HEAD), {},
        dict(num_tokens=50, max_seq_len=24, emb_dim=24, num_memory_tokens=2), {"mask": _mask(N, 2)}),
    "wrapper_embeddings_project_emb": Case(
        dict(dim=D, depth=2, heads=4, attn_kwargs=HEAD), {},
        dict(num_tokens=50, max_seq_len=24, emb_dim=24), {"return_embeddings": True}),
    "wrapper_tied": Case(dict(dim=D, depth=1, heads=4, attn_kwargs=HEAD), {},
                         dict(num_tokens=50, max_seq_len=24, tie_embedding=True), {}),
    "wrapper_pia_no_pos_emb_mems": Case(
        dict(dim=D, depth=2, heads=4, position_infused_attn=True, attn_kwargs=HEAD), {},
        dict(num_tokens=50, max_seq_len=24),
        {"mems": [_rng(33).standard_normal((B, 3, D)).astype(np.float32) for _ in range(2)]}),
}


def _x(seed=34):
    return _rng(seed).standard_normal((B, N, D)).astype(np.float32)


def _tokens(seed=35):
    return _rng(seed).integers(0, 50, (B, N))


def _j(v):
    if isinstance(v, list):
        return [jnp.asarray(e) for e in v]
    return jnp.asarray(v) if isinstance(v, np.ndarray) else v


def _t(v):
    if isinstance(v, list):
        return [torch.tensor(e) for e in v]
    return torch.tensor(v) if isinstance(v, np.ndarray) else v


def _jax_module(case):
    if case.wrapper is None:
        return J.AttentionLayers(**case.layers)
    return J.TransformerWrapper(attn_layers_cfg=case.layers, **case.wrapper)


def _port_module(case):
    if case.wrapper is None:
        return P.AttentionLayers(**case.layers, device="cpu").eval()
    return P.TransformerWrapper(attn_layers_cfg=case.layers, **case.wrapper, device="cpu").eval()


def _inputs(case):
    if case.wrapper is None:
        return _x(), case.call
    return _tokens(), case.wrapper_call


def _jax_run(case, params):
    inp, kw = _inputs(case)
    return np.asarray(_jax_module(case).apply(params, jnp.asarray(inp), **{k: _j(v) for k, v in kw.items()}))


def _port_run(module, case):
    inp, kw = _inputs(case)
    with torch.no_grad():
        return module(torch.tensor(inp), **{k: _t(v) for k, v in kw.items()}).numpy()


def _jax_params(case, seed):
    inp, kw = _inputs(case)
    jkw = {k: _j(v) for k, v in kw.items()}
    return random_jax_params(lambda key, x: _jax_module(case).init(key, x, **jkw), jnp.asarray(inp), seed=seed)


def _jax_convert(case, sd):
    """The JAX package's converter of a reference-named state dict."""
    lk = case.layers
    flags = dict(use_rezero=lk.get("use_rezero", False), use_scalenorm=lk.get("use_scalenorm", False),
                 use_rmsnorm=lk.get("use_rmsnorm", False), gate_residual=lk.get("gate_residual", False),
                 ff_glu=lk.get("ff_kwargs", {}).get("glu", False))
    types = J.AttentionLayers(**lk).layer_types
    if case.wrapper is None:
        return {"params": J.convert_attention_layers(sd, types, **flags)}
    w = case.wrapper
    return {"params": J.convert_transformer_wrapper(
        sd, types, tie_embedding=w.get("tie_embedding", False),
        has_project_emb=w.get("emb_dim", D) != D, num_memory_tokens=w.get("num_memory_tokens", 0), **flags)}


def _load(port, case, sd):
    """Load ``sd`` into ``port``; the only key it may lack is the logits
    head of a wrapper the JAX run never asked for logits (no ``to_logits``
    in the JAX tree)."""
    missing, unexpected = port.load_state_dict(sd, strict=False)
    no_logits = case.wrapper is not None and not case.wrapper.get("tie_embedding") and \
        case.wrapper_call.get("return_embeddings")
    assert not unexpected and sorted(missing) == (["to_logits.bias", "to_logits.weight"] if no_logits else [])


@pytest.mark.parametrize("name", list(CASES))
def test_port_matches_jax(name):
    case = CASES[name]
    params = _jax_params(case, seed=40)
    port = _port_module(case)
    _load(port, case, weights.from_jax_x_transformer(params, macaron=case.layers.get("macaron", False)))
    _close(_port_run(port, case), _jax_run(case, params))


@pytest.mark.parametrize("name", list(CASES))
def test_port_names_are_the_references(name):
    """The port module's own random weights, its state_dict through the
    JAX converter, give the JAX module the port's function."""
    case = CASES[name]
    torch.manual_seed(5)
    port = _port_module(case)
    perturb_zero_params(port, torch.Generator().manual_seed(6))
    _close(_jax_run(case, _jax_convert(case, port.state_dict())), _port_run(port, case))


@pytest.mark.parametrize("name", list(CASES))
def test_from_jax_round_trips(name):
    """The JAX converter gives the JAX tree back bit for bit, and a
    post-norm stack's unused last norm as an identity norm."""
    case = CASES[name]
    params = _jax_params(case, seed=41)
    sd = weights.from_jax_x_transformer(params, macaron=case.layers.get("macaron", False))
    _load(_port_module(case), case, sd)
    back = _jax_convert(case, sd)
    flat = dict(jax.tree_util.tree_leaves_with_path(params))
    for path, b in jax.tree_util.tree_leaves_with_path(back):
        if path in flat:
            assert np.array_equal(np.asarray(flat.pop(path)), np.asarray(b)), path
        else:  # the last layer's norm of a post-norm stack
            n = len(J.AttentionLayers(**case.layers).layer_types)
            assert not case.layers.get("pre_norm", True) and jax.tree_util.keystr(path).endswith(
                tuple(f"['norm_{n - 1}']['{k}']" for k in ("scale", "bias", "g"))), path
            assert np.array_equal(np.asarray(b), np.zeros_like(b) if path[-1].key == "bias" else np.ones_like(b))
    assert not flat, list(flat)


def test_layer_layouts_match_jax():
    for kw in (dict(depth=3, macaron=True), dict(depth=4, par_ratio=4), dict(depth=3, sandwich_coef=1),
               dict(depth=2, cross_attend=True), dict(depth=2, cross_attend=True, only_cross=True),
               dict(depth=6, par_ratio=3, cross_attend=True), dict(depth=1, custom_layers=("a", "f", "f"))):
        assert P.AttentionLayers(D, heads=4, **kw, device="cpu").layer_types == \
            J.AttentionLayers(D, heads=4, **kw).layer_types, kw
    with pytest.raises(ValueError):
        P.AttentionLayers(D, depth=2, par_ratio=9, device="cpu")


def test_gru_gating_gate_order_is_gru_cells():
    """The cell written out is ``nn.GRUCell``'s own (gates r, z, n), input
    x and hidden state the residual, and JAX's ``GRUGating``."""
    torch.manual_seed(7)
    g = P.GRUGating(D)
    x, r = torch.randn(B * N, D), torch.randn(B * N, D)
    with torch.no_grad():
        got = g(x, r)
        np.testing.assert_allclose(got.numpy(), g.gru(x, r).numpy(), rtol=1e-5, atol=1e-6)
    params = {"params": {k: v.detach().numpy() for k, v in g.gru.state_dict().items()}}
    _close(got.numpy(), J.GRUGating(D).apply(params, jnp.asarray(x.numpy()), jnp.asarray(r.numpy())))


def test_sparse_topk_keeps_ties():
    """Every logit not below the k-th largest survives, ties included: with
    every logit equal, top-2 of 5 keys still averages all 5 values."""
    a = P.Attention(D, dim_head=8, heads=1, sparse_topk=2)
    x = torch.randn(1, 5, D)
    with torch.no_grad():
        a.to_q.weight.zero_()
        got = a(x)[0]
        ref = a.to_out(a.to_v(x).mean(dim=1, keepdim=True).expand(1, 5, 8))
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


def test_entmax_and_causal_encoder_are_refused():
    with pytest.raises(NotImplementedError):
        P.Attention(D, use_entmax15=True)
    with pytest.raises(ValueError):
        P.Encoder(dim=D, depth=1, causal=True, device="cpu")
    enc = P.Encoder(dim=D, depth=1, heads=4, attn_kwargs=HEAD, device="cpu")
    assert enc.layer_types == ("a", "f")


def test_fixed_positional_embedding_matches_jax():
    for dim, n, off in ((32, 10, 0), (32, 7, 3), (16, 5, 11)):
        _close(P.fixed_positional_embedding(dim, n, off).numpy(), J.fixed_positional_embedding(dim, n, off))


def test_modules_take_their_dtype():
    w = P.TransformerWrapper(50, 24, dict(dim=D, depth=1, heads=4, attn_kwargs=HEAD), dtype=torch.bfloat16,
                             device="cpu")
    assert {p.dtype for p in w.parameters()} == {torch.bfloat16}
    assert w(torch.tensor(_tokens()), return_embeddings=True).dtype == torch.bfloat16
