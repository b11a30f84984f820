"""The port's alternate encoders (``models/encoders_alt.py``) against the JAX
package's, on the CPU, and against ``transformers`` where it imports.

HF CLIP text in its ``last``, ``pooled`` and ``hidden`` modes, T5 v1.1 with
its bucket table, the CLIP + T5 pair, ``ClassEmbedder`` (its dropout draw
handed over from JAX) and ``IdentityEncoder``, at tiny configs. JAX weights
come from a numpy seed (``random_jax_params``) through ``from_jax_hf_clip_text``
/ ``from_jax_t5``; the ``transformers`` models' own state dicts load into
the port's modules unconverted. Tolerances: fp32 twins that differ only in
the order of their sums, atol 1e-5, rtol 1e-4 against JAX; against
``transformers`` the JAX test's, atol 2e-5 (CLIP) and 3e-5 (T5), rtol 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamicscaler_tpu.models import encoders_alt as JEA
from dynamicscaler_tpu_torch.models import encoders_alt as EA
from dynamicscaler_tpu_torch.utils import weights
from torch_port_helpers import random_jax_params

CLIP_KW = dict(vocab_size=99, width=32, layers=3, heads=4, mlp_width=64, context_length=16)
T5_KW = dict(vocab_size=100, d_model=32, d_kv=8, d_ff=48, num_layers=3, num_heads=4,
             relative_attention_num_buckets=8, relative_attention_max_distance=20)


def _tokens(vocab, L=16, B=2, seed=1):
    rng = np.random.default_rng(seed)
    t = rng.integers(1, vocab - 1, (B, L))
    t[:, -3] = vocab - 1  # the EOT id is the largest of the vocabulary (argmax pooling)
    return t.astype(np.int32)


def _close(got, ref, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=atol, rtol=1e-4)


def _port_clip(params, cfg):
    m = EA.HFCLIPTextEncoder(cfg)
    m.load_state_dict(weights.from_jax_hf_clip_text(params, cfg), strict=True)
    return m.eval()


def _port_t5(params, cfg):
    m = EA.T5TextEncoder(cfg)
    m.load_state_dict(weights.from_jax_t5(params, cfg), strict=True)
    return m.eval()


@pytest.mark.parametrize("layer,layer_idx", [("last", None), ("pooled", None), ("hidden", 1), ("hidden", -1)])
def test_hf_clip_text_matches_jax(layer, layer_idx):
    jcfg = JEA.HFCLIPTextConfig(**CLIP_KW, layer=layer, layer_idx=layer_idx)
    cfg = EA.HFCLIPTextConfig(**CLIP_KW, layer=layer, layer_idx=layer_idx)
    toks = _tokens(cfg.vocab_size)
    jm = JEA.HFCLIPTextEncoder(jcfg)
    params = random_jax_params(jm.init, jnp.asarray(toks), seed=2)
    ref = jm.apply(params, jnp.asarray(toks))
    with torch.no_grad():
        got = _port_clip(params, cfg)(torch.from_numpy(toks))
    assert got.shape == ref.shape
    _close(got, ref)


def test_t5_matches_jax():
    jcfg, cfg = JEA.T5Config(**T5_KW), EA.T5Config(**T5_KW)
    toks = _tokens(cfg.vocab_size, L=13, seed=3)
    jm = JEA.T5TextEncoder(jcfg)
    params = random_jax_params(jm.init, jnp.asarray(toks), seed=4)
    ref = jm.apply(params, jnp.asarray(toks))
    with torch.no_grad():
        got = _port_t5(params, cfg)(toks)
    _close(got, ref)


@pytest.mark.parametrize("L", [13, 77])
def test_t5_bucket_table_matches_jax(L):
    for kw in (T5_KW, {}):
        np.testing.assert_array_equal(EA.t5_position_bucket_table(L, EA.T5Config(**kw)),
                                      JEA.t5_position_bucket_table(L, JEA.T5Config(**kw)))


def test_clip_t5_pair_matches_jax():
    jpair = JEA.CLIPT5TextEncoder(JEA.HFCLIPTextConfig(**CLIP_KW), JEA.T5Config(**T5_KW))
    ct, tt = _tokens(99), _tokens(100, L=13, seed=5)
    params = {"clip": random_jax_params(jpair.clip.init, jnp.asarray(ct), seed=6),
              "t5": random_jax_params(jpair.t5.init, jnp.asarray(tt), seed=7)}
    jc, jt = jpair(params, jnp.asarray(ct), jnp.asarray(tt))
    pair = EA.CLIPT5TextEncoder(EA.HFCLIPTextConfig(**CLIP_KW), EA.T5Config(**T5_KW))
    sd = {**{"clip." + k: v for k, v in weights.from_jax_hf_clip_text(params["clip"], pair.clip.cfg).items()},
          **{"t5." + k: v for k, v in weights.from_jax_t5(params["t5"], pair.t5.cfg).items()}}
    pair.load_state_dict(sd, strict=True)
    with torch.no_grad():
        c, t = pair.eval()(ct, tt)
    _close(c, jc)
    _close(t, jt)


def test_class_embedder_matches_jax():
    """The plain lookup, the JAX draw of dropped labels handed over, the
    reserved class, and ``disable_dropout``."""
    jcfg, cfg = JEA.ClassEmbedderConfig(embed_dim=8, n_classes=10), EA.ClassEmbedderConfig(embed_dim=8, n_classes=10)
    jm = JEA.ClassEmbedder(jcfg, ucg_rate=0.5)
    labels = jnp.arange(8) % 9
    params = random_jax_params(jm.init, labels, seed=8)
    m = EA.ClassEmbedder(cfg, ucg_rate=0.5)
    m.load_state_dict({"embedding.weight": torch.from_numpy(np.array(params["params"]["embedding"]))})
    key = jax.random.PRNGKey(3)
    drop = np.array(jax.random.bernoulli(key, 0.5, labels.shape))
    assert 0 < drop.sum() < drop.size
    tl = torch.from_numpy(np.array(labels))
    with torch.no_grad():
        _close(m(tl), jm.apply(params, labels), atol=0)
        _close(m(tl, drop=torch.from_numpy(drop)), jm.apply(params, labels, key=key), atol=0)
        _close(m(tl, drop=torch.from_numpy(drop), disable_dropout=True), jm.apply(params, labels), atol=0)
        g = torch.Generator().manual_seed(0)
        assert m(tl, generator=g).shape == (8, 1, 8)
    np.testing.assert_array_equal(EA.ClassEmbedder.unconditional_labels(cfg, 3).numpy(),
                                  np.asarray(JEA.ClassEmbedder.unconditional_labels(jcfg, 3)))


def test_identity_encoder():
    x = torch.randn(2, 3)
    assert EA.IdentityEncoder().encode(x) is x and JEA.IdentityEncoder().encode(x) is x


# ---------------------------------------------------------------------------
# against transformers, on its own state dicts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layer,layer_idx", [("last", None), ("pooled", None), ("hidden", 1), ("hidden", -1)])
def test_hf_clip_text_loads_clip_text_model(layer, layer_idx):
    transformers = pytest.importorskip("transformers")
    tcfg = transformers.CLIPTextConfig(
        vocab_size=99, hidden_size=32, intermediate_size=64, num_hidden_layers=3, num_attention_heads=4,
        max_position_embeddings=16, hidden_act="quick_gelu", eos_token_id=2)
    torch.manual_seed(0)
    hf = transformers.CLIPTextModel(tcfg).eval()
    m = EA.HFCLIPTextEncoder(dataclasses.replace(EA.HFCLIPTextConfig(**CLIP_KW), layer=layer, layer_idx=layer_idx))
    m.load_state_dict(hf.state_dict(), strict=True)
    toks = torch.from_numpy(_tokens(99).astype(np.int64))
    with torch.no_grad():
        out = hf(input_ids=toks, output_hidden_states=layer == "hidden")
        ref = {"last": out.last_hidden_state, "pooled": out.pooler_output[:, None]}.get(layer)
        if layer == "hidden":
            ref = out.hidden_states[layer_idx]
        _close(m.eval()(toks), ref, atol=2e-5)


def test_t5_loads_t5_encoder_model():
    transformers = pytest.importorskip("transformers")
    tcfg = transformers.T5Config(vocab_size=100, d_model=32, d_kv=8, d_ff=48, num_layers=3, num_heads=4,
                                 relative_attention_num_buckets=8, relative_attention_max_distance=20,
                                 feed_forward_proj="gated-gelu", dropout_rate=0.0)
    torch.manual_seed(0)
    hf = transformers.T5EncoderModel(tcfg).eval()
    m = EA.T5TextEncoder(EA.T5Config(**T5_KW))
    m.load_state_dict(hf.state_dict(), strict=True)
    toks = torch.from_numpy(_tokens(100, L=13, seed=3).astype(np.int64))
    with torch.no_grad():
        _close(m.eval()(toks), hf(input_ids=toks).last_hidden_state, atol=3e-5)
