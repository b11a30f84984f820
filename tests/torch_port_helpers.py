"""Shared helpers of the PyTorch-port tests (tests/test_torch_*.py)."""

import jax
import numpy as np


def random_jax_params(init_fn, *args, seed=0, scale=0.02):
    """A JAX parameter tree of numpy arrays with the shapes ``init_fn``
    declares (``jax.eval_shape``: traced, not compiled), filled as the flax
    initialisers would (kernels N(0, 1/fan_in), norm scales 1, biases 0,
    embeddings N(0, 0.02)); then every all-zero leaf gets N(0, scale)
    values, since zero-initialised layers make a comparison vacuous."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0), *args)

    def fill(path, s):
        name = str(path[-1].key)
        if name == "scale":
            a = np.ones(s.shape, np.float32)
        elif name == "bias":
            a = np.zeros(s.shape, np.float32)
        elif name == "kernel":
            a = rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        else:
            a = 0.02 * rng.standard_normal(s.shape)
        a = np.asarray(a, np.float32)
        if not a.any():
            a = scale * rng.standard_normal(s.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(fill, shapes)
