"""The PyTorch port's sphere sampler on the t2v bundle (text-only
conditioning, t2v_sphere_panorama_pipeline.py) against the JAX package, on
the CPU, in the three overlap modes: the tiny t2v twins, the same noise
(``jax_noise``), frame windows over 8 frames, a per-phi FOV, paste-on-static
in ``last`` and none in the other two, 2 of the 3 table steps;
``close_fp32_chain`` tolerance. The
i2v twins are in tests/test_torch_sphere_sampler.py.
"""

import pytest

import jax

from dynamicscaler_tpu.pipelines import sphere as jsphere
from dynamicscaler_tpu_torch.pipelines import sphere
from torch_port_helpers import close_fp32_chain, jax_noise, smooth_pano, t2v_twin_models

GEOM = dict(equirect_width=64, equirect_height=32, phi_theta_dict={0.0: [0.0, 180.0], 60.0: [0.0]},
            view_fov=110, loop_step_theta=2, phi_fov_dict={60.0: 140.0}, total_f=8, loop_step_frame=2,
            overlap_ratio_list_f=[0.5, 0.25, 0.5], height=16, width=16, frames=4, fps=8, num_inference_steps=3,
            denoise_to_step=2, use_image_cond=False)


@pytest.fixture(scope="module")
def twin_models():
    return t2v_twin_models()


@pytest.mark.parametrize("mode", ["last", "average", "sequential"])
def test_t2v_sphere_sampler_matches_jax(twin_models, mode):
    jmodel, tmodel = twin_models
    pano = smooth_pano(7, 32, 64)
    kw = dict(GEOM, overlap_mode=mode, paste_on_static=mode == "last")
    key = jax.random.PRNGKey(12)
    _, jl, jd = jsphere.sample_shift_sphere_panorama(jmodel, "x", pano, key=key, **kw)
    _, tl, td = sphere.sample_shift_sphere_panorama(tmodel, "x", pano, noise_fn=jax_noise(key), **kw)
    assert tl.shape == (1, 8, 16, 32, 4)
    close_fp32_chain(tl, jl)
    close_fp32_chain(td, jd)
