"""The PyTorch port's sphere sampler (``pipelines/sphere.py``, stage 1 of
gen_pano_360) against the JAX package, on the CPU: the tiny i2v bundle
(JAX parameters -> the port's modules), the same numpy panorama, and the
same noise (the port's ``noise_fn`` reproduces, draw by draw, the JAX
sampler's keys). One test per overlap mode, each covering other options:
paste-on-static with frame windows, per-phi prompts and merge-prev ratios
and the decode (``last``); view get/set scale factors (``average``);
progressive skip-time init and a per-phi FOV (``sequential``); every case
stops after 2 of the 3 table steps (``denoise_to_step``). Tolerance:
``close_fp32_chain`` (the twins differ in the order of their sums). Plus
the on-device earlier-view masks against the host oracle and the JAX
package's. The t2v twins are in tests/test_torch_sphere_sampler_t2v.py.
"""

import numpy as np
import pytest
import torch

import jax

from dynamicscaler_tpu.pipelines import sphere as jsphere
from dynamicscaler_tpu_torch.ops.sphere import make_sphere_views
from dynamicscaler_tpu_torch.pipelines import sphere
from torch_port_helpers import close_fp32_chain, i2v_twin_models, jax_noise, smooth_pano

# a 32x64 equirect (16x32 latent at the tiny VAE's scale 2) seen through
# 16x16 views (8x8 latent windows), 4 views per phase, 2 phases
GRID = {0.0: [0.0, 180.0], 60.0: [90.0], -60.0: [270.0]}
GEOM = dict(equirect_width=64, equirect_height=32, phi_theta_dict=GRID, view_fov=110, loop_step_theta=2,
            height=16, width=16, frames=4, fps=8, num_inference_steps=3, denoise_to_step=2)
CASES = {
    "last": dict(total_f=8, loop_step_frame=2, overlap_ratio_list_f=[0.5] * 3,
                 merge_prev_denoised_ratio_list=[0.3, 0.2, 0.0], phi_prompt_dict={60.0: "sky", -60.0: "sea"},
                 paste_on_static=True, decode=True),
    "average": dict(total_f=4, paste_on_static=True, view_get_scale_factor=2, view_set_scale_factor=2),
    "sequential": dict(total_f=4, paste_on_static=False, use_skip_time=True, skip_time_step_idx=2,
                       progressive_skip=True, phi_fov_dict={60.0: 130.0}),
}


@pytest.fixture(scope="module")
def twin_models():
    return i2v_twin_models()


@pytest.mark.parametrize("mode", ["last", "average", "sequential"])
def test_i2v_sphere_sampler_matches_jax(twin_models, mode):
    jmodel, tmodel = twin_models
    pano = smooth_pano(1, 32, 64)
    kw = dict(GEOM, overlap_mode=mode, **CASES[mode])
    key = jax.random.PRNGKey(3)
    jv, jl, jd = jsphere.sample_shift_sphere_panorama(jmodel, "ocean", pano, key=key, **kw)
    tv, tl, td = sphere.sample_shift_sphere_panorama(tmodel, "ocean", pano, noise_fn=jax_noise(key), **kw)
    assert tl.shape == td.shape == (1, kw["total_f"], 16, 32, 4)
    close_fp32_chain(tl, jl)
    close_fp32_chain(td, jd)
    if kw.get("decode"):
        assert tv.shape == (1, kw["total_f"], 32, 64, 3)
        close_fp32_chain(tv, jv)


@pytest.mark.parametrize("scale,f_origins,total_f", [(1, [0], 4), (2, [2, 6, 0], 8)])
def test_device_sphere_masks_match_the_host_oracle(scale, f_origins, total_f):
    """Coverage written at the set scale's footprint, read through the
    native maps; against the port's and the JAX package's host oracles."""
    views = [(110, t, p) for p, ts in GRID.items() for t in ts]
    native = make_sphere_views(views, 8, 8, 16, 32)
    wide = make_sphere_views(views, 8 * scale, 8 * scale, 16, 32)
    gather = np.stack([v.gather_idx for v in native])
    valid = np.stack([v.valid for v in native])
    scatter = np.stack([v.scatter_idx for v in wide])
    ref = sphere.sphere_earlier_masks(scatter, f_origins, 4, total_f, 16 * 32, gather, valid)
    jref = jsphere.sphere_earlier_masks(scatter, f_origins, 4, total_f, 16 * 32, gather, valid)
    assert np.array_equal(ref, jref) and 0 < ref.mean() < 1
    pairs = [(v, f0) for f0 in f_origins for v in range(len(views))]
    got = sphere.device_sphere_masks(torch.from_numpy(gather).long(), torch.from_numpy(valid).float(),
                                     torch.from_numpy(scatter).long(), [v for v, _ in pairs],
                                     [f for _, f in pairs], 4, total_f, 16 * 32)
    assert np.array_equal(got.numpy(), ref)
