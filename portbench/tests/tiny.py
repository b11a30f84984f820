"""The benchmark's cells at the program's tiny test sizes, for CPU runs."""

import copy
import dataclasses
import json

from portbench import harness


def tiny_model(i2v: bool) -> dict:
    from dynamicscaler_tpu_torch.config import tiny_test_config

    m = json.loads(json.dumps(dataclasses.asdict(tiny_test_config(i2v))))
    m.pop("dtype")
    return m


def tiny_spec(workload: str) -> harness.Spec:
    """``workload`` of BENCHMARK.json with the tiny model and small traffic:
    fp32 on the CPU, the cell's own limits."""
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    real = harness.Spec(workload, bench)
    config = copy.deepcopy(real.config)
    mix = copy.deepcopy(real.mix)
    if mix["kind"] == "sphere_stage":
        config["model"] = tiny_model(True)
        S = 4
        mix.update(equirect_width=64, equirect_height=32, view_fov=110, loop_step_theta=2, total_f=4, frames=4,
                   height=16, width=16, num_inference_steps=S, denoise_to_step=3, loop_step_frame=2,
                   phi_theta={"0": [0, 120, 240], "60": [0]}, overlap_f=[0.5] * S,
                   merge_prev=[0.5, 0.25, 0.0, 0.0], unet_microbatch=2, check_steps=[1, 1], check_views=2,
                   unet_shape={"frames": 4, "h": 8, "w": 8, "ctx_len": 81})
    elif mix["kind"] == "planar_stage":
        config["model"] = tiny_model(True)
        S = 6
        mix.update(total_w=64, total_h=32, total_f=4, frames=4, height=16, width=32, num_windows_w=2, num_windows_h=2,
                   loop_step=2, num_inference_steps=S, skip_time_step_idx=2, overlap_f=[0.5] * S, loop_step_frame=2,
                   merge_prev=[0.5, 0.25, 0.0, 0.0, 0.0, 0.0], unet_microbatch=4, check_steps=[1, 2],
                   unet_shape={"frames": 4, "h": 8, "w": 16, "ctx_len": 81})
    else:
        config["model"] = tiny_model(False)
        mix.update(num_windows_f=2, num_windows_h=1, num_windows_w=2, height=16, width=16, frames=4,
                   num_inference_steps=4, loop_step=2, unet_microbatch=4, check_steps=[1, 2], check_windows=2,
                   unet_shape={"frames": 4, "h": 8, "w": 8, "ctx_len": 77})
    config["dtype"] = "float32"
    return harness.Spec(workload, bench, config, mix)
