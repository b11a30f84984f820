"""The PyTorch port's demo (``cli/demo.py``) against the JAX package's, on
the CPU.

* ``parse_args`` and ``_parse_multipart`` equal to JAX's.
* The HTTP server on the tiny random CPU models (``build_model`` of
  ``--dev_tiny``): the page (the i2v form only for an i2v bundle),
  ``POST /generate`` and a multipart ``POST /generate_i2v`` each answered
  with the clip inlined as a GIF of 4 frames of 32x32, 400 for an i2v
  request with no image, 503 while a generation runs (a demo object that
  waits on an event).
* The steps clamped at 60; the card route's refusals (``--dtype`` other
  than bfloat16 or float32, no card).
* ``get_prompt`` and ``get_image`` latents against the JAX demo's on the
  tiny twin bundles, the port handed the JAX draws of ``PRNGKey(seed)``,
  within ``close_fp32_chain``.
"""

import base64
import http.client
import io as pyio
import re
import threading

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from dynamicscaler_tpu.cli import demo as jdemo
from dynamicscaler_tpu.pipelines import i2v as ji2v
from dynamicscaler_tpu.pipelines import t2v as jt2v
from dynamicscaler_tpu_torch.cli import demo
from dynamicscaler_tpu_torch.pipelines import i2v, t2v
from torch_port_helpers import close_fp32_chain, i2v_twin_models, t2v_twin_models

BOUNDARY = "xDEMOBOUNDARYx"


def _multipart(fields, image_png=None):
    parts = [f'--{BOUNDARY}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n'.encode() + v + b"\r\n"
             for k, v in fields.items()]
    if image_png is not None:
        parts.append(f'--{BOUNDARY}\r\nContent-Disposition: form-data; name="image"; filename="in.png"\r\n'
                     "Content-Type: image/png\r\n\r\n".encode() + image_png + b"\r\n")
    return b"".join(parts) + f"--{BOUNDARY}--\r\n".encode()


def _png(seed=0, h=40, w=48):
    buf = pyio.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, "PNG")
    return buf.getvalue()


MULTIPART_HEADERS = {"Content-Type": f"multipart/form-data; boundary={BOUNDARY}"}
FORM_HEADERS = {"Content-Type": "application/x-www-form-urlencoded"}


def test_parse_args_match_jax():
    for argv in ([], ["--dev_tiny", "--mode", "i2v", "--port", "0", "--result_dir", "r", "--dtype", "float32"],
                 ["--ckpt_path", "m.ckpt", "--bpe_path", "b.txt.gz"]):
        assert vars(demo.parse_args(argv)) == vars(jdemo.parse_args(argv))


def test_parse_multipart_matches_jax():
    body = _multipart({"prompt": "a swan é".encode(), "steps": b"3", "cfg": b"7.5"}, _png())
    headers = {"Content-Type": MULTIPART_HEADERS["Content-Type"]}
    got = demo._parse_multipart(headers, body)
    assert got == jdemo._parse_multipart(headers, body)
    assert got["prompt"] == "a swan é" and got["image"] == _png()


@pytest.fixture
def serve(tmp_path):
    """Start a demo server on a free port; yields a function of
    (handler-or-model) -> connection; shuts every server down after."""
    servers = []

    def start(model=None, handler=None):
        if handler is not None:
            server = demo.ThreadingHTTPServer(("127.0.0.1", 0), handler)
        else:
            server = demo.make_server(model, port=0, result_dir=str(tmp_path),
                                      defaults={"steps": 2, "height": 32, "width": 32})
        threading.Thread(target=server.serve_forever, daemon=True).start()
        servers.append(server)
        return lambda: http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)

    yield start
    for s in servers:
        s.shutdown()
        s.server_close()


def _post(conn, path, body, headers):
    conn.request("POST", path, body=body, headers=headers)
    r = conn.getresponse()
    return r.status, r.read().decode()


def _inlined_gif(page):
    m = re.search(r'data:image/gif;base64,([A-Za-z0-9+/=]+)"', page)
    assert m, page[-500:]
    with Image.open(pyio.BytesIO(base64.b64decode(m.group(1)))) as im:
        return im.n_frames, im.size


@pytest.mark.parametrize("mode", ["t2v", "i2v"])
def test_server_generates(mode, serve):
    model, defaults = demo.build_model(demo.parse_args(["--dev_tiny", "--mode", mode]))
    assert defaults == {"steps": 4, "height": 32, "width": 32} and model.device.type == "cpu"
    conn = serve(model)()
    conn.request("GET", "/")
    page = conn.getresponse().read().decode()
    assert "Generate" in page and "Prompt" in page
    assert ("/generate_i2v" in page and 'type="file"' in page) == (mode == "i2v")
    if mode == "t2v":
        status, page = _post(conn, "/generate", "prompt=a+swan&steps=2&cfg=7.5&seed=1", FORM_HEADERS)
    else:
        body = _multipart({"prompt": b"a swan", "steps": b"2", "cfg": b"7.5", "seed": b"1"}, _png())
        status, page = _post(conn, "/generate_i2v", body, MULTIPART_HEADERS)
    assert status == 200
    assert _inlined_gif(page) == (4, (32, 32))  # temporal_length frames at the defaults' 32x32
    assert "a swan" in page


def test_i2v_request_without_image_is_400(serve):
    model, _ = demo.build_model(demo.parse_args(["--dev_tiny", "--mode", "i2v"]))
    conn = serve(model)()
    status, page = _post(conn, "/generate_i2v", _multipart({"prompt": b"a swan"}), MULTIPART_HEADERS)
    assert status == 400 and "No image uploaded" in page


def test_busy_server_answers_503(serve, tmp_path):
    """A request that arrives while a generation runs gets 503 and starts
    nothing; the first one then completes."""
    started, release, calls = threading.Event(), threading.Event(), []
    gif = tmp_path / "x.gif"
    Image.new("RGB", (8, 8)).save(gif)

    class Waiting:
        def get_prompt(self, prompt, **kw):
            calls.append(prompt)
            started.set()
            assert release.wait(60)
            return str(gif)

    connect = serve(handler=demo._build_handler(Waiting(), {"steps": 2, "height": 32, "width": 32}))
    first = {}
    t = threading.Thread(target=lambda: first.update(r=_post(connect(), "/generate", "prompt=one", FORM_HEADERS)))
    t.start()
    assert started.wait(60)
    status, page = _post(connect(), "/generate", "prompt=two", FORM_HEADERS)
    release.set()
    t.join(60)
    assert status == 503 and "Busy" in page
    assert first["r"][0] == 200 and calls == ["one"]


def test_steps_clamped_at_60(monkeypatch, tmp_path):
    seen = []

    def fake(model, prompt, *a, num_inference_steps, **kw):
        seen.append(num_inference_steps)
        return torch.zeros((1, 4, 8, 8, 3)), None

    monkeypatch.setattr(t2v, "basic_sample", fake)
    monkeypatch.setattr(i2v, "basic_sample", fake)
    model, _ = demo.build_model(demo.parse_args(["--dev_tiny", "--mode", "i2v"]))
    demo.Text2Video(model, str(tmp_path)).get_prompt("x", steps=100)
    demo.Image2Video(model, str(tmp_path)).get_image(np.zeros((8, 8, 3), np.uint8), "x", steps=61)
    demo.Text2Video(model, str(tmp_path)).get_prompt("x", steps=7)
    assert seen == [60, 60, 7]


@pytest.mark.parametrize("argv,error,match", [
    (["--dtype", "float16"], ValueError, "bfloat16 only"),
    (["--ckpt_path", "t2v.ckpt"], RuntimeError, "CUDA card"),
])
def test_card_route_refusals(argv, error, match, monkeypatch):
    """Without ``--dev_tiny`` the bundle goes on the card: ``--dtype``
    other than bfloat16 or float32 is refused, and so is a machine without a
    card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(error, match=match):
        demo.build_model(demo.parse_args(argv))


def _capture(monkeypatch, module, store):
    fn = module.basic_sample

    def wrapped(*a, **kw):
        video, latent = fn(*a, **kw)
        store.append(np.array(latent))
        return video, latent

    monkeypatch.setattr(module, "basic_sample", wrapped)


@pytest.mark.parametrize("mode", ["t2v", "i2v"])
def test_latents_match_jax(mode, monkeypatch, tmp_path):
    jmodel, tmodel = t2v_twin_models(seed=41) if mode == "t2v" else i2v_twin_models(seed=43)
    seed = 7
    key = jax.random.PRNGKey(seed)
    noise = lambda name, shape: np.array(jax.random.normal(key, shape))  # noqa: E731
    jl, tl = [], []
    _capture(monkeypatch, jt2v if mode == "t2v" else ji2v, jl)
    _capture(monkeypatch, t2v if mode == "t2v" else i2v, tl)
    kw = dict(steps=3, cfg_scale=7.5, seed=seed, height=32, width=32)
    if mode == "t2v":
        jdemo.Text2Video(jmodel, str(tmp_path / "jax")).get_prompt("a sailing boat", **kw)
        path = demo.Text2Video(tmodel, str(tmp_path / "port")).get_prompt("a sailing boat", _noise=noise, **kw)
    else:
        img = np.random.default_rng(3).integers(0, 256, (32, 32, 3), dtype=np.uint8)
        jdemo.Image2Video(jmodel, str(tmp_path / "jax")).get_image(img, "a sailing boat", **kw)
        path = demo.Image2Video(tmodel, str(tmp_path / "port")).get_image(img, "a sailing boat", _noise=noise,
                                                                          **kw)
    assert path == str(tmp_path / "port" / "a_sailing_boat.avi")  # no mp4 backend here: the AVI + PNG writer
    with Image.open(tmp_path / "port" / "a_sailing_boat.gif") as im:
        assert (im.n_frames, im.size) == (4, (32, 32))
    assert len(jl) == len(tl) == 1 and tl[0].shape == jl[0].shape == (1, 4, 16, 16, 4)
    close_fp32_chain(torch.from_numpy(tl[0]), jl[0])
