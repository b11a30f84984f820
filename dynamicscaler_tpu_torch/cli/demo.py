"""Interactive generation demo (PyTorch), the reference's gradio demos.

Counterpart of ``dynamicscaler_tpu/cli/demo.py``. The reference ships
gradio apps around a ``Text2Video`` / ``Image2Video`` class with a
``get_prompt(...)`` entry (scripts/gradio/t2v_test.py:9-61, i2v_test.py);
here the same surface is served two ways:

* :class:`Text2Video` / :class:`Image2Video`, the programmatic demo
  classes;
* a stdlib HTTP app, prompt form -> generate -> inline GIF preview:

    python -m dynamicscaler_tpu_torch.cli.demo --port 7860 \\
        --ckpt_path t2v.ckpt --bpe_path bpe_simple_vocab_16e6.txt.gz
    python -m dynamicscaler_tpu_torch.cli.demo --mode i2v --ckpt_path i2v.ckpt --bpe_path ...
    python -m dynamicscaler_tpu_torch.cli.demo --dev_tiny

The model (VideoCrafter2 t2v, or VideoCrafter i2v with ``--mode i2v``,
which adds the image-upload form) runs on the CUDA card in bf16, or in
fp32 with ``--dtype float32`` (TF32 off); ``--dev_tiny`` serves the tiny
random fp32 model on the CPU. Any other ``--dtype`` on the card is refused
at startup. One generation runs
at a time; a request that arrives meanwhile gets 503.
"""

from __future__ import annotations

import argparse
import base64
import html
import io
import os
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch


def _clip_name(prompt: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in prompt[:30]) or "out"


def _write(video, result_dir: str, prompt: str, fps: int) -> str:
    from dynamicscaler_tpu_torch.utils.io import save_video, to_uint8_device

    return save_video(to_uint8_device(video[0]).cpu().numpy(), result_dir, _clip_name(prompt), fps=fps,
                      save_gif=True)


class Text2Video:
    """Programmatic t2v demo (reference Text2Video.get_prompt,
    scripts/gradio/t2v_test.py:32-61)."""

    def __init__(self, model, result_dir="./tmp/demo"):
        self.model = model
        self.result_dir = result_dir
        os.makedirs(result_dir, exist_ok=True)
        self.save_fps = 8

    def get_prompt(self, prompt, steps=48, cfg_scale=12.0, fps=16, seed=123, height=320, width=512,
                   _noise=None):
        """One clip of ``model.config.unet.temporal_length`` frames, written
        with its GIF; returns the video's path. The noise comes from a
        generator seeded with ``seed`` on the model's device, or from
        ``_noise`` (a sampler ``noise_fn(name, shape)``, for tests)."""
        from dynamicscaler_tpu_torch.pipelines import t2v

        steps = min(int(steps), 60)  # the reference clamps to 60 (:36-37)
        t0 = time.time()
        gen = None if _noise is not None else torch.Generator(device=self.model.device).manual_seed(int(seed))
        video, _ = t2v.basic_sample(
            self.model, prompt, height=height, width=width, guidance_scale=float(cfg_scale),
            frames=self.model.config.unet.temporal_length, num_inference_steps=steps, fps=int(fps),
            generator=gen, noise_fn=_noise,
        )
        path = _write(video, self.result_dir, prompt, self.save_fps)
        print(f"[demo] '{prompt[:40]}' done in {time.time() - t0:.1f}s -> {path}", flush=True)
        return path


class Image2Video:
    """Programmatic i2v demo (reference Image2Video, scripts/gradio/i2v_test.py)."""

    def __init__(self, model, result_dir="./tmp/demo"):
        self.model = model
        self.result_dir = result_dir
        os.makedirs(result_dir, exist_ok=True)
        self.save_fps = 8

    def get_image(self, image, prompt, steps=48, cfg_scale=12.0, fps=16, seed=123, height=320, width=512,
                  _noise=None):
        """``image`` [H, W, 3], float in [-1, 1] or uint8; otherwise as
        :meth:`Text2Video.get_prompt`."""
        from dynamicscaler_tpu_torch.pipelines import i2v

        if image.dtype == np.uint8:
            image = (image.astype(np.float32) / 255.0 - 0.5) * 2
        steps = min(int(steps), 60)
        gen = None if _noise is not None else torch.Generator(device=self.model.device).manual_seed(int(seed))
        video, _ = i2v.basic_sample(
            self.model, prompt, image, height=height, width=width, guidance_scale=float(cfg_scale),
            frames=self.model.config.unet.temporal_length, num_inference_steps=steps, fps=int(fps),
            generator=gen, noise_fn=_noise,
        )
        return _write(video, self.result_dir, prompt, self.save_fps)


_I2V_FORM = """<h3>Image → video (scripts/gradio/i2v_test.py)</h3>
<form method="post" action="/generate_i2v" enctype="multipart/form-data">
<label>Image <input name="image" type="file" accept="image/*" required></label>
<label>Prompt <input name="prompt" size="60" value="a black swan swims on the pond"></label>
<label>Steps <input name="steps" type="number" value="{steps}" min="1" max="60"></label>
<label>CFG scale <input name="cfg" type="number" step="0.5" value="12.0"></label>
<label>Seed <input name="seed" type="number" value="123"></label>
<button type="submit">Generate from image</button>
</form>"""

_PAGE = """<!doctype html><html><head><title>dynamicscaler demo</title>
<style>body{{font-family:sans-serif;max-width:720px;margin:2em auto}}
input,select{{margin:0.2em 0}}label{{display:block;margin-top:0.6em}}</style>
</head><body>
<h2>DynamicScaler — generation demo</h2>
<h3>Text → video</h3>
<form method="post" action="/generate">
<label>Prompt <input name="prompt" size="60" value="a black swan swims on the pond"></label>
<label>Steps <input name="steps" type="number" value="{steps}" min="1" max="60"></label>
<label>CFG scale <input name="cfg" type="number" step="0.5" value="12.0"></label>
<label>Seed <input name="seed" type="number" value="123"></label>
<button type="submit">Generate</button>
</form>
{i2v_form}
{result}
</body></html>"""

_BUSY = "<p>Busy: a generation is already running; retry when it finishes.</p>"


def _parse_multipart(headers, body: bytes):
    """A multipart/form-data body as {field: bytes for a file, else str}
    (stdlib ``email``; ``cgi`` is gone from current Pythons)."""
    from email.parser import BytesParser
    from email.policy import default as default_policy

    msg = BytesParser(policy=default_policy).parsebytes(
        b"Content-Type: " + headers.get("Content-Type", "").encode() + b"\r\n\r\n" + body
    )
    fields = {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if not name:
            continue
        payload = part.get_payload(decode=True)
        fields[name] = payload if part.get_filename() else payload.decode(errors="replace")
    return fields


def _build_handler(t2v_demo, defaults, i2v_demo=None):
    # one generation at a time on the card: a request that finds the lock
    # taken gets 503 at once instead of queueing behind it
    gen_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def _send(self, body: str, code=200):
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):  # quiet
            pass

        def _page(self, result=""):
            i2v_form = _I2V_FORM.format(**defaults) if i2v_demo is not None else ""
            return _PAGE.format(result=result, i2v_form=i2v_form, **defaults)

        def do_GET(self):
            self._send(self._page())

        def _result_html(self, prompt, path):
            # the GIF beside the video is always embeddable
            gif = path if path.endswith(".gif") else os.path.splitext(path)[0] + ".gif"
            show = gif if os.path.exists(gif) else path
            with open(show, "rb") as f:
                b64 = base64.b64encode(f.read()).decode()
            if show.endswith(".gif"):
                tag = f'<img src="data:image/gif;base64,{b64}">'
            else:
                tag = f'<video controls autoplay loop src="data:video/mp4;base64,{b64}"></video>'
            return f"<h3>{html.escape(prompt)}</h3>{tag}<p>{html.escape(show)}</p>"

        def do_POST(self):
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            if not gen_lock.acquire(blocking=False):
                self._send(self._page(_BUSY), 503)
                return
            try:
                if self.path == "/generate_i2v" and i2v_demo is not None:
                    fields = _parse_multipart(self.headers, body)
                    prompt = str(fields.get("prompt", "a black swan"))
                    img_bytes = fields.get("image")
                    if not img_bytes:
                        self._send(self._page("<p>No image uploaded.</p>"), 400)
                        return
                    from PIL import Image

                    img = np.asarray(Image.open(io.BytesIO(img_bytes)).convert("RGB"))
                    path = i2v_demo.get_image(
                        img, prompt, steps=int(fields.get("steps", defaults["steps"])),
                        cfg_scale=float(fields.get("cfg", 12.0)), seed=int(fields.get("seed", 123)),
                        height=defaults["height"], width=defaults["width"],
                    )
                else:
                    form = urllib.parse.parse_qs(body.decode())
                    prompt = form.get("prompt", ["a black swan"])[0]
                    path = t2v_demo.get_prompt(
                        prompt, steps=int(form.get("steps", [defaults["steps"]])[0]),
                        cfg_scale=float(form.get("cfg", [12.0])[0]), seed=int(form.get("seed", [123])[0]),
                        height=defaults["height"], width=defaults["width"],
                    )
            finally:
                gen_lock.release()
            self._send(self._page(self._result_html(prompt, path)))

    return Handler


def make_server(model, port=0, result_dir="./tmp/demo", defaults=None):
    """A ThreadingHTTPServer on 127.0.0.1 serving the demo (port 0: a free
    port). A model with an image encoder also gets the i2v upload form."""
    defaults = defaults or {"steps": 48, "height": 320, "width": 512}
    i2v_demo = Image2Video(model, result_dir=result_dir) if getattr(model, "image_encoder", None) is not None \
        else None
    handler = _build_handler(Text2Video(model, result_dir=result_dir), defaults, i2v_demo=i2v_demo)
    return ThreadingHTTPServer(("127.0.0.1", port), handler)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--mode", choices=["t2v", "i2v"], default="t2v",
                   help="which checkpoint family to serve (i2v adds the image-upload form, reference "
                   "scripts/gradio/i2v_test.py)")
    p.add_argument("--ckpt_path", type=str, default="")
    p.add_argument("--bpe_path", type=str, default="")
    p.add_argument("--result_dir", type=str, default="./tmp/demo")
    p.add_argument("--dtype", type=str, default="bfloat16")
    p.add_argument("--dev_tiny", action="store_true")
    return p.parse_args(argv)


def build_model(args):
    """The bundle and the form's defaults: ``--dev_tiny`` the tiny random
    fp32 model on the CPU (i2v parts for ``--mode i2v``) at 32x32 and 4
    steps; else the checkpoint ``--ckpt_path`` (VideoCrafter2 t2v, or
    VideoCrafter i2v for ``--mode i2v``) with the CLIP BPE file
    ``--bpe_path``, on the card, at 320x512 and 48 steps
    (``cli/sample.py::build_model``)."""
    from dynamicscaler_tpu_torch.cli import sample
    from dynamicscaler_tpu_torch.cli.gen_pano_360 import check_dtype, setup_precision

    check_dtype(args.dtype, args.dev_tiny)
    setup_precision(args.dtype, args.dev_tiny)
    model = sample.build_model(argparse.Namespace(**vars(args), seed=0))
    return model, {"steps": 4, "height": 32, "width": 32} if args.dev_tiny else \
        {"steps": 48, "height": 320, "width": 512}


def main(args):
    model, defaults = build_model(args)
    server = make_server(model, port=args.port, result_dir=args.result_dir, defaults=defaults)
    print(f"[demo] serving on http://127.0.0.1:{server.server_address[1]}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main(parse_args())
