"""Web demo (counterpart of supir_tpu/apps/web_demo.py; the reference
gradio_demo.py surface without gradio): a stdlib HTTP server with a
single-page UI and a JSON API for the three-stage flow, stage 1 (the
denoise), caption, stage 2 (the restore), with the Quality/Fidelity
presets, per-event history and feedback logging (gradio_demo.py:90-186)
and the Q/F checkpoint hot swap.

    python -m supir_tpu_torch.apps.web_demo [--port 7860] [--device cpu] [--tiny --random_weights] ...

The flags are the batch CLI's engine and captioner flags
(`apps/cli.py:add_engine_args`), plus --port.
Requests run on the server's threads; one lock serialises every engine
and captioner call, so the launch counters, the GEMVs' shared scratch and
the hot swap see one request at a time, all on the device's default
stream. The server answers an exception with `{"error": ...}`, as the
JAX demo does (web_demo.py:245-246).

Hot swap: `param_sets` maps a sign (Q, F) to a host state dict or a
zero-argument loader (`utils/checkpoint.py:convert_and_cache`), as the
reference keeps both state dicts in RAM (gradio_demo.py:52, 99-107). A
loader runs once and its result is kept; the first swap away from a
sign keeps a host copy of the engine's weights under it, so swapping
back copies host to device and converts nothing.
"""

from __future__ import annotations

import base64
import io
import json
import os
import threading
import time
import traceback
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from supir_tpu_torch.utils.image import array_to_pil, pil_to_array
from supir_tpu_torch.utils.tokenizer import tokenize

INDEX_HTML = """<!doctype html>
<html><head><title>supir-tpu-torch</title><style>
body{font-family:sans-serif;max-width:1100px;margin:2em auto}
img{max-width:520px;border:1px solid #ccc}
.row{display:flex;gap:1em}.col{flex:1}
label{display:block;margin-top:.5em}
</style></head><body>
<h2>SUPIR (PyTorch/CUDA) — photo-realistic image restoration</h2>
<input type="file" id="file" accept="image/*">
<div class="row">
 <div class="col">
  <label>Prompt <input id="prompt" size="50" value=""></label>
  <label>Steps <input id="steps" type="number" value="50"></label>
  <label>CFG <input id="cfg" type="number" step="0.5" value="7.5"></label>
  <label>Upscale <input id="upscale" type="number" step="0.5" value="2"></label>
  <label>Gamma <input id="gamma" type="number" step="0.1" min="0.1" max="2" value="1"></label>
  <label>Preset <select id="preset"><option>Quality</option><option>Fidelity</option></select></label>
  <label>Model <select id="model"><option>Q</option><option>F</option></select></label>
  <label>Color fix <select id="colorfix"><option>Wavelet</option><option>AdaIn</option><option>None</option></select></label>
  <button onclick="run('stage1')">Stage 1 (denoise)</button>
  <button onclick="run('caption')">Caption</button>
  <button onclick="run('stage2')">Stage 2 (restore)</button>
  <p id="status"></p><p id="caption"></p>
 </div>
 <div class="col"><h4>Input</h4><img id="inimg"></div>
 <div class="col"><h4>Output</h4><img id="outimg">
  <div><button onclick="feedback(1)">&#128077;</button>
  <button onclick="feedback(-1)">&#128078;</button></div></div>
</div>
<script>
let lastEvent = null;
document.getElementById('file').onchange = e => {
  const r = new FileReader();
  r.onload = () => document.getElementById('inimg').src = r.result;
  r.readAsDataURL(e.target.files[0]);
};
async function run(stage){
  const img = document.getElementById('inimg').src;
  if(!img){alert('load an image');return}
  document.getElementById('status').textContent = stage + ' running...';
  const body = {stage, image: img.split(',')[1],
    prompt: document.getElementById('prompt').value,
    edm_steps: +document.getElementById('steps').value,
    s_cfg: +document.getElementById('cfg').value,
    upscale: +document.getElementById('upscale').value,
    gamma_correction: +document.getElementById('gamma').value,
    preset: document.getElementById('preset').value,
    model_select: document.getElementById('model').value,
    color_fix_type: document.getElementById('colorfix').value};
  const t0 = performance.now();
  const res = await fetch('/api/' + stage, {method:'POST', body: JSON.stringify(body)});
  const out = await res.json();
  lastEvent = out.event_id;
  document.getElementById('status').textContent =
    stage + ' done in ' + ((performance.now()-t0)/1000).toFixed(1) + 's';
  if(out.caption !== undefined) document.getElementById('caption').textContent = out.caption;
  if(out.image) document.getElementById('outimg').src = 'data:image/png;base64,' + out.image;
}
async function feedback(score){
  if(!lastEvent) return;
  await fetch('/api/feedback', {method:'POST',
    body: JSON.stringify({event_id: lastEvent, score})});
}
</script></body></html>"""

PRESETS = {
    # default_setting block (options/SUPIR_v0.yaml:157-163)
    "Quality": dict(s_cfg=7.5, spt_linear_CFG=4.0),
    "Fidelity": dict(s_cfg=4.0, spt_linear_CFG=1.0),
}


def host_state_dict(model: torch.nn.Module) -> dict:
    """A host copy of the model's state dict (no tensor shared with it)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}


class DemoServer:
    def __init__(self, engine, cfg, captioner=None, history_dir="./history", param_sets=None, active_sign="Q"):
        """param_sets: {'Q': state_dict_or_loader, 'F': ...}; a state dict
        given for the active sign must not share tensors with the engine
        (a swap overwrites those in place)."""
        self.engine = engine
        self.cfg = cfg
        self.captioner = captioner
        self.history_dir = history_dir
        self.param_sets = dict(param_sets or {})
        self.active_sign = active_sign
        self.lock = threading.Lock()
        os.makedirs(history_dir, exist_ok=True)

    def select_model(self, sign: str) -> str:
        """Load checkpoint `sign` into the engine's modules."""
        if sign == self.active_sign:
            return sign
        if sign not in self.param_sets:
            raise ValueError(f"unknown checkpoint {sign!r}; available: {sorted(self.param_sets)}")
        sd = self.param_sets[sign]
        if callable(sd):
            sd = sd()
            self.param_sets[sign] = sd  # materialise once, keep on the host
        if self.active_sign not in self.param_sets:
            self.param_sets[self.active_sign] = host_state_dict(self.engine.model)
        self.engine.load_weights(sd)
        self.active_sign = sign
        return sign

    def _log_event(self, kind, params, images: dict) -> str:
        event_id = time.strftime("%Y%m%d_%H%M%S") + "_" + uuid.uuid4().hex[:6]
        d = os.path.join(self.history_dir, event_id)
        os.makedirs(d, exist_ok=True)
        clean = {k: v for k, v in params.items() if k != "image"}
        with open(os.path.join(d, "params.json"), "w") as f:
            json.dump({"kind": kind, **clean}, f, indent=2)
        for name, img in images.items():
            img.save(os.path.join(d, name + ".png"))
        return event_id

    def feedback(self, event_id: str, score: int) -> bool:
        d = os.path.join(self.history_dir, event_id)
        if os.path.isdir(d):
            with open(os.path.join(d, "feedback.json"), "w") as f:
                json.dump({"score": score, "ts": time.time()}, f)
            return True
        return False

    # ------------------------------------------------------------ stages

    @staticmethod
    def _decode_image(params):
        from PIL import Image

        return Image.open(io.BytesIO(base64.b64decode(params["image"]))).convert("RGB")

    @staticmethod
    def _png(pil) -> str:
        buf = io.BytesIO()
        pil.save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()

    def stage1(self, params: dict) -> dict:
        img = self._decode_image(params)
        arr, _, _ = pil_to_array(img, upscale=1.0, min_size=512, fix_resize=512,
                                 gamma=float(params.get("gamma_correction", 1.0)))
        with self.lock:
            out = self.engine.batchify_denoise(torch.from_numpy(arr)[None])
            pil = array_to_pil(out[0])
        event_id = self._log_event("stage1", params, {"in": img, "out": pil})
        return {"image": self._png(pil), "event_id": event_id}

    def caption(self, params: dict) -> dict:
        img = self._decode_image(params)
        if self.captioner is None:
            return {"caption": "", "event_id": "", "error": "captioner unavailable"}
        with self.lock:
            cap = self.captioner.gen_image_caption([np.asarray(img)])[0]
        event_id = self._log_event("caption", {**params, "caption": cap}, {"in": img})
        return {"caption": cap, "event_id": event_id}

    def stage2(self, params: dict) -> dict:
        img = self._decode_image(params)
        preset = PRESETS.get(params.get("preset", "Quality"), PRESETS["Quality"])
        arr, h0, w0 = pil_to_array(img, upscale=float(params.get("upscale", 1.0)),
                                   min_size=int(params.get("min_size", 1024)),
                                   gamma=float(params.get("gamma_correction", 1.0)))
        x = torch.from_numpy(arr)[None]
        prompt = params.get("prompt", "") + self.cfg.p_p
        tok_p, tok_n = tokenize([prompt]), tokenize([self.cfg.n_p])
        with self.lock:
            if params.get("model_select"):
                self.select_model(params["model_select"])
            z = self.engine.encode_first_stage_with_denoise(x)
            c, uc = self.engine.prepare_condition(z, tok_p, tok_p, tok_n, tok_n)
            out = self.engine.batchify_sample(
                x, c, uc, num_steps=int(params.get("edm_steps", 50)),
                cfg_scale=float(params.get("s_cfg", preset["s_cfg"])), use_linear_cfg=True,
                cfg_scale_start=preset["spt_linear_CFG"], color_fix_type=params.get("color_fix_type", "Wavelet"),
                seed=int(params.get("seed", 0)), z_override=z,
            )
            pil = array_to_pil(out[0], h0, w0)
        event_id = self._log_event("stage2", params, {"in": img, "out": pil})
        return {"image": self._png(pil), "event_id": event_id}


def serve_demo(demo: DemoServer, host="0.0.0.0", port=7860) -> ThreadingHTTPServer:
    """The demo's HTTP server (not yet serving: call serve_forever, or
    run it in a thread); port 0 takes a free port (server_address[1])."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, body: bytes, content_type: str):
            self.send_response(200)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            self._send(INDEX_HTML.encode(), "text/html")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            params = json.loads(self.rfile.read(n) or b"{}")
            try:
                if self.path == "/api/stage1":
                    out = demo.stage1(params)
                elif self.path == "/api/caption":
                    out = demo.caption(params)
                elif self.path == "/api/stage2":
                    out = demo.stage2(params)
                elif self.path == "/api/feedback":
                    out = {"ok": demo.feedback(params["event_id"], params["score"])}
                else:
                    out = {"error": "unknown endpoint"}
            except Exception as e:  # the server keeps answering; the client sees the error
                traceback.print_exc()
                out = {"error": str(e)}
            self._send(json.dumps(out).encode(), "application/json")

    return ThreadingHTTPServer((host, port), Handler)


def create_demo_from_args(args, history_dir: str = "./history") -> DemoServer:
    """The engine (and captioner, unless --no_llava) the batch CLI builds
    from these flags, in a DemoServer; for a full model whose yaml names
    the other sign's SUPIR checkpoint and it exists, that sign loads lazily
    through convert_and_cache (cache: .ckpt_cache/)."""
    from supir_tpu_torch.apps.cli import create_captioner_from_args, create_engine_from_args

    engine, cfg = create_engine_from_args(args)
    param_sets = {}
    if not args.tiny:
        from supir_tpu_torch.config import load_yaml_config
        from supir_tpu_torch.utils.checkpoint import convert_and_cache

        _, extras = load_yaml_config(args.opt)
        other = "F" if args.SUPIR_sign == "Q" else "Q"
        sdxl, sp = extras.get("SDXL_CKPT"), extras.get(f"SUPIR_CKPT_{other}")
        if sdxl and sp and os.path.exists(sdxl) and os.path.exists(sp):
            param_dtype = torch.float32 if args.loading_half_params is False else None
            param_sets[other] = lambda: convert_and_cache(cfg, sdxl, sp, cache_dir=".ckpt_cache", sign=other,
                                                          cond_cfg=engine.cond_cfg, param_dtype=param_dtype)
    captioner = create_captioner_from_args(args, engine.device)
    return DemoServer(engine, cfg, captioner=captioner, history_dir=history_dir, param_sets=param_sets,
                      active_sign=args.SUPIR_sign)


def build_parser():
    """The CLI's engine and captioner flags, plus --port; a request carries
    the sampling settings."""
    import argparse

    from supir_tpu_torch.apps.cli import add_engine_args

    ap = add_engine_args(argparse.ArgumentParser("supir_tpu_torch web demo"))
    ap.add_argument("--port", type=int, default=7860)
    ap.set_defaults(sampler=None, use_tiled_sampling=False)  # stage 2 runs the yaml's sampler, untiled
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    demo = create_demo_from_args(args)
    httpd = serve_demo(demo, port=args.port)
    print(f"demo on http://0.0.0.0:{httpd.server_address[1]}")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
