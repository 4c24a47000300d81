"""Model worker: registers with the controller, heartbeats, serves
restoration and caption requests with a concurrency limit (the port's copy
of supir_tpu/serve/worker.py, the reference's llava/serve/model_worker.py:44-230).

    python -m supir_tpu_torch.serve.worker [--port 21002] [--controller http://127.0.0.1:21001] \\
        [--tiny --random_weights] [--device cpu] ...

Registration at start-up, a heartbeat every 15 s carrying the queue length
(re-registering when the controller has forgotten the worker), generate
limited by a semaphore, and errors answered as payloads: an out-of-memory
error (MemoryError, torch.cuda.OutOfMemoryError) as ErrorCode_OOM, after
the allocator's cache is freed, any other exception as ErrorCode_ERROR.

`/worker_generate_stream` answers with frames of json + b"\\0", the
connection's close ending the body. Each work function runs its device
part under a lock of its own, so one per worker: requests may wait on the
semaphore together, but the kernels of two requests never interleave, so
the launch counters and the decode GEMVs' shared scratch
(`ops/quantize.py:_tc_scratch`) see one request at a time, all on the
device's default stream.
"""

from __future__ import annotations

import base64
import io
import json
import threading
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

import torch

from supir_tpu_torch.serve.controller import WORKER_HEART_BEAT_INTERVAL

ErrorCode_OOM = 1
ErrorCode_ERROR = 2


class ModelWorker:
    def __init__(self, controller_addr: str, worker_addr: str, work_fn: Callable[[dict], dict],
                 model_names=("supir",), limit_concurrency: int = 2, register: bool = True):
        self.controller_addr = controller_addr
        self.worker_addr = worker_addr
        self.worker_id = str(uuid.uuid4())[:8]
        self.work_fn = work_fn
        self.model_names = list(model_names)
        self.semaphore = threading.Semaphore(limit_concurrency)
        self.active = 0
        self.lock = threading.Lock()
        self._stop = threading.Event()
        if register:
            self.register_to_controller()
            self.heart_beat_thread = threading.Thread(target=self._heart_beat_loop, daemon=True)
            self.heart_beat_thread.start()

    # -------------------------------------------------------- control plane

    def _post(self, path: str, payload: dict) -> dict:
        req = urllib.request.Request(self.controller_addr + path, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=15) as r:
            return json.loads(r.read())

    def register_to_controller(self) -> None:
        self._post("/register_worker", {"worker_name": self.worker_addr, "model_names": self.model_names,
                                        "check_heart_beat": True, "queue_length": self.queue_length()})

    def _heart_beat_loop(self) -> None:
        while not self._stop.wait(WORKER_HEART_BEAT_INTERVAL):
            try:
                ok = self._post("/receive_heart_beat",
                                {"worker_name": self.worker_addr, "queue_length": self.queue_length()})
                if not ok.get("exist"):
                    self.register_to_controller()  # model_worker.py:98-104
            except Exception:
                pass

    def queue_length(self) -> int:
        with self.lock:
            return self.active

    def stop(self) -> None:
        self._stop.set()

    # -------------------------------------------------------- inference

    def generate(self, params: dict) -> dict:
        """Blocking generate: drains the stream, returns the final payload."""
        last = {"text": "", "error_code": ErrorCode_ERROR, "error": "empty"}
        for last in self.generate_stream(params):
            pass
        return last

    def generate_stream(self, params: dict):
        """Semaphore-limited streaming generate (model_worker.py:123-193):
        yields payload dicts as the work function produces them; a work
        function that returns a generator streams, one that returns a dict
        yields once."""
        if not self.semaphore.acquire(timeout=60):
            yield {"text": "", "error_code": ErrorCode_ERROR, "error": "busy"}
            return
        with self.lock:
            self.active += 1
        try:
            out = self.work_fn(params)
            if hasattr(out, "__next__"):
                yield from out
            else:
                yield out
        except (MemoryError, torch.cuda.OutOfMemoryError) as e:
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            yield {"text": "", "error_code": ErrorCode_OOM, "error": str(e)}
        except Exception as e:  # model_worker.py:194-223
            yield {"text": "", "error_code": ErrorCode_ERROR, "error": str(e)}
        finally:
            with self.lock:
                self.active -= 1
            self.semaphore.release()


class WorkerHandler(BaseHTTPRequestHandler):
    worker: ModelWorker = None  # set by serve_worker

    def log_message(self, *a):
        pass

    def _json(self, code: int, obj) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        data = json.loads(self.rfile.read(n) or b"{}")
        if self.path == "/worker_generate_stream":
            # each partial payload is json + b"\0"; the connection's close ends the body
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.end_headers()
            try:
                for chunk in self.worker.generate_stream(data):
                    self.wfile.write(json.dumps(chunk).encode() + b"\0")
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                pass  # the client went away mid-stream
        elif self.path == "/worker_get_status":
            self._json(200, {"model_names": self.worker.model_names, "speed": 1,
                             "queue_length": self.worker.queue_length()})
        else:
            self._json(404, {"error": "unknown endpoint"})


def serve_worker(worker: ModelWorker, host: str = "0.0.0.0", port: int = 21002) -> ThreadingHTTPServer:
    """The worker's HTTP server (not yet serving); port 0 takes a free port."""
    handler = type("Handler", (WorkerHandler,), {"worker": worker})
    return ThreadingHTTPServer((host, port), handler)


def iter_stream_frames(resp, block: int = 4096):
    """The payload dicts of a delimiter-framed response as its bytes arrive
    (the client side of the b"\\0" protocol). `resp`: any object whose read1
    or read returns b"" at the end. A truncated last frame (a connection
    dropped mid-frame) comes out as an error payload, not an exception."""
    read1 = getattr(resp, "read1", None) or resp.read
    buf = bytearray()
    while True:
        b = read1(block)
        if not b:
            break
        scanned = len(buf)  # no delimiter before here: search only the new bytes
        buf += b
        while (end := buf.find(b"\0", scanned)) >= 0:
            frame = bytes(buf[:end])
            del buf[:end + 1]
            scanned = 0
            if frame:
                yield json.loads(frame)
    if buf.strip():
        try:
            yield json.loads(buf)
        except json.JSONDecodeError:
            yield {"text": "", "error_code": 1, "error": "stream truncated mid-frame"}


def _decode_image(b64: str):
    from PIL import Image

    return Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB")


def caption_work_fn(captioner):
    """A streaming work function for caption requests: yields the growing
    partial caption after every decoded token (the JAX worker yields per
    16-token chunk; the final text is the same). The request's `seed`
    seeds the sampler's torch.Generator."""
    import numpy as np

    lock = threading.Lock()

    def work(params: dict):
        img = np.array(_decode_image(params["image"]))
        with lock:
            for partial in captioner.gen_image_caption_stream(
                    [img], temperature=float(params.get("temperature", 0.2)),
                    top_p=float(params.get("top_p", 0.7)), qs=params.get("prompt") or None,
                    seed=int(params.get("seed", 0))):
                yield {"text": partial[0], "error_code": 0}

    return work


def restoration_work_fn(engine, cfg):
    """A work function for base64-PNG restoration requests: pil_to_array,
    the stage-1 encode, tokenize, prepare_condition, batchify_sample (the
    config's sampler, the request's seed), array_to_pil and a PNG."""
    from supir_tpu_torch.utils.image import array_to_pil, pil_to_array
    from supir_tpu_torch.utils.tokenizer import tokenize

    lock = threading.Lock()

    def work(params: dict) -> dict:
        img = _decode_image(params["image"])
        arr, h0, w0 = pil_to_array(img, upscale=params.get("upscale", 1.0), min_size=params.get("min_size", 1024))
        x = torch.from_numpy(arr)[None]
        tok_p = tokenize([params.get("prompt", "") + cfg.p_p])
        tok_n = tokenize([cfg.n_p])
        with lock:
            z = engine.encode_first_stage_with_denoise(x)
            c, uc = engine.prepare_condition(z, tok_p, tok_p, tok_n, tok_n)
            out = engine.batchify_sample(
                x, c, uc, num_steps=int(params.get("edm_steps", 50)), cfg_scale=float(params.get("s_cfg", 7.5)),
                seed=int(params.get("seed", 0)), color_fix_type=params.get("color_fix_type", "Wavelet"),
                z_override=z)
            pil = array_to_pil(out[0], h0, w0)
        buf = io.BytesIO()
        pil.save(buf, format="PNG")
        return {"image": base64.b64encode(buf.getvalue()).decode(), "error_code": 0}

    return work


def build_parser():
    """The worker's flags and the batch CLI's engine flags
    (`apps/cli.py:add_engine_args`: --opt, --SUPIR_sign, --tiny,
    --random_weights, the dtypes, --device, ...)."""
    import argparse

    from supir_tpu_torch.apps.cli import add_engine_args

    ap = add_engine_args(argparse.ArgumentParser("supir_tpu_torch model worker"))
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=21002)
    ap.add_argument("--controller", default="http://127.0.0.1:21001")
    ap.add_argument("--worker-address", default=None)
    ap.add_argument("--limit-concurrency", type=int, default=2)
    ap.set_defaults(sampler=None, use_tiled_sampling=False)  # the yaml's sampler, untiled
    return ap


def main(argv=None) -> None:
    """Launch a restoration worker and register it with the controller."""
    from supir_tpu_torch.apps.cli import create_engine_from_args

    args = build_parser().parse_args(argv)
    engine, cfg = create_engine_from_args(args)
    httpd = serve_worker(None, args.host, args.port)  # bound first: port 0 names its port
    addr = args.worker_address or f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.RequestHandlerClass.worker = ModelWorker(args.controller, addr, restoration_work_fn(engine, cfg),
                                                   limit_concurrency=args.limit_concurrency)
    print(f"worker {addr} registered with {args.controller}")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
