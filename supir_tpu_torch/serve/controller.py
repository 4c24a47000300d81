"""Serving controller: worker registry, liveness and dispatch (the port's
copy of supir_tpu/serve/controller.py, the reference's
llava/serve/controller.py:57-230).

Workers register and heartbeat (expiry 30 s, send interval 15 s), dead
workers are pruned, and requests are dispatched by `lottery` (random,
weighted by speed) or `shortest_queue` (queue length over speed). Only the
stdlib and numpy: the controller touches no device.

    python -m supir_tpu_torch.serve.controller [--port 21001] [--dispatch-method lottery]
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np

CONTROLLER_HEART_BEAT_EXPIRATION = 30.0
WORKER_HEART_BEAT_INTERVAL = 15.0


@dataclasses.dataclass
class WorkerInfo:
    model_names: List[str]
    speed: float
    queue_length: int
    last_heart_beat: float
    check_heart_beat: bool = True


class Registry:
    """Thread-safe worker registry with the reference's dispatch policies."""

    def __init__(self, dispatch_method: str = "shortest_queue"):
        if dispatch_method not in ("lottery", "shortest_queue"):
            raise ValueError(f"unknown dispatch method {dispatch_method!r}")
        self.dispatch_method = dispatch_method
        self.workers: Dict[str, WorkerInfo] = {}
        self.lock = threading.Lock()
        self.rng = np.random.default_rng(0)

    def register(self, name: str, model_names: List[str], speed: float = 1.0,
                 queue_length: int = 0, check_heart_beat: bool = True) -> bool:
        with self.lock:
            self.workers[name] = WorkerInfo(model_names=list(model_names), speed=speed, queue_length=queue_length,
                                            last_heart_beat=time.time(), check_heart_beat=check_heart_beat)
        return True

    def heartbeat(self, name: str, queue_length: int) -> bool:
        """False for a worker the registry does not know: it must re-register."""
        with self.lock:
            w = self.workers.get(name)
            if w is None:
                return False
            w.queue_length = queue_length
            w.last_heart_beat = time.time()
            return True

    def remove_expired(self, now: Optional[float] = None) -> List[str]:
        now = now if now is not None else time.time()
        with self.lock:
            dead = [n for n, w in self.workers.items()
                    if w.check_heart_beat and w.last_heart_beat + CONTROLLER_HEART_BEAT_EXPIRATION < now]
            for n in dead:
                del self.workers[n]
        return dead

    def remove(self, name: str) -> None:
        with self.lock:
            self.workers.pop(name, None)

    def list_models(self) -> List[str]:
        with self.lock:
            names = set()
            for w in self.workers.values():
                names.update(w.model_names)
        return sorted(names)

    def get_worker_address(self, model_name: str) -> str:
        """A worker serving `model_name`, or "" (controller.py:120-160).
        shortest_queue counts the dispatch in the chosen worker's queue
        until its next heartbeat."""
        with self.lock:
            cands = [(n, w) for n, w in self.workers.items() if model_name in w.model_names]
            if not cands:
                return ""
            if self.dispatch_method == "lottery":
                speeds = np.array([w.speed for _, w in cands], np.float32)
                idx = int(self.rng.choice(len(cands), p=speeds / speeds.sum()))
                return cands[idx][0]
            loads = [w.queue_length / max(w.speed, 1e-6) for _, w in cands]
            idx = int(np.argmin(loads))
            cands[idx][1].queue_length += 1
            return cands[idx][0]


class ControllerHandler(BaseHTTPRequestHandler):
    registry: Registry = None  # set by serve_controller

    def log_message(self, *a):
        pass

    def _json(self, code: int, obj) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read(self) -> dict:
        n = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(n) or b"{}")

    def do_POST(self):
        reg = self.registry
        data = self._read()
        if self.path == "/register_worker":
            ok = reg.register(data["worker_name"], data.get("model_names", ["supir"]), data.get("speed", 1.0),
                              data.get("queue_length", 0), data.get("check_heart_beat", True))
            self._json(200, {"exist": ok})
        elif self.path == "/receive_heart_beat":
            self._json(200, {"exist": reg.heartbeat(data["worker_name"], data.get("queue_length", 0))})
        elif self.path == "/list_models":
            reg.remove_expired()
            self._json(200, {"models": reg.list_models()})
        elif self.path == "/get_worker_address":
            reg.remove_expired()
            self._json(200, {"address": reg.get_worker_address(data["model"])})
        elif self.path == "/worker_generate_stream":
            self._proxy_stream(reg, data)
        else:
            self._json(404, {"error": "unknown endpoint"})

    def _proxy_stream(self, reg: Registry, data: dict) -> None:
        """Forward a worker's delimiter-framed stream to the client as it
        arrives (controller.py:193-219); a worker that fails is removed."""
        reg.remove_expired()
        addr = reg.get_worker_address(data.get("model", "supir"))
        if not addr:
            self._json(200, {"text": "", "error_code": 2})
            return
        headers_sent = False
        try:
            req = urllib.request.Request(addr + "/worker_generate_stream", data=json.dumps(data).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.end_headers()
                headers_sent = True
                read1 = getattr(r, "read1", None) or r.read
                while True:
                    b = read1(4096)
                    if not b:
                        break
                    self.wfile.write(b)
                    self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass  # the client went away mid-stream
        except Exception:
            reg.remove(addr)
            if not headers_sent:
                self._json(200, {"text": "", "error_code": 3})


def serve_controller(host: str = "0.0.0.0", port: int = 21001, dispatch_method: str = "shortest_queue"):
    """-> (server, registry); the server is not yet serving (call
    serve_forever, or run it in a thread); port 0 takes a free port."""
    registry = Registry(dispatch_method)
    handler = type("Handler", (ControllerHandler,), {"registry": registry})
    return ThreadingHTTPServer((host, port), handler), registry


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser("supir_tpu_torch controller")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=21001)
    ap.add_argument("--dispatch-method", default="shortest_queue", choices=["lottery", "shortest_queue"])
    args = ap.parse_args(argv)
    httpd, _ = serve_controller(args.host, args.port, args.dispatch_method)
    print(f"controller on {args.host}:{httpd.server_address[1]}")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
