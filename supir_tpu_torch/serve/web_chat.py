"""The captioner's web chat (the port's copy of supir_tpu/serve/web_chat.py,
the reference's llava/serve/gradio_web_server.py surface without gradio):
a stdlib HTTP page with the controller's model list, an image upload and a
multi-turn history, each message routed through `/get_worker_address` to a
worker's `/worker_generate_stream`.

    python -m supir_tpu_torch.serve.web_chat [--controller http://127.0.0.1:21001] [--port 7860]
    python -m supir_tpu_torch.serve.web_chat --register-worker http://127.0.0.1:21002
    python -m supir_tpu_torch.serve.web_chat --test-message

Also the reference's two small utilities: `register_worker` (manual
registration, llava/serve/register_worker.py) and `send_test_message`
(a message through dispatch to a worker, llava/serve/test_message.py).
The chat touches no device.
"""

from __future__ import annotations

import base64
import html
import json
import threading
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from supir_tpu_torch.serve.worker import iter_stream_frames


def _post(addr: str, path: str, payload: dict, timeout: float = 600.0) -> dict:
    req = urllib.request.Request(addr + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read() or b"{}")


def _post_stream(addr: str, path: str, payload: dict, timeout: float = 600.0) -> dict:
    """POST to a delimiter-framed streaming endpoint, drain the stream and
    return the final payload."""
    req = urllib.request.Request(addr + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    last: dict = {}
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for last in iter_stream_frames(r):
            pass
    return last


def register_worker(controller_addr: str, worker_addr: str, check_heart_beat: bool = True) -> dict:
    """Register a worker with the controller by hand (register_worker.py:26):
    the worker's own status, forwarded to the controller's registry."""
    status = _post(worker_addr, "/worker_get_status", {})
    return _post(controller_addr, "/register_worker", {
        "worker_name": worker_addr, "check_heart_beat": check_heart_beat,
        "model_names": status.get("model_names", ["supir"]), "speed": status.get("speed", 1.0),
        "queue_length": status.get("queue_length", 0)})


def send_test_message(controller_addr: str, model_name: Optional[str] = None,
                      text: str = "Tell me a story with more than 1000 words.") -> dict:
    """A message through the controller's dispatch to a worker and back
    (test_message.py)."""
    models = _post(controller_addr, "/list_models", {}).get("models", [])
    if not models:
        raise RuntimeError("no models registered")
    model = model_name or models[0]
    addr = _post(controller_addr, "/get_worker_address", {"model": model}).get("address", "")
    if not addr:
        raise RuntimeError(f"no worker for model {model}")
    return _post_stream(addr, "/worker_generate_stream", {"text": text, "prompt": text, "model": model})


_PAGE = """<!doctype html><html><head><title>supir-tpu chat</title><style>
body{{font-family:sans-serif;max-width:820px;margin:2em auto;padding:0 1em}}
.turn{{margin:.6em 0;padding:.6em;border-radius:8px}}
.user{{background:#eef}}.bot{{background:#efe}}
textarea{{width:100%}}img.upload{{max-height:160px}}
</style></head><body>
<h2>supir-tpu captioner chat</h2>
<form method="post" action="/send" enctype="multipart/form-data">
<p>model: <select name="model">{models}</select>
 session: <code>{session}</code>
 <a href="/?session={session}&clear=1">clear</a></p>
<p><input type="file" name="image" accept="image/*"></p>
<textarea name="text" rows="3" placeholder="ask about the image..."></textarea>
<input type="hidden" name="session" value="{session}">
<p><button type="submit">send</button></p>
</form>
<div>{history}</div>
</body></html>"""


def _parse_form(content_type: str, body: bytes) -> Dict[str, bytes]:
    """A urlencoded or multipart/form-data body -> {field: bytes}, with the
    stdlib's email parser (the cgi module is gone from Python 3.13)."""
    from urllib.parse import parse_qs

    if "multipart/form-data" not in content_type:
        return {k: v[0].encode() for k, v in parse_qs(body.decode(errors="replace")).items()}
    import email.parser
    import email.policy

    msg = email.parser.BytesParser(policy=email.policy.HTTP).parsebytes(
        b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + body)
    fields: Dict[str, bytes] = {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if name:
            fields[str(name)] = part.get_payload(decode=True) or b""
    return fields


def _text_field(form: Dict[str, bytes], key: str) -> str:
    return form.get(key, b"").decode(errors="replace").strip()


class ChatState:
    """The sessions' turns, {session: [{'role', 'text'}, ...]}."""

    def __init__(self):
        self.lock = threading.Lock()
        self.sessions: Dict[str, List[dict]] = {}

    def turns(self, sid: str) -> List[dict]:
        with self.lock:
            return list(self.sessions.get(sid, []))

    def append(self, sid: str, role: str, text: str) -> None:
        with self.lock:
            self.sessions.setdefault(sid, []).append({"role": role, "text": text})

    def clear(self, sid: str) -> None:
        with self.lock:
            self.sessions.pop(sid, None)


class WebChatHandler(BaseHTTPRequestHandler):
    controller_addr = ""
    state: ChatState = None  # set by serve_web_chat

    def log_message(self, *a):
        pass

    def _html(self, body: str, code: int = 200) -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _models(self) -> List[str]:
        try:
            return _post(self.controller_addr, "/list_models", {}).get("models", [])
        except Exception:
            return []

    def _render(self, sid: str) -> None:
        options = "".join(f'<option value="{html.escape(m)}">{html.escape(m)}</option>'
                          for m in self._models()) or '<option value="">(no workers)</option>'
        hist = "".join(f'<div class="turn {"user" if t["role"] == "user" else "bot"}">'
                       f'<b>{t["role"]}:</b> {html.escape(t["text"])}</div>' for t in self.state.turns(sid))
        self._html(_PAGE.format(models=options, history=hist, session=sid))

    def do_GET(self):
        from urllib.parse import parse_qs, urlparse

        q = parse_qs(urlparse(self.path).query)
        sid = q.get("session", [uuid.uuid4().hex[:8]])[0]
        if q.get("clear"):
            self.state.clear(sid)
        self._render(sid)

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        form = _parse_form(self.headers.get("Content-Type", ""), self.rfile.read(n))
        sid = _text_field(form, "session") or uuid.uuid4().hex[:8]
        model = _text_field(form, "model")
        text = _text_field(form, "text")
        payload = {"text": text, "prompt": text, "model": model}
        raw = form.get("image")
        if raw:
            payload["image"] = base64.b64encode(raw).decode()
        self.state.append(sid, "user", text)
        try:
            addr = _post(self.controller_addr, "/get_worker_address", {"model": model}).get("address", "")
            if not addr:
                reply = "(no worker available)"
            else:
                out = _post_stream(addr, "/worker_generate_stream", payload)
                reply = out.get("text") or out.get("caption") or json.dumps(out)
        except Exception as e:  # the error shows in the chat, as in the reference's UI
            reply = f"(error: {e})"
        self.state.append(sid, "assistant", reply)
        self.send_response(303)
        self.send_header("Location", f"/?session={sid}")
        self.end_headers()


def serve_web_chat(controller_addr: str, host: str = "0.0.0.0", port: int = 7860) -> ThreadingHTTPServer:
    """The chat's server, serving in a daemon thread; port 0 takes a free port."""
    handler = type("Handler", (WebChatHandler,), {"controller_addr": controller_addr, "state": ChatState()})
    server = ThreadingHTTPServer((host, port), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser("captioner web chat")
    ap.add_argument("--controller", default="http://127.0.0.1:21001")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--register-worker", default=None, help="one-shot: register this worker address and exit")
    ap.add_argument("--test-message", action="store_true", help="one-shot: send a smoke message and exit")
    args = ap.parse_args(argv)
    if args.register_worker:
        print(json.dumps(register_worker(args.controller, args.register_worker)))
        return
    if args.test_message:
        print(json.dumps(send_test_message(args.controller)))
        return
    server = serve_web_chat(args.controller, args.host, args.port)
    print(f"web chat on http://{args.host}:{server.server_address[1]} -> {args.controller}")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
