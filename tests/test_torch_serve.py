"""The port's serving stack against the JAX package on the CPU: the
controller's registry (dispatch and expiry), the worker against the
controller over localhost (registration, the heartbeat that re-registers,
status, the b"\\0" framing and its truncated tail, busy and error
payloads), the restoration and caption work functions, the web chat, and
the conversation's image messages.

Bounds: restoration PNGs as uint8 within one level of JAX's on all but
0.5 % of the pixels (tests/test_torch_apps.py's bound: fp32 samples 5e-5
apart, then a bicubic resize and a uint8 cast); captions greedy and
exact; registry choices, frames, forms and images exactly equal.
"""

import base64
import io
import json
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from supir_tpu_torch.captioner import conversation as TC
from supir_tpu_torch.serve import controller as TCtl
from supir_tpu_torch.serve import web_chat as TChat
from supir_tpu_torch.serve import worker as TWk
from torch_parity import one_torch_thread  # noqa: F401

PNG_SHARE = 5e-3  # pixels allowed to differ by more than one level


def _png_b64(h=48, w=48, seed=0):
    img = Image.fromarray(np.random.default_rng(seed).integers(0, 255, (h, w, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _decoded(out) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(out["image"]))).convert("RGB"), np.int16)


def _serve(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(addr, path, body):
    req = urllib.request.Request(addr + path, data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read()


# ------------------------------------------------------------------ registry


def _registry_trace(mod, method):
    """The same calls on a registry of `mod` -> everything they returned."""
    reg = mod.Registry(method)
    out = [reg.register("http://a", ["supir"], speed=1.0), reg.register("http://b", ["supir", "llava"], speed=3.0),
           reg.register("http://c", ["llava"], speed=0.5, queue_length=2, check_heart_beat=False)]
    out.append(reg.list_models())
    out += [reg.get_worker_address("supir") for _ in range(12)]
    out += [reg.get_worker_address("llava") for _ in range(6)]
    out.append(reg.get_worker_address("none"))
    out += [reg.heartbeat("http://a", 0), reg.heartbeat("http://gone", 1)]
    out.append({n: w.queue_length for n, w in reg.workers.items()})
    now = time.time()
    out.append(reg.remove_expired(now + mod.CONTROLLER_HEART_BEAT_EXPIRATION - 5))
    out.append(sorted(reg.remove_expired(now + mod.CONTROLLER_HEART_BEAT_EXPIRATION + 5)))
    out.append(sorted(reg.workers))
    reg.remove("http://c")
    out.append(reg.list_models())
    return out


@pytest.mark.parametrize("method", ["lottery", "shortest_queue"])
def test_registry_matches_jax(method):
    from supir_tpu.serve import controller as JCtl

    assert (TCtl.CONTROLLER_HEART_BEAT_EXPIRATION, TCtl.WORKER_HEART_BEAT_INTERVAL) == (30.0, 15.0)
    assert _registry_trace(TCtl, method) == _registry_trace(JCtl, method)
    with pytest.raises(ValueError):
        TCtl.Registry("round_robin")


# ------------------------------------------------------------------ worker and controller


class _Resp:
    """A response whose read1 hands out the given byte chunks."""

    def __init__(self, chunks):
        self.chunks = list(chunks)

    def read1(self, n):
        return self.chunks.pop(0) if self.chunks else b""


@pytest.mark.parametrize("chunks", [
    [b'{"a": 1}\0{"b"', b': 2}\0', b'{"c": 3}\0'],
    [b'{"a": 1}\0\0{"b": 2}\0{"tail": ', b'"cut'],
    [b'{"a": 1}\0{"whole": "no delimiter"}'],
    [b""],
    [bytes([c]) for c in b'{"a": [1, 2]}\0\0{"b": "x"}\0{"c": 3}\0{"tail": 1'],
], ids=["split", "truncated", "last-without-delimiter", "empty", "one-byte-reads"])
def test_stream_frames_match_jax(chunks):
    from supir_tpu.serve import worker as JWk

    got = list(TWk.iter_stream_frames(_Resp(chunks)))
    assert got == list(JWk.iter_stream_frames(_Resp(chunks)))
    if chunks[-1] == b'"cut':
        assert got[-1] == {"text": "", "error_code": 1, "error": "stream truncated mid-frame"}


@pytest.fixture()
def cluster(monkeypatch):
    """A port controller on port 0 and a factory of registered workers on
    port 0, heartbeating every 50 ms; everything shut down after the test."""
    monkeypatch.setattr(TWk, "WORKER_HEART_BEAT_INTERVAL", 0.05)
    ctl, registry = TCtl.serve_controller("127.0.0.1", 0)
    ctl_addr = _serve(ctl)
    servers, workers = [ctl], []

    def add_worker(work_fn, models=("supir",), limit=2):
        httpd = TWk.serve_worker(None, "127.0.0.1", 0)
        addr = f"http://127.0.0.1:{httpd.server_address[1]}"
        worker = TWk.ModelWorker(ctl_addr, addr, work_fn, model_names=models, limit_concurrency=limit)
        httpd.RequestHandlerClass.worker = worker
        _serve(httpd)
        servers.append(httpd)
        workers.append(worker)
        return worker, addr

    yield types.SimpleNamespace(addr=ctl_addr, registry=registry, add_worker=add_worker)
    for w in workers:
        w.stop()
    for s in servers:
        s.shutdown()
        s.server_close()


def test_worker_registers_heartbeats_and_re_registers(cluster):
    worker, addr = cluster.add_worker(lambda p: {"text": "ok", "error_code": 0}, models=("supir", "x"))
    assert json.loads(_post(cluster.addr, "/list_models", {})) == {"models": ["supir", "x"]}
    assert json.loads(_post(addr, "/worker_get_status", {})) == {"model_names": ["supir", "x"], "speed": 1,
                                                                 "queue_length": 0}
    before = cluster.registry.workers[addr].last_heart_beat
    time.sleep(0.3)
    assert cluster.registry.workers[addr].last_heart_beat > before
    cluster.registry.remove(addr)  # the controller forgets it: the next heartbeat re-registers
    deadline = time.time() + 5
    while addr not in cluster.registry.workers and time.time() < deadline:
        time.sleep(0.02)
    assert addr in cluster.registry.workers
    assert json.loads(_post(cluster.addr, "/get_worker_address", {"model": "x"})) == {"address": addr}
    assert json.loads(_post(cluster.addr, "/get_worker_address", {"model": "y"})) == {"address": ""}
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(addr, "/nowhere", {})
    assert e.value.code == 404 and json.loads(e.value.read()) == {"error": "unknown endpoint"}


def test_worker_stream_framing_and_controller_proxy(cluster):
    def work(params):
        for i in range(params["n"]):
            yield {"text": "x" * (i + 1), "error_code": 0}

    _, addr = cluster.add_worker(work)
    raw = _post(addr, "/worker_generate_stream", {"n": 3})
    assert raw == b"".join(json.dumps({"text": "x" * i, "error_code": 0}).encode() + b"\0" for i in (1, 2, 3))
    # through the controller's streaming proxy, parsed by the client
    req = urllib.request.Request(cluster.addr + "/worker_generate_stream",
                                 data=json.dumps({"n": 2, "model": "supir"}).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        assert [f["text"] for f in TWk.iter_stream_frames(r)] == ["x", "xx"]
    assert json.loads(_post(cluster.addr, "/worker_generate_stream", {"model": "nothing"})) == \
        {"text": "", "error_code": 2}


@pytest.mark.parametrize("error,code", [
    (ValueError("bad request"), TWk.ErrorCode_ERROR),
    (MemoryError("host memory"), TWk.ErrorCode_OOM),
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), TWk.ErrorCode_OOM),
], ids=["ValueError", "MemoryError", "cuda-OOM"])
def test_worker_error_payloads(cluster, error, code):
    def work(params):
        raise error

    worker, addr = cluster.add_worker(work)
    frames = list(TWk.iter_stream_frames(io.BytesIO(_post(addr, "/worker_generate_stream", {}))))
    assert frames == [{"text": "", "error_code": code, "error": str(error)}]
    assert worker.generate({}) == frames[0] and worker.queue_length() == 0
    assert (TWk.ErrorCode_OOM, TWk.ErrorCode_ERROR) == (1, 2)


def test_worker_busy_payload():
    worker = TWk.ModelWorker("", "", lambda p: {"error_code": 0}, register=False)
    worker.semaphore = types.SimpleNamespace(acquire=lambda timeout: False)
    assert worker.generate({}) == {"text": "", "error_code": TWk.ErrorCode_ERROR, "error": "busy"}
    assert worker.queue_length() == 0


def test_worker_main_parses_the_engine_flags():
    args = TWk.build_parser().parse_args(["--tiny", "--random_weights", "--device", "cpu", "--port", "0"])
    assert (args.tiny, args.device, args.port, args.limit_concurrency, args.sampler, args.SUPIR_sign) == \
        (True, "cpu", 0, 2, None, "Q")
    assert TWk.build_parser().parse_args([]).device == "cuda"


# ------------------------------------------------------------------ work functions


class Greedy:
    """A captioner whose stream decodes greedily (the agents' default
    samples at temperature 0.2, from each package's own RNG)."""

    def __init__(self, agent):
        self.agent = agent

    def gen_image_caption_stream(self, images, temperature=0.2, top_p=0.7, qs=None, seed=0):
        return self.agent.gen_image_caption_stream(images, temperature=0.0, qs=qs)


@pytest.fixture(scope="module")
def pairs():
    """The tiny engine pair (noise injected) and the tiny int4 captioner pair."""
    from torch_parity import inject_noise, tiny_captioner_pair, tiny_engine_pair

    cfg, jengine, tcfg, tengine = tiny_engine_pair()
    inject_noise(jengine)
    inject_noise(tengine)
    jagent, tagent = tiny_captioner_pair()
    return types.SimpleNamespace(cfg=cfg, jengine=jengine, tcfg=tcfg, tengine=tengine, jagent=jagent, tagent=tagent)


@pytest.mark.parametrize("color_fix", ["Wavelet", "AdaIn"])
def test_restoration_work_fn_matches_jax(pairs, color_fix):
    from supir_tpu.serve import worker as JWk

    params = {"image": _png_b64(48, 40, seed=3), "edm_steps": 2, "upscale": 1, "min_size": 64,
              "prompt": "a lake, ", "seed": 5, "color_fix_type": color_fix}
    got = TWk.restoration_work_fn(pairs.tengine, pairs.tcfg)(params)
    want = JWk.restoration_work_fn(pairs.jengine, pairs.cfg)(params)
    assert got["error_code"] == want["error_code"] == 0
    a, b = _decoded(got), _decoded(want)
    assert a.shape == b.shape == (48, 40, 3)
    assert (np.abs(a - b) > 1).mean() <= PNG_SHARE


class _FakeEngine:
    """An engine whose device calls record how many requests are inside them."""

    def __init__(self):
        self.inside, self.most, self.calls = 0, 0, 0

    def _enter(self):
        self.inside += 1
        self.most = max(self.most, self.inside)
        time.sleep(0.001)
        self.inside -= 1

    def encode_first_stage_with_denoise(self, x):
        self._enter()
        return torch.zeros(1, 8, 8, 4)

    def prepare_condition(self, z, *tokens):
        self._enter()
        return {"control": z}, {"control": z}

    def batchify_sample(self, x, c, uc, **kw):
        self._enter()
        self.calls += 1
        return torch.full(x.shape, kw["seed"] / 100.0)


def test_restoration_work_fn_serialises_device_work():
    """24 requests at once through one worker (more threads than cores, a
    short switch interval): the device parts never overlap, every request
    is answered with its own seed's image, and the queue drains to 0."""
    import sys

    from supir_tpu_torch.utils.image import array_to_pil

    engine = _FakeEngine()
    cfg = types.SimpleNamespace(p_p="", n_p="")
    worker = TWk.ModelWorker("", "", TWk.restoration_work_fn(engine, cfg), register=False, limit_concurrency=24)
    outs = {}
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda i=i: outs.__setitem__(
            i, worker.generate({"image": _png_b64(64, 64, seed=i), "min_size": 64, "seed": i}))) for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(before)
    assert not any(t.is_alive() for t in threads)
    assert engine.most == 1 and engine.calls == 24 and worker.queue_length() == 0
    for i, out in outs.items():
        assert out["error_code"] == 0
        assert np.array_equal(_decoded(out), np.asarray(array_to_pil(torch.full((64, 64, 3), i / 100.0))))


def test_caption_work_fn_matches_jax(pairs):
    """The final text equals JAX's; every partial is a prefix of it (the
    port yields after every token, JAX after every 16-token chunk)."""
    from supir_tpu.serve import worker as JWk

    params = {"image": _png_b64(56, 80, seed=4), "prompt": "Describe the image."}
    got = [f["text"] for f in TWk.caption_work_fn(Greedy(pairs.tagent))(params)]
    want = [f["text"] for f in JWk.caption_work_fn(Greedy(pairs.jagent))(params)]
    assert got[-1] == want[-1] and got[-1]
    assert all(want[-1].startswith(p) for p in got + want)
    assert len(got) >= len(want)


# ------------------------------------------------------------------ web chat


def _multipart(fields, image: bytes):
    boundary = "----supirtest"
    parts = []
    for k, v in fields.items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode())
    parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="image"; filename="a.png"\r\n'
                 f"Content-Type: image/png\r\n\r\n".encode() + image + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return f"multipart/form-data; boundary={boundary}", b"".join(parts)


def test_parse_form_matches_jax():
    from supir_tpu.serve import web_chat as JChat

    png = base64.b64decode(_png_b64(seed=5))
    ctype, body = _multipart({"text": "What is here?", "session": "abc", "model": "llava"}, png)
    got = TChat._parse_form(ctype, body)
    assert got == JChat._parse_form(ctype, body) and got["image"] == png and got["text"] == b"What is here?"
    plain = b"text=hello+there&session=s1&model="
    assert TChat._parse_form("application/x-www-form-urlencoded", plain) == \
        JChat._parse_form("application/x-www-form-urlencoded", plain)
    assert TChat._PAGE == JChat._PAGE


def test_register_worker_and_test_message(cluster):
    _, addr = cluster.add_worker(lambda p: {"text": "echo " + p["text"], "error_code": 0}, models=("echo",))
    cluster.registry.remove(addr)
    assert TChat.register_worker(cluster.addr, addr) == {"exist": True}
    assert cluster.registry.workers[addr].model_names == ["echo"]
    assert TChat.send_test_message(cluster.addr, text="hi") == {"text": "echo hi", "error_code": 0}
    cluster.registry.remove(addr)
    with pytest.raises(RuntimeError, match="no models"):
        TChat.send_test_message(cluster.addr)


def test_web_chat_send_round_trip(cluster, pairs):
    """A /send with an image through the controller to a caption worker
    over the tiny port captioner: the chat's reply is that image's greedy
    caption; the page lists the worker's model."""
    cluster.add_worker(TWk.caption_work_fn(Greedy(pairs.tagent)), models=("llava-tiny",))
    server = TChat.serve_web_chat(cluster.addr, "127.0.0.1", 0)
    try:
        port = server.server_address[1]
        png = base64.b64decode(_png_b64(64, 48, seed=6))
        ctype, body = _multipart({"text": "What is in the photo?", "session": "s1", "model": "llava-tiny"}, png)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/send", data=body, headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=120) as r:  # follows the 303 to the page
            page = r.read().decode()
        img = np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))
        want = pairs.tagent.gen_image_caption([img], temperature=0.0, qs="What is in the photo?")[0]
        turns = server.RequestHandlerClass.state.turns("s1")
        assert turns == [{"role": "user", "text": "What is in the photo?"}, {"role": "assistant", "text": want}]
        assert '<option value="llava-tiny">' in page and "What is in the photo?" in page
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/?session=s1&clear=1", timeout=60) as r:
            r.read()
        assert server.RequestHandlerClass.state.turns("s1") == []
    finally:
        server.shutdown()
        server.server_close()


# ------------------------------------------------------------------ conversation


def _image(h, w, seed):
    return Image.fromarray(np.random.default_rng(seed).integers(0, 255, (h, w, 3), dtype=np.uint8))


@pytest.mark.parametrize("mode", ["Pad", "Resize", "Default", "Crop"])
@pytest.mark.parametrize("hw", [(300, 500), (900, 420), (1000, 1000), (200, 200)], ids=str)
def test_process_image_matches_jax(mode, hw):
    from supir_tpu.captioner.conversation import Conversation as JConv

    img = _image(*hw, seed=hw[0])
    got, want = TC.Conversation.process_image(img, mode), JConv.process_image(img, mode)
    assert got.size == want.size
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    with pytest.raises(ValueError):
        TC.Conversation.process_image(img, "Stretch")


@pytest.mark.parametrize("template", sorted(TC.conv_templates))
@pytest.mark.parametrize("version", [None, "v1_mmtag"])
def test_image_messages_match_jax(template, version):
    """get_prompt over (text, image, mode) messages, mmtag wrapping
    included, get_images (PIL and base64 PNG) and dict, against JAX."""
    from supir_tpu.captioner import conversation as JCv

    img, img2 = _image(360, 640, 1), _image(500, 300, 2)

    def run(mod):
        conv = mod.conv_templates[template].copy()
        if version:
            conv.version = version
        conv.append_message(conv.roles[0], ("<image>\nWhat is this?", img, "Pad"))
        conv.append_message(conv.roles[1], "A lake.")
        conv.append_message(conv.roles[0], ("And this one?", img2, "Resize"))
        conv.append_message(conv.roles[1], None)
        try:
            prompt = conv.get_prompt()
        except TypeError as e:  # the PLAIN style has no sep2 for an mmtag turn, in both packages
            prompt = type(e).__name__
        pil = [np.asarray(i) for i in conv.get_images(return_pil=True)]
        return prompt, pil, conv.get_images(), conv.dict()

    got, want = run(TC), run(JCv)
    assert got[0] == want[0] and got[2] == want[2] and got[3] == want[3]
    assert len(got[1]) == len(want[1]) and all(np.array_equal(a, b) for a, b in zip(got[1], want[1]))
    assert TC.default_conversation is TC.conv_vicuna_v1


def test_restoration_request_launch_counts_match_chip_smoke(monkeypatch):
    """chip_smoke.py's [serve] count on a tiny CPU run: the GroupNorm calls
    (K2's sites) of one restoration request are [web demo]'s stage 2's, one
    network per step and the VAE's two encodes and two decodes."""
    import chip_smoke
    from supir_tpu_torch.engine.factory import create_engine, tiny_test_config
    from supir_tpu_torch.models import layers
    from supir_tpu_torch.ops import groupnorm as G

    calls = []
    monkeypatch.setattr(layers, "group_norm", lambda *a: calls.append(1) or G.group_norm_plain(*a))
    cfg, cond = tiny_test_config()
    work = TWk.restoration_work_fn(create_engine(cfg, "cpu", seed=7, cond_cfg=cond), cfg)
    assert work({"image": _png_b64(seed=9), "edm_steps": 3, "min_size": 64})["error_code"] == 0
    assert len(calls) == chip_smoke.expected_group_norm_launches(cfg, 3, encodes=2, decodes=2) > 0


def test_chip_smoke_times_restoration_requests_from_outside():
    """chip_smoke.py's [serve] split of a request's seconds, taken around
    the worker's own work function: one record per request, every part
    non-negative, the answer unchanged, every wrapper undone on exit."""
    import chip_smoke
    from supir_tpu_torch.utils import image as TI

    engine, cfg = _FakeEngine(), types.SimpleNamespace(p_p="", n_p="")
    params = {"image": _png_b64(64, 64, seed=4), "min_size": 64, "seed": 4}
    want = TWk.restoration_work_fn(engine, cfg)(params)
    originals = (TWk._decode_image, TI.array_to_pil)
    with chip_smoke.timed_restoration_work(engine, cfg) as (work, timings):
        got = [work(params) for _ in range(2)]
    assert got == [want, want]
    assert len(timings) == 2 and all(set(t) == {"decode", "prepare", "device", "encode"} for t in timings)
    assert all(v >= 0 for t in timings for v in t.values())
    assert (TWk._decode_image, TI.array_to_pil) == originals and "encode_first_stage_with_denoise" not in vars(engine)


def test_worker_main_refuses_without_cuda(monkeypatch):
    """Without --device the worker runs on the card, and without one it
    raises before it binds or registers."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TWk.main(["--tiny", "--random_weights", "--port", "0", "--controller", "http://127.0.0.1:9"])
