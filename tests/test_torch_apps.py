"""The port's apps against the JAX package on the CPU: the web demo's
DemoServer (stage 1, caption, stage 2 with the Quality and Fidelity
presets, feedback and history) on the tiny engine and captioner, its HTTP
server, the Q/F hot swap over convert_and_cache, the metrics and the eval
app, and utils/file.py and utils/logging.py.

Bounds: the demo's PNGs as uint8 within 1 level of JAX's on all but 0.5 %
of the pixels (the images go through the engine's fp32 samples, 5e-5 of
JAX's in tests/test_torch_cli.py, and a bicubic resize before the uint8
cast, which can carry a difference across a rounding boundary); greedy
captions exact; PSNR and SSIM 1e-4 relative; LPIPS 2e-3; converted and
cached weights bit for bit. JAX is imported inside the helpers, so the
`gpu` test at the end runs where it is not installed.
"""

import base64
import io
import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from supir_tpu_torch.apps import eval as TE
from supir_tpu_torch.apps import web_demo as TW
from supir_tpu_torch.utils import checkpoint as TCK
from supir_tpu_torch.utils import file as TFile
from supir_tpu_torch.utils import metrics as TM
from supir_tpu_torch.utils import weights as W
from supir_tpu_torch.utils.logging import build_logger
from torch_parity import one_torch_thread  # noqa: F401

PNG_SHARE = 5e-3  # pixels allowed to differ by more than one level
METRIC_RTOL = 1e-4
LPIPS_TOL = 2e-3


def _png_b64(h=48, w=48, seed=0):
    img = Image.fromarray(np.random.default_rng(seed).integers(0, 255, (h, w, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _decoded(out) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(out["image"]))).convert("RGB"), np.int16)


def _assert_png_close(got, want):
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert (diff > 1).mean() <= PNG_SHARE, f"{(diff > 1).mean():.4f} of pixels off by more than 1, max {diff.max()}"


class Greedy:
    """A captioner whose gen_image_caption decodes greedily (the agents'
    default samples at temperature 0.2, from each package's own RNG)."""

    def __init__(self, agent):
        self.agent = agent

    def gen_image_caption(self, images):
        return self.agent.gen_image_caption(images, temperature=0.0)


@pytest.fixture(scope="module")
def demos(tmp_path_factory):
    """The JAX and the port DemoServer on one random tiny engine (noise
    injected) and one random tiny captioner (int4, greedy)."""
    from supir_tpu.apps.web_demo import DemoServer as JDemo
    from torch_parity import inject_noise, tiny_captioner_pair, tiny_engine_pair

    cfg, jengine, tcfg, tengine = tiny_engine_pair()
    inject_noise(jengine)
    inject_noise(tengine)
    jagent, tagent = tiny_captioner_pair()
    jdemo = JDemo(jengine, cfg, captioner=Greedy(jagent), history_dir=str(tmp_path_factory.mktemp("jhist")))
    tdemo = TW.DemoServer(tengine, tcfg, captioner=Greedy(tagent), history_dir=str(tmp_path_factory.mktemp("thist")))
    return jdemo, tdemo


def test_presets_and_page_equal_jax():
    from supir_tpu.apps import web_demo as JW

    assert TW.PRESETS == JW.PRESETS
    assert TW.INDEX_HTML.split("<script>")[1] == JW.INDEX_HTML.split("<script>")[1]


def test_stage1_feedback_and_history_match_jax(demos):
    jdemo, tdemo = demos
    params = {"image": _png_b64(seed=1), "gamma_correction": 0.8}
    want, got = jdemo.stage1(params), tdemo.stage1(params)
    assert _decoded(got).shape == (512, 512, 3)
    _assert_png_close(_decoded(got), _decoded(want))
    d = os.path.join(tdemo.history_dir, got["event_id"])
    assert sorted(os.listdir(d)) == ["in.png", "out.png", "params.json"]
    with open(os.path.join(d, "params.json")) as f:
        assert json.load(f) == {"kind": "stage1", "gamma_correction": 0.8}
    assert tdemo.feedback(got["event_id"], -1) and not tdemo.feedback("nonexistent", 1)
    with open(os.path.join(d, "feedback.json")) as f:
        assert json.load(f)["score"] == -1


@pytest.mark.parametrize("preset", ["Quality", "Fidelity"])
def test_stage2_matches_jax(demos, preset):
    """Stage 2 end to end (pil_to_array, stage-1 encode, tokenize,
    prepare_condition, batchify_sample with the preset's linear CFG and
    injected noise, array_to_pil at the input's size, history)."""
    jdemo, tdemo = demos
    params = {"image": _png_b64(seed=2), "edm_steps": 2, "upscale": 1, "min_size": 64, "preset": preset,
              "prompt": "a cat, ", "color_fix_type": "AdaIn" if preset == "Fidelity" else "Wavelet"}
    want, got = jdemo.stage2(params), tdemo.stage2(params)
    assert _decoded(got).shape == (48, 48, 3)
    _assert_png_close(_decoded(got), _decoded(want))
    d = os.path.join(tdemo.history_dir, got["event_id"])
    assert sorted(os.listdir(d)) == ["in.png", "out.png", "params.json"]


def test_caption_matches_jax(demos):
    jdemo, tdemo = demos
    params = {"image": _png_b64(56, 80, seed=3)}
    want, got = jdemo.caption(params), tdemo.caption(params)
    assert got["caption"] == want["caption"] and got["event_id"]
    with open(os.path.join(tdemo.history_dir, got["event_id"], "params.json")) as f:
        assert json.load(f)["caption"] == got["caption"]
    bare = TW.DemoServer(tdemo.engine, tdemo.cfg, history_dir=tdemo.history_dir)
    assert bare.caption(params)["error"] == "captioner unavailable"


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_http_round_trip(tmp_path):
    """serve_demo on port 0 in a thread over a tiny port engine (its noise
    from the request's seed): the page, stage 1 over HTTP equal to the
    direct call, feedback, an unknown endpoint and an exception answered
    with "error"; two stage-2 requests at once equal the serial ones."""
    from supir_tpu_torch.engine.factory import create_engine, tiny_test_config

    cfg, cond = tiny_test_config()
    tdemo = TW.DemoServer(create_engine(cfg, "cpu", seed=4, cond_cfg=cond), cfg, history_dir=str(tmp_path))
    httpd = TW.serve_demo(tdemo, host="127.0.0.1", port=0)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=30) as r:
            assert r.read().decode() == TW.INDEX_HTML
        out = _post(port, "/api/stage1", {"image": _png_b64(seed=4)})
        assert "error" not in out
        np.testing.assert_array_equal(_decoded(out), _decoded(tdemo.stage1({"image": _png_b64(seed=4)})))
        assert _post(port, "/api/feedback", {"event_id": out["event_id"], "score": 1}) == {"ok": True}
        assert _post(port, "/api/nothing", {}) == {"error": "unknown endpoint"}
        assert "error" in _post(port, "/api/stage2", {"image": _png_b64(seed=4), "model_select": "X"})

        reqs = [{"image": _png_b64(seed=5 + i), "edm_steps": 1, "upscale": 1, "min_size": 64} for i in range(2)]
        serial = [_decoded(tdemo.stage2(r)) for r in reqs]
        outs = [None, None]

        def send(i):
            outs[i] = _post(port, "/api/stage2", reqs[i])

        threads = [threading.Thread(target=send, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for out, want in zip(outs, serial):
            assert "error" not in out
            np.testing.assert_array_equal(_decoded(out), want)
    finally:
        httpd.shutdown()
        httpd.server_close()


# ------------------------------------------------------------------ checkpoints and the hot swap


@pytest.fixture(scope="module")
def tiny_files(tmp_path_factory):
    """An SDXL and a SUPIR safetensors file of a random tiny model (the
    reference's split) and the state dict they hold."""
    from safetensors.torch import save_file

    from supir_tpu_torch.engine.factory import create_engine, tiny_test_config

    cfg, cond = tiny_test_config()
    sd = create_engine(cfg, "cpu", seed=31, cond_cfg=cond).model.state_dict()
    supir_prefixes = ("model.control_model.", "model.diffusion_model.project_modules.",
                      "first_stage_model.denoise_encoder.")
    d = tmp_path_factory.mktemp("ckpt")
    paths = (str(d / "sdxl.safetensors"), str(d / "supir_F.safetensors"))
    save_file({k: v for k, v in sd.items() if not k.startswith(supir_prefixes)}, paths[0])
    save_file({k: v for k, v in sd.items() if k.startswith(supir_prefixes)}, paths[1])
    return paths, sd


def test_convert_and_cache_converts_once(tiny_files, tmp_path, monkeypatch):
    """The first call merges the files through load_supir_checkpoint and
    writes the cache; the second reads the cache and converts nothing; both
    hold the files' weights bit for bit; load_params checks a target."""
    from supir_tpu_torch.engine.factory import tiny_test_config
    from supir_tpu_torch.utils import ckpt as TC

    (sdxl, supir), want = tiny_files
    cfg, cond = tiny_test_config()
    calls = []
    original = TC.load_supir_checkpoint
    monkeypatch.setattr(TC, "load_supir_checkpoint", lambda *a, **k: calls.append(1) or original(*a, **k))
    first = TCK.convert_and_cache(cfg, sdxl, supir, str(tmp_path), sign="F", cond_cfg=cond)
    assert calls == [1] and os.path.exists(tmp_path / "supir_F.safetensors")
    second = TCK.convert_and_cache(cfg, sdxl, supir, str(tmp_path), sign="F", cond_cfg=cond)
    assert calls == [1]
    assert set(first) == set(second) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(second[k], v, rtol=0, atol=0, msg=k)
        torch.testing.assert_close(first[k], v, rtol=0, atol=0, msg=k)
    TCK.load_params(str(tmp_path / "supir_F.safetensors"), target=first)
    with pytest.raises(ValueError, match="does not match"):
        TCK.load_params(str(tmp_path / "supir_F.safetensors"), target={"x": torch.zeros(1)})


def test_hot_swap(tiny_files, tmp_path):
    """select_model: the lazy loader (convert_and_cache) runs once, the
    swap changes stage 2's output, swapping back restores the engine's
    weights bit for bit from the host copy without converting again, an
    unknown sign raises; a model_select in a stage-2 request swaps."""
    from supir_tpu_torch.engine.factory import create_engine, tiny_test_config

    (sdxl, supir), f_sd = tiny_files
    cfg, cond = tiny_test_config()
    engine = create_engine(cfg, "cpu", seed=5, cond_cfg=cond)
    q_sd = {k: v.clone() for k, v in engine.model.state_dict().items()}
    loads = []

    def load_f():
        loads.append(1)
        return TCK.convert_and_cache(cfg, sdxl, supir, str(tmp_path), sign="F", cond_cfg=cond)

    demo = TW.DemoServer(engine, cfg, history_dir=str(tmp_path / "hist"), param_sets={"F": load_f})
    req = {"image": _png_b64(seed=6), "edm_steps": 1, "upscale": 1, "min_size": 64, "model_select": "Q"}
    q_out = _decoded(demo.stage2(req))
    assert demo.select_model("Q") == "Q" and not loads
    f_out = _decoded(demo.stage2(dict(req, model_select="F")))
    assert demo.active_sign == "F" and loads == [1] and not np.array_equal(f_out, q_out)
    held = engine.model.state_dict()
    for k, v in f_sd.items():
        torch.testing.assert_close(held[k], v, rtol=0, atol=0, msg=k)
    assert demo.select_model("Q") == "Q"
    held = engine.model.state_dict()
    for k, v in q_sd.items():  # the weights stage 2 gave q_out with
        torch.testing.assert_close(held[k], v, rtol=0, atol=0, msg=k)
    demo.select_model("F")
    demo.select_model("Q")
    assert loads == [1]
    with pytest.raises(ValueError, match="unknown checkpoint"):
        demo.select_model("X")


def test_engine_load_weights_swaps_and_drops_cached_conditioning():
    """SUPIREngine.load_weights: the state dict lands in the model bit for
    bit (strict: a missing key raises) and the cached text conditioning of
    the weights it replaced is gone."""
    from supir_tpu_torch.engine.factory import create_engine, tiny_test_config

    cfg, cond = tiny_test_config()
    engine = create_engine(cfg, "cpu", seed=5, cond_cfg=cond)
    other = create_engine(cfg, "cpu", seed=6, cond_cfg=cond).model.state_dict()
    engine._cond_cache["key"] = ({}, {})
    engine.load_weights(other)
    assert not engine._cond_cache
    held = engine.model.state_dict()
    for k, v in other.items():
        torch.testing.assert_close(held[k], v, rtol=0, atol=0, msg=k)
    with pytest.raises(RuntimeError, match="Missing key"):
        engine.load_weights({k: v for i, (k, v) in enumerate(other.items()) if i})


def test_web_demo_main_builds_the_tiny_demo(monkeypatch, tmp_path):
    """main's flags are the CLI's engine and captioner flags plus --port;
    --tiny --device cpu builds the demo; the CLI's folder and sampling
    flags are refused, a yaml with a tiled sampler raises (stage 2 samples
    untiled); without a card the default device raises."""
    for flags in (["--img_dir", "x"], ["--save_dir", "x"], ["--edm_steps", "4"], ["--use_tiled_sampling"]):
        with pytest.raises(SystemExit):
            TW.build_parser().parse_args(flags)
    tiled = TW.build_parser().parse_args(["--opt", os.path.abspath("options/SUPIR_v0_tiled.yaml"),
                                          "--random_weights", "--no_llava", "--device", "cpu"])
    with pytest.raises(ValueError, match="samples tiles"):
        TW.create_demo_from_args(tiled, history_dir=str(tmp_path / "tiled"))
    monkeypatch.chdir(tmp_path)
    args = TW.build_parser().parse_args(["--tiny", "--random_weights", "--no_llava", "--device", "cpu",
                                         "--port", "0"])
    demo = TW.create_demo_from_args(args)
    assert demo.engine.device.type == "cpu" and demo.captioner is None and demo.param_sets == {}
    assert os.path.isdir(tmp_path / "history")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TW.main(["--tiny", "--no_llava"])


# ------------------------------------------------------------------ metrics and the eval app


def _pair(seed, shape=(2, 40, 48, 3)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, shape).astype(np.float32)
    return a, np.clip(a + 0.2 * rng.standard_normal(shape), -1, 1).astype(np.float32)


def test_psnr_ssim_match_jax():
    from supir_tpu.utils import metrics as JM

    a, b = _pair(7)
    for name in ("psnr", "ssim"):
        want = np.asarray(getattr(JM, name)(a, b))
        got = getattr(TM, name)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(got, want, rtol=METRIC_RTOL, atol=0, err_msg=name)
    same = TM.psnr(torch.from_numpy(a), torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(same, np.asarray(JM.psnr(a, a)), rtol=METRIC_RTOL)  # the 1e-12 floor


def _lpips_sources(seed):
    """A torchvision-keyed vgg16 state dict (with classifier extras) and
    taming lin heads, random."""
    rng = np.random.default_rng(seed)
    out_ch = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
    vgg = {}
    for i, t in enumerate(TM.VGG_TORCH_CONV_IDX):
        cin = 3 if i == 0 else out_ch[i - 1]
        vgg[f"features.{t}.weight"] = torch.from_numpy(
            (rng.standard_normal((out_ch[i], cin, 3, 3)) * (9 * cin) ** -0.5).astype(np.float32))
        vgg[f"features.{t}.bias"] = torch.from_numpy((0.05 * rng.standard_normal(out_ch[i])).astype(np.float32))
    vgg["classifier.0.weight"] = torch.zeros(8, 8)
    lin = {f"lin{i}.model.1.weight": torch.from_numpy(rng.normal(0, 1, (1, c, 1, 1)).astype(np.float32))
           for i, c in enumerate(TM.VGG_CHANNELS)}
    return vgg, lin


def test_lpips_matches_jax(tmp_path):
    """convert_lpips_state equal to the JAX converter's tree through the
    bridge; LPIPS on those weights equal to JAX's (negative lin weights
    clamped); load_lpips_from_torch from files; a missing key raises."""
    from supir_tpu.utils import metrics as JM

    vgg, lin = _lpips_sources(8)
    sd = TM.convert_lpips_state(vgg, lin)
    jparams = JM.convert_lpips_state({k: v.numpy() for k, v in vgg.items()}, {k: v.numpy() for k, v in lin.items()})
    want_sd = W.lpips_state_dict_from_jax(jparams)
    assert set(sd) == set(want_sd)
    for k in sd:
        torch.testing.assert_close(sd[k], want_sd[k], rtol=0, atol=0, msg=k)
    a, b = _pair(9, (2, 32, 32, 3))
    want = np.asarray(JM.LPIPS().apply({"params": jparams}, a, b))
    torch.save(vgg, tmp_path / "vgg16.pth")
    torch.save(lin, tmp_path / "vgg.pth")
    TM.load_lpips_from_torch(str(tmp_path / "vgg16.pth"), str(tmp_path / "vgg.pth"), device="cpu")
    assert TM.lpips_available()
    got = TM.lpips(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=LPIPS_TOL, atol=0)
    assert (want > 0).all()
    del vgg["features.28.bias"]
    with pytest.raises(KeyError):
        TM.convert_lpips_state(vgg, lin)


def _eval_dirs(tmp_path):
    rng = np.random.default_rng(10)
    pred, ref = tmp_path / "pred", tmp_path / "ref"
    pred.mkdir()
    ref.mkdir()
    for i, (h, w) in enumerate([(40, 48), (36, 44)]):
        r = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(r).save(ref / f"img{i}.png")
        noisy = np.clip(r + rng.normal(0, 12, r.shape), 0, 255).astype(np.uint8)
        Image.fromarray(noisy).resize((w * 2, h * 2), Image.BICUBIC).save(pred / f"img{i}_0.png")
    Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(ref / "unmatched.png")
    return str(pred), str(ref)


def test_evaluate_dirs_matches_jax(tmp_path, capsys):
    """evaluate_dirs and main on a folder pair (predictions at twice the
    size, one reference unmatched): PSNR, SSIM and LPIPS (weights from a
    state-dict file of the port's keys) against JAX's evaluate_dirs."""
    import pickle

    from supir_tpu.apps import eval as JE
    from supir_tpu.utils import metrics as JM

    pred, ref = _eval_dirs(tmp_path)
    vgg, lin = _lpips_sources(11)
    jparams = JM.convert_lpips_state({k: v.numpy() for k, v in vgg.items()}, {k: v.numpy() for k, v in lin.items()})
    with open(tmp_path / "lpips.pkl", "wb") as f:
        pickle.dump(jparams, f)
    TCK.save_params(str(tmp_path / "lpips.safetensors"), TM.convert_lpips_state(vgg, lin))
    want = JE.evaluate_dirs(pred, ref, str(tmp_path / "lpips.pkl"))
    got = TE.evaluate_dirs(pred, ref, str(tmp_path / "lpips.safetensors"), device="cpu")
    assert got["n"] == want["n"] == 2
    for k in ("psnr", "ssim"):
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL, err_msg=k)
    np.testing.assert_allclose(got["lpips"], want["lpips"], rtol=LPIPS_TOL)
    out = TE.main(["--pred_dir", pred, "--ref_dir", ref, "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["psnr"] == pytest.approx(got["psnr"], rel=1e-6)


def test_eval_refuses_without_cuda(tmp_path, monkeypatch):
    pred, ref = _eval_dirs(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.main(["--pred_dir", pred, "--ref_dir", ref])


# ------------------------------------------------------------------ file and logging


def test_file_helpers_match_jax(tmp_path, monkeypatch):
    """load_file_list, list_image_files (extension filter, recursion,
    max_size) and load_file_from_url on a file already in the cache (no
    download), and the offline refusal, as the JAX helpers give them."""
    from supir_tpu.utils import file as JFile

    (tmp_path / "a" / "b").mkdir(parents=True)
    for name in ("a/x.png", "a/b/y.JPG", "a/b/z.txt", "a/w.jpeg"):
        (tmp_path / name).write_bytes(b"0")
    lst = tmp_path / "list.txt"
    lst.write_text("one.png\n\n  two.png \n")
    assert TFile.load_file_list(str(lst)) == JFile.load_file_list(str(lst)) == ["one.png", "two.png"]
    for kw in ({}, {"max_size": 1}, {"exts": (".txt",)}):
        assert TFile.list_image_files(str(tmp_path / "a"), **kw) == JFile.list_image_files(str(tmp_path / "a"), **kw)
    assert len(TFile.list_image_files(str(tmp_path / "a"))) == 3

    cache = tmp_path / "cache"
    monkeypatch.setenv("SUPIR_CACHE_DIR", str(cache))
    assert TFile.get_cache_dir() == JFile.get_cache_dir() == str(cache)
    cache.mkdir()
    (cache / "weights.pth").write_bytes(b"w")
    url = "https://example.invalid/models/weights.pth"
    assert TFile.load_file_from_url(url) == JFile.load_file_from_url(url) == str(cache / "weights.pth")
    monkeypatch.setenv("SUPIR_OFFLINE", "1")
    with pytest.raises(FileNotFoundError, match="offline mode"):
        TFile.load_file_from_url("https://example.invalid/models/absent.pth")


def test_build_logger(tmp_path):
    log_file = tmp_path / "logs" / "demo.log"
    logger = build_logger("supir_tpu_torch.test_apps", str(log_file))
    assert build_logger("supir_tpu_torch.test_apps") is logger and len(logger.handlers) == 2
    logger.info("request served")
    for h in logger.handlers:
        h.flush()
    line = log_file.read_text().strip()
    assert line.endswith("| INFO | supir_tpu_torch.test_apps | request served")


# ------------------------------------------------------------------ on the card


def _rel_l2(got, want) -> float:
    got, want = (np.asarray(x, np.float64) for x in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.gpu
def test_fp32_flash_site_on_the_card_runs():
    """A flash-eligible attention site with fp32 q, k, v on the card (an
    engine with fp32 parameters: --full_params, the tiny test engine) runs
    on K1 fp32 (csrc/flash_attn_fwd_fp32.cu), counted in
    `flash_attention.fp32_launches`, within relative L2 1e-5 of the plain
    version in fp32; an fp16 site is widened to fp32, runs there too and
    comes back fp16. The bf16 kernel launches not: nothing is cast down."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode")
    from supir_tpu_torch.ops.attention import attention
    from supir_tpu_torch.ops.flash_attention import attention_plain, flash_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(1, 4096, 1, 64, generator=g, device="cuda") for _ in range(3))
    want = attention_plain(q, k, v)
    for dtype, bound in ((torch.float32, 1e-5), (torch.float16, 1e-3)):
        before = (flash_attention.launches, flash_attention.fp32_launches)
        out = attention(q.to(dtype), k.to(dtype), v.to(dtype))
        torch.cuda.synchronize()
        assert (flash_attention.launches, flash_attention.fp32_launches) == (before[0], before[1] + 1)
        assert out.dtype == dtype
        # fp16: the inputs and the output each rounded once to fp16, and the
        # output exactly K1 fp32's on the widened inputs, rounded once
        ref = want if dtype == torch.float32 else attention_plain(*(x.half().float() for x in (q, k, v)))
        assert _rel_l2(out.float().cpu(), ref.cpu()) <= bound, dtype
        if dtype == torch.float16:
            assert torch.equal(out, flash_attention(*(x.half().float() for x in (q, k, v))).half())


@pytest.mark.gpu
def test_web_demo_on_the_card_matches_cpu(tmp_path):
    """The tiny engine in bf16 on the card answers stage 1 (512², its VAE's
    mid attention through K1) and stage 2 over HTTP as the same weights in
    fp32 and the same injected noise do on the CPU: relative L2 of the
    decoded images within 5e-2, the bound of chip_smoke.py's reduced-width
    card-against-CPU references (card bf16 with kernels, CPU fp32 plain)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the web demo's engine runs on the card")
    import dataclasses

    from supir_tpu_torch.engine.factory import create_engine, tiny_test_config
    from supir_tpu_torch.ops.flash_attention import flash_attention
    from torch_parity import inject_noise

    cfg, cond = tiny_test_config()
    cpu = create_engine(cfg, "cpu", seed=3, cond_cfg=cond)
    card_cfg = dataclasses.replace(cfg, ae_dtype="bf16", diffusion_dtype="bf16")
    card = create_engine(card_cfg, "cuda", state_dict=cpu.model.state_dict(), cond_cfg=cond)
    inject_noise(cpu)  # the two devices' generators draw different noise from one seed
    inject_noise(card)
    outs, launches = {}, {}
    for name, engine, engine_cfg in (("cpu", cpu, cfg), ("cuda", card, card_cfg)):
        httpd = TW.serve_demo(TW.DemoServer(engine, engine_cfg, history_dir=str(tmp_path / name)), "127.0.0.1", 0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        port = httpd.server_address[1]
        before = flash_attention.launches
        try:
            outs[name] = [_post(port, "/api/stage1", {"image": _png_b64(seed=12)}),
                          _post(port, "/api/stage2", {"image": _png_b64(seed=12), "edm_steps": 2, "upscale": 1,
                                                      "min_size": 64})]
        finally:
            httpd.shutdown()
            httpd.server_close()
        launches[name] = flash_attention.launches - before
    assert launches == {"cpu": 0, "cuda": 2}  # stage 1's encode and decode at 512²
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert "error" not in got
        assert _rel_l2(_decoded(got) / 127.5 - 1, _decoded(want) / 127.5 - 1) <= 5e-2


def test_demo_and_face_launch_counts_match_chip_smoke(monkeypatch, tmp_path):
    """chip_smoke.py's [web demo] and [face] counts on tiny CPU runs: the
    GroupNorm calls (K2's sites) of one stage-2 request are one network's
    per step and the VAE's over two encodes (stage 1, x_center) and two
    decodes (the sampler's stage-1 decode, the final one); stage 1 is one
    encode and one decode; restore_with_faces is that per face and for the
    background."""
    import chip_smoke
    from supir_tpu_torch.apps.face_demo import restore_with_faces
    from supir_tpu_torch.engine.factory import create_engine, tiny_test_config
    from supir_tpu_torch.models import layers
    from supir_tpu_torch.ops import groupnorm as G

    calls = []
    monkeypatch.setattr(layers, "group_norm", lambda *a: calls.append(1) or G.group_norm_plain(*a))
    cfg, cond = tiny_test_config()
    demo = TW.DemoServer(create_engine(cfg, "cpu", seed=7, cond_cfg=cond), cfg, history_dir=str(tmp_path))
    demo.stage1({"image": _png_b64(seed=8)})
    assert len(calls) == chip_smoke.expected_group_norm_launches(cfg, 0, encodes=1, decodes=1) > 0
    calls.clear()
    demo.stage2({"image": _png_b64(seed=8), "edm_steps": 3, "upscale": 2, "min_size": 64})
    per_request = chip_smoke.expected_group_norm_launches(cfg, 3, encodes=2, decodes=2)
    assert len(calls) == per_request
    calls.clear()
    image = np.random.default_rng(9).uniform(-1, 1, (64, 96, 3)).astype(np.float32)
    restore_with_faces(demo.engine, cfg, image, face_resolution=64, num_steps=3, detector=chip_smoke.two_faces)
    assert len(calls) == 3 * per_request


def test_demo_lock_serialises_engine_calls(tmp_path):
    """Twelve threads send stage-1 requests at once, with a short switch
    interval: the engine never sees two calls in flight, and every answer
    is logged."""
    import sys

    class Engine:
        def __init__(self):
            self.in_flight = self.most = self.calls = 0

        def batchify_denoise(self, x):
            self.in_flight += 1
            self.most = max(self.most, self.in_flight)
            for _ in range(200):  # a read-modify-write window for another thread
                self.calls += 0
            self.calls += 1
            self.in_flight -= 1
            return x

    engine = Engine()
    demo = TW.DemoServer(engine, None, history_dir=str(tmp_path))
    image = _png_b64(16, 16, seed=13)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=demo.stage1, args=({"image": image},)) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert engine.calls == 12 and engine.most == 1
    assert len(os.listdir(tmp_path)) == 12
