"""The port's batch-restore path against the JAX package: image I/O, the
YAML loader, checkpoint loading, the captioner's checkpoint entry point and
the slice as a whole, PNG in and PNG out, on the CPU at tiny widths.

Bounds: the host geometry (`pil_to_array`, `hwc3`, `upscale_image`,
`fix_resize`) bit for bit; `array_to_pil` within 1 uint8 level (its
bicubic resize is two fp32 matmuls here, XLA's contraction there, and the
uint8 cast truncates); loaded weights equal to JAX's load of the same files
bit for bit; the slice's float samples 5e-5 max abs, the bound of
tests/test_torch_engine.py, and its PNGs within 1 level; greedy caption
tokens exact.
"""

import dataclasses
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from supir_tpu import config as JCfg
from supir_tpu.captioner import agent as JA
from supir_tpu.engine import factory as JF
from supir_tpu.engine.supir import SUPIREngine as JaxEngine
from supir_tpu.utils import ckpt as JCkpt
from supir_tpu.utils import image as JI
from supir_tpu.utils import tokenizer as JT
from supir_tpu_torch import config as TCfg
from supir_tpu_torch.apps import cli
from supir_tpu_torch.captioner import agent as TA
from supir_tpu_torch.captioner.convert import CaptionerCheckpointError
from supir_tpu_torch.engine.factory import tiny_test_config
from supir_tpu_torch.utils import ckpt as TCkpt
from supir_tpu_torch.utils import image as TI
from supir_tpu_torch.utils import tokenizer as TT
from supir_tpu_torch.utils import weights as W
from tests import torch_parity as P
from torch_parity import one_torch_thread  # noqa: F401

SLICE_BOUND = 5e-5
ROOT = Path(__file__).resolve().parents[1]
OPTIONS = sorted(p.name for p in (ROOT / "options").glob("*.yaml"))


def _photo(h=48, w=80, seed=0, mode="RGB"):
    rng = np.random.default_rng(seed)
    shape = (h, w) if mode == "L" else (h, w, len(mode))
    return Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode)


# ------------------------------------------------------------------ image I/O

PIL_CASES = {
    "min_size": dict(min_size=64),
    "upscale": dict(upscale=1.5, min_size=64),
    "gamma": dict(min_size=64, gamma=0.7),
    "fix_resize": dict(min_size=64, fix_resize=128),
    "no_resize": dict(min_size=16),
}


@pytest.mark.parametrize("case", sorted(PIL_CASES))
def test_pil_to_array_equals_jax(case):
    img = _photo()
    arr, h0, w0 = TI.pil_to_array(img, **PIL_CASES[case])
    want, jh0, jw0 = JI.pil_to_array(img, **PIL_CASES[case])
    assert (h0, w0) == (jh0, jw0) and arr.dtype == np.float32
    assert arr.shape[0] % 64 == 0 and arr.shape[1] % 64 == 0
    np.testing.assert_array_equal(arr, want)


def test_host_geometry_equals_jax():
    """hwc3 on gray, RGBA and RGB; upscale_image up and down (with a
    min_size); fix_resize up and down: bit for bit."""
    for mode in ("L", "RGBA", "RGB"):
        x = np.asarray(_photo(mode=mode))
        np.testing.assert_array_equal(TI.hwc3(x), JI.hwc3(x))
    x = np.asarray(_photo(160, 232))
    for up, min_size in ((2.0, None), (0.5, None), (1.0, 300)):
        np.testing.assert_array_equal(TI.upscale_image(x, up, min_size), JI.upscale_image(x, up, min_size))
    for size in (64, 128):
        np.testing.assert_array_equal(TI.fix_resize(x, size), JI.fix_resize(x, size))
    with pytest.raises(ValueError):
        TI.hwc3(x.astype(np.float32))


@pytest.mark.parametrize("target", [(40, 56), (100, 150)], ids=["downscale", "upscale"])
def test_array_to_pil_within_one_level_of_jax(target):
    x = np.random.default_rng(1).uniform(-1.1, 1.1, (64, 96, 3)).astype(np.float32)
    got = np.asarray(TI.array_to_pil(x, *target), np.int16)
    want = np.asarray(JI.array_to_pil(x, *target), np.int16)
    assert got.shape == want.shape == target + (3,)
    assert np.abs(got - want).max() <= 1
    np.testing.assert_array_equal(np.asarray(TI.array_to_pil(torch.from_numpy(x))), np.asarray(JI.array_to_pil(x)))


# ------------------------------------------------------------------ YAML


@pytest.mark.parametrize("name", OPTIONS)
def test_load_yaml_config_equals_jax(name):
    cfg, extras = TCfg.load_yaml_config(str(ROOT / "options" / name))
    jcfg, jextras = JCfg.load_yaml_config(str(ROOT / "options" / name))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert extras == jextras


# ------------------------------------------------------------------ checkpoints


@pytest.fixture(scope="module")
def tiny_weights():
    """Random weights of the tiny model with its conditioner, every leaf."""
    cfg, cond = JF.tiny_test_config()
    params = P.random_params(JF.eval_shape_params(cfg, cond, image_size=64), seed=21)
    return cfg, cond, params


def _write(sd, path):
    if path.endswith(".safetensors"):
        from safetensors.torch import save_file

        save_file({k: v.contiguous() for k, v in sd.items()}, path)
    else:
        torch.save({"state_dict": sd, "global_step": 7}, path)


SUPIR_PREFIXES = ("model.control_model.", "model.diffusion_model.project_modules.",
                  "first_stage_model.denoise_encoder.")


def _checkpoints(tiny_weights, tmp_path, suffix, denoise_encoder=True):
    """An SDXL file (UNet, VAE encoder/decoder, conditioner, one stray key)
    and a SUPIR file (control net, adapters and, if asked, the denoise
    encoder), as the reference splits them."""
    cfg, _, params = tiny_weights
    sd = W.state_dict_from_jax(params, cfg)
    sdxl = {k: v for k, v in sd.items() if not k.startswith(SUPIR_PREFIXES)}
    sdxl["conditioner.embedders.0.transformer.text_model.embeddings.position_ids"] = torch.arange(77)[None]
    supir = {k: v for k, v in sd.items() if k.startswith(SUPIR_PREFIXES[:2 + denoise_encoder])}
    paths = [str(tmp_path / f"sdxl{suffix}"), str(tmp_path / f"supir{suffix}")]
    for part, path in zip((sdxl, supir), paths):
        _write(part, path)
    return paths


@pytest.mark.parametrize("suffix,denoise_encoder", [(".safetensors", True), (".ckpt", False)],
                         ids=["safetensors", "ckpt_no_denoise_encoder"])
def test_load_supir_checkpoint_equals_jax(tiny_weights, tmp_path, suffix, denoise_encoder):
    """The port's load of the files holds the weights JAX's load of them
    holds, bit for bit (the denoise encoder from the encoder where the
    SUPIR file has none), reports the stray key, and a missing key raises."""
    cfg, cond, params = tiny_weights
    sdxl, supir = _checkpoints(tiny_weights, tmp_path, suffix, denoise_encoder)
    tcfg, tcond = tiny_test_config()
    engine, report = TCkpt.load_supir_checkpoint(tcfg, sdxl, supir, tcond, device="cpu")
    jparams, jreport = JCkpt.load_supir_checkpoint(cfg, sdxl, supir)
    want = W.state_dict_from_jax(jparams, cfg)
    got = engine.model.state_dict()
    assert set(got) == set(want) and report.filled == len(got)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
    if not denoise_encoder:
        enc = {k[len("first_stage_model.encoder."):]: v for k, v in got.items()
               if k.startswith("first_stage_model.encoder.")}
        for k, v in enc.items():
            torch.testing.assert_close(got["first_stage_model.denoise_encoder." + k], v, rtol=0, atol=0)
    assert report.unused == jreport.unused == [
        "conditioner.embedders.0.transformer.text_model.embeddings.position_ids"]

    sd = TCkpt.load_torch_file(supir)
    del sd[next(k for k in sd if k.startswith("model.control_model."))]
    _write(sd, supir)
    with pytest.raises(KeyError, match="lacks 1"):
        TCkpt.load_supir_checkpoint(tcfg, sdxl, supir, tcond, device="cpu")


def test_restore_slice_matches_jax(tiny_weights, tmp_path):
    """The slice as a whole on a checkpoint both packages load from the same
    files: PNG -> pil_to_array -> stage 1 -> tokenize -> prepare_condition
    -> batchify_sample (noise injected) -> array_to_pil, at 48x80 (a 64x128
    model image, an 8x16 latent)."""
    cfg, cond, _ = tiny_weights
    sdxl, supir = _checkpoints(tiny_weights, tmp_path, ".safetensors")
    tcfg, tcond = tiny_test_config()
    tengine, _ = TCkpt.load_supir_checkpoint(tcfg, sdxl, supir, tcond, device="cpu")
    jparams, _ = JCkpt.load_supir_checkpoint(cfg, sdxl, supir)
    jengine = JaxEngine(cfg, jax.tree_util.tree_map(jnp.asarray, jparams), cond_cfg=cond)

    png = tmp_path / "photo.png"
    _photo(48, 80, seed=3).save(png)
    img = Image.open(png).convert("RGB")
    arr, h0, w0 = TI.pil_to_array(img, min_size=64)
    assert arr.shape == (64, 128, 3) and (h0, w0) == (48, 80)
    rng = np.random.default_rng(4)
    noise, center = (rng.standard_normal((1, 8, 16, 4)).astype(np.float32) for _ in range(2))
    kw = dict(num_steps=2, restoration_scale=4.0, cfg_scale=4.0, use_linear_cfg=True, cfg_scale_start=7.5,
              s_churn=0.0, color_fix_type="Wavelet", seed=3, noise_override=noise,
              center_noise_override=center)
    pos, neg = "a sharp photo, " + cfg.p_p, cfg.n_p

    x = arr[None]
    z = jengine.encode_first_stage_with_denoise(x)
    tok, tok_n = JT.tokenize([pos]), JT.tokenize([neg])
    c, uc = jengine.prepare_condition(z, jnp.asarray(tok), jnp.asarray(tok), jnp.asarray(tok_n), jnp.asarray(tok_n))
    want = np.asarray(jengine.batchify_sample(x, c, uc, z_override=z, **kw))

    tz = tengine.encode_first_stage_with_denoise(torch.from_numpy(x))
    ttok, ttok_n = TT.tokenize([pos]), TT.tokenize([neg])
    tc, tuc = tengine.prepare_condition(tz, ttok, ttok, ttok_n, ttok_n)
    got = tengine.batchify_sample(torch.from_numpy(x), tc, tuc, z_override=tz, **kw).numpy()

    assert got.shape == (1, 64, 128, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=SLICE_BOUND, rtol=0)
    got_png = np.asarray(TI.array_to_pil(got[0], h0, w0), np.int16)
    want_png = np.asarray(JI.array_to_pil(want[0], h0, w0), np.int16)
    assert got_png.shape == (48, 80, 3) and np.abs(got_png - want_png).max() <= 1


# ------------------------------------------------------------------ the CLI


def _img_dir(tmp_path, h=48, w=56):
    d = tmp_path / "in"
    d.mkdir()
    _photo(h, w, seed=5).save(d / "photo.png")
    return d


def test_cli_tiny_end_to_end(tmp_path):
    """The port's main on the CPU writes the restored image at the input's
    size, as tests/test_cli_e2e.py checks the JAX CLI."""
    out = tmp_path / "out"
    records = cli.main(["--img_dir", str(_img_dir(tmp_path)), "--save_dir", str(out), "--tiny",
                        "--random_weights", "--no_llava", "--device", "cpu", "--upscale", "1",
                        "--min_size", "64", "--edm_steps", "2", "--num_samples", "1"])
    assert [f for f in os.listdir(out)] == ["photo_0.png"]
    got = np.asarray(Image.open(out / "photo_0.png"))
    assert got.shape == (48, 56, 3)
    rec, = records
    assert rec["caption"] == "" and rec["prompt"] == TCfg.SUPIRConfig.p_p
    assert set(rec["timings"]) == {"stage1", "tokenize", "cond", "sample", "save"}


SAMPLER_CHOICES = ("RestoreEDM", "RestoreDPMPP2M", "EulerEDM", "HeunEDM", "EulerAncestral", "DPMPP2SAncestral",
                   "DPMPP2M", "LMS", "Substep")
CACHE_RUNS = {"feature_cache": ["--feature_cache_interval", "2"],
              "tiled_feature_cache": ["--use_tiled_sampling", "--sampler_tile_size", "4", "--sampler_tile_stride", "2",
                                      "--feature_cache_interval", "2"]}


@pytest.mark.parametrize("case", SAMPLER_CHOICES + tuple(sorted(CACHE_RUNS)))
def test_cli_runs_every_sampler_and_the_feature_cache(tmp_path, monkeypatch, case):
    """The tiny CLI with each --sampler choice of the JAX CLI (Substep at
    its cap of 4 steps, the others 3) and with --feature_cache_interval 2
    writes the restored image; the cache's flag reaches the untiled
    batchify_sample (recompute, reuse, recompute), and, as in the JAX CLI,
    not the tiled one."""
    from supir_tpu_torch.engine import supir as E

    flags = CACHE_RUNS.get(case, ["--sampler", case])
    steps = "4" if case == "Substep" else "3"
    seen = []
    cached = E.SUPIREngine._network_cached
    monkeypatch.setattr(E.SUPIREngine, "_network_cached",
                        lambda self, *a: seen.append(a[-1]) or cached(self, *a))
    out = tmp_path / "out"
    rec, = cli.main(["--img_dir", str(_img_dir(tmp_path)), "--save_dir", str(out), "--tiny", "--random_weights",
                     "--no_llava", "--device", "cpu", "--min_size", "64", "--edm_steps", steps] + flags)
    got = np.asarray(Image.open(out / "photo_0.png"))
    assert got.shape == (48, 56, 3) and got.std() > 0
    assert rec["saved"] == [str(out / "photo_0.png")]
    assert seen == ([True, False, True] if case == "feature_cache" else [])


TILED_FLAGS = ["--use_tile_vae", "--use_tiled_sampling", "--encoder_tile_size", "32", "--decoder_tile_size", "4",
               "--sampler_tile_size", "4", "--sampler_tile_stride", "2"]
PORTED_RUNS = {
    "tiled": TILED_FLAGS,
    "tiled_dpmpp2m": TILED_FLAGS + ["--sampler", "RestoreDPMPP2M"],
    "lightning": ["--sampler", "RestoreDPMPP2M"],
}


@pytest.mark.parametrize("case", sorted(PORTED_RUNS))
def test_cli_tiled_and_lightning_end_to_end(tmp_path, case):
    """The tiny CLI through the tiled VAE and tiled sampling (TiledRestoreEDM,
    and TiledRestoreDPMPP2M by --sampler), and through RestoreDPMPP2M
    untiled: the restored image at the input's size."""
    out = tmp_path / "out"
    rec, = cli.main(["--img_dir", str(_img_dir(tmp_path)), "--save_dir", str(out), "--tiny", "--random_weights",
                     "--no_llava", "--device", "cpu", "--min_size", "64", "--edm_steps", "3"] + PORTED_RUNS[case])
    got = np.asarray(Image.open(out / "photo_0.png"))
    assert got.shape == (48, 56, 3) and got.std() > 0
    assert rec["saved"] == [str(out / "photo_0.png")]


@pytest.mark.parametrize("name", ["SUPIR_v0_tiled.yaml", "SUPIR_v0_Juggernautv9_lightning.yaml"])
def test_cli_shipped_options_are_ported(name, monkeypatch):
    """Both option files that the port refused before pass check_sampler
    with the flags they are run with; the tiled one without
    --use_tiled_sampling is a ValueError, as in the JAX CLI (its sampler
    table has no tiled sampler)."""
    cfg, _ = TCfg.load_yaml_config(str(ROOT / "options" / name))
    tiled = cfg.sampler.name.startswith("Tiled")
    args = cli.build_parser().parse_args(["--img_dir", ".", "--save_dir", "."]
                                         + (["--use_tile_vae", "--use_tiled_sampling"] if tiled else []))
    cli.check_sampler(args, cfg.sampler.name)
    assert cli.sampler_for(args) is None
    if tiled:
        args.use_tiled_sampling = False
        with pytest.raises(ValueError, match="--use_tiled_sampling"):
            cli.check_sampler(args, cfg.sampler.name)
    args.sampler = "DPMPP2M"
    args.use_tiled_sampling = True
    assert cli.sampler_for(args) == "TiledRestoreDPMPP2M"


def test_cli_refuses_without_cuda(tmp_path, monkeypatch):
    """Without --device the CLI runs on the card, and without one it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--img_dir", str(tmp_path), "--save_dir", str(tmp_path / "out"), "--tiny", "--no_llava"])


# ------------------------------------------------------------------ captioner checkpoint


@pytest.fixture(scope="module")
def hf_llava_dir(tmp_path_factory):
    """A tiny HF-layout llava directory written with transformers' own
    modules (as tests/test_captioner_load.py:16-60 writes it)."""
    from safetensors.torch import save_file
    from transformers import CLIPVisionConfig, CLIPVisionModel, LlamaConfig, LlamaForCausalLM

    cfg = JA.CaptionerConfig.tiny()
    torch.manual_seed(0)
    llama = LlamaForCausalLM(LlamaConfig(
        vocab_size=cfg.llama.vocab_size, hidden_size=cfg.llama.dim, intermediate_size=cfg.llama.hidden_dim,
        num_hidden_layers=cfg.llama.layers, num_attention_heads=cfg.llama.heads,
        num_key_value_heads=cfg.llama.kv_heads, max_position_embeddings=cfg.llama.max_seq_len))
    vision = CLIPVisionModel(CLIPVisionConfig(
        hidden_size=cfg.vision.width, intermediate_size=cfg.vision.width * 4,
        num_hidden_layers=cfg.vision.layers, num_attention_heads=cfg.vision.heads,
        image_size=cfg.vision.image_size, patch_size=cfg.vision.patch_size))
    sd = dict(llama.state_dict())
    sd.update({"model.vision_tower.vision_tower." + k: v for k, v in vision.state_dict().items()})
    for i, (cin, cout) in ((0, (cfg.vision.width, cfg.llama.dim)), (2, (cfg.llama.dim, cfg.llama.dim))):
        sd.update({f"model.mm_projector.{i}.{k}": v for k, v in torch.nn.Linear(cin, cout).state_dict().items()})
    d = tmp_path_factory.mktemp("llava_tiny")
    save_file({k: v.contiguous() for k, v in sd.items()}, str(d / "model.safetensors"))
    hf = {"hidden_size": cfg.llama.dim, "num_hidden_layers": cfg.llama.layers,
          "num_attention_heads": cfg.llama.heads, "intermediate_size": cfg.llama.hidden_dim,
          "vocab_size": cfg.llama.vocab_size, "max_position_embeddings": cfg.llama.max_seq_len,
          "vision_config": {"image_size": cfg.vision.image_size, "patch_size": cfg.vision.patch_size,
                            "hidden_size": cfg.vision.width, "num_hidden_layers": cfg.vision.layers,
                            "num_attention_heads": cfg.vision.heads}}
    (d / "config.json").write_text(json.dumps(hf))
    return str(d), hf


def test_captioner_config_from_hf_equals_jax(hf_llava_dir):
    _, hf = hf_llava_dir
    for d in (hf, {"hidden_size": 4096, "num_hidden_layers": 32, "num_key_value_heads": 8, "rope_theta": 5e5}):
        assert dataclasses.asdict(TA.CaptionerConfig.from_hf_config(d)) == \
            dataclasses.asdict(JA.CaptionerConfig.from_hf_config(d))


@pytest.mark.parametrize("bits", [None, 4], ids=["fp32", "int4"])
def test_create_default_matches_jax(hf_llava_dir, monkeypatch, bits):
    """create_default on the directory ($LLAVA_MODEL_PATH, config.json
    read, byte tokenizer) decodes the JAX agent's greedy tokens, token for
    token, unquantized and with --load_4bit_llava."""
    d, _ = hf_llava_dir
    monkeypatch.setenv("LLAVA_MODEL_PATH", d)
    for agent_cls in (TA.CaptionerAgent, JA.CaptionerAgent):
        monkeypatch.setattr(agent_cls, "load_tokenizer", staticmethod(lambda p: None))
    agent = TA.CaptionerAgent.create_default(device="cpu", load_4bit=bits == 4)
    jagent = JA.CaptionerAgent.create_default(weights_dir=d, load_4bit=bits == 4)
    assert agent.cfg.llama.quantize_int4 == (bits == 4) and agent.cfg.vision.width == 64
    img = np.random.default_rng(6).integers(0, 256, (80, 56, 3), dtype=np.uint8)
    seqs, stop_at, _ = agent.generate([img], temperature=0.0)
    tok, plen, caches, stopper, _ = jagent._prefill_images([img], None, "vicuna_v1")
    want, want_stop = jagent._decode_tokens(tok, plen, caches, 0, 0.0, 0.7, 2, stopper)
    np.testing.assert_array_equal(seqs, np.asarray(want))
    np.testing.assert_array_equal(stop_at, np.asarray(want_stop))


def test_create_default_refuses_missing_or_incomplete(hf_llava_dir, tmp_path, monkeypatch):
    from safetensors.torch import load_file, save_file

    d, _ = hf_llava_dir
    monkeypatch.delenv("LLAVA_MODEL_PATH", raising=False)
    with pytest.raises(CaptionerCheckpointError, match="no captioner weights"):
        TA.CaptionerAgent.create_default(device="cpu")
    with pytest.raises(RuntimeError, match="no captioner weights"):
        TA.CaptionerAgent.create_default(str(tmp_path / "nowhere"), device="cpu")
    bad = tmp_path / "bad"
    bad.mkdir()
    sd = {k: v for k, v in load_file(os.path.join(d, "model.safetensors")).items() if "mm_projector" not in k}
    save_file(sd, str(bad / "model.safetensors"))
    (bad / "config.json").write_text(Path(d, "config.json").read_text())
    monkeypatch.setattr(TA.CaptionerAgent, "load_tokenizer", staticmethod(lambda p: None))
    with pytest.raises(CaptionerCheckpointError, match="incomplete"):
        TA.CaptionerAgent.create_default(str(bad), device="cpu")


# ------------------------------------------------------------------ boundary and launch counts


def test_new_modules_import_no_jax():
    """The slice's modules, imported in a fresh interpreter with the
    tokenizer run once (it may import transformers), leave no jax, flax,
    supir_tpu or CKPT_PTH in sys.modules, and no module of the package
    names CKPT_PTH in an import."""
    import ast
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import supir_tpu_torch.apps.cli, supir_tpu_torch.captioner.convert, supir_tpu_torch.utils.ckpt\n"
        "import supir_tpu_torch.utils.image, supir_tpu_torch.models.embedders, supir_tpu_torch.utils.tiling\n"
        "import supir_tpu_torch.parallel.tiled_vae, supir_tpu_torch.parallel.tiled_sampler\n"
        "from supir_tpu_torch.utils.tokenizer import tokenize\n"
        "tokenize(['a photo'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'supir_tpu', 'CKPT_PTH'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=ROOT)
    for path in (ROOT / "supir_tpu_torch").rglob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        assert not [m for m in names if m.split(".")[0] in ("jax", "flax", "supir_tpu", "CKPT_PTH")], path


def test_cli_launch_counts_match_chip_smoke(tmp_path, monkeypatch):
    """chip_smoke.py's [cli] counts on a tiny CLI run on the CPU: the
    GroupNorm calls (K2's sites) are one network's per step and the VAE's
    over two encodes and three decodes; at full width an h x w latent has
    the square's K1 sites where each level holds as many tokens."""
    import chip_smoke
    from supir_tpu_torch.models import layers
    from supir_tpu_torch.ops import groupnorm as G

    calls = []
    monkeypatch.setattr(layers, "group_norm", lambda *a: calls.append(1) or G.group_norm_plain(*a))
    cli.main(["--img_dir", str(_img_dir(tmp_path)), "--save_dir", str(tmp_path / "out"), "--tiny",
              "--no_llava", "--device", "cpu", "--min_size", "64", "--edm_steps", "3"])
    cfg, _ = tiny_test_config()
    assert len(calls) == chip_smoke.expected_group_norm_launches(cfg, 3, encodes=2, decodes=3) > 0
    assert chip_smoke.expected_group_norm_launches(cfg, 3, 4) == \
        chip_smoke.expected_group_norm_launches(cfg, 3, encodes=2, decodes=2)
    full = TCfg.SUPIRConfig()
    assert chip_smoke.expected_flash_sites(full, (128, 192)) == chip_smoke.expected_flash_sites(full, 128) == 106
    assert chip_smoke.expected_flash_sites(full, (64, 96)) == chip_smoke.expected_flash_sites(full, (96, 64))
    assert chip_smoke.expected_flash_launches(full, (128, 192), 4, vae_passes=5) == 424


@pytest.mark.parametrize("case", ["tiled", "lightning"])
def test_cli_tiled_and_lightning_launch_counts_match_chip_smoke(tmp_path, monkeypatch, case):
    """chip_smoke.py's [tiled] and [lightning] counts on tiny CPU runs. Tiled:
    the tiled VAE's GroupNorm sites never call `layers.group_norm` (K2 on
    the card; they take pooled or given statistics), so the calls are the
    sampler's network calls alone, one per step on all windows folded.
    Lightning: per step one network call, and the VAE's sites over one
    encode (stage 1) and three decodes (RestoreDPMPP2M has no x_center
    encode)."""
    import chip_smoke
    from supir_tpu_torch.models import layers
    from supir_tpu_torch.ops import groupnorm as G

    calls = []
    monkeypatch.setattr(layers, "group_norm", lambda *a: calls.append(1) or G.group_norm_plain(*a))
    pooled = layers.GroupNorm32.pooled_sites
    img_dir = _img_dir(tmp_path)
    cli.main(["--img_dir", str(img_dir), "--save_dir", str(tmp_path / "out"), "--tiny", "--no_llava", "--device",
              "cpu", "--min_size", "64", "--edm_steps", "3"] + PORTED_RUNS[case])
    cfg, _ = tiny_test_config()
    if case == "lightning":
        assert layers.GroupNorm32.pooled_sites == pooled
        assert len(calls) == chip_smoke.expected_group_norm_launches(cfg, 3, encodes=1, decodes=3) > 0
        return
    model_h, model_w = TI.pil_to_array(Image.open(img_dir / "photo.png"), min_size=64)[0].shape[:2]
    want = chip_smoke.expected_tiled_launches(cfg, (model_h // 8, model_w // 8), 3, tile_size=4, tile_stride=2)
    assert len(calls) == want["K2"] == chip_smoke.expected_group_norm_launches(cfg, 3, vae_passes=0) > 0
    assert layers.GroupNorm32.pooled_sites > pooled
    # at full width: 2048^2 is 9 windows of 128 folded into one call a step,
    # 4096^2 is 49 windows; the VAE's 512-wide head never reaches K1
    full = TCfg.SUPIRConfig()
    assert chip_smoke.expected_tiled_launches(full, 256, 4) == {
        "K1": 106 * 4, "K2": chip_smoke.expected_group_norm_launches(full, 4, vae_passes=0)}
    assert chip_smoke.expected_tiled_launches(full, 512, 2, tile_chunk=16)["K1"] == 106 * 2 * 4
    assert chip_smoke.tiled_vae_tiles(full, (2048, 2048), 512, 64) == (16, 16)
    assert chip_smoke.expected_tiled_vae_flash(full, (2048, 2048), 512, 64, (8, 4), 2, 3) == 0
    reduced = chip_smoke._reduced_cfg()  # VAE head 128: each chunk call's attention reaches K1
    assert chip_smoke.expected_tiled_vae_flash(reduced, (512, 512), 256, 32, (3, 4), 1, 1) == 2 + 1
