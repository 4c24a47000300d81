"""The port's real-weight entry points against the JAX package on the CPU:
the chat CLI with --weights on a tiny HF llava directory, the LLaVA weight
tools, and the readiness drill (supir_tpu_torch/tools/load_real.py) on a
reference-keyed checkpoint written from the port's random tiny model.

Bounds: the chat's greedy answer exactly JAX's; the weight tools' files
bit for bit; the drill's converted state within 1e-6 of JAX's
load_supir_checkpoint of the same file (both copy the file's fp32 values:
the bound only allows for the transposes); its PSNR rerun at the JAX
drill test's 45 dB bar.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from supir_tpu_torch.captioner import chat as TChat
from supir_tpu_torch.captioner import weight_tools as TWT
from supir_tpu_torch.tools import load_real as TDrill
from torch_parity import one_torch_thread  # noqa: F401

STATE_TOL = 1e-6


# ------------------------------------------------------------------ chat --weights


@pytest.fixture(scope="module")
def llava_dir(tmp_path_factory):
    from torch_parity import write_tiny_llava_dir

    d = str(tmp_path_factory.mktemp("llava_tiny"))
    write_tiny_llava_dir(d)
    return d


def _last_line(capsys) -> str:
    return capsys.readouterr().out.strip().splitlines()[-1]


def test_chat_weights_matches_jax(llava_dir, tmp_path, capsys, monkeypatch):
    """`chat --weights DIR --image ... --query ...` greedy: the port's
    answer is the JAX chat's on the same directory."""
    from supir_tpu.captioner import agent as JA
    from supir_tpu.captioner import chat as JChat
    from supir_tpu_torch.captioner import agent as TA

    for agent_cls in (TA.CaptionerAgent, JA.CaptionerAgent):  # no tokenizer files: the byte fallback
        monkeypatch.setattr(agent_cls, "load_tokenizer", staticmethod(lambda p: None))
    img = tmp_path / "img.png"
    Image.fromarray(np.random.default_rng(3).integers(0, 256, (72, 56, 3), dtype=np.uint8)).save(img)
    flags = ["--weights", llava_dir, "--image", str(img), "--query", "What is in the picture?", "--temperature", "0"]
    TChat.main(flags + ["--device", "cpu"])
    got = _last_line(capsys)
    JChat.main(flags)
    want = _last_line(capsys)
    assert got == want and got


def test_chat_without_weights_is_a_usage_error(tmp_path, monkeypatch):
    monkeypatch.delenv("LLAVA_MODEL_PATH", raising=False)
    with pytest.raises(SystemExit):
        TChat.main(["--weights", str(tmp_path / "nowhere"), "--device", "cpu", "--query", "Hi"])


# ------------------------------------------------------------------ weight tools


def _base_sd(rng):
    return {"model.embed_tokens.weight": rng.normal(size=(10, 4)).astype(np.float32),
            "lm_head.weight": rng.normal(size=(10, 4)).astype(np.float32),
            "model.layers.0.mlp.up_proj.weight": rng.normal(size=(8, 4)).astype(np.float32)}


def _target_sd(rng):
    """An extended vocabulary (12 rows over 10) and a multimodal addition."""
    return {"model.embed_tokens.weight": rng.normal(size=(12, 4)).astype(np.float32),
            "lm_head.weight": rng.normal(size=(12, 4)).astype(np.float32),
            "model.layers.0.mlp.up_proj.weight": rng.normal(size=(8, 4)).astype(np.float32),
            "model.mm_projector.0.weight": rng.normal(size=(4, 4)).astype(np.float32)}


def _files(path):
    from safetensors.numpy import load_file

    return load_file(os.path.join(path, "model.safetensors")), sorted(os.listdir(path))


def test_weight_tools_files_equal_jax(tmp_path):
    """apply-delta, make-delta and consolidate through both packages' CLIs:
    the same tensors bit for bit, the same sidecar files."""
    from safetensors.numpy import save_file

    from supir_tpu.captioner import weight_tools as JWT

    rng = np.random.default_rng(0)
    base, target = _base_sd(rng), _target_sd(rng)
    bdir, tdir, sdir = tmp_path / "base", tmp_path / "target", tmp_path / "shards"
    for d in (bdir, tdir, sdir):
        d.mkdir()
    save_file(base, str(bdir / "model.safetensors"))
    save_file(target, str(tdir / "model.safetensors"))
    (tdir / "config.json").write_text('{"model_type": "llava"}')
    (tdir / "tokenizer.model").write_bytes(b"\x00tok")
    save_file({"a": rng.normal(size=(2, 3)).astype(np.float32)}, str(sdir / "model-00001-of-00002.safetensors"))
    save_file({"b": rng.normal(size=(5,)).astype(np.float32)}, str(sdir / "model-00002-of-00002.safetensors"))
    (sdir / "model.safetensors.index.json").write_text("{}")
    (sdir / "config.json").write_text("{}")
    for tag, mod in (("t", TWT), ("j", JWT)):
        mod.main(["make-delta", "--base", str(bdir), "--target", str(tdir), "--delta", str(tmp_path / f"{tag}d")])
        mod.main(["apply-delta", "--base", str(bdir), "--delta", str(tmp_path / f"{tag}d"),
                  "--target", str(tmp_path / f"{tag}o")])
        mod.main(["consolidate", "--src", str(sdir), "--dst", str(tmp_path / f"{tag}c")])
    for kind in ("d", "o", "c"):
        (got, got_names), (want, want_names) = _files(tmp_path / f"t{kind}"), _files(tmp_path / f"j{kind}")
        assert got_names == want_names and sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (kind, k)
    assert _files(tmp_path / "tc")[1] == ["config.json", "model.safetensors"]
    recovered = _files(tmp_path / "to")[0]
    for k in target:
        np.testing.assert_allclose(recovered[k], target[k], atol=1e-6, err_msg=k)


def test_weight_tools_delta_round_trip_and_refusals():
    rng = np.random.default_rng(1)
    base, target = _base_sd(rng), _target_sd(rng)
    delta = TWT.make_delta_sd(base, target)
    back = TWT.apply_delta_sd(base, delta)
    assert set(back) == set(target)
    for k in target:
        np.testing.assert_allclose(back[k], target[k], atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(delta["model.mm_projector.0.weight"], target["model.mm_projector.0.weight"])
    with pytest.raises(KeyError, match="not in base model"):
        TWT.apply_delta_sd(base, {"model.layers.99.bogus.weight": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="dimension mismatch"):
        TWT.apply_delta_sd(base, {"model.layers.0.mlp.up_proj.weight": np.zeros((9, 4), np.float32)})
    with pytest.raises(FileNotFoundError):
        TWT.load_state_dir(os.path.dirname(TWT.__file__) + "/../csrc")


def test_load_state_dir_reads_bf16_and_bin(tmp_path):
    from safetensors.torch import save_file

    w = torch.randn(3, 4)
    save_file({"a": w.to(torch.bfloat16)}, str(tmp_path / "a.safetensors"))
    torch.save({"state_dict": {"b": w, "n": torch.arange(3)}}, str(tmp_path / "b.bin"))
    sd = TWT.load_state_dir(str(tmp_path))
    assert sd["a"].dtype == np.float32 and np.array_equal(sd["a"], w.to(torch.bfloat16).float().numpy())
    assert np.array_equal(sd["b"], w.numpy()) and sd["n"].tolist() == [0, 1, 2]


# ------------------------------------------------------------------ the drill


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """The port's tiny fp32 SUPIRModel (no text towers) with every weight
    random, its state dict (the reference's keys) written as one
    safetensors file."""
    import dataclasses

    from safetensors.torch import save_file

    from supir_tpu_torch.config import SUPIRConfig
    from supir_tpu_torch.engine.factory import create_engine

    cfg = dataclasses.replace(SUPIRConfig.tiny(), ae_dtype="fp32", diffusion_dtype="fp32")
    model = create_engine(cfg, "cpu", seed=3).model
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in model.parameters():
            if not p.any():  # the zero-initialised heads
                p.copy_(0.02 * torch.randn(p.shape, generator=g))
    d = tmp_path_factory.mktemp("drill")
    path = str(d / "tiny_supir_merged.safetensors")
    save_file({k: v.contiguous() for k, v in model.state_dict().items()}, path)
    return path, str(d)


DRILL = ["--tiny", "--random_conditioner", "--allow_hash_tokenizer", "--device", "cpu", "--steps", "2",
         "--size", "64"]


def test_drill_pass_and_psnr_round_trip(tiny_ckpt, capsys):
    path, d = tiny_ckpt
    out_png = os.path.join(d, "out.png")
    assert TDrill.main(DRILL + ["--sdxl", path, "--save", out_png]) == 0
    out = capsys.readouterr().out
    assert "VERDICT: PASS (3 stages)" in out and "[PASS] restore-5step" in out
    assert np.asarray(Image.open(out_png)).shape == (64, 64, 3)
    assert TDrill.main(DRILL + ["--sdxl", path, "--save", os.path.join(d, "again.png"), "--ref_out", out_png,
                                "--psnr_min", "45"]) == 0
    out = capsys.readouterr().out
    assert "[PASS] psnr — 99.00 dB" in out and "VERDICT: PASS (4 stages)" in out


def test_drill_fails_on_a_missing_key(tiny_ckpt, tmp_path, capsys):
    from safetensors.torch import load_file, save_file

    path, _ = tiny_ckpt
    sd = load_file(path)
    gone = sorted(k for k in sd if k.startswith("model.control_model."))[0]
    del sd[gone]
    bad = str(tmp_path / "incomplete.safetensors")
    save_file(sd, bad)
    assert TDrill.main(DRILL + ["--sdxl", bad, "--save", str(tmp_path / "x.png")]) == 1
    out = capsys.readouterr().out
    assert "[FAIL] conversion" in out and gone in out and "VERDICT: FAIL (1 stage(s): conversion)" in out
    assert not os.path.exists(tmp_path / "x.png")


def test_drill_conversion_equals_jax(tiny_ckpt):
    """The drill's stage-1 state dict against JAX's load_supir_checkpoint of
    the same file, carried over by utils/weights.py:state_dict_from_jax."""
    import dataclasses

    from supir_tpu.config import SUPIRConfig as JConfig
    from supir_tpu.utils.ckpt import load_supir_checkpoint
    from supir_tpu_torch.utils.weights import state_dict_from_jax

    path, _ = tiny_ckpt
    args = TDrill.build_parser().parse_args(DRILL + ["--sdxl", path])
    engine, cfg = TDrill._conversion(TDrill.Drill(), args, torch.device("cpu"))
    jcfg = dataclasses.replace(JConfig.tiny(), ae_dtype="fp32", diffusion_dtype="fp32")
    params, report = load_supir_checkpoint(jcfg, path, with_conditioner=False)
    assert not report.missing
    want = state_dict_from_jax(params, cfg)
    got = engine.model.state_dict()
    assert sorted(got) == sorted(want)
    worst = max(float((got[k].float() - want[k]).abs().max()) for k in want)
    assert worst <= STATE_TOL


def test_drill_refuses_without_cuda(tiny_ckpt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TDrill.main(["--sdxl", tiny_ckpt[0], "--tiny"])
