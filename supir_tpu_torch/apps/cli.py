"""Batch restore CLI: a folder of photos in, restored PNGs out (counterpart
of supir_tpu/apps/cli.py, the reference's `test.py` surface).

    python -m supir_tpu_torch.apps.cli --img_dir IN --save_dir OUT [--no_llava] ...
    python -m supir_tpu_torch.apps.cli --img_dir IN --save_dir OUT --tiny --random_weights \\
        --no_llava --device cpu    # tiny random model on the CPU

Per image: `pil_to_array` (upscale, min_size, 64-rounded), the stage-1
denoise-encode and decode, optionally a LLaVA caption of the stage-1
denoise of a 512-short-side copy (test.py:84-92), `tokenize` of the caption
plus the positive prompt and of the negative prompt, `prepare_condition`
(CLIP-L and OpenCLIP bigG), `batchify_sample` (the config's sampler,
RestoreEDM or RestoreDPMPP2M (options/SUPIR_v0_Juggernautv9_lightning.yaml),
or any of the JAX CLI's nine by `--sampler`; `--feature_cache_interval`
turns on RestoreEDM's cross-step feature cache) and `array_to_pil` back to the input's size times `--upscale`, saved as
`<name>_<i>.png`.

The tiled path for large outputs (options/SUPIR_v0_tiled.yaml):
`--use_tile_vae` sends every VAE pass through the tiled VAE
(`--encoder_tile_size`, `--decoder_tile_size`), `--use_tiled_sampling`
samples with `batchify_sample_tiled` over `--sampler_tile_size` windows at
`--sampler_tile_stride` (TiledRestoreEDM, or TiledRestoreDPMPP2M where
`--sampler` names a DPM++ sampler).

The flags are the JAX CLI's, plus `--device` (default cuda; without a card
that raises unless the caller names the CPU). As in the JAX CLI,
`--feature_cache_interval` reaches only the untiled `batchify_sample`: the
tiled cache is the engine's (`batchify_sample_tiled(feature_cache_interval=)`).
A tiled sampler in the yaml without `--use_tiled_sampling` is a
ValueError (the JAX CLI fails there too).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time

import numpy as np
import torch
from PIL import Image

from supir_tpu_torch.captioner.agent import CaptionerAgent
from supir_tpu_torch.captioner.convert import CaptionerCheckpointError
from supir_tpu_torch.config import ConditionerConfig, load_yaml_config
from supir_tpu_torch.engine.factory import create_engine, tiny_test_config
from supir_tpu_torch.utils.ckpt import load_supir_checkpoint
from supir_tpu_torch.utils.device import resolve_device
from supir_tpu_torch.utils.image import array_to_pil, pil_to_array
from supir_tpu_torch.utils.tokenizer import tokenize

IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".webp", ".bmp")
# fp16 maps to bf16, as the JAX CLI maps it; the reference bans fp16 autoencoders (SUPIR_model.py:24)
DTYPE_MAP = {"fp16": "bf16", "bf16": "bf16", "fp32": "fp32"}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("supir_tpu_torch batch restorer")
    ap.add_argument("--img_dir", type=str, required=True)
    ap.add_argument("--save_dir", type=str, required=True)
    ap.add_argument("--opt", type=str, default="options/SUPIR_v0.yaml")
    ap.add_argument("--upscale", type=float, default=1.0)
    ap.add_argument("--SUPIR_sign", type=str, default="Q", choices=["F", "Q"])
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--min_size", type=int, default=1024)
    ap.add_argument("--edm_steps", type=int, default=50)
    ap.add_argument("--s_stage1", type=float, default=-1.0)
    ap.add_argument("--s_churn", type=float, default=5.0)
    ap.add_argument("--s_noise", type=float, default=1.003)
    ap.add_argument("--s_cfg", type=float, default=7.5)
    ap.add_argument("--s_stage2", type=float, default=1.0)
    ap.add_argument("--num_samples", type=int, default=1)
    ap.add_argument("--a_prompt", type=str, default=None)
    ap.add_argument("--n_prompt", type=str, default=None)
    ap.add_argument("--gamma_correction", type=float, default=1.0,
                    help="input gamma (reference UI knob, gradio_demo.py:112-115)")
    ap.add_argument("--color_fix_type", type=str, default="Wavelet", choices=["None", "AdaIn", "Wavelet"])
    ap.add_argument("--linear_CFG", action="store_true", default=True)
    ap.add_argument("--no_linear_CFG", dest="linear_CFG", action="store_false")
    ap.add_argument("--linear_s_stage2", action="store_true", default=False)
    ap.add_argument("--spt_linear_CFG", type=float, default=4.0)
    ap.add_argument("--spt_linear_s_stage2", type=float, default=0.0)
    ap.add_argument("--no_llava", action="store_true", default=False)
    ap.add_argument("--load_8bit_llava", action="store_true", default=False)
    ap.add_argument("--load_4bit_llava", action="store_true", default=False)
    ap.add_argument("--use_tile_vae", action="store_true", default=False)
    ap.add_argument("--encoder_tile_size", type=int, default=512)
    ap.add_argument("--decoder_tile_size", type=int, default=64)
    ap.add_argument("--sampler", type=str, default=None,
                    choices=["RestoreEDM", "RestoreDPMPP2M", "EulerEDM", "HeunEDM", "EulerAncestral",
                             "DPMPP2SAncestral", "DPMPP2M", "LMS", "Substep"],
                    help="override the config sampler")
    ap.add_argument("--use_tiled_sampling", action="store_true", default=False)
    ap.add_argument("--sampler_tile_size", type=int, default=128)
    ap.add_argument("--sampler_tile_stride", type=int, default=64)
    ap.add_argument("--loading_half_params", action="store_true", default=None,
                    help="parameters in the compute dtypes (the default)")
    ap.add_argument("--full_params", dest="loading_half_params", action="store_false",
                    help="every parameter in fp32, and so every computation")
    ap.add_argument("--ae_dtype", type=str, default=None, choices=["bf16", "fp32"],
                    help="autoencoder (and text conditioner) dtype (reference test.py --ae_dtype)")
    ap.add_argument("--diff_dtype", type=str, default=None, choices=["fp16", "bf16", "fp32"],
                    help="diffusion dtype (reference test.py --diff_dtype; fp16 maps to bf16)")
    ap.add_argument("--random_weights", action="store_true",
                    help="random weights from a seed, no checkpoints (smoke runs, benchmarks)")
    ap.add_argument("--tiny", action="store_true", help="the width-scaled tiny model (tests)")
    ap.add_argument("--profile_dir", type=str, default=None,
                    help="write a torch.profiler trace of each image's sample phase there")
    ap.add_argument("--feature_cache_interval", type=int, default=0,
                    help="cross-step encoder/control feature cache of RestoreEDM, untiled (0 = off, exact; "
                         "N > 1 recomputes every N steps)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="where the models run: cuda (the default) or cpu")
    return ap


def sampler_for(args) -> str | None:
    """The sampler name batchify_sample(_tiled) gets, as the JAX CLI maps
    it: with --use_tiled_sampling, --sampler picks TiledRestoreDPMPP2M for
    a DPM++ sampler and TiledRestoreEDM for any other; None leaves the
    choice to the config (the tiled call runs the yaml's tiled sampler, or
    TiledRestoreEDM)."""
    if args.sampler and args.use_tiled_sampling:
        return "TiledRestoreDPMPP2M" if "DPMPP" in args.sampler else "TiledRestoreEDM"
    return args.sampler


def check_sampler(args, config_sampler: str) -> None:
    """Raise on a tiled sampler without tiled sampling: with
    --use_tiled_sampling every name maps to one of the two tiled samplers."""
    sampler = args.sampler or config_sampler
    if not args.use_tiled_sampling and sampler.startswith("Tiled"):
        raise ValueError(f"the config's sampler {sampler!r} samples tiles: pass --use_tiled_sampling "
                         "(or --sampler for the untiled path)")


def create_engine_from_args(args):
    """-> (engine, cfg): the tiny model, a checkpoint from the yaml's
    SDXL_CKPT (and SUPIR_CKPT_Q/F) where it exists, or random weights."""
    device = resolve_device(args.device)
    param_dtype = torch.float32 if args.loading_half_params is False else None
    if args.tiny:
        cfg, cond_cfg = tiny_test_config()
        check_sampler(args, cfg.sampler.name)
        return create_engine(cfg, device, seed=0, param_dtype=param_dtype, cond_cfg=cond_cfg), cfg
    cfg, extras = load_yaml_config(args.opt)
    check_sampler(args, cfg.sampler.name)
    cfg = dataclasses.replace(
        cfg,
        ae_dtype=DTYPE_MAP[args.ae_dtype] if args.ae_dtype else cfg.ae_dtype,
        diffusion_dtype=DTYPE_MAP[args.diff_dtype] if args.diff_dtype else cfg.diffusion_dtype,
    )
    ckpt = extras.get("SDXL_CKPT")
    if ckpt and os.path.exists(ckpt):
        engine, report = load_supir_checkpoint(cfg, ckpt, extras.get(f"SUPIR_CKPT_{args.SUPIR_sign}"),
                                               ConditionerConfig(), device, param_dtype)
        print("checkpoint load:", report.summary())
        return engine, cfg
    if args.random_weights:
        return create_engine(cfg, device, seed=0, param_dtype=param_dtype, cond_cfg=ConditionerConfig()), cfg
    raise SystemExit(f"no checkpoint at {ckpt!r}; set SDXL_CKPT in {args.opt} or pass "
                     "--random_weights for a smoke run")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    """Restore every image of --img_dir. Returns one record per image:
    its name, caption, prompt, the saved paths and the seconds of each
    phase (stage1, caption, tokenize, cond, sample, save)."""
    args = build_parser().parse_args(argv)
    engine, cfg = create_engine_from_args(args)
    device = engine.device
    if args.use_tile_vae:
        engine.init_tile_vae(args.encoder_tile_size, args.decoder_tile_size)

    os.makedirs(args.save_dir, exist_ok=True)
    names = sorted(f for f in os.listdir(args.img_dir) if f.lower().endswith(IMAGE_SUFFIXES))

    captioner = None
    if not args.no_llava:
        try:
            captioner = CaptionerAgent.create_default(device=device, load_8bit=args.load_8bit_llava,
                                                      load_4bit=args.load_4bit_llava)
        except CaptionerCheckpointError as e:
            print(f"[warn] captioner unavailable ({e}); proceeding without")

    p_p = args.a_prompt if args.a_prompt is not None else cfg.p_p
    n_p = args.n_prompt if args.n_prompt is not None else cfg.n_p

    records = []
    for name in names:
        t_start = time.perf_counter()
        img = Image.open(os.path.join(args.img_dir, name)).convert("RGB")
        arr, h0, w0 = pil_to_array(img, upscale=args.upscale, min_size=args.min_size,
                                   gamma=args.gamma_correction)
        x = torch.from_numpy(arr)[None]

        timings = {}
        t0 = time.perf_counter()
        z = engine.encode_first_stage_with_denoise(x)
        engine.decode_first_stage(z)
        _sync(device)
        timings["stage1"] = time.perf_counter() - t0

        caption = ""
        if captioner is not None:
            # the captioner sees the stage-1 denoise of a 512-short-side copy
            # of the input, not the full-size stage-1 output (test.py:84-92)
            t0 = time.perf_counter()
            arr512, h1, w1 = pil_to_array(img, upscale=args.upscale, min_size=args.min_size, fix_resize=512)
            x512 = engine.batchify_denoise(torch.from_numpy(arr512)[None])
            cap_img = array_to_pil(x512[0], h1, w1)
            caption = captioner.gen_image_caption([np.asarray(cap_img)])[0]
            timings["caption"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        prompt = caption + p_p
        tok_l = tokenize([prompt] * args.num_samples)
        tok_n = tokenize([n_p] * args.num_samples)
        timings["tokenize"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        zN = z.repeat_interleave(args.num_samples, 0)
        xN = x.repeat_interleave(args.num_samples, 0)
        c, uc = engine.prepare_condition(zN, tok_l, tok_l, tok_n, tok_n)
        _sync(device)
        timings["cond"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        profiler = contextlib.nullcontext()
        if args.profile_dir:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
        sample_kwargs = dict(
            num_steps=args.edm_steps,
            restoration_scale=args.s_stage1 if args.s_stage1 >= 0 else cfg.sampler.restore_cfg,
            s_churn=args.s_churn, s_noise=args.s_noise, cfg_scale=args.s_cfg, control_scale=args.s_stage2,
            seed=args.seed, color_fix_type=args.color_fix_type, use_linear_cfg=args.linear_CFG,
            use_linear_control_scale=args.linear_s_stage2, cfg_scale_start=args.spt_linear_CFG,
            control_scale_start=args.spt_linear_s_stage2, sampler_name=sampler_for(args),
            z_override=zN,
        )
        if args.feature_cache_interval and not args.use_tiled_sampling:
            sample_kwargs["feature_cache_interval"] = args.feature_cache_interval
        with profiler:
            if args.use_tiled_sampling:
                samples = engine.batchify_sample_tiled(xN, c, uc, tile_size=args.sampler_tile_size,
                                                       tile_stride=args.sampler_tile_stride, **sample_kwargs)
            else:
                samples = engine.batchify_sample(xN, c, uc, **sample_kwargs)
            _sync(device)
        if args.profile_dir:
            os.makedirs(args.profile_dir, exist_ok=True)
            profiler.export_chrome_trace(os.path.join(args.profile_dir, f"{os.path.splitext(name)[0]}.json"))
        timings["sample"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        base = os.path.splitext(name)[0]
        saved = []
        for i in range(args.num_samples):
            path = os.path.join(args.save_dir, f"{base}_{i}.png")
            array_to_pil(samples[i], h0, w0).save(path)
            saved.append(path)
        timings["save"] = time.perf_counter() - t0
        total = time.perf_counter() - t_start
        phase_str = " ".join(f"{k}={timings[k]:.2f}s" for k in ("stage1", "caption", "sample") if k in timings)
        print(f"{name}: {total:.2f}s ({phase_str}) caption={caption[:60]!r}")
        records.append({"name": name, "caption": caption, "prompt": prompt, "saved": saved,
                        "size": (h0, w0), "timings": timings, "total": total})
    return records


if __name__ == "__main__":
    main()
