"""Real-weight readiness drill (the port's copy of tools/load_real.py): the
one command to run when real SDXL, SUPIR and LLaVA checkpoints are at hand.

Given their paths it runs, in order, printing PASS or FAIL for each stage
and one verdict at the end:

  1. the layered load (SDXL base, then SUPIR Q/F over it, as the
     reference's SUPIR/util.py:34-51 merges them) with its coverage
     report: FAIL on any missing key, naming it;
  2. the CLIP tokenizer (the real vocabulary, or the hash fallback,
     utils/tokenizer.py);
  3. a 5-step 512 px restore through the engine;
  4. one caption through the LLaVA checkpoint (with --llava);
  5. PSNR against a stored output (with --ref_out).

    python -m supir_tpu_torch.tools.load_real --opt options/SUPIR_v0.yaml \\
        --sdxl /ckpts/sd_xl_base_1.0_0.9vae.safetensors --supir /ckpts/SUPIR-v0Q.ckpt \\
        [--llava /ckpts/llava-v1.5-13b] [--img in/low.png] [--ref_out golden/low_restored.png] [--device cpu]

It runs on the card unless `--device cpu` is given, and exits non-zero on
any FAIL. `--tiny` (the tiny fp32 model), `--random_conditioner` (synthetic
conditioning: tiny checkpoints carry no text towers) and
`--allow_hash_tokenizer` (the CLIP hash fallback, and a LLaVA directory
without tokenizer files, pass) are the smoke-test surface.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch


class Drill:
    def __init__(self):
        self.results = []

    def record(self, stage: str, ok: bool, detail: str = "") -> None:
        self.results.append((stage, ok, detail))
        print(f"[{'PASS' if ok else 'FAIL'}] {stage}" + (f" — {detail}" if detail else ""), flush=True)

    def verdict(self) -> int:
        failed = [s for s, ok, _ in self.results if not ok]
        print("=" * 60)
        if failed:
            print(f"VERDICT: FAIL ({len(failed)} stage(s): {', '.join(failed)})")
            return 1
        print(f"VERDICT: PASS ({len(self.results)} stages)")
        return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("supir_tpu_torch real-weight readiness drill")
    ap.add_argument("--opt", default="options/SUPIR_v0.yaml")
    ap.add_argument("--sdxl", required=True, help="SDXL base .safetensors")
    ap.add_argument("--supir", default=None, help="SUPIR Q/F .ckpt")
    ap.add_argument("--llava", default=None, help="HF llava-v1.5 checkpoint dir")
    ap.add_argument("--img", default=None, help="LQ test image (synthetic if unset)")
    ap.add_argument("--ref_out", default=None, help="stored restore to PSNR against")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--save", default=os.path.join(tempfile.gettempdir(), "load_real_out.png"))
    ap.add_argument("--psnr_min", type=float, default=35.0,
                    help="PSNR bar against --ref_out (a rerun of the same pipeline should be near inf)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--tiny", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--random_conditioner", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--allow_hash_tokenizer", action="store_true", help=argparse.SUPPRESS)
    return ap


def synthetic_lq(size: int):
    """A smooth gradient with noise, from seed 0: the LQ image without --img."""
    from PIL import Image

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:size, 0:size]
    base = np.stack([yy, xx, (yy + xx) / 2], -1) / size * 255
    return Image.fromarray(np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8))


def _conversion(drill: Drill, args, device):
    """Stage 1 -> (engine, cfg), or None after a FAIL."""
    from supir_tpu_torch.config import ConditionerConfig, SUPIRConfig, load_yaml_config
    from supir_tpu_torch.utils.ckpt import load_supir_checkpoint

    if args.tiny:
        cfg = dataclasses.replace(SUPIRConfig.tiny(), ae_dtype="fp32", diffusion_dtype="fp32")
    else:
        cfg, _ = load_yaml_config(args.opt)
    cond_cfg = None if args.random_conditioner else ConditionerConfig()
    t0 = time.time()
    try:
        engine, report = load_supir_checkpoint(cfg, args.sdxl, args.supir, cond_cfg, device)
    except Exception as e:  # a missing key raises KeyError naming the first ones
        drill.record("conversion", False, repr(e))
        return None
    drill.record("conversion", True, f"{report.summary()} in {time.time() - t0:.1f}s")
    if report.unused:
        print(f"       note: {len(report.unused)} unused torch keys (EMA, optimiser state, ...), "
              f"first: {report.unused[:3]}")
    return engine, cfg


def _restore(drill: Drill, args, engine, cfg):
    """Stage 3 -> the model input x [1, H, W, 3], or None after a FAIL."""
    from PIL import Image

    from supir_tpu_torch.utils.image import array_to_pil, pil_to_array
    from supir_tpu_torch.utils.tokenizer import tokenize

    try:
        pil = Image.open(args.img).convert("RGB") if args.img else synthetic_lq(args.size)
        arr, h0, w0 = pil_to_array(pil, upscale=1.0, min_size=args.size)
        x = torch.from_numpy(arr)[None]
        t0 = time.time()
        z = engine.encode_first_stage_with_denoise(x)
        if args.random_conditioner:
            print("       WARNING: conditioning is SYNTHETIC (smoke mode)")
            r = np.random.default_rng(1)

            def synthetic():
                return {"crossattn": torch.from_numpy(
                            (r.standard_normal((1, 77, cfg.unet.context_dim)) * 0.3).astype(np.float32)).to(z.device),
                        "vector": torch.from_numpy(
                            (r.standard_normal((1, cfg.unet.adm_in_channels)) * 0.3).astype(np.float32)).to(z.device),
                        "control": z}

            c, uc = synthetic(), synthetic()
        else:
            tok_p, tok_n = tokenize([cfg.p_p]), tokenize([cfg.n_p])
            c, uc = engine.prepare_condition(z, tok_p, tok_p, tok_n, tok_n)
        out = engine.batchify_sample(x, c, uc, num_steps=args.steps, cfg_scale=7.5, seed=0,
                                     color_fix_type="Wavelet", z_override=z)
        out_np = out[0].float().cpu().numpy()
        drill.record("restore-5step", bool(np.isfinite(out_np).all()),
                     f"{args.steps} steps @{arr.shape[0]}px in {time.time() - t0:.1f}s, "
                     f"out range [{out_np.min():.2f}, {out_np.max():.2f}]")
        array_to_pil(out_np, h0, w0).save(args.save)
        print(f"       saved {args.save}")
        return x
    except Exception as e:
        drill.record("restore-5step", False, repr(e))
        return None


def _caption(drill: Drill, args, engine, x, device) -> None:
    """Stage 4: one greedy caption of the stage-1 image, the checkpoint in int4."""
    from supir_tpu_torch.captioner.agent import CaptionerAgent

    try:
        t0 = time.time()
        agent = CaptionerAgent.create_default(weights_dir=args.llava, load_4bit=True, device=device)
        stage1 = ((engine.batchify_denoise(x)[0].float().clamp(-1, 1) + 1) * 127.5).cpu().numpy().astype(np.uint8)
        caps = agent.gen_image_caption([stage1], temperature=0.0)
        # the byte fallback stands in for a checkpoint without tokenizer files only in smoke mode
        ok = bool(caps and caps[0].strip()) and (agent.tokenizer is not None or args.allow_hash_tokenizer)
        tok = "HF tokenizer" if agent.tokenizer is not None else "byte fallback tokenizer"
        drill.record("caption", ok, f"{time.time() - t0:.1f}s, {tok}: {caps[0][:100]!r}" if caps else "empty")
    except Exception as e:
        drill.record("caption", False, repr(e))


def _psnr(drill: Drill, args) -> None:
    """Stage 5: the saved output against --ref_out."""
    from PIL import Image

    try:
        ref = np.asarray(Image.open(args.ref_out).convert("RGB"), np.float32)
        got = np.asarray(Image.open(args.save).convert("RGB"), np.float32)
        if ref.shape != got.shape:
            drill.record("psnr", False, f"shape {got.shape} != golden {ref.shape}")
            return
        mse = float(np.mean((ref - got) ** 2))
        psnr = 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
        drill.record("psnr", psnr >= args.psnr_min, f"{psnr:.2f} dB vs {args.ref_out} (bar {args.psnr_min})")
    except Exception as e:
        drill.record("psnr", False, repr(e))


def main(argv=None) -> int:
    from supir_tpu_torch.utils.device import resolve_device
    from supir_tpu_torch.utils.tokenizer import tokenizer_available

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    drill = Drill()
    loaded = _conversion(drill, args, device)
    if loaded is None:
        return drill.verdict()
    engine, cfg = loaded
    real = tokenizer_available()
    drill.record("clip-tokenizer", real or args.allow_hash_tokenizer,
                 "real BPE vocab" if real else
                 "hash fallback only — provide openai/clip-vit-large-patch14's tokenizer files locally")
    x = _restore(drill, args, engine, cfg)
    if x is None:
        return drill.verdict()
    if args.llava:
        _caption(drill, args, engine, x, device)
    else:
        print("[skip] caption — no --llava dir given")
    if args.ref_out:
        _psnr(drill, args)
    else:
        print("[skip] psnr — no --ref_out golden given")
    return drill.verdict()


if __name__ == "__main__":
    raise SystemExit(main())
