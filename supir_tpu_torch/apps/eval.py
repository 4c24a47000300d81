"""Eval app: PSNR / SSIM / LPIPS over a folder of (restored, reference)
image pairs (counterpart of supir_tpu/apps/eval.py; the RealPhoto60 parity
check of BASELINE.md).

    python -m supir_tpu_torch.apps.eval --pred_dir out/ --ref_dir refs/ [--lpips W.safetensors] [--device cpu]

Each reference image is paired with the first file of --pred_dir whose
name starts with its stem, resized bicubic (PIL) to the reference's size;
the metrics run on --device (the card unless the caller names the CPU).
Prints one JSON line with the count and each metric's mean (null where
nothing was scored).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch
from PIL import Image

from supir_tpu_torch.utils.device import resolve_device
from supir_tpu_torch.utils.metrics import load_lpips_params, lpips, lpips_available, psnr, ssim


def _load(path: str, size=None) -> np.ndarray:
    img = Image.open(path).convert("RGB")
    if size is not None:
        img = img.resize(size, Image.BICUBIC)
    return np.asarray(img, np.float32) / 127.5 - 1.0


def evaluate_dirs(pred_dir: str, ref_dir: str, lpips_weights: Optional[str] = None, device="cuda") -> dict:
    device = resolve_device(device)
    if lpips_weights:
        load_lpips_params(lpips_weights, device)
    names = sorted(f for f in os.listdir(ref_dir) if f.lower().endswith((".png", ".jpg", ".jpeg")))
    scores = {"psnr": [], "ssim": [], "lpips": []}
    matched = 0
    for name in names:
        base = os.path.splitext(name)[0]
        cands = [os.path.join(pred_dir, c) for c in os.listdir(pred_dir) if c.startswith(base)]
        if not cands:
            continue
        matched += 1
        ref = _load(os.path.join(ref_dir, name))
        pred = _load(cands[0], size=(ref.shape[1], ref.shape[0]))
        a = torch.from_numpy(pred)[None].to(device)
        b = torch.from_numpy(ref)[None].to(device)
        scores["psnr"].append(float(psnr(a, b)[0]))
        scores["ssim"].append(float(ssim(a, b)[0]))
        if lpips_available():
            scores["lpips"].append(float(lpips(a, b)[0]))
    return {"n": matched, **{k: float(np.mean(v)) if v else None for k, v in scores.items()}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("supir_tpu_torch eval")
    ap.add_argument("--pred_dir", required=True)
    ap.add_argument("--ref_dir", required=True)
    ap.add_argument("--lpips", default=None, help="LPIPS state dict (the port's keys; convert_lpips_state)")
    ap.add_argument("--device", default="cuda", help="where the metrics run: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    out = evaluate_dirs(args.pred_dir, args.ref_dir, args.lpips, args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
