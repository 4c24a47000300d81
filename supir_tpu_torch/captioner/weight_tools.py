"""LLaVA weight tools: apply-delta, make-delta, consolidate (the port's copy
of supir_tpu/captioner/weight_tools.py, the reference's
llava/model/apply_delta.py:48, make_delta.py:52, consolidate.py:29).

They materialise LLaVA weights from a Llama base and a released delta (and
the inverse), and merge sharded checkpoints into one file, on numpy arrays
and safetensors files: no model class is built and nothing touches a device.

    python -m supir_tpu_torch.captioner.weight_tools apply-delta --base B --delta D --target T
    python -m supir_tpu_torch.captioner.weight_tools make-delta  --base B --target T --delta D
    python -m supir_tpu_torch.captioner.weight_tools consolidate --src S --dst D
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import Dict

import numpy as np

# keys allowed to exist only in the delta (the multimodal additions)
_DELTA_ONLY_PREFIXES = ("model.mm_projector", "model.vision_tower")
# keys allowed to differ in shape (vocabulary extensions): the base goes into the leading slice
_RESIZABLE = ("model.embed_tokens.weight", "lm_head.weight")


def load_state_dir(path: str) -> Dict[str, np.ndarray]:
    """Every weight shard (.safetensors, .bin, .pt) of a file or directory,
    as float32 (or integer) numpy arrays."""
    from supir_tpu_torch.utils.ckpt import load_torch_file

    if os.path.isdir(path):
        names = [f for f in sorted(os.listdir(path)) if f.endswith((".safetensors", ".bin", ".pt"))]
        if not names:
            raise FileNotFoundError(f"no weight files in {path}")
        sd = {}
        for f in names:
            sd.update(load_torch_file(os.path.join(path, f)))
    else:
        sd = load_torch_file(path)
    return {k: _np(v) for k, v in sd.items()}


def _np(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu()
        v = (v.float() if v.is_floating_point() else v).numpy()
    return np.asarray(v)


def _check_delta_only(name: str) -> None:
    if not name.startswith(_DELTA_ONLY_PREFIXES):
        raise KeyError(f"{name} not in base model")


def _check_resizable(name: str, a: np.ndarray, b: np.ndarray) -> None:
    if name not in _RESIZABLE:
        raise ValueError(f"{name} dimension mismatch: {a.shape} vs {b.shape}")


def apply_delta_sd(base: Dict[str, np.ndarray], delta: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """target = delta + base (apply_delta.py:13-37): delta-only keys pass
    through; a resizable key adds the base into its leading slice."""
    out = {}
    for name, dparam in delta.items():
        if name not in base:
            _check_delta_only(name)
            out[name] = dparam
            continue
        bparam = base[name]
        if dparam.shape == bparam.shape:
            out[name] = dparam + bparam
        else:
            _check_resizable(name, dparam, bparam)
            t = dparam.copy()
            t[: bparam.shape[0], : bparam.shape[1]] += bparam
            out[name] = t
    return out


def make_delta_sd(base: Dict[str, np.ndarray], target: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """delta = target - base (make_delta.py), the inverse of apply_delta_sd."""
    out = {}
    for name, tparam in target.items():
        if name not in base:
            _check_delta_only(name)
            out[name] = tparam
            continue
        bparam = base[name]
        if tparam.shape == bparam.shape:
            out[name] = tparam - bparam
        else:
            _check_resizable(name, tparam, bparam)
            d = tparam.copy()
            d[: bparam.shape[0], : bparam.shape[1]] -= bparam
            out[name] = d
    return out


def save_state_dir(sd: Dict[str, np.ndarray], path: str, src_dir: str = None) -> None:
    """One model.safetensors in `path`, and the config and tokenizer files
    of `src_dir` copied beside it, as HF's save_pretrained keeps them."""
    from safetensors.numpy import save_file

    os.makedirs(path, exist_ok=True)
    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()}, os.path.join(path, "model.safetensors"))
    if src_dir and os.path.isdir(src_dir):
        for f in os.listdir(src_dir):
            if f.endswith((".json", ".model", ".txt")) and not f.endswith(".safetensors.index.json"):
                shutil.copy2(os.path.join(src_dir, f), os.path.join(path, f))


def apply_delta(base_path: str, delta_path: str, target_path: str) -> None:
    target = apply_delta_sd(load_state_dir(base_path), load_state_dir(delta_path))
    save_state_dir(target, target_path, src_dir=delta_path)
    print(f"apply-delta: wrote {len(target)} tensors to {target_path}")


def make_delta(base_path: str, target_path: str, delta_path: str) -> None:
    delta = make_delta_sd(load_state_dir(base_path), load_state_dir(target_path))
    save_state_dir(delta, delta_path, src_dir=target_path)
    print(f"make-delta: wrote {len(delta)} tensors to {delta_path}")


def consolidate(src_path: str, dst_path: str) -> None:
    """Merge sharded weight files into one model.safetensors
    (consolidate.py:29, without HF's round trip)."""
    sd = load_state_dir(src_path)
    save_state_dir(sd, dst_path, src_dir=src_path)
    print(f"consolidate: wrote {len(sd)} tensors to {dst_path}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("llava weight tools")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("apply-delta")
    p.add_argument("--base", required=True)
    p.add_argument("--delta", required=True)
    p.add_argument("--target", required=True)
    p = sub.add_parser("make-delta")
    p.add_argument("--base", required=True)
    p.add_argument("--target", required=True)
    p.add_argument("--delta", required=True)
    p = sub.add_parser("consolidate")
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    args = ap.parse_args(argv)
    if args.cmd == "apply-delta":
        apply_delta(args.base, args.delta, args.target)
    elif args.cmd == "make-delta":
        make_delta(args.base, args.target, args.delta)
    else:
        consolidate(args.src, args.dst)


if __name__ == "__main__":
    main()
