"""facexlib checkpoints for the face models (counterpart of
supir_tpu/utils/face_ckpt.py): `detection_Resnet50_Final.pth` into
`models/retinaface.py:RetinaFace`, `parsing_parsenet.pth` into
`models/parsenet.py:ParseNet` (face_restoration_helper.py:114-118).

The port's modules hold facexlib's keys, so converting is checking: the
rule tables below are the JAX package's (torch key, flax path, kind)
triples, pinned to `supir_tpu/data/face_key_manifests.json` by the tests.
A conversion strips the DataParallel `module.` prefix and drops
`num_batches_tracked` as the JAX converter does, lists every rule key the
dict lacks in `report.missing` (a loader raises on any) and every other
key in `report.unused` (printed, as the LLaVA loader prints its report),
and loads the rest with `strict=True`. The flax paths drive the weight
bridge (`utils/weights.py`), which turns a JAX tree into the same keys.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import torch

from supir_tpu_torch.utils.ckpt import load_torch_file
from supir_tpu_torch.utils.ckpt_rules import Rule
from supir_tpu_torch.utils.weights import ConversionReport


# ----------------------------------------------------------- rule builders

def _convbn(tk_conv: str, tk_bn: str, fp: Tuple[str, ...], bias=False) -> List[Rule]:
    rules = [(f"{tk_conv}.weight", fp + ("conv", "kernel"), "conv")]
    if bias:
        rules.append((f"{tk_conv}.bias", fp + ("conv", "bias"), None))
    rules += [
        (f"{tk_bn}.weight", fp + ("bn_scale",), None),
        (f"{tk_bn}.bias", fp + ("bn_bias",), None),
        (f"{tk_bn}.running_mean", fp + ("bn_mean",), None),
        (f"{tk_bn}.running_var", fp + ("bn_var",), None),
    ]
    return rules


def retinaface_rules() -> List[Rule]:
    rules: List[Rule] = [("body.conv1.weight", ("body", "stem_conv", "kernel"), "conv")]
    for part, leaf in (("weight", "stem_bn_scale"), ("bias", "stem_bn_bias"),
                       ("running_mean", "stem_bn_mean"), ("running_var", "stem_bn_var")):
        rules.append((f"body.bn1.{part}", ("body", leaf), None))
    for layer, blocks in enumerate([3, 4, 6, 3], start=1):
        for b in range(blocks):
            base = f"body.layer{layer}.{b}"
            fp = ("body", f"layer{layer}_{b}")
            for k in (1, 2, 3):
                rules += _convbn(f"{base}.conv{k}", f"{base}.bn{k}", fp + (f"conv{k}",))
            if b == 0:
                rules += _convbn(f"{base}.downsample.0", f"{base}.downsample.1", fp + ("downsample",))
    for i in (1, 2, 3):
        rules += _convbn(f"fpn.output{i}.0", f"fpn.output{i}.1", (f"fpn_output{i}",))
    for i in (1, 2):
        rules += _convbn(f"fpn.merge{i}.0", f"fpn.merge{i}.1", (f"fpn_merge{i}",))
    for i in (1, 2, 3):
        m = f"ssh{i}"
        for tk, fk in (("conv3X3", "conv3x3"), ("conv5X5_1", "conv5x5_1"), ("conv5X5_2", "conv5x5_2"),
                       ("conv7X7_2", "conv7x7_2"), ("conv7x7_3", "conv7x7_3")):
            rules += _convbn(f"{m}.{tk}.0", f"{m}.{tk}.1", (m, fk))
    for i in range(3):
        for tk, fk in (("ClassHead", "class_head"), ("BboxHead", "bbox_head"), ("LandmarkHead", "landmark_head")):
            rules.append((f"{tk}.{i}.conv1x1.weight", (f"{fk}{i}", "kernel"), "conv"))
            rules.append((f"{tk}.{i}.conv1x1.bias", (f"{fk}{i}", "bias"), None))
    return rules


def _pconv(tk: str, fp: Tuple[str, ...], norm: bool) -> List[Rule]:
    """facexlib ConvLayer: .conv2d (+ .norm.norm BatchNorm, the conv then
    without bias)."""
    rules = [(f"{tk}.conv2d.weight", fp + ("conv", "kernel"), "conv")]
    if norm:
        rules += [(f"{tk}.norm.norm.{part}", fp + (leaf,), None)
                  for part, leaf in (("weight", "bn_scale"), ("bias", "bn_bias"),
                                     ("running_mean", "bn_mean"), ("running_var", "bn_var"))]
    else:
        rules.append((f"{tk}.conv2d.bias", fp + ("conv", "bias"), None))
    return rules


def _presblock(tk: str, fp: Tuple[str, ...], shortcut: bool) -> List[Rule]:
    rules: List[Rule] = []
    if shortcut:
        rules += _pconv(f"{tk}.shortcut_func", fp + ("shortcut",), norm=False)
    for part, leaf in (("weight", "preact_bn_scale"), ("bias", "preact_bn_bias"),
                       ("running_mean", "preact_bn_mean"), ("running_var", "preact_bn_var")):
        rules.append((f"{tk}.preact_func.0.norm.{part}", fp + (leaf,), None))
    rules += _pconv(f"{tk}.conv1", fp + ("conv1",), norm=True)
    rules += _pconv(f"{tk}.conv2", fp + ("conv2",), norm=False)
    return rules


def parsenet_rules(in_size: int = 512, min_feat_size: int = 32, res_depth: int = 10) -> List[Rule]:
    down_steps = int(math.log2(in_size // min_feat_size))
    rules: List[Rule] = _pconv("encoder.0", ("enc_in",), norm=False)
    for i in range(down_steps):
        rules += _presblock(f"encoder.{i + 1}", (f"enc_{i}",), shortcut=True)
    for i in range(res_depth):
        rules += _presblock(f"body.{i}", (f"body_{i}",), shortcut=False)
    for i in range(down_steps):
        rules += _presblock(f"decoder.{i}", (f"dec_{i}",), shortcut=True)
    rules += _pconv("out_img_conv", ("out_img",), norm=False)
    rules += _pconv("out_mask_conv", ("out_mask",), norm=False)
    return rules


# ----------------------------------------------------------------- loaders

def _convert(torch_sd: Mapping[str, torch.Tensor], rules: List[Rule]) -> Tuple[Dict[str, torch.Tensor],
                                                                              ConversionReport]:
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in torch_sd.items()}
    report = ConversionReport()
    out: Dict[str, torch.Tensor] = {}
    for tkey, fpath, _ in rules:
        if tkey in sd:
            v = sd[tkey]
            out[tkey] = v if torch.is_tensor(v) else torch.as_tensor(v)
            report.filled += 1
        else:
            report.missing.append(f"{tkey} -> {'/'.join(fpath)}")
    report.unused = sorted(k for k in sd if k not in out and "num_batches_tracked" not in k)
    return out, report


def convert_retinaface_state_dict(torch_sd: Mapping[str, torch.Tensor]):
    """facexlib detector state dict -> (RetinaFace's state dict, report)."""
    return _convert(torch_sd, retinaface_rules())


def convert_parsenet_state_dict(torch_sd: Mapping[str, torch.Tensor], in_size: int = 512, res_depth: int = 10):
    """facexlib parser state dict -> (ParseNet's state dict, report)."""
    return _convert(torch_sd, parsenet_rules(in_size=in_size, res_depth=res_depth))


def _checked(name: str, converted):
    sd, report = converted
    if report.missing:
        raise ValueError(f"{name} conversion missing {len(report.missing)} keys, e.g. "
                         + "; ".join(report.missing[:5]))
    print(f"{name} conversion: {report.summary()}" + (f", unused: {report.unused[:5]}" if report.unused else ""))
    return sd


def load_retinaface(path: str, canvas: int = 640, device="cuda"):
    """facexlib detection_Resnet50_Final.pth -> RetinaFaceDetector on `device`."""
    from supir_tpu_torch.models.retinaface import RetinaFaceDetector

    sd = _checked("retinaface", convert_retinaface_state_dict(load_torch_file(path)))
    return RetinaFaceDetector.from_state_dict(sd, canvas=canvas, device=device)


def load_parsenet(path: str, device="cuda"):
    """facexlib parsing_parsenet.pth -> FaceParser (512, depth 10) on `device`."""
    from supir_tpu_torch.models.parsenet import FaceParser

    sd = _checked("parsenet", convert_parsenet_state_dict(load_torch_file(path)))
    return FaceParser.from_state_dict(sd, device=device)
