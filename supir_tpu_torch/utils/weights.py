"""The weight bridge: JAX parameter trees -> the port's state dicts.

The bridge walks the rule tables of `utils/ckpt_rules.py` (the port's copy
of `supir_tpu/utils/ckpt.py` and `supir_tpu/captioner/convert.py`)
backwards: every rule names a reference torch key, a flax leaf path and a
transform, and the inverse transform turns the leaf into the torch tensor:

  linear  [in, out] -> [out, in]
  conv    HWIO -> OIHW
  qkv_w   the q/k/v_proj kernels beside the placeholder, each [in, out] ->
          [out, in], concatenated to OpenCLIP's in_proj_weight [3w, w]
  qkv_b   their biases concatenated to in_proj_bias [3w]
  other   as is (norm scale -> weight, biases, embeddings)

The keys are the reference's, so the results load with `strict=True`:
`state_dict_from_jax` into `SUPIRModel` (`model.diffusion_model.*`,
`model.control_model.*`, `first_stage_model.*`, and the text conditioner's
`conditioner.embedders.{0,1}.*` where the tree holds one), and
`captioner_state_dict_from_jax` into the unquantized `LlavaForCausalLM`
(HF LLaVA keys: `model.layers.{i}.self_attn.q_proj.weight`,
`model.vision_tower.vision_tower.vision_model.*`, `model.mm_projector.*`,
`lm_head.weight`). A quantized JAX captioner tree (`quantize_llama_params`)
crosses too: each quantized projection's leaves under the module's name
(`model.layers.{i}.self_attn.qkv_proj.qp`, `.scale`, ...), `jnp.int4`
weights (`qn`, whose numpy form is `ml_dtypes.int4`) repacked to K11's
column pairs, and the int8 head as `lm_head.q` / `lm_head.scale`; else
quantization happens in the port (`captioner/llama.py:quantize_llama_state_dict`).

`mpt_state_dict_from_jax` carries a JAX MPTForCausalLM tree
(`captioner/mpt.py:init_mpt_params` builds one in numpy) into the port's MPT
under the reference's HF keys (`transformer.blocks.{i}.attn.Wqkv.weight`,
...); `convert_mpt_state_dict` takes a reference MPT state dict as it is,
fills the LayerNorm biases that the no_bias family (mpt-7b) strips with
zeros and reports every other key that is missing or unused, as
`supir_tpu/captioner/convert.py:convert_mpt_state_dict` (:127-152) does.

`convert_llava_state_dict` takes a reference LLaVA state dict (HF keys, as
`supir_tpu/data/ref_key_manifests.json["llava"]` lists them) to the port's
tree: it drops the keys that the JAX converter also leaves unused
(`supir_tpu/captioner/convert.py:84,151`) and the port's `LlavaForCausalLM`
does not hold, and reports them.

`plain_unet_state_dict_from_jax` carries the plain SDXL UNetModel's tree
into the port's `models/unet.py:UNetModel` (`C.plain_unet_rules`).

`retinaface_state_dict_from_jax`, `parsenet_state_dict_from_jax` and
`lpips_state_dict_from_jax` carry the face models' and LPIPS's trees into
the port's modules under facexlib's keys (`utils/face_ckpt.py`'s tables)
and under torchvision's and the taming heads' keys.

`train_state_from_jax` carries a JAX trainer state (params, optax's AdamW
mu and nu, the EMA and the step) into the port's trainer state by the same
rules: the transforms are linear, so they serve the moments and the EMA as
they serve the parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from supir_tpu_torch.config import ControlConfig, SUPIRConfig, UNetConfig
from supir_tpu_torch.models.control import _build_adapter_specs
from supir_tpu_torch.models.unet import encoder_feature_channels
from supir_tpu_torch.utils import ckpt_rules as C


def light_glv_unet_rules(cfg: UNetConfig, ctrl: ControlConfig) -> List[C.Rule]:
    """model.diffusion_model.* -> params['unet'] (as supir_tpu/utils/ckpt.py:209)."""
    tk = "model.diffusion_model."
    rules = C._time_embed(tk, (), with_label=cfg.adm_in_channels is not None)
    rules += C.unet_encoder_rules(cfg, tk, ("enc",))
    rules += C.unet_decoder_rules(cfg, tk, (), encoder_feature_channels(cfg))
    for pos, (kind, _) in enumerate(_build_adapter_specs(ctrl)):
        base = f"{tk}project_modules.{pos}"
        if kind == "sft":
            rules += C.zero_sft_rules(base, (f"proj_{pos}",))
        else:
            rules += C.zero_xattn_rules(base, (f"proj_{pos}",))
    return rules


def conditioner_rules(cond_cfg) -> List[C.Rule]:
    """conditioner.* -> params['conditioner'] (cond_cfg: a ConditionerConfig)."""
    return C.clip_l_rules(cond_cfg.clip_l.layers) + C.clip_bigg_rules(cond_cfg.clip_bigg.layers)


def supir_rules(cfg: SUPIRConfig) -> Dict[str, List[C.Rule]]:
    """The rule table of each parameter branch of the restore path."""
    return {
        "unet": light_glv_unet_rules(cfg.unet, cfg.control),
        "control": C.glv_control_rules(cfg.unet),
        "vae": C.vae_rules(cfg.vae),
    }


def captioner_rules(cfg) -> Dict[str, List[C.Rule]]:
    """The rule table of each branch of the captioner (a CaptionerConfig)."""
    return {
        "llama": C.llama_rules(cfg.llama),
        "vision": C.vision_rules(cfg.vision),
        "projector": C.projector_rules(),
    }


def _leaf(tree: Mapping[str, Any], path) -> np.ndarray:
    node = tree
    for p in path:
        node = node[p]
    return np.asarray(node)


def _to_torch(kind, v: np.ndarray) -> np.ndarray:
    if kind == "linear":
        return np.transpose(v, (1, 0))
    if kind == "conv":
        return np.transpose(v, (3, 2, 0, 1))
    if kind is None:
        return v
    raise ValueError(f"rule kind {kind!r} has no place in the bridge")


def _packed_qkv(tree: Mapping[str, Any], fpath, kind) -> np.ndarray:
    """The inverse of the JAX converter's split of OpenCLIP's in_proj
    (supir_tpu/utils/ckpt.py:apply_rules, "qkv_w"/"qkv_b")."""
    leaf = "kernel" if kind == "qkv_w" else "bias"
    parts = [_leaf(tree, fpath[:-1] + (f"{p}_proj", "Dense_0", leaf)) for p in "qkv"]
    return np.concatenate([p.T if kind == "qkv_w" else p for p in parts], axis=0)


def state_dict_from_rules(tree: Mapping[str, Any], rules: List[C.Rule]) -> Dict[str, torch.Tensor]:
    def value(fpath, kind):
        if kind in ("qkv_w", "qkv_b"):
            return _packed_qkv(tree, fpath, kind)
        return _to_torch(kind, _leaf(tree, fpath))

    return {tkey: torch.from_numpy(np.ascontiguousarray(value(fpath, kind), np.float32))
            for tkey, fpath, kind in rules}


def _bridge(params_np: Mapping[str, Any], tables: Dict[str, List[C.Rule]]) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for branch, rules in tables.items():
        sd.update(state_dict_from_rules(params_np[branch], rules))
    return sd


def _tower_layers(tower: Mapping[str, Any]) -> int:
    return sum(k.startswith("block_") for k in tower)


def state_dict_from_jax(params_np: Mapping[str, Any], cfg: SUPIRConfig) -> Dict[str, torch.Tensor]:
    """{'unet', 'control', 'vae'} parameter trees (numpy or array leaves),
    and 'conditioner' where the tree holds one (its towers' depths read off
    the tree) -> fp32 CPU tensors under the reference torch keys."""
    tables = supir_rules(cfg)
    if "conditioner" in params_np:
        cond = params_np["conditioner"]
        tables["conditioner"] = (C.clip_l_rules(_tower_layers(cond["clip_l"]))
                                 + C.clip_bigg_rules(_tower_layers(cond["clip_bigg"])))
    return _bridge(params_np, tables)


def plain_unet_state_dict_from_jax(params_np: Mapping[str, Any], cfg: UNetConfig) -> Dict[str, torch.Tensor]:
    """A JAX `UNetModel` tree (supir_tpu/models/unet.py:240) -> fp32 CPU
    tensors under the port's `UNetModel` keys (the reference's without the
    `model.diffusion_model.` prefix)."""
    return state_dict_from_rules(params_np, C.plain_unet_rules(cfg, tk=""))


def _has(tree: Mapping[str, Any], path) -> bool:
    node = tree
    for p in path:
        if not isinstance(node, Mapping) or p not in node:
            return False
        node = node[p]
    return True


_MLP = ("gate_proj", "up_proj", "down_proj", "gateup_proj")


def _quantized_leaf(name: str, v: np.ndarray) -> torch.Tensor:
    from supir_tpu_torch.ops.quantize import pack_int4_native

    if name == "qn":  # jnp.int4 values [in, out] -> K11's column pairs
        return pack_int4_native(torch.from_numpy(np.asarray(v).astype(np.int8)))
    dtype = {"qp": np.uint8, "q4": np.uint8, "q": np.int8, "scale": np.float32}[name]
    return torch.from_numpy(np.ascontiguousarray(np.asarray(v), dtype))


def _quantized_llama(llama: Mapping[str, Any], layers: int) -> Dict[str, torch.Tensor]:
    """The quantized leaves of a `quantize_llama_params` tree under the
    port's keys: every projection node that holds a `scale`, and the int8
    head."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(layers):
        for name, node in llama["model"][f"layer_{i}"].items():
            if isinstance(node, Mapping) and "scale" in node:
                group = "mlp" if name in _MLP else "self_attn"
                for leaf, v in node.items():
                    sd[f"model.layers.{i}.{group}.{name}.{leaf}"] = _quantized_leaf(leaf, v)
    head = llama["lm_head"]
    if "q" in head:
        sd["lm_head.q"] = _quantized_leaf("q", head["q"])
        sd["lm_head.scale"] = _quantized_leaf("scale", head["scale"])
    return sd


def captioner_state_dict_from_jax(params_np: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """The JAX agent's {'vision', 'projector', 'llama'} trees -> CPU tensors
    under the HF LLaVA keys (cfg: a CaptionerConfig): fp32 for unquantized
    leaves (a bf16 head included), the quantized leaves of a quantized
    'llama' tree in the port's buffer types (uint8 qp/q4/qn, int8 q, fp32
    scale)."""
    tables = captioner_rules(cfg)
    llama = params_np["llama"]
    tables["llama"] = [r for r in tables["llama"] if _has(llama, r[1])]
    sd = _bridge(params_np, tables)
    sd.update(_quantized_llama(llama, cfg.llama.layers))
    return sd


def train_state_from_jax(state_np: Mapping[str, Any], cfg: SUPIRConfig) -> Dict[str, Any]:
    """A JAX `SUPIRTrainer.init_state` (numpy or array leaves) -> the state
    `supir_tpu_torch.engine.training.SUPIRTrainer.load_state` takes:
    'params' (every parameter), 'exp_avg' / 'exp_avg_sq' (optax's mu / nu)
    and 'ema' over the trainable branches (control, unet), and 'step'."""
    tables = supir_rules(cfg)
    trainable = {k: tables[k] for k in ("control", "unet")}
    adam = next(s for s in state_np["opt"] if hasattr(s, "mu"))
    out = {
        "params": _bridge(state_np["params"], tables),
        "exp_avg": _bridge(adam.mu, trainable),
        "exp_avg_sq": _bridge(adam.nu, trainable),
        "step": int(np.asarray(state_np["step"])),
    }
    if "ema" in state_np:
        out["ema"] = _bridge(state_np["ema"], trainable)
    return out


def mpt_state_dict_from_jax(params_np: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """A JAX MPTForCausalLM parameter tree (numpy or array leaves) -> fp32
    CPU tensors under the HF MPT keys (cfg: an MPTConfig)."""
    return state_dict_from_rules(params_np, C.mpt_rules(cfg))


@dataclasses.dataclass
class ConversionReport:
    """What a conversion found, as `supir_tpu/utils/ckpt.py:ConversionReport`
    counts it: leaves filled, rule keys missing from the checkpoint
    ("torch key -> flax/path"), checkpoint keys no rule used."""

    filled: int = 0
    missing: List[str] = dataclasses.field(default_factory=list)
    unused: List[str] = dataclasses.field(default_factory=list)

    def summary(self) -> str:
        return (f"filled={self.filled} missing_flax_leaves={len(self.missing)} "
                f"unused_torch_keys={len(self.unused)}")


def convert_mpt_state_dict(torch_sd: Mapping[str, Any], cfg) -> Tuple[Dict[str, torch.Tensor], ConversionReport]:
    """A reference MPT state dict -> (the port's state dict, report). The
    keys are the port's already; a missing LayerNorm bias (the no_bias
    checkpoint family, mpt-7b) is filled with zeros, any other missing key
    stays in `report.missing`, and keys no rule reads land in
    `report.unused`."""
    report = ConversionReport()
    sd: Dict[str, torch.Tensor] = {}
    for tkey, fpath, _ in C.mpt_rules(cfg):
        if tkey in torch_sd:
            v = torch_sd[tkey]
            sd[tkey] = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
        elif tkey.endswith(".bias") and fpath[-2] == "ln":
            sd[tkey] = torch.zeros(cfg.d_model, dtype=torch.float32)
        else:
            report.missing.append(tkey + " -> " + "/".join(fpath))
            continue
        report.filled += 1
    report.unused = sorted(k for k in torch_sd if k not in sd)
    return sd, report


# keys of a reference LLaVA checkpoint that no rule of the JAX converter reads
# (the allowlist of tests/test_ckpt_manifest.py:186-196) and that the port's
# tree may lack
LLAVA_UNUSED_SUFFIXES = (
    "vision_model.post_layernorm.weight",   # applied after the hidden layer the features come from
    "vision_model.post_layernorm.bias",
    ".position_ids",                         # buffers of the reference's modules, not weights
    "rotary_emb.inv_freq",
)


def convert_llava_state_dict(torch_sd: Mapping[str, Any], cfg) -> Tuple[Dict[str, Any], ConversionReport]:
    """A reference LLaVA state dict -> (the port's state dict, report) for
    `LlavaForCausalLM(cfg)` (cfg: a CaptionerConfig). Keys that end in one
    of LLAVA_UNUSED_SUFFIXES and that the port's tree does not hold are
    dropped and listed in `report.unused`; every other key passes as it is,
    so a strict load still refuses any other stray key."""
    from supir_tpu_torch.captioner.agent import LlavaForCausalLM

    with torch.device("meta"):
        held = set(LlavaForCausalLM(cfg).state_dict())
    report = ConversionReport()
    sd: Dict[str, Any] = {}
    for key, value in torch_sd.items():
        if key not in held and key.endswith(LLAVA_UNUSED_SUFFIXES):
            report.unused.append(key)
        else:
            sd[key] = value
    report.filled = len(sd)
    report.unused.sort()
    return sd, report


def retinaface_state_dict_from_jax(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX RetinaFace tree -> the port's RetinaFace state dict (facexlib keys)."""
    from supir_tpu_torch.utils.face_ckpt import retinaface_rules

    return state_dict_from_rules(params_np, retinaface_rules())


def parsenet_state_dict_from_jax(params_np: Mapping[str, Any], in_size: int = 512,
                                 res_depth: int = 10) -> Dict[str, torch.Tensor]:
    """A JAX ParseNet tree -> the port's ParseNet state dict (facexlib keys)."""
    from supir_tpu_torch.utils.face_ckpt import parsenet_rules

    return state_dict_from_rules(params_np, parsenet_rules(in_size=in_size, res_depth=res_depth))


def lpips_state_dict_from_jax(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX LPIPS tree ({'vgg': {'conv_i': ...}, 'lin_i': [1, 1, 1, C]}) ->
    the port's LPIPS state dict (`vgg.features.{t}.*` at torchvision's
    indices, `lin{i}.model.1.weight` [1, C, 1, 1])."""
    from supir_tpu_torch.utils.metrics import VGG_TORCH_CONV_IDX

    sd: Dict[str, torch.Tensor] = {}
    for i, t in enumerate(VGG_TORCH_CONV_IDX):
        conv = params_np["vgg"][f"conv_{i}"]
        sd[f"vgg.features.{t}.weight"] = _to_torch("conv", np.asarray(conv["kernel"], np.float32))
        sd[f"vgg.features.{t}.bias"] = np.asarray(conv["bias"], np.float32)
    for i in range(5):
        sd[f"lin{i}.model.1.weight"] = np.asarray(params_np[f"lin_{i}"], np.float32).transpose(0, 3, 1, 2)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
