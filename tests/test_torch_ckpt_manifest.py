"""The port's checkpoint key spaces against the reference's real ones (the
counterpart of tests/test_ckpt_manifest.py), one case per port tree:
restore (UNet, control, VAE), text conditioner, LLaVA, MPT, the face
models, and the trainers' own trees: the autoencoder GAN's discriminator
and the captioner's LoRA adapters (rank 64 on LLaVA-1.5-13B).

The manifests (`supir_tpu/data/ref_key_manifests.json`,
`face_key_manifests.json`) hold the state-dict keys and shapes of the
reference's own torch modules at full width. MPT has no entry there: its
key space is the JAX converter's rule table
(supir_tpu/captioner/convert.py:mpt_rules) with each torch shape taken
back from JAX's full-width MPT-7B tree; so is each trainer tree's, from
JAX's `NLayerDiscriminator` and from `init_lora` over the 13B Llama. For
each tree:

  1. every rule's reference key is in the manifest;
  2. the manifest's shapes, passed through the port's converter for that
     tree as meta tensors, equal the port module's parameter shapes at
     full width (built on the meta device);
  3. every parameter and buffer of the port module is covered by a rule;
  4. every manifest key is consumed, or on the tree's stated allowlist.
"""

import json
import os

import pytest
import torch

from torch_parity import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "supir_tpu", "data")

# keys of the reference's trees that no rule reads, by tree, and why
ALLOWED_UNUSED = {
    "restore": (),
    # the causal mask buffer, HF's position ids, CLIP's contrastive scale
    "conditioner": (".attn_mask", ".position_ids", "logit_scale"),
    # applied after the hidden layer the features come from; HF buffers
    # (the allowlist of tests/test_ckpt_manifest.py:186-196)
    "llava": ("vision_model.post_layernorm.weight", "vision_model.post_layernorm.bias", ".position_ids",
              "rotary_emb.inv_freq"),
    "mpt": (),
    # BatchNorm's step counters
    "face": ("num_batches_tracked",),
    "discriminator": (),
    "lora": (),
}


def _manifest(name):
    with open(os.path.join(DATA, name)) as f:
        return json.load(f)


def _meta(module_fn):
    with torch.device("meta"):
        return {k: tuple(v.shape) for k, v in module_fn().state_dict().items()}


def _restore():
    from supir_tpu_torch.config import SUPIRConfig
    from supir_tpu_torch.engine.supir import SUPIRModel
    from supir_tpu_torch.utils.weights import supir_rules

    cfg, man = SUPIRConfig(), _manifest("ref_key_manifests.json")
    manifest = {**man["unet"], **man["control"], **man["vae"]}
    rules = [r for table in supir_rules(cfg).values() for r in table]
    return manifest, rules, _meta(lambda: SUPIRModel(cfg)), lambda sd: sd


def _conditioner():
    from supir_tpu_torch.config import ConditionerConfig, SUPIRConfig
    from supir_tpu_torch.engine.supir import SUPIRModel
    from supir_tpu_torch.utils.weights import conditioner_rules

    man = _manifest("ref_key_manifests.json")
    held = _meta(lambda: SUPIRModel(SUPIRConfig(), cond_cfg=ConditionerConfig()))
    held = {k: v for k, v in held.items() if k.startswith("conditioner.")}
    return {**man["clip_l"], **man["clip_bigg"]}, conditioner_rules(ConditionerConfig()), held, lambda sd: sd


def _llava():
    from supir_tpu_torch.captioner.agent import CaptionerConfig, LlavaForCausalLM
    from supir_tpu_torch.utils.weights import captioner_rules, convert_llava_state_dict

    cfg = CaptionerConfig()  # llava-v1.5-13b
    rules = [r for table in captioner_rules(cfg).values() for r in table]
    return (_manifest("ref_key_manifests.json")["llava"], rules, _meta(lambda: LlavaForCausalLM(cfg)),
            lambda sd: convert_llava_state_dict(sd, cfg)[0])


def _mpt():
    import jax
    import numpy as np

    from supir_tpu.captioner import convert as JC
    from supir_tpu.captioner import mpt as JM
    from supir_tpu_torch.captioner.mpt import MPTConfig, MPTForCausalLM
    from supir_tpu_torch.utils import ckpt_rules as C
    from supir_tpu_torch.utils.weights import convert_mpt_state_dict

    cfg, jcfg = MPTConfig(), JM.MPTConfig()  # MPT-7B
    shapes = jax.eval_shape(lambda: JM.MPTForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), np.zeros((1, 4), np.int32)))["params"]

    def torch_shape(fpath, kind):
        leaf = shapes
        for p in fpath:
            leaf = leaf[p]
        return tuple(reversed(leaf.shape)) if kind == "linear" else tuple(leaf.shape)

    manifest = {tk: torch_shape(fp, kind) for tk, fp, kind in JC.mpt_rules(jcfg)}
    return manifest, C.mpt_rules(cfg), _meta(lambda: MPTForCausalLM(cfg)), \
        lambda sd: convert_mpt_state_dict(sd, cfg)[0]


def _face():
    from supir_tpu_torch.models.parsenet import ParseNet
    from supir_tpu_torch.models.retinaface import RetinaFace
    from supir_tpu_torch.utils import face_ckpt as F

    man = _manifest("face_key_manifests.json")
    manifest = {**{"retinaface." + k: v for k, v in man["retinaface"].items()},
                **{"parsenet." + k: v for k, v in man["parsenet"].items()}}
    rules = [("retinaface." + tk, fp, kind) for tk, fp, kind in F.retinaface_rules()]
    rules += [("parsenet." + tk, fp, kind) for tk, fp, kind in F.parsenet_rules()]
    held = {**{"retinaface." + k: v for k, v in _meta(RetinaFace).items()},
            **{"parsenet." + k: v for k, v in _meta(ParseNet).items()}}

    def convert(sd):
        out = {}
        for tree, fn in (("retinaface.", F.convert_retinaface_state_dict), ("parsenet.", F.convert_parsenet_state_dict)):
            sub, _ = fn({k[len(tree):]: v for k, v in sd.items() if k.startswith(tree)})
            out.update({tree + k: v for k, v in sub.items()})
        return out

    return manifest, rules, held, convert


def _from_jax_shapes(shapes, rules):
    """A rule table's torch keys with each torch shape taken back from a
    JAX tree of shapes."""
    def torch_shape(fpath, kind):
        leaf = shapes
        for p in fpath:
            leaf = leaf[p]
        return {"linear": lambda s: tuple(reversed(s)), "conv": lambda s: (s[3], s[2], s[0], s[1])}.get(
            kind, tuple)(tuple(leaf.shape))

    return {tk: torch_shape(fp, kind) for tk, fp, kind in rules}


def _discriminator():
    import jax
    import numpy as np

    from supir_tpu.diffusion import ae_losses as JL
    from supir_tpu_torch.diffusion.ae_losses import NLayerDiscriminator
    from supir_tpu_torch.utils import ckpt_rules as C

    shapes = jax.eval_shape(lambda: JL.NLayerDiscriminator().init(
        jax.random.PRNGKey(0), np.zeros((1, 256, 256, 3), np.float32)))["params"]
    rules = C.discriminator_rules()
    return _from_jax_shapes(shapes, rules), rules, _meta(NLayerDiscriminator), lambda sd: sd


def _lora():
    import jax
    import numpy as np

    from supir_tpu.captioner import llama as JLL
    from supir_tpu.captioner import train as JT
    from supir_tpu_torch.captioner.agent import CaptionerConfig, LlavaForCausalLM
    from supir_tpu_torch.captioner.train import LORA_TARGETS, init_lora
    from supir_tpu_torch.utils import ckpt_rules as C

    cfg = CaptionerConfig()  # llava-v1.5-13b, rank 64
    ids = np.zeros((1, 4), np.int32)
    module = JLL.LlamaForCausalLM(JLL.LlamaConfig())
    llama = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), ids, ids, method=module.forward_ids))["params"]
    shapes = jax.eval_shape(lambda p: JT.init_lora(p, rank=64), llama)
    rules = C.lora_rules(cfg.llama.layers, LORA_TARGETS)
    with torch.device("meta"):
        held = {k: tuple(v.shape) for k, v in init_lora(LlavaForCausalLM(cfg), rank=64).items()}
    return _from_jax_shapes(shapes, rules), rules, held, lambda sd: sd


TREES = {"restore": _restore, "conditioner": _conditioner, "llava": _llava, "mpt": _mpt, "face": _face,
         "discriminator": _discriminator, "lora": _lora}


@pytest.mark.parametrize("tree", sorted(TREES))
def test_port_tree_against_the_reference_key_space(tree):
    manifest, rules, held, convert = TREES[tree]()
    rule_keys = {tk for tk, _, _ in rules}
    missing = sorted(rule_keys - set(manifest))
    assert not missing, f"{len(missing)} rule keys not in the reference key space, e.g. {missing[:5]}"
    converted = convert({k: torch.empty(v, device="meta") for k, v in manifest.items()})
    wrong = [(k, tuple(converted[k].shape), held[k]) for k in held if k in converted
             and tuple(converted[k].shape) != held[k]]
    assert not wrong, f"{len(wrong)} converted shapes differ from the port's, e.g. {wrong[:5]}"
    uncovered = sorted(k for k in held if k not in rule_keys)
    assert not uncovered, f"{len(uncovered)} port keys no rule covers, e.g. {uncovered[:5]}"
    assert set(held) <= set(converted)
    unused = sorted(k for k in manifest if k not in rule_keys and not k.endswith(ALLOWED_UNUSED[tree]))
    assert not unused, f"{len(unused)} reference keys neither consumed nor allowed, e.g. {unused[:5]}"
    assert len(held) >= {"restore": 2900, "conditioner": 580, "llava": 750, "mpt": 190, "face": 500,
                         "discriminator": 13, "lora": 560}[tree]
