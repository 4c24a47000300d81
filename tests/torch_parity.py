"""Shared helpers for the parity tests of supir_tpu_torch against supir_tpu.

Inputs and weights are made with numpy from a seed and handed to both
packages. Weights start from the JAX package's own parameter shapes
(`eval_shape_params`, no init compile) and every leaf is filled with random
values, zero-initialised layers included: left at zero, those layers would
hide most of the network from the comparison.

Every tests/test_torch_*.py imports `one_torch_thread` from here, so its
tests run torch on one intra-op thread. They import this module as
`torch_parity` (pytest puts tests/ on the path), since another installed
package may own the top-level name `tests`. JAX is imported inside the
helpers that need it: the `gpu` tests import this module where JAX is not
installed.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one intra-op thread for the module's tests, the previous
    count restored after them. The suite runs six xdist workers; at torch's
    default of one thread per core they oversubscribe the cores over
    thousands of small tensor ops (one plan test: 1.3 s alone, 77 s with
    six copies at once, 0.7 s at one thread). A fixture, not import-time
    code: every worker imports every test module, the JAX package's too."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _random_leaf(name: str, shape, rng: np.random.Generator) -> np.ndarray:
    if name == "kernel":
        fan_in = math.prod(shape[:-1])
        v = rng.standard_normal(shape) * fan_in ** -0.5
    elif name == "scale":
        v = 1.0 + 0.1 * rng.standard_normal(shape)
    else:
        v = 0.1 * rng.standard_normal(shape)
    return v.astype(np.float32)


def random_params(shapes, seed: int):
    """A tree of jax.ShapeDtypeStruct (or arrays) -> the same tree of random
    float32 numpy leaves."""
    import jax

    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        return _random_leaf(path[-1].key, leaf.shape, rng)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def tiny_cfg():
    from supir_tpu.engine.factory import tiny_test_config

    cfg, _ = tiny_test_config()
    return cfg


def tiny_params(cfg, seed: int = 0):
    """Random {'unet', 'control', 'vae'} params of `cfg` (no conditioner)."""
    from supir_tpu.engine.factory import eval_shape_params

    return random_params(eval_shape_params(cfg, None, image_size=64), seed)


def sub_state_dict(sd, prefix: str):
    """Keys under `prefix.` with the prefix stripped."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in sd.items() if k.startswith(prefix + ".")}


def nchw(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1))


def nhwc(x) -> np.ndarray:
    return np.ascontiguousarray(np.moveaxis(np.asarray(x), 1, -1))


def tiny_engine_pair(seed: int = 21):
    """(cfg, JAX engine, port cfg, port engine on the CPU): the tiny model
    with its conditioner, every leaf random from `seed`, in both packages."""
    import jax
    import jax.numpy as jnp

    from supir_tpu.engine import factory as JF
    from supir_tpu.engine.supir import SUPIREngine as JaxEngine
    from supir_tpu_torch.engine.factory import create_engine, tiny_test_config
    from supir_tpu_torch.utils.weights import state_dict_from_jax

    cfg, cond = JF.tiny_test_config()
    params = random_params(JF.eval_shape_params(cfg, cond, image_size=64), seed=seed)
    jengine = JaxEngine(cfg, jax.tree_util.tree_map(jnp.asarray, params), cond_cfg=cond)
    tcfg, tcond = tiny_test_config()
    tengine = create_engine(tcfg, "cpu", state_dict=state_dict_from_jax(params, cfg), cond_cfg=tcond)
    return cfg, jengine, tcfg, tengine


def inject_noise(engine, seed: int = 0):
    """Wrap engine.batchify_sample (JAX or port) so that its n-th call gets
    noise_override and center_noise_override drawn with numpy from (seed,
    n): the two packages draw different noise from a seed, so parity runs
    of an app that passes `seed` give both engines these draws instead.
    Returns the list of the calls' latent shapes."""
    original = engine.batchify_sample
    calls = []

    def wrapped(x, c, uc, **kw):
        shape = tuple(np.shape(c["control"]))
        rng = np.random.default_rng((seed, len(calls)))
        calls.append(shape)
        noise, center = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
        return original(x, c, uc, noise_override=noise, center_noise_override=center, **kw)

    engine.batchify_sample = wrapped
    return calls


def tiny_captioner_pair(seed: int = 1, quantized: bool = True):
    """(JAX agent, port agent on the CPU): the tiny captioner in int4 (merged
    qkv and gate-up, the glue fused), or unquantized fp32 with
    `quantized=False`, every leaf random from `seed` with the norm weights
    near 1, in both packages. Greedy decodes agree token for token
    (tests/test_torch_captioner.py)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from supir_tpu.captioner import agent as JA
    from supir_tpu.captioner import llama as JL
    from supir_tpu_torch.captioner import agent as TA
    from supir_tpu_torch.captioner import llama as TL
    from supir_tpu_torch.captioner import vision as TV
    from supir_tpu_torch.utils.weights import captioner_state_dict_from_jax

    jcfg = JA.CaptionerConfig.tiny()
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        shape, name = np.shape(leaf), path[-1].key
        if name == "kernel":
            return (rng.standard_normal(shape) * float(np.prod(shape[:-1])) ** -0.5).astype(np.float32)
        return ((1.0 if name in ("scale", "weight") else 0.0) + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, JA.CaptionerAgent.create_random(jcfg, seed=0).params)
    if quantized:
        qllama, _ = JL.quantize_llama_params(params["llama"], bits=4, fuse=True)
        llama = dataclasses.replace(jcfg.llama, quantize_int4=True, fused_qkv=True, fused_glue=True)
        jagent = JA.CaptionerAgent(dataclasses.replace(jcfg, llama=llama),
                                   jax.tree_util.tree_map(jnp.asarray, dict(params, llama=qllama)))
    else:
        jagent = JA.CaptionerAgent(jcfg, jax.tree_util.tree_map(jnp.asarray, params))
    d = dataclasses.asdict(jcfg)
    tcfg = TA.CaptionerConfig(vision=TV.CLIPVisionConfig(**d.pop("vision")), llama=TL.LlamaConfig(**d.pop("llama")),
                              **d)
    tagent = TA.create_captioner(tcfg, "cpu", bits=4 if quantized else None,
                                 state_dict=captioner_state_dict_from_jax(params, jcfg), stochastic=False)
    return jagent, tagent


def write_tiny_llava_dir(path: str, seed: int = 0) -> dict:
    """A tiny HF-layout llava directory written with transformers' own
    modules (Llama, the CLIP vision tower, the mm_projector's two linears):
    model.safetensors and config.json, no tokenizer files. Returns the
    config.json dict."""
    import json
    import os

    from safetensors.torch import save_file
    from transformers import CLIPVisionConfig, CLIPVisionModel, LlamaConfig, LlamaForCausalLM

    from supir_tpu.captioner.agent import CaptionerConfig

    cfg = CaptionerConfig.tiny()
    torch.manual_seed(seed)
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
    os.makedirs(path, exist_ok=True)
    save_file({k: v.contiguous() for k, v in sd.items()}, os.path.join(path, "model.safetensors"))
    hf = {"hidden_size": cfg.llama.dim, "num_hidden_layers": cfg.llama.layers,
          "num_attention_heads": cfg.llama.heads, "intermediate_size": cfg.llama.hidden_dim,
          "vocab_size": cfg.llama.vocab_size, "max_position_embeddings": cfg.llama.max_seq_len,
          "vision_config": {"image_size": cfg.vision.image_size, "patch_size": cfg.vision.patch_size,
                            "hidden_size": cfg.vision.width, "num_hidden_layers": cfg.vision.layers,
                            "num_attention_heads": cfg.vision.heads}}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f)
    return hf
