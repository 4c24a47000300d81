"""Checkpoint rule tables: (torch key, flax leaf path, kind) triples.

The port's own copy of the rule helpers of `supir_tpu/utils/ckpt.py`
(:54-322) and of the captioner's tables in `supir_tpu/captioner/convert.py`
(:25-72, and MPT's :104-124). The weight bridge (`utils/weights.py`) walks them backwards to
turn a JAX parameter tree into a state dict under the reference's torch
keys. `tests/test_torch_engine.py` and `tests/test_torch_captioner.py` hold
each table equal to the JAX package's, key for key and path for path.

kind: "linear" ([out, in] torch, [in, out] flax), "conv" (OIHW torch, HWIO
flax), None (as is), or "qkv_w" / "qkv_b": OpenCLIP's packed in_proj
weight [3w, w] or bias [3w], whose flax path ends in a placeholder
(`__qkv_w__`, `__qkv_b__`) beside the q/k/v_proj Dense leaves it splits into.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from supir_tpu_torch.config import UNetConfig, VAEConfig

Rule = Tuple[str, Tuple[str, ...], Optional[str]]  # torch key, flax path, kind


def _dense(tk: str, fp: Tuple[str, ...], bias=True) -> List[Rule]:
    rules = [(f"{tk}.weight", fp + ("Dense_0", "kernel"), "linear")]
    if bias:
        rules.append((f"{tk}.bias", fp + ("Dense_0", "bias"), None))
    return rules


def _conv(tk: str, fp: Tuple[str, ...]) -> List[Rule]:
    return [
        (f"{tk}.weight", fp + ("Conv_0", "kernel"), "conv"),
        (f"{tk}.bias", fp + ("Conv_0", "bias"), None),
    ]


def _norm(tk: str, fp: Tuple[str, ...]) -> List[Rule]:
    """GroupNorm and LayerNorm alike: weight -> scale."""
    return [
        (f"{tk}.weight", fp + ("scale",), None),
        (f"{tk}.bias", fp + ("bias",), None),
    ]


def _resblock(tk: str, fp: Tuple[str, ...], has_skip: bool) -> List[Rule]:
    rules = []
    rules += _norm(f"{tk}.in_layers.0", fp + ("in_norm",))
    rules += _conv(f"{tk}.in_layers.2", fp + ("in_conv",))
    rules += _dense(f"{tk}.emb_layers.1", fp + ("emb_proj",))
    rules += _norm(f"{tk}.out_layers.0", fp + ("out_norm",))
    rules += _conv(f"{tk}.out_layers.3", fp + ("out_conv",))
    if has_skip:
        rules += _conv(f"{tk}.skip_connection", fp + ("skip",))
    return rules


def _btb(tk: str, fp: Tuple[str, ...]) -> List[Rule]:
    """BasicTransformerBlock."""
    rules = []
    for a in ("attn1", "attn2"):
        rules += _dense(f"{tk}.{a}.to_q", fp + (a, "to_q"), bias=False)
        rules += _dense(f"{tk}.{a}.to_k", fp + (a, "to_k"), bias=False)
        rules += _dense(f"{tk}.{a}.to_v", fp + (a, "to_v"), bias=False)
        rules += _dense(f"{tk}.{a}.to_out.0", fp + (a, "to_out"))
    rules += _dense(f"{tk}.ff.net.0.proj", fp + ("ff", "geglu", "proj"))
    rules += _dense(f"{tk}.ff.net.2", fp + ("ff", "proj_out"))
    for n in ("norm1", "norm2", "norm3"):
        rules += _norm(f"{tk}.{n}", fp + (n,))
    return rules


def _spatial_transformer(tk: str, fp: Tuple[str, ...], depth: int) -> List[Rule]:
    rules = []
    rules += _norm(f"{tk}.norm", fp + ("norm",))
    rules += _dense(f"{tk}.proj_in", fp + ("proj_in",))
    for d in range(depth):
        rules += _btb(f"{tk}.transformer_blocks.{d}", fp + (f"block_{d}",))
    rules += _dense(f"{tk}.proj_out", fp + ("proj_out",))
    return rules


def _time_embed(tk_prefix: str, fp: Tuple[str, ...], with_label: bool) -> List[Rule]:
    rules = []
    rules += _dense(f"{tk_prefix}time_embed.0", fp + ("time", "time_embed", "fc1"))
    rules += _dense(f"{tk_prefix}time_embed.2", fp + ("time", "time_embed", "fc2"))
    if with_label:
        rules += _dense(f"{tk_prefix}label_emb.0.0", fp + ("time", "label_emb", "fc1"))
        rules += _dense(f"{tk_prefix}label_emb.0.2", fp + ("time", "label_emb", "fc2"))
    return rules


def unet_encoder_rules(cfg: UNetConfig, tk: str, fp: Tuple[str, ...]) -> List[Rule]:
    """input_blocks + middle_block under torch prefix `tk`, flax scope `fp`."""
    rules = _conv(f"{tk}input_blocks.0.0", fp + ("conv_in",))
    ch = cfg.model_channels
    ds = 1
    i = 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            out_ch = mult * cfg.model_channels
            rules += _resblock(f"{tk}input_blocks.{i}.0", fp + (f"in_{i}_res",), has_skip=(ch != out_ch))
            ch = out_ch
            if ds in cfg.attention_resolutions:
                rules += _spatial_transformer(
                    f"{tk}input_blocks.{i}.1", fp + (f"in_{i}_attn",), cfg.transformer_depth[level]
                )
            i += 1
        if level != cfg.levels - 1:
            rules += _conv(f"{tk}input_blocks.{i}.0.op", fp + (f"in_{i}_down", "conv"))
            i += 1
            ds *= 2
    rules += _resblock(f"{tk}middle_block.0", fp + ("mid_res1",), has_skip=False)
    rules += _spatial_transformer(f"{tk}middle_block.1", fp + ("mid_attn",), cfg.middle_depth)
    rules += _resblock(f"{tk}middle_block.2", fp + ("mid_res2",), has_skip=False)
    return rules


def unet_decoder_rules(cfg: UNetConfig, tk: str, fp: Tuple[str, ...],
                       skip_channels: List[int]) -> List[Rule]:
    """output_blocks + out head. skip_channels: encoder feature channels."""
    rules: List[Rule] = []
    skips = list(skip_channels)
    ch = cfg.model_channels * cfg.channel_mult[-1]
    ds = 2 ** (cfg.levels - 1)
    i = 0
    for rlevel, mult in enumerate(reversed(cfg.channel_mult)):
        level = cfg.levels - 1 - rlevel
        out_ch = mult * cfg.model_channels
        for blk in range(cfg.num_res_blocks + 1):
            ich = skips.pop()
            rules += _resblock(
                f"{tk}output_blocks.{i}.0", fp + (f"out_{i}_res",), has_skip=(ch + ich != out_ch)
            )
            ch = out_ch
            mod_idx = 1
            if ds in cfg.attention_resolutions:
                rules += _spatial_transformer(
                    f"{tk}output_blocks.{i}.{mod_idx}", fp + (f"out_{i}_attn",), cfg.transformer_depth[level]
                )
                mod_idx += 1
            if level > 0 and blk == cfg.num_res_blocks:
                rules += _conv(f"{tk}output_blocks.{i}.{mod_idx}.conv", fp + (f"out_{i}_up", "conv"))
                ds //= 2
            i += 1
    rules += _norm(f"{tk}out.0", fp + ("out", "norm"))
    rules += _conv(f"{tk}out.2", fp + ("out", "conv"))
    return rules


def zero_sft_rules(tk: str, fp: Tuple[str, ...]) -> List[Rule]:
    rules = []
    rules += _norm(f"{tk}.param_free_norm", fp + ("norm",))
    rules += _conv(f"{tk}.mlp_shared.0", fp + ("mlp_shared",))
    rules += _conv(f"{tk}.zero_mul", fp + ("zero_mul",))
    rules += _conv(f"{tk}.zero_add", fp + ("zero_add",))
    rules += _conv(f"{tk}.zero_conv", fp + ("zero_conv",))
    return rules


def zero_xattn_rules(tk: str, fp: Tuple[str, ...]) -> List[Rule]:
    rules = []
    rules += _dense(f"{tk}.attn.to_q", fp + ("attn", "to_q"), bias=False)
    rules += _dense(f"{tk}.attn.to_k", fp + ("attn", "to_k"), bias=False)
    rules += _dense(f"{tk}.attn.to_v", fp + ("attn", "to_v"), bias=False)
    rules += _dense(f"{tk}.attn.to_out.0", fp + ("attn", "to_out"))
    rules += _norm(f"{tk}.norm1", fp + ("norm1",))
    rules += _norm(f"{tk}.norm2", fp + ("norm2",))
    return rules


def glv_control_rules(cfg: UNetConfig) -> List[Rule]:
    """model.control_model.* -> params['control']."""
    tk = "model.control_model."
    rules = _time_embed(tk, (), with_label=cfg.adm_in_channels is not None)
    rules += unet_encoder_rules(cfg, tk, ("enc",))
    rules += _conv(f"{tk}input_hint_block.0", ("input_hint_block",))
    return rules


def plain_unet_rules(cfg: UNetConfig, tk: str = "model.diffusion_model.") -> List[Rule]:
    """The plain SDXL UNetModel (txt2img), its encoder under ('enc',) and
    its decoder under ('dec',), the output head at the root, as
    supir_tpu/utils/ckpt.py:237-251 fixes the decoder's head up."""
    from supir_tpu_torch.models.unet import encoder_feature_channels

    rules = _time_embed(tk, (), with_label=cfg.adm_in_channels is not None)
    rules += unet_encoder_rules(cfg, tk, ("enc",))
    rules += unet_decoder_rules(cfg, tk, ("dec",), encoder_feature_channels(cfg))
    return [(k, fp[1:] if fp[:2] == ("dec", "out") else fp, kind) for k, fp, kind in rules]


def _vae_resblock(tk: str, fp: Tuple[str, ...], has_nin: bool) -> List[Rule]:
    rules = []
    rules += _norm(f"{tk}.norm1", fp + ("norm1",))
    rules += _conv(f"{tk}.conv1", fp + ("conv1",))
    rules += _norm(f"{tk}.norm2", fp + ("norm2",))
    rules += _conv(f"{tk}.conv2", fp + ("conv2",))
    if has_nin:
        rules += _conv(f"{tk}.nin_shortcut", fp + ("nin_shortcut",))
    return rules


def _vae_attn(tk: str, fp: Tuple[str, ...]) -> List[Rule]:
    rules = []
    rules += _norm(f"{tk}.norm", fp + ("norm",))
    for n in ("q", "k", "v", "proj_out"):
        rules += _conv(f"{tk}.{n}", fp + (n,))
    return rules


def vae_encoder_rules(cfg: VAEConfig, tk: str, fp: Tuple[str, ...]) -> List[Rule]:
    rules = _conv(f"{tk}.conv_in", fp + ("conv_in",))
    ch = cfg.ch
    for level, mult in enumerate(cfg.ch_mult):
        out_ch = cfg.ch * mult
        for i in range(cfg.num_res_blocks):
            rules += _vae_resblock(
                f"{tk}.down.{level}.block.{i}", fp + (f"down_{level}_block_{i}",), has_nin=(ch != out_ch)
            )
            ch = out_ch
        if level != len(cfg.ch_mult) - 1:
            rules += _conv(f"{tk}.down.{level}.downsample.conv", fp + (f"down_{level}_downsample",))
    rules += _vae_resblock(f"{tk}.mid.block_1", fp + ("mid_block_1",), has_nin=False)
    rules += _vae_attn(f"{tk}.mid.attn_1", fp + ("mid_attn_1",))
    rules += _vae_resblock(f"{tk}.mid.block_2", fp + ("mid_block_2",), has_nin=False)
    rules += _norm(f"{tk}.norm_out", fp + ("norm_out",))
    rules += _conv(f"{tk}.conv_out", fp + ("conv_out",))
    return rules


def vae_decoder_rules(cfg: VAEConfig, tk: str, fp: Tuple[str, ...]) -> List[Rule]:
    rules = _conv(f"{tk}.conv_in", fp + ("conv_in",))
    rules += _vae_resblock(f"{tk}.mid.block_1", fp + ("mid_block_1",), has_nin=False)
    rules += _vae_attn(f"{tk}.mid.attn_1", fp + ("mid_attn_1",))
    rules += _vae_resblock(f"{tk}.mid.block_2", fp + ("mid_block_2",), has_nin=False)
    ch = cfg.ch * cfg.ch_mult[-1]
    for rlevel, mult in enumerate(reversed(cfg.ch_mult)):
        level = len(cfg.ch_mult) - 1 - rlevel
        out_ch = cfg.ch * mult
        for i in range(cfg.num_res_blocks + 1):
            rules += _vae_resblock(
                f"{tk}.up.{level}.block.{i}", fp + (f"up_{level}_block_{i}",), has_nin=(ch != out_ch)
            )
            ch = out_ch
        if level != 0:
            rules += _conv(f"{tk}.up.{level}.upsample.conv", fp + (f"up_{level}_upsample",))
    rules += _norm(f"{tk}.norm_out", fp + ("norm_out",))
    rules += _conv(f"{tk}.conv_out", fp + ("conv_out",))
    return rules


def vae_rules(cfg: VAEConfig, with_denoise_encoder: bool = True) -> List[Rule]:
    tk = "first_stage_model"
    rules = vae_encoder_rules(cfg, f"{tk}.encoder", ("encoder",))
    rules += vae_decoder_rules(cfg, f"{tk}.decoder", ("decoder",))
    rules += _conv(f"{tk}.quant_conv", ("quant_conv",))
    rules += _conv(f"{tk}.post_quant_conv", ("post_quant_conv",))
    if with_denoise_encoder:
        rules += vae_encoder_rules(cfg, f"{tk}.denoise_encoder", ("denoise_encoder",))
    return rules


# ---------------------------------------------------------- text conditioner
# supir_tpu/utils/ckpt.py:325-367: HF CLIP-L and OpenCLIP bigG under conditioner.*


def clip_l_rules(layers: int = 12) -> List[Rule]:
    """HF CLIP-L text tower (conditioner.embedders.0.transformer.text_model)."""
    tk = "conditioner.embedders.0.transformer.text_model"
    fp = ("clip_l",)
    rules = [
        (f"{tk}.embeddings.token_embedding.weight", fp + ("token_embedding", "embedding"), None),
        (f"{tk}.embeddings.position_embedding.weight", fp + ("positional_embedding",), None),
    ]
    for i in range(layers):
        lt = f"{tk}.encoder.layers.{i}"
        lf = fp + (f"block_{i}",)
        for p in ("q", "k", "v", "out"):
            rules += _dense(f"{lt}.self_attn.{p}_proj", lf + ("attn", f"{p}_proj"))
        rules += _norm(f"{lt}.layer_norm1", lf + ("ln_1",))
        rules += _norm(f"{lt}.layer_norm2", lf + ("ln_2",))
        rules += _dense(f"{lt}.mlp.fc1", lf + ("mlp_fc1",))
        rules += _dense(f"{lt}.mlp.fc2", lf + ("mlp_fc2",))
    rules += _norm(f"{tk}.final_layer_norm", fp + ("ln_final",))
    return rules


def clip_bigg_rules(layers: int = 32) -> List[Rule]:
    """OpenCLIP bigG text tower (conditioner.embedders.1.model); the packed
    in_proj q/k/v take the "qkv_w" / "qkv_b" kinds."""
    tk = "conditioner.embedders.1.model"
    fp = ("clip_bigg",)
    rules = [
        (f"{tk}.token_embedding.weight", fp + ("token_embedding", "embedding"), None),
        (f"{tk}.positional_embedding", fp + ("positional_embedding",), None),
        (f"{tk}.text_projection", fp + ("text_projection",), None),
    ]
    for i in range(layers):
        lt = f"{tk}.transformer.resblocks.{i}"
        lf = fp + (f"block_{i}",)
        rules.append((f"{lt}.attn.in_proj_weight", lf + ("attn", "__qkv_w__"), "qkv_w"))
        rules.append((f"{lt}.attn.in_proj_bias", lf + ("attn", "__qkv_b__"), "qkv_b"))
        rules += _dense(f"{lt}.attn.out_proj", lf + ("attn", "out_proj"))
        rules += _norm(f"{lt}.ln_1", lf + ("ln_1",))
        rules += _norm(f"{lt}.ln_2", lf + ("ln_2",))
        rules += _dense(f"{lt}.mlp.c_fc", lf + ("mlp_fc1",))
        rules += _dense(f"{lt}.mlp.c_proj", lf + ("mlp_fc2",))
    rules += _norm(f"{tk}.ln_final", fp + ("ln_final",))
    return rules


# ---------------------------------------------------------------- captioner
# HF LlavaLlamaForCausalLM key space (supir_tpu/captioner/convert.py:25-72)


def llama_rules(cfg) -> List[Rule]:
    """model.embed_tokens / model.layers.{i}.* / model.norm / lm_head ->
    params['llama'] (a LlamaConfig)."""
    tk = "model"
    rules: List[Rule] = [
        (f"{tk}.embed_tokens.weight", ("embed_tokens", "embedding"), None),
        (f"{tk}.norm.weight", ("model", "norm", "weight"), None),
    ]
    rules += _dense("lm_head", ("lm_head",), bias=False)
    for i in range(cfg.layers):
        lt = f"{tk}.layers.{i}"
        lf = ("model", f"layer_{i}")
        for p in ("q", "k", "v"):
            rules += _dense(f"{lt}.self_attn.{p}_proj", lf + (f"{p}_proj",), bias=False)
        rules += _dense(f"{lt}.self_attn.o_proj", lf + ("o_proj",), bias=False)
        for p in ("gate", "up", "down"):
            rules += _dense(f"{lt}.mlp.{p}_proj", lf + (f"{p}_proj",), bias=False)
        rules.append((f"{lt}.input_layernorm.weight", lf + ("input_norm", "weight"), None))
        rules.append((f"{lt}.post_attention_layernorm.weight", lf + ("post_norm", "weight"), None))
    return rules


def vision_rules(cfg) -> List[Rule]:
    """model.vision_tower.vision_tower.vision_model.* -> params['vision']
    (a CLIPVisionConfig)."""
    tk = "model.vision_tower.vision_tower.vision_model"
    rules: List[Rule] = [
        (f"{tk}.embeddings.class_embedding", ("class_embedding",), None),
        (f"{tk}.embeddings.position_embedding.weight", ("positional_embedding",), None),
        (f"{tk}.embeddings.patch_embedding.weight", ("patch_embedding", "kernel"), "conv"),
    ]
    # HF's layer is spelled "pre_layrnorm"
    rules += [
        (f"{tk}.pre_layrnorm.weight", ("pre_layernorm", "scale"), None),
        (f"{tk}.pre_layrnorm.bias", ("pre_layernorm", "bias"), None),
    ]
    for i in range(cfg.layers):
        lt = f"{tk}.encoder.layers.{i}"
        lf = (f"block_{i}",)
        for p in ("q", "k", "v", "out"):
            rules += _dense(f"{lt}.self_attn.{p}_proj", lf + ("attn", f"{p}_proj"))
        rules += _norm(f"{lt}.layer_norm1", lf + ("ln_1",))
        rules += _norm(f"{lt}.layer_norm2", lf + ("ln_2",))
        rules += _dense(f"{lt}.mlp.fc1", lf + ("mlp_fc1",))
        rules += _dense(f"{lt}.mlp.fc2", lf + ("mlp_fc2",))
    return rules


def projector_rules() -> List[Rule]:
    """model.mm_projector.{0,2}.* -> params['projector'] (mlp2x_gelu)."""
    return _dense("model.mm_projector.0", ("fc1",)) + _dense("model.mm_projector.2", ("fc2",))


def mpt_rules(cfg) -> List[Rule]:
    """The reference's MPT key space (transformer.wte / transformer.blocks.{i}.
    {norm_1, attn.Wqkv, attn.out_proj, norm_2, ffn.up_proj, ffn.down_proj} /
    transformer.norm_f) -> the MPTForCausalLM tree (an MPTConfig;
    supir_tpu/captioner/convert.py:104-124)."""
    tk = "transformer"
    rules: List[Rule] = [
        (f"{tk}.wte.weight", ("wte", "embedding"), None),
        (f"{tk}.norm_f.weight", ("norm_f", "ln", "scale"), None),
        (f"{tk}.norm_f.bias", ("norm_f", "ln", "bias"), None),
    ]
    for i in range(cfg.n_layers):
        lt = f"{tk}.blocks.{i}"
        lf = (f"block_{i}",)
        for n in ("norm_1", "norm_2"):
            rules.append((f"{lt}.{n}.weight", lf + (n, "ln", "scale"), None))
            rules.append((f"{lt}.{n}.bias", lf + (n, "ln", "bias"), None))
        rules += _dense(f"{lt}.attn.Wqkv", lf + ("Wqkv",), bias=False)
        rules += _dense(f"{lt}.attn.out_proj", lf + ("out_proj",), bias=False)
        rules += _dense(f"{lt}.ffn.up_proj", lf + ("up_proj",), bias=False)
        rules += _dense(f"{lt}.ffn.down_proj", lf + ("down_proj",), bias=False)
    return rules


# ------------------------------------------------------------------ training
# trees of the trainers that no reference checkpoint holds: the port's keys
# against the JAX modules' own paths


def discriminator_rules(n_layers: int = 3) -> List[Rule]:
    """NLayerDiscriminator (diffusion/ae_losses.py) -> the JAX
    discriminator's tree (supir_tpu/diffusion/ae_losses.py:20): flax Conv
    leaves directly under conv{i}, GroupNorm's scale -> weight."""
    def conv(name: str, bias: bool = True) -> List[Rule]:
        rules = [(f"{name}.weight", (name, "kernel"), "conv")]
        return rules + [(f"{name}.bias", (name, "bias"), None)] if bias else rules

    rules = conv("conv0")
    for i in range(1, n_layers + 1):
        rules += conv(f"conv{i}", bias=False)
        rules += _norm(f"norm{i}", (f"norm{i}",))
    return rules + conv("conv_out")


LORA_MLP = ("gate_proj", "up_proj", "down_proj")


def lora_rules(layers: int, targets) -> List[Rule]:
    """The trainer's LoRA leaves (captioner/train.py:init_lora) -> JAX's
    `init_lora` tree (supir_tpu/captioner/train.py:32): a [in, r] and b
    [r, out] in the same layout under params['lora']['model']['layer_{i}']."""
    rules: List[Rule] = []
    for i in range(layers):
        for p in targets:
            group = "mlp" if p in LORA_MLP else "self_attn"
            for leaf in ("a", "b"):
                rules.append((f"model.layers.{i}.{group}.{p}.lora_{leaf}", ("model", f"layer_{i}", p, leaf), None))
    return rules
