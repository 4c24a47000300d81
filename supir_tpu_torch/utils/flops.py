"""FLOP counts of the diffusion pipeline in closed form (counterpart of
supir_tpu/utils/flops.py; the reference counts them with thop hooks,
openaimodel.py:411-428), so that a measured time can be read as a
utilisation. Exact integers, the JAX package's formulas term for term,
including their approximations (the decoder as 1.5 encoders, GLVControl
as 0.45 of the UNet)."""

from __future__ import annotations

from supir_tpu_torch.config import SUPIRConfig, UNetConfig


def conv_flops(h, w, cin, cout, k=3):
    return 2 * h * w * cin * cout * k * k


def attn_flops(seq, kv, heads, dim_head):
    return 4 * heads * seq * kv * dim_head + 4 * seq * kv * heads * dim_head


def transformer_block_flops(seq, dim, ctx_len, ctx_dim, heads, dim_head):
    inner = heads * dim_head
    f = 0
    f += 2 * seq * dim * inner * 3 + 2 * seq * inner * dim  # qkv + out, self-attention
    f += attn_flops(seq, seq, heads, dim_head)
    f += 2 * seq * dim * inner + 2 * ctx_len * ctx_dim * inner * 2 + 2 * seq * inner * dim
    f += attn_flops(seq, ctx_len, heads, dim_head)
    f += 2 * seq * inner * inner * 8 + 2 * seq * inner * 4 * inner  # GEGLU feed-forward
    return f


def unet_eval_flops(cfg: UNetConfig, latent_hw: int, batch: int = 1, ctx_len: int = 77):
    """FLOPs of one UNet forward (encoder, middle, decoder), roughly."""
    total = 0
    h = latent_hw
    ch = cfg.model_channels
    ds = 1
    for level, mult in enumerate(cfg.channel_mult):
        out_ch = mult * cfg.model_channels
        for _ in range(cfg.num_res_blocks):
            total += conv_flops(h, h, ch, out_ch) + conv_flops(h, h, out_ch, out_ch)
            ch = out_ch
            if ds in cfg.attention_resolutions:
                total += cfg.transformer_depth[level] * transformer_block_flops(
                    h * h, ch, ctx_len, cfg.context_dim, ch // cfg.num_head_channels, cfg.num_head_channels)
        if level != cfg.levels - 1:
            total += conv_flops(h // 2, h // 2, ch, ch)
            h //= 2
            ds *= 2
    total += 2 * (conv_flops(h, h, ch, ch) * 2)
    total += cfg.middle_depth * transformer_block_flops(
        h * h, ch, ctx_len, cfg.context_dim, ch // cfg.num_head_channels, cfg.num_head_channels)
    # the decoder as 1.5 encoders (num_res_blocks + 1 a level, the skip concatenations)
    total = total + int(total * 1.5)
    return total * batch


def pipeline_flops(cfg: SUPIRConfig, latent_hw: int, num_steps: int, batch: int = 1):
    """The controlled denoiser a step: GLVControl (about the UNet's encoder
    and middle, 0.45 of it) and LightGLVUNet, at CFG's doubled batch."""
    unet = unet_eval_flops(cfg.unet, latent_hw, batch=2 * batch)
    control = int(unet * 0.45)
    return (unet + control) * num_steps
