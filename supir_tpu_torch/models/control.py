"""SUPIR control path (counterpart of supir_tpu/models/control.py), NCHW:
GLVControl, ZeroConv, ZeroSFT, ZeroCrossAttn and LightGLVUNet, with the
mode tables of `supir_tpu.config.ControlConfig`, and the progressive
training schedule of adapter masks.

State-dict keys are the reference's: `model.control_model.*` for
GLVControl and `model.diffusion_model.*` (with `project_modules.{pos}`) for
LightGLVUNet, relative to those prefixes.

LightGLVUNet's cross-step feature cache: `return_features=True` also
returns the encoder features and the middle block's output of the call,
and `feature_cache=(hs, h)` skips the encoder and the middle block and
takes those instead; the time embedding, the adapters, the decoder and the
output head run either way.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from supir_tpu_torch.config import ControlConfig, UNetConfig
from supir_tpu_torch.models.attention import CrossAttention
from supir_tpu_torch.models.layers import Conv, GroupNorm32
from supir_tpu_torch.models.unet import UNetDecoderPlain, UNetEncoder, Upsample, run_block
from supir_tpu_torch.ops.resize import bilinear_resize


def _masked(t: torch.Tensor, mask) -> torch.Tensor:
    """t * (1 - mask); t itself without a mask."""
    return t if mask is None else t * (1.0 - torch.as_tensor(mask, dtype=t.dtype, device=t.device))


class ZeroConv(nn.Module):
    """1x1 zero-init additive injector (reference SUPIR_v0.py:45-59; the v0
    configs do not build it): h + zero_conv(c), with the decoder stream
    h_ori concatenated in front where given."""

    def __init__(self, label_nc: int, norm_nc: int, device=None, dtype=None):
        super().__init__()
        self.zero_conv = Conv(label_nc, norm_nc, 1, zero_init=True, device=device, dtype=dtype)

    def forward(self, c, h, h_ori=None):
        h = h + self.zero_conv(c)
        return h if h_ori is None else torch.cat([h_ori, h], dim=1)


class ZeroSFT(nn.Module):
    """Zero-init SFT modulation of a decoder skip feature.

    forward(c, h, h_ori): c = control feature [label_nc], h = skip feature
    [norm_nc], h_ori = decoder stream [concat_channels] or None."""

    def __init__(self, label_nc: int, norm_nc: int, concat_channels: int = 0,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        nhidden = 128
        self.concat_channels = concat_channels
        self.param_free_norm = GroupNorm32(norm_nc + concat_channels, **kw)
        self.mlp_shared = nn.Sequential(Conv(label_nc, nhidden, 3, **kw), nn.SiLU())
        self.zero_mul = Conv(nhidden, norm_nc + concat_channels, 3, zero_init=True, **kw)
        self.zero_add = Conv(nhidden, norm_nc + concat_channels, 3, zero_init=True, **kw)
        self.zero_conv = Conv(label_nc, norm_nc, 1, zero_init=True, **kw)

    def forward(self, c, h, h_ori=None, control_scale: float = 1.0, mask=None):
        """`mask` (1 masks, 0 or None does not; progressive training,
        SUPIR_v0.py:98-110) zeroes the control's part, the zero_conv add,
        gamma and beta; the GroupNorm and the control_scale blend stay."""
        pre_concat = h_ori is not None and self.concat_channels != 0
        h_raw = torch.cat([h_ori, h], dim=1) if pre_concat else h
        h = h + _masked(self.zero_conv(c), mask)
        if pre_concat:
            h = torch.cat([h_ori, h], dim=1)
        actv = self.mlp_shared(c)
        gamma = _masked(self.zero_mul(actv), mask)
        beta = _masked(self.zero_add(actv), mask)
        h = self.param_free_norm(h) * (gamma + 1.0) + beta
        if h_ori is not None and not pre_concat:
            h = torch.cat([h_ori, h], dim=1)
        return h * control_scale + h_raw * (1.0 - control_scale)


class ZeroCrossAttn(nn.Module):
    """Cross-attention injector: x attends to the control feature. The
    reference does not zero-init its output projection."""

    def __init__(self, context_dim: int, query_dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attn = CrossAttention(query_dim, context_dim, heads=query_dim // 64, dim_head=64, **kw)
        self.norm1 = GroupNorm32(query_dim, **kw)
        self.norm2 = GroupNorm32(context_dim, **kw)

    def forward(self, context, x, control_scale: float = 1.0, mask=None):
        """`mask` (1 masks) zeroes the attention's output."""
        b, c, h, w = x.shape
        q = self.norm1(x).flatten(2).transpose(1, 2)
        ctx = self.norm2(context).flatten(2).transpose(1, 2)
        out = self.attn(q, ctx).transpose(1, 2).reshape(b, c, h, w).contiguous()
        return x + _masked(out, mask) * control_scale


class GLVControl(UNetEncoder):
    """Control net: UNet encoder clone + zero hint conv; returns the
    10-feature pyramid (9 input-block features + middle). With
    `input_upscale` != 1 the LQ latent is first resized by that factor
    (bilinear, antialiased, as jax.image.resize)."""

    def __init__(self, cfg: UNetConfig, input_upscale: int = 1, device=None, dtype=None):
        super().__init__(cfg, device=device, dtype=dtype)
        self.input_upscale = input_upscale
        self.input_hint_block = nn.Sequential(
            Conv(cfg.in_channels, cfg.model_channels, 3, zero_init=True, device=device, dtype=dtype)
        )

    def forward(self, x, timesteps, xt, context, y) -> List[torch.Tensor]:
        """x: LQ control latent [B,4,H,W]; xt: noisy latent [B,4,H,W]."""
        dtype = self.input_hint_block[0].weight.dtype
        x = x.to(dtype)
        if self.input_upscale != 1:
            x = bilinear_resize(x, (x.shape[2] * self.input_upscale, x.shape[3] * self.input_upscale),
                                antialias=True)
        emb = self.embed_time(timesteps, y)
        hint = self.input_hint_block(x)
        hs, h_mid = self.encode(xt.to(dtype), emb, context.to(dtype), hint=hint)
        return hs + [h_mid]


def _build_adapter_specs(ctrl: ControlConfig) -> List[Tuple[str, int]]:
    """project_modules: one ZeroSFT per control feature, with ZeroCrossAttns
    inserted at the mode table's indices; ('sft'|'xattn', i) with i indexing
    the pre-insert tables."""
    specs = [("sft", i) for i in range(len(ctrl.cond_output_channels))]
    for idx in ctrl.cross_attn_insert_idx:
        specs.insert(idx, ("xattn", idx))
    return specs


# XL-base progressive training schedule (SUPIR_v0.py:552): each stage
# unmasks more project modules; stages are consumed back to front.
PROGRESSIVE_MASK_NUMS_XL_BASE = (0, 3, 7, 11)


def progressive_adapter_masks(ctrl: ControlConfig, stage: int) -> torch.Tensor:
    """The reference's `step_progressive_mask` (SUPIR_v0.py:583-597) as data:
    stage 0 masks the first progressive_mask_nums[-1] adapters, each later
    stage fewer, and a stage past the schedule none. fp32 [num_adapters],
    1 = masked, on the CPU."""
    nums = PROGRESSIVE_MASK_NUMS_XL_BASE
    n_adapters = len(ctrl.cond_output_channels) + len(ctrl.cross_attn_insert_idx)
    mask_num = 0 if stage >= len(nums) else nums[len(nums) - 1 - stage]
    return torch.tensor([1.0 if i < mask_num else 0.0 for i in range(n_adapters)])


class LightGLVUNet(UNetDecoderPlain):
    """SDXL UNet whose decoder consumes the control features.
    forward(x, t, context, y, control, control_scale) -> eps prediction.

    The output blocks are the plain decoder's; ahead of each, a ZeroSFT
    modulates the skip by the control feature and concatenates the decoder
    stream in front of it, and a ZeroCrossAttn precedes each Upsample."""

    def __init__(self, cfg: UNetConfig, ctrl: ControlConfig, device=None, dtype=None):
        super().__init__(cfg, device=device, dtype=dtype)
        kw = dict(device=device, dtype=dtype)
        self.project_modules = nn.ModuleList(
            ZeroSFT(ctrl.project_channels[i], ctrl.cond_output_channels[i],
                    ctrl.concat_channels[i], **kw)
            if kind == "sft" else
            ZeroCrossAttn(ctrl.cond_output_channels[i], ctrl.concat_channels[i], **kw)
            for kind, i in _build_adapter_specs(ctrl)
        )

    def forward(self, x, timesteps, context, y, control: Sequence[torch.Tensor],
                control_scale: float = 1.0, adapter_masks: Optional[torch.Tensor] = None,
                feature_cache=None, return_features: bool = False):
        """`adapter_masks`: [num_adapters] 0/1 (`progressive_adapter_masks`)
        or None. `feature_cache=(hs, h)` takes the encoder features and the
        middle block's output from a call at an earlier step instead of
        running the encoder and the middle block; `return_features=True`
        returns (eps, (hs, h)) of this call. The time embedding runs fresh
        either way: a step that reuses features is at a new sigma."""
        dtype = self.out[2].weight.dtype
        x = x.to(dtype)
        context = context.to(dtype)
        control = [c.to(dtype) for c in control]
        # the reference's no_grad region: time embedding and input blocks are
        # frozen, the middle block, adapters and decoder train
        # (supir_tpu/models/control.py:229, unet.py:158-160)
        emb = self.embed_time(timesteps, y).detach()
        if feature_cache is None:
            hs, h = self.encode(x, emb, context, detach_inputs=True)
        else:
            hs, h = [f.to(dtype) for f in feature_cache[0]], feature_cache[1].to(dtype)
        feats = (list(hs), h) if return_features else None  # the decoder pops hs

        def project(pos, *args):
            mask = None if adapter_masks is None else adapter_masks[pos]
            return self.project_modules[pos](*args, control_scale=control_scale, mask=mask)

        pos = len(self.project_modules) - 1
        ctrl_idx = len(control) - 1
        # middle-feature SFT (no decoder stream to concatenate)
        h = project(pos, control[ctrl_idx], h)
        pos -= 1
        ctrl_idx -= 1
        for block in self.output_blocks:
            h = project(pos, control[ctrl_idx], hs.pop(), h)
            pos -= 1
            if isinstance(block[-1], Upsample):
                h = run_block(block[:-1], h, emb, context, self.remat)
                # ZeroCrossAttn before each Upsample
                h = project(pos, control[ctrl_idx], h)
                pos -= 1
                h = block[-1](h)
            else:
                h = run_block(block, h, emb, context, self.remat)
            ctrl_idx -= 1
        if pos != -1 or ctrl_idx != -1:
            raise RuntimeError(f"adapter/control bookkeeping off: {pos}, {ctrl_idx}")
        out = self.out(h).float()
        return (out, feats) if return_features else out
