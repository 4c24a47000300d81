"""Configuration: the port's own copy of the restore path's dataclasses.

Field names, defaults and the `tiny()` / `scaled_for()` helpers are those of
`supir_tpu/config.py`, and of the text towers' `CLIPTextConfig`
(`supir_tpu/models/clip.py:28`) and `ConditionerConfig`
(`supir_tpu/models/embedders.py:35`); `tests/test_torch_engine.py` and
`tests/test_torch_conditioning.py` hold the copies equal. The port keeps its
own so that it imports nothing of the JAX package. `dtype_of` maps a dtype
name to the torch dtype; `load_yaml_config` reads an `options/*.yaml` as
`supir_tpu/config.py:load_yaml_config` (:225) does.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """SDXL-base UNet (reference options/SUPIR_v0.yaml:43-64)."""

    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2)
    channel_mult: Tuple[int, ...] = (1, 2, 4)
    num_head_channels: int = 64
    transformer_depth: Tuple[int, ...] = (1, 2, 10)
    transformer_depth_middle: Optional[int] = None
    context_dim: int = 2048
    adm_in_channels: Optional[int] = 2816
    dropout: float = 0.0

    def tiny(self) -> "UNetConfig":
        """Scaled-down config for tests (keeps the wiring, shrinks widths)."""
        return dataclasses.replace(
            self,
            model_channels=32,
            num_head_channels=16,
            transformer_depth=(1, 1, 2),
            context_dim=64,
            adm_in_channels=96,
        )

    @property
    def levels(self) -> int:
        return len(self.channel_mult)

    @property
    def middle_depth(self) -> int:
        return (
            self.transformer_depth_middle
            if self.transformer_depth_middle is not None
            else self.transformer_depth[-1]
        )


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL f8/z4 (reference options/SUPIR_v0.yaml:107-125)."""

    in_channels: int = 3
    out_channels: int = 3
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 4
    double_z: bool = True
    embed_dim: int = 4

    def tiny(self) -> "VAEConfig":
        return dataclasses.replace(self, ch=32)

    @property
    def downscale_factor(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)


@dataclasses.dataclass(frozen=True)
class ControlConfig:
    """GLVControl/LightGLVUNet wiring (reference SUPIR_v0.py:543-580); the
    mode tables are the checkpoint contract, XL-base values below."""

    mode: str = "XL-base"
    project_type: str = "ZeroSFT"
    project_channel_scale: float = 2.0
    input_upscale: int = 1

    @property
    def cond_output_channels(self) -> Tuple[int, ...]:
        if self.mode == "XL-base":
            return tuple([320] * 4 + [640] * 3 + [1280] * 3)
        if self.mode == "XL-refine":
            return tuple([384] * 4 + [768] * 3 + [1536] * 6)
        raise NotImplementedError(self.mode)

    @property
    def project_channels(self) -> Tuple[int, ...]:
        if self.mode == "XL-base":
            base = [160] * 4 + [320] * 3 + [640] * 3
        elif self.mode == "XL-refine":
            base = [192] * 4 + [384] * 3 + [768] * 6
        else:
            raise NotImplementedError(self.mode)
        return tuple(int(c * self.project_channel_scale) for c in base)

    @property
    def concat_channels(self) -> Tuple[int, ...]:
        if self.mode == "XL-base":
            return tuple([320] * 2 + [640] * 3 + [1280] * 4 + [0])
        if self.mode == "XL-refine":
            return tuple([384] * 2 + [768] * 3 + [1536] * 7 + [0])
        raise NotImplementedError(self.mode)

    @property
    def cross_attn_insert_idx(self) -> Tuple[int, ...]:
        return (6, 3) if self.mode == "XL-base" else (9, 6, 3)

    def scaled_for(self, unet: UNetConfig) -> "ControlConfig":
        """Tables scaled to a (tiny) UNet width for tests."""
        return _ScaledControlConfig(unet=unet, base=self)


@dataclasses.dataclass(frozen=True)
class _ScaledControlConfig(ControlConfig):
    unet: UNetConfig = None
    base: ControlConfig = None

    def _scale(self, vals):
        # base channel of the mode table (320 for XL-base, 384 for XL-refine)
        r = self.unet.model_channels / float(self.base.cond_output_channels[0])
        return tuple(int(v * r) for v in vals)

    @property
    def cond_output_channels(self):
        return self._scale(self.base.cond_output_channels)

    @property
    def project_channels(self):
        return self._scale(self.base.project_channels)

    @property
    def concat_channels(self):
        return self._scale(self.base.concat_channels)

    @property
    def cross_attn_insert_idx(self):
        return self.base.cross_attn_insert_idx


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    name: str = "RestoreEDM"  # RestoreEDM | RestoreDPMPP2M | TiledRestoreEDM | ...
    num_steps: int = 50
    restore_cfg: float = 4.0
    restore_cfg_s_tmin: float = 0.05
    s_churn: float = 0.0
    s_tmin: float = 0.0
    s_tmax: float = float("inf")
    s_noise: float = 1.003
    eta: float = 1.0
    cfg_scale: float = 7.5
    cfg_scale_min: float = 4.0
    use_linear_cfg: bool = True
    tile_size: int = 128
    tile_stride: int = 64


@dataclasses.dataclass(frozen=True)
class SUPIRConfig:
    unet: UNetConfig = UNetConfig()
    vae: VAEConfig = VAEConfig()
    control: ControlConfig = ControlConfig()
    sampler: SamplerConfig = SamplerConfig()
    scale_factor: float = 0.13025
    num_idx: int = 1000
    ae_dtype: str = "bf16"
    diffusion_dtype: str = "bf16"
    p_p: str = (
        "Cinematic, High Contrast, highly detailed, taken using a Canon EOS R "
        "camera, hyper detailed photo - realistic maximum detail, 32k, Color "
        "Grading, ultra HD, extreme meticulous detailing, skin pore detailing, "
        "hyper sharpness, perfect without deformations."
    )
    n_p: str = (
        "painting, oil painting, illustration, drawing, art, sketch, oil "
        "painting, cartoon, CG Style, 3D render, unreal engine, blurring, "
        "dirty, messy, worst quality, low quality, frames, watermark, "
        "signature, jpeg artifacts, deformed, lowres, over-smooth"
    )

    @classmethod
    def tiny(cls) -> "SUPIRConfig":
        unet = UNetConfig().tiny()
        return cls(
            unet=unet,
            vae=VAEConfig().tiny(),
            control=ControlConfig().scaled_for(unet),
        )


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """A CLIP text tower: ViT-L/14 (the defaults) or OpenCLIP ViT-bigG/14."""

    vocab_size: int = 49408
    max_length: int = 77
    width: int = 768
    layers: int = 12
    heads: int = 12
    use_quick_gelu: bool = True
    projection_dim: Optional[int] = None  # set for OpenCLIP pooled output

    @classmethod
    def vit_l(cls) -> "CLIPTextConfig":
        return cls()

    @classmethod
    def vit_bigg(cls) -> "CLIPTextConfig":
        return cls(width=1280, layers=32, heads=20, use_quick_gelu=False, projection_dim=1280)

    def tiny(self) -> "CLIPTextConfig":
        return dataclasses.replace(self, width=64, layers=2, heads=4,
                                   projection_dim=64 if self.projection_dim else None)


@dataclasses.dataclass(frozen=True)
class ConditionerConfig:
    """The SDXL conditioner: CLIP-L at hidden layer `clip_l_hidden_layer`,
    bigG's penultimate layer and pooled output, and three size scalars
    embedded `vector_outdim` wide each."""

    clip_l: CLIPTextConfig = CLIPTextConfig.vit_l()
    clip_bigg: CLIPTextConfig = CLIPTextConfig.vit_bigg()
    clip_l_hidden_layer: int = 11
    vector_outdim: int = 256

    def tiny(self) -> "ConditionerConfig":
        return dataclasses.replace(self, clip_l=self.clip_l.tiny(), clip_bigg=self.clip_bigg.tiny(),
                                   clip_l_hidden_layer=1, vector_outdim=8)

    @property
    def context_dim(self) -> int:
        """Width of `crossattn`: both towers' hidden states side by side."""
        return self.clip_l.width + self.clip_bigg.width

    @property
    def adm_dim(self) -> int:
        """Width of `vector`: bigG's pooled output and two sinusoids for
        each of the three size pairs."""
        return self.clip_bigg.projection_dim + 6 * self.vector_outdim


_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# YAML surface (options/*.yaml)

EXTRA_KEYS = ("SDXL_CKPT", "SUPIR_CKPT_Q", "SUPIR_CKPT_F", "default_setting", "tile_vae")


def _merge(base: dict, over: dict) -> dict:
    """`over` on top of `base`, nested dicts merged key by key."""
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def load_yaml_config(path: str):
    """An options/*.yaml -> (SUPIRConfig, extras). An `include:` key layers
    the file over the one it names (the tiled and lightning variants extend
    the base file); extras carry the checkpoint paths, `default_setting`
    and the tile_vae sizes. Keys a dataclass lacks are ignored."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    if "include" in raw:
        with open(os.path.join(os.path.dirname(path), raw.pop("include"))) as f:
            base = yaml.safe_load(f)
        base.pop("include", None)
        raw = _merge(base, raw)

    m = raw.get("model", {})

    def build(cls, key):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in m.get(key, {}).items() if k in names})

    cfg = SUPIRConfig(
        unet=build(UNetConfig, "unet"),
        vae=build(VAEConfig, "vae"),
        control=build(ControlConfig, "control"),
        sampler=build(SamplerConfig, "sampler"),
        scale_factor=m.get("scale_factor", 0.13025),
        ae_dtype=m.get("ae_dtype", "bf16"),
        diffusion_dtype=m.get("diffusion_dtype", "bf16"),
        p_p=raw.get("p_p", SUPIRConfig.p_p),
        n_p=raw.get("n_p", SUPIRConfig.n_p),
    )
    return cfg, {k: raw.get(k) for k in EXTRA_KEYS}
