"""SUPIREngine: the restore path's orchestration (counterpart of
supir_tpu/engine/supir.py): stage-1 denoise-encoding, the CFG-batched
control denoiser, RestoreEDM sampling, decoding and colour fix.

Public methods keep the JAX engine's layout, so tests compare like with
like: images [B, H, W, 3] in [-1, 1] and latents [B, h, w, 4], NHWC, fp32,
as torch tensors or numpy arrays; results are fp32 torch tensors on the
engine's device. Inside, everything is NCHW. Random draws come from a
`torch.Generator` on the engine's device seeded with `seed`; they differ
from jax.random's, so parity runs inject the noise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from supir_tpu_torch.config import SUPIRConfig, dtype_of
from supir_tpu_torch.diffusion.denoiser import DiscreteDenoiser
from supir_tpu_torch.diffusion.discretization import legacy_ddpm_sigmas
from supir_tpu_torch.diffusion.guidance import cfg_combine
from supir_tpu_torch.diffusion.samplers import make_step_tables, restore_edm_sample
from supir_tpu_torch.models.control import GLVControl, LightGLVUNet
from supir_tpu_torch.models.vae import AutoencoderKL, DiagonalGaussian
from supir_tpu_torch.utils.colorfix import adaptive_instance_normalization, wavelet_reconstruction


class SUPIRModel(nn.Module):
    """The restore path's modules under the reference's state-dict keys:
    model.diffusion_model.*, model.control_model.*, first_stage_model.*."""

    def __init__(self, cfg: SUPIRConfig, device=None):
        super().__init__()
        diff = dict(device=device, dtype=dtype_of(cfg.diffusion_dtype))
        self.model = nn.ModuleDict({
            "diffusion_model": LightGLVUNet(cfg.unet, cfg.control, **diff),
            "control_model": GLVControl(cfg.unet, cfg.control.input_upscale, **diff),
        })
        self.first_stage_model = AutoencoderKL(
            cfg.vae, device=device, dtype=dtype_of(cfg.ae_dtype)
        )


def _nchw(x) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class SUPIREngine:
    """The reference engine's public surface for the restore path:
    `encode_first_stage_with_denoise`, `encode_first_stage`,
    `decode_first_stage`, `batchify_denoise`, `batchify_sample`."""

    def __init__(self, cfg: SUPIRConfig, model: SUPIRModel):
        self.cfg = cfg
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.denoiser = DiscreteDenoiser(num_idx=cfg.num_idx)

    @property
    def vae(self) -> AutoencoderKL:
        return self.model.first_stage_model

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                               dtype=torch.float32).to(self.device)

    # ----------------------------------------------------------------- VAE

    @torch.no_grad()
    def encode_first_stage_with_denoise(self, x) -> torch.Tensor:
        """LQ image [B,H,W,3] in [-1,1] -> stage-1 cleaned latent (mode)."""
        moments = self.vae.moments(_nchw(self._tensor(x)), use_denoise_encoder=True)
        z = DiagonalGaussian(moments).mode()
        return _nhwc((z * self.cfg.scale_factor).float())

    @torch.no_grad()
    def encode_first_stage(self, x, noise=None, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """HQ image -> latent. With unit-normal `noise` [B,h,w,4] (or a
        `generator` to draw it) the posterior is sampled, as the reference's
        first stage does; with neither, the mode."""
        moments = self.vae.moments(_nchw(self._tensor(x)))
        p = DiagonalGaussian(moments)
        if noise is None and generator is not None:
            noise = torch.randn(p.mean.shape, generator=generator, device=self.device)
        elif noise is not None:
            noise = _nchw(self._tensor(noise))
        z = p.mode() if noise is None else p.sample(noise)
        return _nhwc((z * self.cfg.scale_factor).float())

    @torch.no_grad()
    def decode_first_stage(self, z) -> torch.Tensor:
        z = _nchw(self._tensor(z)) / self.cfg.scale_factor
        return _nhwc(self.vae.decode(z).float())

    def batchify_denoise(self, x) -> torch.Tensor:
        """Stage 1: degradation-robust encode, then decode."""
        return self.decode_first_stage(self.encode_first_stage_with_denoise(x))

    @staticmethod
    def _check_override(name: str, arr, expected_shape):
        if arr is None:
            return
        got = tuple(arr.shape)
        if got != tuple(expected_shape):
            raise ValueError(f"{name} shape {got} != expected latent shape {tuple(expected_shape)}")

    # -------------------------------------------------------------- sampling

    def _network(self, x, t, cond, control_scale):
        unet = self.model.model["diffusion_model"]
        control_net = self.model.model["control_model"]
        control = control_net(cond["control"], t, x, cond["crossattn"], cond["vector"])
        return unet(x, t, cond["crossattn"], cond["vector"], control, control_scale)

    @torch.no_grad()
    def batchify_sample(
        self,
        x,
        c: Dict[str, object],
        uc: Dict[str, object],
        num_steps: int = 50,
        restoration_scale: float = 4.0,
        s_churn: float = 0.0,
        s_noise: float = 1.003,
        cfg_scale: float = 7.5,
        seed: int = 0,
        control_scale: float = 1.0,
        color_fix_type: str = "None",
        use_linear_cfg: bool = False,
        use_linear_control_scale: bool = False,
        cfg_scale_start: float = 1.0,
        control_scale_start: float = 0.0,
        sampler_name: Optional[str] = None,
        z_override=None,
        noise_override=None,
        center_noise_override=None,
    ) -> torch.Tensor:
        """Full stage-2 pipeline on an LQ image batch [B,H,W,3] in [-1,1].
        `c`/`uc` hold 'crossattn' [B,77,ctx], 'vector' [B,adm] and 'control'
        [B,h,w,4] (the stage-1 latent), as `prepare_condition` builds them."""
        if color_fix_type not in ("Wavelet", "AdaIn", "None"):
            raise ValueError(f"unknown color_fix_type {color_fix_type!r}")
        cfg = self.cfg
        sampler_name = sampler_name or cfg.sampler.name
        if sampler_name != "RestoreEDM":
            raise NotImplementedError(f"sampler {sampler_name!r} is not ported yet (RestoreEDM only)")

        scfg = dataclasses.replace(
            cfg.sampler,
            num_steps=num_steps,
            restore_cfg=restoration_scale,
            s_churn=s_churn,
            s_noise=s_noise,
            cfg_scale=cfg_scale_start if use_linear_cfg else cfg_scale,
            cfg_scale_min=cfg_scale,
            use_linear_cfg=use_linear_cfg,
        )
        sigmas = legacy_ddpm_sigmas(num_steps)
        tables = make_step_tables(
            sigmas, scfg, control_scale=control_scale,
            use_linear_control_scale=use_linear_control_scale,
            control_scale_start=control_scale_start,
        )
        gen = torch.Generator(device=self.device).manual_seed(seed)

        z = self._tensor(z_override) if z_override is not None else self.encode_first_stage_with_denoise(x)
        x_stage1 = self.decode_first_stage(z)
        self._check_override("center_noise_override", center_noise_override, z.shape)
        self._check_override("noise_override", noise_override, z.shape)
        if noise_override is not None:
            noised_z = _nchw(self._tensor(noise_override))
        else:
            noised_z = torch.randn(_nchw(z).shape, generator=gen, device=self.device)
        noised_z = noised_z * float(np.sqrt(1.0 + float(sigmas[0]) ** 2))
        # x_center is a sampled latent, as in the reference's first stage
        z_stage1 = self.encode_first_stage(
            x_stage1, noise=center_noise_override,
            generator=None if center_noise_override is not None else gen,
        )

        cond2 = {
            "crossattn": torch.cat([self._tensor(uc["crossattn"]), self._tensor(c["crossattn"])]),
            "vector": torch.cat([self._tensor(uc["vector"]), self._tensor(c["vector"])]),
            "control": _nchw(torch.cat([self._tensor(uc["control"]), self._tensor(c["control"])])),
        }

        def denoise(xt, sigma_b, cfg_b, ctrl_s):
            x2 = torch.cat([xt, xt])
            s2 = torch.cat([sigma_b, sigma_b])
            den = self.denoiser(self._network, x2, s2, cond2, ctrl_s)
            d_uc, d_c = den.chunk(2)
            return cfg_combine(d_uc, d_c, cfg_b)

        samples_z = restore_edm_sample(
            denoise, noised_z, gen, tables, x_center=_nchw(z_stage1), s_noise=s_noise,
        )
        samples = self.decode_first_stage(_nhwc(samples_z))
        if color_fix_type == "Wavelet":
            samples = _nhwc(wavelet_reconstruction(_nchw(samples), _nchw(x_stage1)))
        elif color_fix_type == "AdaIn":
            samples = _nhwc(adaptive_instance_normalization(_nchw(samples), _nchw(x_stage1)))
        return samples
