"""SUPIREngine: the restore path's orchestration (counterpart of
supir_tpu/engine/supir.py): stage-1 denoise-encoding, the SDXL text
conditioning, the CFG-batched control denoiser, sampling with any sampler
of the JAX engine's table (RestoreEDM, the default; RestoreDPMPP2M,
Lightning; EulerEDM, HeunEDM, EulerAncestral, DPMPP2SAncestral, DPMPP2M,
LMS, Substep), RestoreEDM's cross-step feature cache, the tiled forms of
RestoreEDM (with the cache too) and RestoreDPMPP2M over sliding-window
latent tiles, the tiled VAE, decoding and colour fix.

Public methods keep the JAX engine's layout, so tests compare like with
like: images [B, H, W, 3] in [-1, 1] and latents [B, h, w, 4], NHWC, fp32,
as torch tensors or numpy arrays; results are fp32 torch tensors on the
engine's device. Inside, everything is NCHW. Random draws come from a
`torch.Generator` on the engine's device seeded with `seed`; they differ
from jax.random's, so parity runs inject the noise.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from supir_tpu_torch.config import ConditionerConfig, SUPIRConfig, dtype_of
from supir_tpu_torch.diffusion.denoiser import DiscreteDenoiser
from supir_tpu_torch.diffusion.discretization import legacy_ddpm_sigmas
from supir_tpu_torch.diffusion.guidance import cfg_combine
from supir_tpu_torch.diffusion import samplers as S
from supir_tpu_torch.models.control import GLVControl, LightGLVUNet
from supir_tpu_torch.models.embedders import Conditioner
from supir_tpu_torch.models.vae import AutoencoderKL, DiagonalGaussian
from supir_tpu_torch.parallel.tiled_sampler import (
    _gather_tiles,
    make_tile_plan,
    make_tiled_denoise,
    make_tiled_denoise_cached,
    tiled_restore_dpmpp2m_sample,
    tiled_restore_edm_sample,
    tiled_restore_edm_sample_cached,
)
from supir_tpu_torch.parallel.tiled_vae import DECODER_PAD, ENCODER_PAD, tiled_decode, tiled_encode
from supir_tpu_torch.utils.colorfix import adaptive_instance_normalization, wavelet_reconstruction


# The JAX engine's sampler table (supir_tpu/engine/supir.py:70-80); Substep
# runs as EulerAncestral on its own schedule. Each takes (denoise, x, rng,
# tables, **kwargs): rng is the DPM++ samplers' Brownian-tree seed, the
# others' torch.Generator.
SAMPLERS = {
    "RestoreEDM": S.restore_edm_sample,
    "EulerEDM": S.euler_edm_sample,
    "HeunEDM": S.heun_edm_sample,
    "EulerAncestral": S.euler_ancestral_sample,
    "DPMPP2SAncestral": S.dpmpp2s_ancestral_sample,
    "DPMPP2M": S.dpmpp2m_sample,
    "RestoreDPMPP2M": S.dpmpp2m_sample,
    "LMS": S.lms_sample,
}


def sampler_kwargs(name: str, eta: float, s_noise: float) -> dict:
    """The keywords the JAX engine's `_sample_fn` (:488-499) gives each
    sampler: eta and s_noise to the ancestral and Restore DPM++ ones,
    s_noise to the EDM ones, none to DPMPP2M (the ODE, eta 0) and LMS."""
    if name in ("RestoreDPMPP2M", "EulerAncestral", "DPMPP2SAncestral"):
        return dict(eta=eta, s_noise=s_noise)
    if name in ("RestoreEDM", "EulerEDM", "HeunEDM"):
        return dict(s_noise=s_noise)
    return {}


class SUPIRModel(nn.Module):
    """The restore path's modules under the reference's state-dict keys:
    model.diffusion_model.*, model.control_model.*, first_stage_model.*,
    and with a `cond_cfg` the text conditioner, conditioner.*. Parameters
    are in the config's dtypes (the conditioner in `ae_dtype`, where the
    JAX engine runs it, :104), or all in `param_dtype` if given (the
    trainer's fp32 parameters)."""

    def __init__(self, cfg: SUPIRConfig, device=None, param_dtype: Optional[torch.dtype] = None,
                 cond_cfg: Optional[ConditionerConfig] = None):
        super().__init__()
        self.cond_cfg = cond_cfg
        diff = dict(device=device, dtype=param_dtype or dtype_of(cfg.diffusion_dtype))
        self.model = nn.ModuleDict({
            "diffusion_model": LightGLVUNet(cfg.unet, cfg.control, **diff),
            "control_model": GLVControl(cfg.unet, cfg.control.input_upscale, **diff),
        })
        self.first_stage_model = AutoencoderKL(
            cfg.vae, device=device, dtype=param_dtype or dtype_of(cfg.ae_dtype)
        )
        if cond_cfg is not None:
            self.conditioner = Conditioner(cond_cfg, device=device,
                                           dtype=param_dtype or dtype_of(cfg.ae_dtype))


def _nchw(x) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class SUPIREngine:
    """The reference engine's public surface for the restore path:
    `encode_first_stage_with_denoise`, `encode_first_stage`,
    `decode_first_stage`, `batchify_denoise`, `prepare_condition` (and its
    cached and tiled forms, where the model holds a conditioner),
    `batchify_sample`, `batchify_sample_tiled`, `init_tile_vae`,
    `log_images`."""

    SAMPLERS = tuple(SAMPLERS) + ("Substep",)
    TILED_SAMPLERS = ("TiledRestoreEDM", "TiledRestoreDPMPP2M")

    COND_CACHE_SIZE = 32

    def __init__(self, cfg: SUPIRConfig, model: SUPIRModel):
        self.cfg = cfg
        self.model = model.eval()
        self.cond_cfg = model.cond_cfg
        self.device = next(model.parameters()).device
        self.denoiser = DiscreteDenoiser(num_idx=cfg.num_idx)
        self._cond_cache: Dict[str, Tuple[dict, dict]] = {}
        self._tile_vae: Optional[Tuple[int, int, Optional[Tuple[int, int]], bool]] = None

    @property
    def vae(self) -> AutoencoderKL:
        return self.model.first_stage_model

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                               dtype=torch.float32).to(self.device)

    # ----------------------------------------------------------------- VAE

    def init_tile_vae(self, encoder_tile_size: int = 512, decoder_tile_size: int = 64,
                      chunk: Optional[Tuple[int, int]] = (8, 4), fast_mode: bool = False) -> None:
        """Send every first-stage encode and decode through the tiled VAE
        (reference init_tile_vae, SUPIR_model.py:138-151). Tile sizes are
        image px for the encoder and latent px for the decoder; `chunk` is
        (encode, decode) tiles per call, None for all tiles in one call.
        Chunked, the GroupNorm statistics are exact (pooled over every tile
        of the image, the staged executor) unless `fast_mode` pools them
        per chunk (the reference's fast mode)."""
        self._tile_vae = (encoder_tile_size, decoder_tile_size, chunk, fast_mode)

    def _moments(self, x: torch.Tensor, use_denoise_encoder: bool = False) -> torch.Tensor:
        """Image [B,3,H,W] -> posterior moments, tiled if init_tile_vae was called."""
        if self._tile_vae is None:
            return self.vae.moments(x, use_denoise_encoder=use_denoise_encoder)
        tile, _, chunk, fast_mode = self._tile_vae
        encoder = self.vae.denoise_encoder if use_denoise_encoder else self.vae.encoder
        return tiled_encode(encoder, self.vae.quant_conv, x, tile, ENCODER_PAD,
                            chunk[0] if chunk else None, fast_mode)

    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        if self._tile_vae is None:
            return self.vae.decode(z)
        _, tile, chunk, fast_mode = self._tile_vae
        return tiled_decode(self.vae.decoder, self.vae.post_quant_conv, z, tile, DECODER_PAD,
                            chunk[1] if chunk else None, fast_mode)

    @torch.no_grad()
    def encode_first_stage_with_denoise(self, x) -> torch.Tensor:
        """LQ image [B,H,W,3] in [-1,1] -> stage-1 cleaned latent (mode)."""
        moments = self._moments(_nchw(self._tensor(x)), use_denoise_encoder=True)
        z = DiagonalGaussian(moments).mode()
        return _nhwc((z * self.cfg.scale_factor).float())

    @torch.no_grad()
    def encode_first_stage(self, x, noise=None, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """HQ image -> latent. With unit-normal `noise` [B,h,w,4] (or a
        `generator` to draw it) the posterior is sampled, as the reference's
        first stage does, in tiled mode too (one draw over the merged
        latent); with neither, the mode."""
        moments = self._moments(_nchw(self._tensor(x)))
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
        return _nhwc(self._decode(z).float())

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

    # ---------------------------------------------------------- conditioning

    @torch.no_grad()
    def _condition(self, tokens_l, tokens_bigg) -> Dict[str, torch.Tensor]:
        """The conditioner on token ids [n, 77] at the fixed SDXL size
        tuples (1024, 1024) original and target, crop (0, 0); fp32 out."""
        if getattr(self.model, "conditioner", None) is None:
            raise ValueError("this engine's model holds no conditioner (build it with cond_cfg)")
        tl, tg = (torch.as_tensor(t if torch.is_tensor(t) else np.ascontiguousarray(t)).long().to(self.device)
                  for t in (tokens_l, tokens_bigg))
        n = tl.shape[0]
        size = torch.full((n, 2), 1024.0, device=self.device)
        crop = torch.zeros((n, 2), device=self.device)
        out = self.model.conditioner(tl, tg, size, crop, size)
        return {k: v.float() for k, v in out.items()}

    def prepare_condition(self, z, tokens_l, tokens_bigg, tokens_l_uc, tokens_bigg_uc):
        """SDXL conditioning of a batch (SUPIR_model.py:152-179): (c, uc),
        each {'crossattn', 'vector', 'control'}; `control` is the stage-1
        latent z [n, h, w, 4] itself."""
        c = self._condition(tokens_l, tokens_bigg)
        uc = self._condition(tokens_l_uc, tokens_bigg_uc)
        z = self._tensor(z)
        return dict(c, control=z), dict(uc, control=z)

    @staticmethod
    def condition_key(tokens_l, tokens_bigg, tokens_l_uc, tokens_bigg_uc) -> str:
        """SHA-1 over the four int32 token arrays, the JAX engine's cache key."""
        return hashlib.sha1(b"".join(
            np.asarray(t.cpu() if torch.is_tensor(t) else t, np.int32).tobytes()
            for t in (tokens_l, tokens_bigg, tokens_l_uc, tokens_bigg_uc))).hexdigest()

    def prepare_condition_cached(self, z, tokens_l, tokens_bigg, tokens_l_uc, tokens_bigg_uc):
        """prepare_condition with the towers' outputs kept per token set
        (reference PreparedConditioner, encoders/modules.py:246): repeated
        prompts run the towers once, and only the control latent changes
        per call. The oldest of more than COND_CACHE_SIZE entries goes."""
        key = self.condition_key(tokens_l, tokens_bigg, tokens_l_uc, tokens_bigg_uc)
        if key not in self._cond_cache:
            self._cond_cache[key] = (self._condition(tokens_l, tokens_bigg),
                                     self._condition(tokens_l_uc, tokens_bigg_uc))
            if len(self._cond_cache) > self.COND_CACHE_SIZE:
                self._cond_cache.pop(next(iter(self._cond_cache)))
        c_txt, uc_txt = self._cond_cache[key]
        z = self._tensor(z)
        return dict(c_txt, control=z), dict(uc_txt, control=z)

    def prepare_condition_tiled(self, z, tokens_l_tiles, tokens_bigg_tiles, tokens_l_uc, tokens_bigg_uc):
        """Per-tile local prompts (SUPIR_model.py:167-178): tokens_*_tiles
        are [T, 77] and the uncond is shared. c carries 'crossattn_tiles'
        [T, 1, 77, D] beside the first tile's conditioning. Batch 1 only,
        as the reference."""
        if self._tensor(z).shape[0] != 1:
            raise ValueError("local prompts support batch 1 (reference parity)")
        c, uc = self.prepare_condition(z, tokens_l_tiles[:1], tokens_bigg_tiles[:1], tokens_l_uc,
                                       tokens_bigg_uc)
        c["crossattn_tiles"] = self._condition(tokens_l_tiles, tokens_bigg_tiles)["crossattn"][:, None]
        return c, uc

    def log_images(self, x, c, uc, num_steps: int = 8, seed: int = 0) -> Dict[str, torch.Tensor]:
        """The training loop's pictures (DiffusionEngine.log_images,
        diffusion.py:272-320): the input, its stage-1 reconstruction and a
        short sample."""
        z = self.encode_first_stage_with_denoise(x)
        return {
            "inputs": self._tensor(x),
            "stage1": self.decode_first_stage(z),
            "samples": self.batchify_sample(x, c, uc, num_steps=num_steps, seed=seed, z_override=z),
        }

    # -------------------------------------------------------------- sampling

    def _network(self, x, t, cond, control_scale):
        unet = self.model.model["diffusion_model"]
        control_net = self.model.model["control_model"]
        control = control_net(cond["control"], t, x, cond["crossattn"], cond["vector"])
        return unet(x, t, cond["crossattn"], cond["vector"], control, control_scale)

    def _network_cached(self, x, t, cond, control_scale, cache, recompute: bool):
        """The network with the cross-step feature cache (JAX :410-441): a
        recompute step runs GLVControl and the whole UNet and returns
        (eps, (control pyramid, (encoder features, middle output))); a reuse
        step runs only the UNet's time embedding, adapters, decoder and
        output head, on the cached features and control pyramid. With
        recompute on every step it computes what `_network` does."""
        unet = self.model.model["diffusion_model"]
        if recompute:
            control_net = self.model.model["control_model"]
            control = control_net(cond["control"], t, x, cond["crossattn"], cond["vector"])
            out, feats = unet(x, t, cond["crossattn"], cond["vector"], control, control_scale, return_features=True)
            return out, (control, feats)
        control, feats = cache
        return unet(x, t, cond["crossattn"], cond["vector"], control, control_scale, feature_cache=feats), cache

    def _tables(self, sampler: str, num_steps: int, restoration_scale: float, s_churn: float, s_noise: float,
                cfg_scale: float, control_scale: float, use_linear_cfg: bool, use_linear_control_scale: bool,
                cfg_scale_start: float, control_scale_start: float):
        """The sampler's step tables and the sigma its initial noise is scaled
        for: the Restore DPM++2M samplers on a Karras ramp, Substep on its
        subset of the 1000-step table, the others on the LegacyDDPM one."""
        scfg = dataclasses.replace(
            self.cfg.sampler, num_steps=num_steps, restore_cfg=restoration_scale, s_churn=s_churn,
            s_noise=s_noise, cfg_scale=cfg_scale_start if use_linear_cfg else cfg_scale,
            cfg_scale_min=cfg_scale, use_linear_cfg=use_linear_cfg,
        )
        control = dict(control_scale=control_scale, use_linear_control_scale=use_linear_control_scale,
                       control_scale_start=control_scale_start)
        if sampler.endswith("RestoreDPMPP2M"):
            tables = S.restore_dpmpp2m_tables(scfg, num_steps, **control)
            return tables, float(tables.sigma[0])
        sigmas = S.substep_sigmas(num_steps) if sampler == "Substep" else legacy_ddpm_sigmas(num_steps)
        return S.make_step_tables(sigmas, scfg, **control), float(sigmas[0])

    def _stage1(self, x, z_override, sigma0: float, gen: torch.Generator, noise_override,
                center_noise_override, sampled_center: bool):
        """(x_stage1 NHWC, the initial noise NCHW scaled by sqrt(1 + sigma0^2),
        x_center NCHW or None): the stage-1 image decoded from the latent,
        and, for RestoreEDM, the stage-1 image encoded again with the
        posterior sampled (the reference's first stage samples it).
        DPM++2M has no restoration guidance, so it skips that encode."""
        z = self._tensor(z_override) if z_override is not None else self.encode_first_stage_with_denoise(x)
        x_stage1 = self.decode_first_stage(z)
        self._check_override("center_noise_override", center_noise_override, z.shape)
        self._check_override("noise_override", noise_override, z.shape)
        if noise_override is not None:
            noised_z = _nchw(self._tensor(noise_override))
        else:
            noised_z = torch.randn(_nchw(z).shape, generator=gen, device=self.device)
        noised_z = noised_z * float(np.sqrt(1.0 + sigma0 ** 2))
        x_center = None
        if sampled_center:
            x_center = _nchw(self.encode_first_stage(
                x_stage1, noise=center_noise_override,
                generator=None if center_noise_override is not None else gen,
            ))
        return x_stage1, noised_z, x_center

    def _finish(self, samples_z: torch.Tensor, x_stage1: torch.Tensor, color_fix_type: str) -> torch.Tensor:
        samples = self.decode_first_stage(_nhwc(samples_z))
        if color_fix_type == "Wavelet":
            samples = _nhwc(wavelet_reconstruction(_nchw(samples), _nchw(x_stage1)))
        elif color_fix_type == "AdaIn":
            samples = _nhwc(adaptive_instance_normalization(_nchw(samples), _nchw(x_stage1)))
        return samples

    @staticmethod
    def _check_cache_interval(interval: int, sampler_name: str, cached_sampler: str) -> None:
        if interval < 0:
            raise ValueError(f"feature_cache_interval {interval} < 0")
        if interval and sampler_name != cached_sampler:
            raise ValueError(f"feature_cache_interval is only supported with {cached_sampler}")

    @staticmethod
    def _check_color_fix(color_fix_type: str) -> None:
        if color_fix_type not in ("Wavelet", "AdaIn", "None"):
            raise ValueError(f"unknown color_fix_type {color_fix_type!r}")

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
        feature_cache_interval: int = 0,
    ) -> torch.Tensor:
        """Full stage-2 pipeline on an LQ image batch [B,H,W,3] in [-1,1].
        `c`/`uc` hold 'crossattn' [B,77,ctx], 'vector' [B,adm] and 'control'
        [B,h,w,4] (the stage-1 latent), as `prepare_condition` builds them.
        `sampler_name`: any of SAMPLERS, the config's by default (DPM++ at
        the config's eta for RestoreDPMPP2M, its Brownian tree seeded by
        `seed`; eta 0 for DPMPP2M; the config's eta for the ancestral ones;
        Substep 1 to 4 steps).

        `feature_cache_interval` (RestoreEDM only): 0 disables; N >= 1
        recomputes the UNet's encoder and middle block and the control
        pyramid on every N-th step and reuses them in between (N = 1 is
        exact, N > 1 approximates)."""
        self._check_color_fix(color_fix_type)
        sampler_name = sampler_name or self.cfg.sampler.name
        if sampler_name in self.TILED_SAMPLERS:
            raise ValueError(f"sampler {sampler_name!r} runs through batchify_sample_tiled "
                             "(the CLI's --use_tiled_sampling)")
        if sampler_name not in self.SAMPLERS:
            raise ValueError(f"unknown sampler {sampler_name!r}, not one of {self.SAMPLERS}")
        self._check_cache_interval(feature_cache_interval, sampler_name, "RestoreEDM")
        tables, sigma0 = self._tables(sampler_name, num_steps, restoration_scale, s_churn, s_noise, cfg_scale,
                                      control_scale, use_linear_cfg, use_linear_control_scale, cfg_scale_start,
                                      control_scale_start)
        name = "EulerAncestral" if sampler_name == "Substep" else sampler_name
        gen = torch.Generator(device=self.device).manual_seed(seed)
        edm = name == "RestoreEDM"
        x_stage1, noised_z, x_center = self._stage1(x, z_override, sigma0, gen, noise_override,
                                                    center_noise_override, sampled_center=edm)

        cond2 = {
            "crossattn": torch.cat([self._tensor(uc["crossattn"]), self._tensor(c["crossattn"])]),
            "vector": torch.cat([self._tensor(uc["vector"]), self._tensor(c["vector"])]),
            "control": _nchw(torch.cat([self._tensor(uc["control"]), self._tensor(c["control"])])),
        }

        def denoise(xt, sigma_b, cfg_b, ctrl_s):
            den = self.denoiser(self._network, torch.cat([xt, xt]), torch.cat([sigma_b, sigma_b]), cond2, ctrl_s)
            d_uc, d_c = den.chunk(2)
            return cfg_combine(d_uc, d_c, cfg_b)

        def denoise_cached(xt, sigma_b, cfg_b, ctrl_s, cache, rec):
            den, cache = self.denoiser.call_cached(self._network_cached, torch.cat([xt, xt]),
                                                   torch.cat([sigma_b, sigma_b]), cond2, ctrl_s, cache, rec)
            d_uc, d_c = den.chunk(2)
            return cfg_combine(d_uc, d_c, cfg_b), cache

        kwargs = sampler_kwargs(name, self.cfg.sampler.eta, s_noise)
        if feature_cache_interval:
            recompute = np.arange(num_steps) % int(feature_cache_interval) == 0
            samples_z = S.restore_edm_sample_cached(denoise_cached, recompute, noised_z, gen, tables,
                                                    x_center=x_center, **kwargs)
        else:
            if edm:
                kwargs["x_center"] = x_center
            rng = seed if name.endswith("DPMPP2M") else gen
            samples_z = SAMPLERS[name](denoise, noised_z, rng, tables, **kwargs)
        return self._finish(samples_z, x_stage1, color_fix_type)

    @torch.no_grad()
    def batchify_sample_tiled(
        self,
        x,
        c: Dict[str, object],
        uc: Dict[str, object],
        num_steps: int = 50,
        tile_size: int = 128,
        tile_stride: int = 64,
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
        z_override=None,
        sampler_name: Optional[str] = None,
        tile_chunk: Optional[int] = None,
        noise_override=None,
        center_noise_override=None,
        feature_cache_interval: int = 0,
    ) -> torch.Tensor:
        """The tiled restore pipeline for outputs past one UNet window
        (reference TiledRestoreEDMSampler / TiledRestoreDPMPP2MSampler,
        sampling.py:600-730): the latent is sampled in `tile_size` windows
        at `tile_stride`, all windows folded into one network batch per step,
        or `tile_chunk` windows a call. With local prompts, `c` carries
        'crossattn_tiles' [T, 1, 77, D] (`prepare_condition_tiled`), one per
        window. The sampler is the config's where it is a tiled one, else
        TiledRestoreEDM.

        `feature_cache_interval` (TiledRestoreEDM only): 0 disables; N >= 1
        runs the tile-indexed feature cache, every window's encoder, middle
        block and control pyramid recomputed every N steps and reused in
        between (N = 1 is exact)."""
        self._check_color_fix(color_fix_type)
        cfg = self.cfg
        sampler_name = sampler_name or (cfg.sampler.name if cfg.sampler.name in self.TILED_SAMPLERS
                                        else "TiledRestoreEDM")
        if sampler_name not in self.TILED_SAMPLERS:
            raise ValueError(f"batchify_sample_tiled runs {' or '.join(self.TILED_SAMPLERS)}, not {sampler_name!r}")
        self._check_cache_interval(feature_cache_interval, sampler_name, "TiledRestoreEDM")
        tables, sigma0 = self._tables(sampler_name, num_steps, restoration_scale, s_churn, s_noise, cfg_scale,
                                      control_scale, use_linear_cfg, use_linear_control_scale, cfg_scale_start,
                                      control_scale_start)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        edm = sampler_name == "TiledRestoreEDM"
        x_stage1, noised_z, x_center = self._stage1(x, z_override, sigma0, gen, noise_override,
                                                    center_noise_override, sampled_center=edm)

        ca_uc, vec_uc, vec_c = (self._tensor(d[k]) for d, k in ((uc, "crossattn"), (uc, "vector"), (c, "vector")))
        ca_c = self._tensor(c["crossattn"])

        def batch2(x_flat, sigma_b, control_flat, ca_flat):
            # [B, ...] conditioning repeated tile-major to the flat batch [T*B, ...], then [uc; c]
            reps = x_flat.shape[0] // ca_uc.shape[0]

            def rep(a):
                return a.repeat((reps,) + (1,) * (a.dim() - 1))

            cond2 = {
                "crossattn": torch.cat([rep(ca_uc), rep(ca_c) if ca_flat is None else ca_flat]),
                "vector": torch.cat([rep(vec_uc), rep(vec_c)]),
                "control": torch.cat([control_flat, control_flat]),
            }
            return torch.cat([x_flat, x_flat]), torch.cat([sigma_b, sigma_b]), cond2

        def denoise_flat(x_flat, sigma_b, cfg_b, ctrl_s, control_flat, ca_flat):
            x2, s2, cond2 = batch2(x_flat, sigma_b, control_flat, ca_flat)
            d_uc, d_c = self.denoiser(self._network, x2, s2, cond2, ctrl_s).chunk(2)
            return cfg_combine(d_uc, d_c, cfg_b)

        def denoise_flat_cached(x_flat, sigma_b, cfg_b, ctrl_s, control_flat, ca_flat, cache, rec):
            x2, s2, cond2 = batch2(x_flat, sigma_b, control_flat, ca_flat)
            den, cache = self.denoiser.call_cached(self._network_cached, x2, s2, cond2, ctrl_s, cache, rec)
            d_uc, d_c = den.chunk(2)
            return cfg_combine(d_uc, d_c, cfg_b), cache

        starts, _, _ = make_tile_plan(noised_z.shape[2], noised_z.shape[3], tile_size, tile_stride)
        control_tiles = _gather_tiles(_nchw(self._tensor(c["control"])), starts, tile_size)
        ca_tiles = self._tensor(c["crossattn_tiles"]) if "crossattn_tiles" in c else None
        tiles = dict(control_tiles=control_tiles, tile_size=tile_size, tile_stride=tile_stride,
                     crossattn_tiles=ca_tiles)
        if feature_cache_interval:
            recompute = np.arange(num_steps) % int(feature_cache_interval) == 0
            samples_z = tiled_restore_edm_sample_cached(
                make_tiled_denoise_cached(denoise_flat_cached, tile_chunk=tile_chunk), recompute, noised_z, gen,
                tables, x_center=x_center, s_noise=s_noise, **tiles)
        elif edm:
            samples_z = tiled_restore_edm_sample(make_tiled_denoise(denoise_flat, tile_chunk=tile_chunk), noised_z,
                                                 gen, tables, x_center=x_center, s_noise=s_noise, **tiles)
        else:
            samples_z = tiled_restore_dpmpp2m_sample(make_tiled_denoise(denoise_flat, tile_chunk=tile_chunk),
                                                     noised_z, seed, tables, eta=cfg.sampler.eta, s_noise=s_noise,
                                                     **tiles)
        return self._finish(samples_z, x_stage1, color_fix_type)
