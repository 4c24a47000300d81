"""Diffusion runtime: schedules, scaling, guidance, denoiser, sampler."""
