"""Tiled execution: the tiled VAE (tiled_vae) and tiled diffusion sampling
(tiled_sampler), the path to outputs past about 2K on one card."""
