"""supir_tpu_torch: the PyTorch/CUDA port of supir_tpu for NVIDIA Hopper.

Mirrors supir_tpu's tree, module for module:

  ops/        attention dispatch and the hand-written kernels: flash
              attention (CUDA C++, csrc/) and GroupNorm+SiLU (Triton)
  models/     nn.Modules in NCHW: VAE, SDXL UNet, GLVControl/ZeroSFT path
  diffusion/  sigma schedules, eps scaling, CFG, denoiser, RestoreEDM loop
  engine/     SUPIREngine (stage-1 denoise, full sample pipeline), factory
  utils/      the JAX->torch weight bridge, colour fix

Imports torch, never jax or flax. The JAX package stays the reference.
"""
