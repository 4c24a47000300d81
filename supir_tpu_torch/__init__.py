"""supir_tpu_torch: the PyTorch/CUDA port of supir_tpu for NVIDIA Hopper.

Mirrors supir_tpu's tree, module for module:

  ops/        attention dispatch and the hand-written kernels: flash
              attention, the int4/int8 decode GEMVs and the int8 quantizer
              (CUDA C++, csrc/), GroupNorm+SiLU (Triton)
  models/     nn.Modules in NCHW: VAE, SDXL UNet, GLVControl/ZeroSFT path,
              CLIP blocks
  diffusion/  sigma schedules, eps scaling, CFG, denoiser, RestoreEDM loop
  engine/     SUPIREngine (stage-1 denoise, full sample pipeline), factory
  captioner/  the LLaVA captioner: CLIP vision tower, Llama decoder with
              quantized projections, prompt templates, CaptionerAgent
  utils/      the JAX->torch weight bridge and its rule tables, colour fix

Imports torch, never jax, flax or supir_tpu. The JAX package stays the
reference.
"""
