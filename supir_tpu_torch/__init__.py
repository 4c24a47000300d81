"""supir_tpu_torch: the PyTorch/CUDA port of supir_tpu for NVIDIA Hopper.

Mirrors supir_tpu's tree, module for module:

  ops/        attention dispatch and the hand-written kernels: flash
              attention, the int4/int8 decode GEMVs, the int8 quantizer
              and the probes' kernels (CUDA C++, csrc/), GroupNorm+SiLU
              (Triton)
  models/     nn.Modules in NCHW: VAE, SDXL UNet, GLVControl/ZeroSFT path,
              CLIP blocks and text towers, the SDXL conditioner
  diffusion/  sigma schedules, eps scaling, CFG, denoiser, RestoreEDM and
              DPM++(2M) SDE loops, the Brownian tree
  engine/     SUPIREngine (stage-1 denoise, text conditioning, full sample
              pipeline, tiled and untiled), factory
  parallel/   the tiled VAE (pooled GroupNorm statistics, staged exact)
              and tiled diffusion sampling
  captioner/  the LLaVA captioner: CLIP vision tower, Llama decoder with
              quantized projections, prompt templates, CaptionerAgent and
              its checkpoint entry point
  apps/       the batch restore CLI (python -m supir_tpu_torch.apps.cli)
  utils/      the JAX->torch weight bridge and its rule tables, checkpoint
              loading, image I/O, the CLIP tokenizer, colour fix, tiling
              geometry
  tools/      the decode-GEMV probes T1-T4 (stream ceiling, GEMV sweep,
              nibble order, native int4), run as python -m
              supir_tpu_torch.tools.<name> on the card

Imports torch, never jax, flax or supir_tpu. The JAX package stays the
reference.
"""
