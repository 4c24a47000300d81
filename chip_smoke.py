#!/usr/bin/env python3
"""Smoke run of supir_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py [--steps 4] [--repeat 0]
    python3 chip_smoke.py --steps 50 --repeat 3    # the 50-step headline

Phases, each printing its own lines:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions; TF32 is switched off for matmuls and cuDNN convolutions.
  2. build: the CUDA C++ kernels (K1 and K3, K1 fp32, K4, K2, the strip-body GEMVs,
     the tensor-core GEMV of K5, K6, K7, K9, K10, K5's act_int8 mode and
     K11, K8, K9's strip body, the probes' kernels and their GEMV
     geometries; one nvcc per source, all at once, into
     build/supir_tpu_torch/) with ptxas' registers and spills (for each of
     the forward's eight instantiations, K1/K3 x D 64/128 x ALiBi, and the
     tensor-core GEMV's seventeen, four layouts x three row tiles, W4A8 x
     two and K9's pair x three, which may not spill; and K1 fp32's
     fourteen, D 64/128 x the kernel and its six planted faults, which may
     not spill either), and the Triton import
     of K2's first design, which stays as a comparator.
  3. kernels against their plain PyTorch versions on the card, with
     CUDA-event or CUDA-graph times of both, the least time the card could
     take (bound) and, where one PyTorch call computes the same function,
     its time: K1 at the restore path's shapes and at the tiled path's
     batches (98 rows: 49 windows of a 4096^2 image with CFG), K1 causal,
     K1 fp32 (3xTF32 on wgmma) at the restore's two shapes, the fp32 CLI
     path's two and a ragged D 128 one, causal and not (rel-L2 1e-5
     against the fp32 plain version, which the bf16 kernel on the same
     values misses; planted faults: no rescale when the max rises, the
     ragged tile unmasked, the diagonal unmasked, S on one TF32 product, P V
     without V's lo part, V^T without the fragment permutation; in turns
     with SDPA fp32 by CUDA-graph replay, beside the 3xTF32 bound and the
     CUDA-core one),
     K2 at each of the restore path's shape classes and at the tiled
     path's largest batch (the cluster kernel in turns with
     the Triton first design, by events and by CUDA-graph replay, host µs
     per call of both, its planted faults: one rank's partials left out,
     each CTA on its own part's statistics, the affine one channel off,
     pass 2 reading the next group), and K5
     (also in its act_int8 mode), K6, K7, K8, K10 and K11 at the 13B
     captioner's decode shapes and K9 at its two pairs per layer, for 1 and
     8 rows, K5 (also act_int8), K7 (int8 and half-split int4), K9, K10 and
     K11 also at 32 rows and in turns with the strip body they replaced, K8
     (also at the int8 head) in turns with its first design, equal to its
     bytes for 3 seeds, with its planted faults (one rank's maxima left
     out, the Philox words rotated, the tile one column off) (K9
     also with its yardstick, the same products as two tensor-core K5
     calls), with the tensor-core body's planted faults (one block's share
     dropped, the combine run twice, x' staged out of order; W4A8: the row
     scale applied twice; K9: phase 2 staged without waiting for phase 1,
     the statistics from one strip) and two runs bit-identical;
     K10 timed as the kernel alone on int8 x and as its wrapper with the
     activation quantizer, and equal to the strip body bit for bit (K5's
     act_int8 mode too where it has no prologue); beside K6, K7 and K11 one
     PyTorch call computing
     the same function (torch._weight_int8pack_mm, torch._weight_int4pack_mm),
     held to the plain version, and beside K5 the int4 call without the
     prologue; and K3 (the forward with
     logsumexp) and K4 (the backward) at the training path's shapes and
     causal at Llama-13B's, and K3 ALiBi and K4 ALiBi at the MPT-7B
     prefill's shape and a non-causal one. Each is held to a stated bound,
     and planted faults must break it.
  3b. probes: the four decode-GEMV probes (supir_tpu_torch/tools/:
     stream_ceiling T1, gemv_sweep T2, bitcast_probe T3, int4_native_probe
     T4) run through their `main` at 3 replays, with the launch counters of
     T1a-T4b zeroed just before and read just after (each must be > 0);
     the card's measured streaming ceiling, and the ring column sum in
     turns with K6 at one row on the same bytes and plan at qkv and down;
     then each probe kernel at one geometry against its plain version: the
     ring column sum (csrc/colsum_tc.cu) at 1 (T1a) and 2 (T1b) k-slices,
     and exact at 1, 2, 4, 8 and the plan's count, two runs the same bits;
     T2 (W4A8 on the tensor-core body, csrc/quant_gemv_tc.cu) bit for bit
     at the plan's k-slices, and at 1, 2, 4 and 8, two runs the same bits;
     the nibble unpack T3a through both of the body's decodes
     (csrc/nibble_order.cu on csrc/tc_decode.cuh's nib2 and quad16) and
     the native cast T4a through nib2 bit for bit (and equal to its CPU
     walk), T3a and T4a beside an empty kernel's launch;
     T1c (half-split), T3b (paired) and T4b (native) on the tensor-core
     body at the plan's k-slices by rel-L2 1e-2; each with planted faults
     that must break it; T1a and T1b in turns with torch.sum, T2 with its
     first design (K10's strip body at strip 32, split-K 2, and at the
     fastest strip x split-K of this run's sweep-strip) and the yardstick
     torch._int_mm on int8 weights, T1c and T4b with their first designs
     (K7's strip body at 128, K11's at 256) and tinygemm, T3b with
     tinygemm; T1c, T3b and T4b on all-positive x at cin 13824, 1 and 8
     rows, at each slice count of the probes' sweep.
  4. main path: a full-width SDXL/SUPIR engine (XL-base, bf16, random
     weights from a seeded CUDA generator) restores one image through
     SUPIREngine.batchify_sample with bench.py's headline settings: a
     warm-up run, `--repeat` timed runs synchronised only at their end,
     then one run timed per stage. The launch counters are zeroed just
     before that last run and must show K1 at every eligible attention
     site of every step and K2 at every GroupNorm site of every step and
     VAE pass (expected_group_norm_launches; the warm-up logs K2's calls
     by shape).
  4b. cli: the batch CLI (supir_tpu_torch.apps.cli.main) in-process at
     full width (options/SUPIR_v0.yaml, bf16, random weights, the main
     path's steps): a 768x1152 PNG restored at 1024x1536 through
     pil_to_array, stage 1, tokenize, prepare_condition (CLIP-L and bigG at
     full width), batchify_sample and array_to_pil with --no_llava; the
     saved PNG must have the input's size and K1 and K2 must launch as the
     config says on that path (expected_flash_launches and
     expected_group_norm_launches at a 128x192 latent, two encodes and
     three decodes); per-stage times beside the card's name and power
     limit. Then again with --load_4bit_llava and LLAVA_MODEL_PATH at a
     tiny HF-layout llava directory the phase writes: the caption must
     lead the prompt and K5 must launch.
  4c. fp32: the same photo through cli.main with --full_params (every
     parameter fp32): K1 fp32 at every flash site (106 a step), no bf16
     K1 launch, K2 as in [cli] on fp32 tensors, a finite fp32 sample;
     stage times and peak memory; one network call of that run again under
     torch.profiler: K1 fp32's device ms and share of its kernel time.
  5. reference: a reduced-width engine whose self-attention still reaches
     K1 runs the same path on the card (bf16, kernels) and on the CPU
     (fp32, plain versions) with the same weights and noise; the two
     images must agree, and two planted faults (K2 without its SiLU, K1
     with exp2 without the log2(e) fold) must break the bound. Its text
     conditioner (towers 128 wide) gives prepare_condition on both, which
     must agree; bigG's last hidden state in place of its penultimate one
     must break that bound. Then [fp32 reference]: the same reduced
     engine with every parameter fp32 on the card (K1 fp32, K2 fp32)
     against the CPU, same weights and injected noise, 512^2, TF32 off:
     the image within 1e-3 rel-L2, each K1 fp32 site within 1e-5, bf16 K1
     never launched; K1 fp32 without its rescale must break the bound.
  5b. tiled: the tiled 4K path through the batch CLI at full width
     (options/SUPIR_v0_tiled.yaml, --use_tile_vae --use_tiled_sampling,
     bf16, random weights, --no_llava, the main path's steps): a 1024^2
     PNG at --upscale 2, a 2048^2 model image; 16 encoder tiles, 16
     decoder tiles and 9 sampler windows, counted as the path makes them;
     K1 and K2 must launch as expected_tiled_launches says (the tiled
     VAE's pooled GroupNorm sites launch no K2); stage times, peak memory,
     the saved PNG 2048^2. Then [tiled vae]: the same engine's tiled
     denoise-encode and decode of one 4096^2 image, timed, peak memory.
  5c. tiled reference: at the reference's reduced width, the tiled
     pipeline (a 768^2 image, 4 windows, every VAE pass tiled and staged)
     on the card (bf16, kernels) and on the CPU (fp32, plain versions),
     same weights and injected noise, by relative L2; the blend without
     its normaliser and chunk-local GroupNorm statistics must break it.
  5d. lightning: options/SUPIR_v0_Juggernautv9_lightning.yaml through the
     CLI at 1024x1536 with its own 8 RestoreDPMPP2M steps and CFG; stage
     times, peak memory, K1 and K2 launches as the config says.
  5e. samplers: the seven samplers beyond RestoreEDM and RestoreDPMPP2M
     (EulerEDM, HeunEDM, EulerAncestral, DPMPP2SAncestral, DPMPP2M, LMS,
     Substep) through batchify_sample at full width, 1024^2, 4 steps
     each (Substep's cap): seconds, network calls (two a step but the
     last for Heun and DPM++(2S)), K1 and K2 launches (calls x sites + the
     VAE's), peak memory; finite output.
  5f. feature cache: RestoreEDM's cross-step cache at full width, 1024^2, 8
     steps: interval 1 equal to the plain path (to 0 where two plain runs
     agree bit for bit), intervals 2 and 4 with each recompute and reuse
     step timed by CUDA events, K1/K2 launches (a reuse call runs the
     decoder's 38 K1 sites of the 106), the cache's bytes, peak memory;
     then TiledRestoreEDM at 2048^2 (tiled VAE, 9 windows), 4 steps,
     interval 2, folded, beside the plain tiled run.
  5g. samplers reference: at the reduced width, card bf16 vs CPU fp32 on the
     same weights and injected noise (each step's draw through the
     samplers' noise hook): each new sampler, the cache at interval 2
     (untiled; tiled folded and in chunks of 3), the plain UNetModel and
     GLVControl with input_upscale 2, rel-L2 0.05; Heun without its
     correction and a reuse step keeping the recompute step's time
     embedding must break it.
  5h. web demo: apps.web_demo's DemoServer at full width (the CLI's flags:
     options/SUPIR_v0.yaml, bf16, random weights, the tiny 4-bit
     captioner) behind serve_demo on 127.0.0.1, port 0, in a thread,
     driven over HTTP with urllib: the page, stage 1 on a 512^2 PNG,
     caption (K5 must launch), stage 2 at --upscale 2 (1024^2) with the
     Quality and the Fidelity preset (K1/K2 per request as
     expected_flash_launches and expected_group_norm_launches say, two
     encodes, two decodes), feedback, stage 2 after the hot swap to F (a
     synthetic SDXL + SUPIR file pair written here, loaded lazily once
     through convert_and_cache), stage 2 after the swap back (equal to the
     first), two stage-2 requests at once (equal to the serial ones); no
     answer may carry "error"; the history files; each request's wall
     time, the swaps' times, peak memory.
  5i. face: apps.face_demo.restore_with_faces at face_resolution 1024 on a
     1536x1024 image with two faces (a landmark callable): two 1024^2
     restores and the background's, K1/K2 as their shapes say, pasted
     through ParsedPasteBack with a random FaceParser at 512; the random
     RetinaFaceDetector (canvas 640) and parse_mask timed on the card.
  5j. eval: apps.eval.evaluate_dirs over those outputs against their
     inputs on the card, LPIPS from a torchvision-keyed random state dict
     through convert_lpips_state.
  5h'. serve: the port's controller and a restoration worker
     (supir_tpu_torch/serve/) over [web demo]'s engine on 127.0.0.1, port
     0, in threads; requests dispatched through /get_worker_address to
     /worker_generate_stream: a 1024^2 restoration equal within the demo's
     PNG bound to a direct batchify_sample on the same inputs and seed
     (K1/K2 per request as the config says), a second seed, both at once
     (each equal to its serial answer), a request without an image
     (an error payload); seconds per request split into batchify_sample,
     the rest of the device part and the host's base64/PNG work.
  5j'. load_real: the port's drill (supir_tpu_torch/tools/load_real.py) at
     full width on [web demo]'s synthetic SDXL + SUPIR pair and the tiny HF
     llava directory, 5 steps at 512^2: every stage PASS, a rerun against
     the first output at --psnr_min, a copy without one key FAIL naming it;
     then captioner/chat.py --weights on the llava directory.
  5k. apps reference: the tiny face and eval pipeline (warps, both pastes,
     ParseNet 64, RetinaFace at canvas 128, PSNR, SSIM, LPIPS) on the card
     against the CPU, fp32, rel-L2 1e-3; the paste through the matrix not
     inverted and the blur padded with zeros must break it.
  6. captioner: LLaVA-1.5-13B at full width (CLIP ViT-L/14-336, Llama-13B,
     random weights drawn and quantized layer by layer on the card) captions
     a 1024^2 image through CaptionerAgent.gen_image_caption, greedy, 32
     tokens, in each mode of CAPTION_MODES: int4 (K5), int4 without fused
     glue (K6), int8 (K8 at load, K7 in decode), int4-lean (fused pairs,
     int8 KV cache, int8 head: K9, K5, K7; K8 at load), int4-w4a8 (K5's
     act_int8 mode), int4-w4a8-unfused (K10), int4-native (K11) and
     int4-half (the half-split layout: K7 int4). The
     counters are zeroed before each mode's load and read after its caption
     and must equal expected_caption_launches; every GEMV call of one
     decode step is then held to its fp32 plain version on that call's
     inputs, and torch.profiler reads three decode steps (device busy
     share, kernels). In int4-lean, one text-only `chat` turn follows.
     On the int4 agent, the caption side of [serve]: a caption worker
     behind the controller and the web chat, one /send with a 1024^2 PNG
     whose reply must be the agent's own caption (K5 per request as the
     config says); and [captioner eval]: run_vqa over three synthetic
     questions (K5 against each answer's tokens), then score-pope.
  7. captioner reference: a reduced-width captioner on the card (bf16,
     kernels) and on the CPU (fp32, plain versions) with the same weights,
     in every mode: prefill logits and the logits of decode steps
     teacher-forced on the CPU's tokens must agree; a planted fault (nibble
     order swapped) must break the bound.
  8. train: the full-width SUPIR control-path trainer (XL-base, fp32
     parameters, bf16 autocast, remat; AdamW at lr 1e-5, EMA 0.9999; every
     leaf random) takes 3 steps on a 1024^2 latent: s/step split into
     forward+backward, optimizer and EMA, peak memory, each loss; frozen
     leaves must stay bit-identical, every trainable leaf and the EMA must
     move, and K1, K2, K3 and K4 must launch as often as the config says.
     One more forward+backward holds every K3 and K4 call to its fp32 plain
     version, and torch.profiler reads one step.
  9. train reference: a reduced-width trainer takes one step on the card
     (bf16, kernels) and on the CPU (fp32, plain versions) from the same
     state with the same sigma and noise: the loss and the gradients of
     each group (control net, UNet middle+decoder, adapters) must agree;
     a planted fault (every gradient site sent to K1/K2, detached) must
     break the bound.
 10. mpt generate: MPT-7B at full width and depth (random bf16 weights
     drawn on the card) runs mpt_generate on a 1536-token prompt of random
     ids, cache_len 2048, 32 greedy tokens: the prefill's attention is K3
     ALiBi at every layer (counted: as many launches as layers), decode
     the plain biased route; prefill ms, ms/token, torch.profiler over
     three decode steps, peak memory, and every prefill attention held to
     its fp32 plain version.
 11. mpt grad: one causal-LM loss and its backward through MPT-7B (bf16
     parameters) on a 2048-token conversation labelled by preprocess_mpt:
     K3 ALiBi with lse and K4 ALiBi once per layer, every call held to its
     plain version; s per forward+backward and peak memory.
 12. mpt reference: reduced-width MPT (512 wide, 4 layers; 8 heads,
     multiquery, and 6 heads on the plain route) on the card (bf16,
     kernels) and on the CPU (fp32, plain versions) with the same weights:
     logits, each gradient group, greedy tokens up to the first
     divergence, prefix-LM logits.
 13. captioner train: LLaVA-1.5-13B at full width and depth (dense bf16,
     random weights) through CaptionerTrainer.train_step_tokens on one
     collate batch (a 336^2 image and a vicuna_v1 conversation on the byte
     tokenizer, spliced to 2048 positions): "lora" (rank 64, alpha 16; a
     warm-up step with every K3/K4 call held to its plain version, then a
     counted and timed step), "projector" (one counted step), then "full"
     at full width and 2 of the 40 layers: K3 and K4 causal at
     [1,2048,40,128] once per layer per step and no K1; a finite loss, the
     base bit-identical, every trainable leaf moved; forward+backward and
     optimizer seconds, peak memory.
 14. captioner train reference: the same step at a reduced width (Llama
     512 wide, 2 layers, 2048 positions) on the card (bf16 base, K3/K4)
     and on the CPU (fp32, plain) from the same weights, each mode: loss
     and gradients (the first Adam moments) within 5e-2.
 15. ae train: SDXL's AutoencoderKL with its denoise encoder (fp32
     parameters, bf16 autocast), LPIPS (random) perceptual, disc_start 0,
     a 512^2 HQ batch of 2 and its blurred, noisy LQ copy: two
     denoise-encoder steps, one step of the whole autoencoder: K2 only in
     the discriminator phase's no-grad reconstruction (encoder and decoder
     sites), the generator phase's GroupNorms on the plain form; d_weight
     1.0 and in [0, 1e4]; the frozen parts bit-identical; seconds by phase,
     peak memory.
 16. ae train reference: one step of each branch at VAE ch 32, 128^2, the
     card (bf16 autocast; and fp32) against the CPU (fp32), same weights,
     discriminator and draws: losses within 5e-2, the gradients of the
     generator and the discriminator within 5e-2 in fp32 (in bf16 the L1
     loss's and LeakyReLU's kinks flip them; printed).
 17. multi-device: one spawn of two ranks (gloo sharing card 0 on one
     card, NCCL one rank per card on two or more) at full XL-base width,
     bf16, each split run beside rank 0's one-process run: (a)
     shard_for_inference on a (1,1,2) mesh and the 1024^2 restore (bit
     for bit; K1/K2 424/428 a rank); (b) set_sequence_mesh and one untiled
     2048^2 network call, its 16384-token sites on ring attention with K3
     blocks (5e-2 against K1), and ring_attention alone at [2,16384,10,64]
     against K1 and attention_plain (1e-2) with a planted fault (the merge
     without its rescale) and the fp32 and requires-grad refusals; (c)
     the [tiled] configuration at 2048^2 on a (1,2,1) tile mesh (5e-2);
     (d) LLaVA-13B int4 sharded over 'model': the greedy tokens equal.
     Seconds, peak memory, the collectives' share and launches per rank.
Then one JSON line with each kernel's numbers, the card line, and last
`{"ok": true, "device": {...}}`. There is no fallback: without a CUDA
device, or outside a checkout of the repository, it exits non-zero before
printing any result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time


SIZE = 1024  # image side of the main path, as bench.py's headline
SEED = 0
K1_REL_BOUND = 1e-2   # K1 against its fp32 plain version, relative L2
K1_FP32_REL_BOUND = 1e-5  # K1 fp32 against its fp32 plain version, relative L2 (a bf16 cast gives ~4e-3)
K3_LSE_BOUND = 1e-3   # K3's lse against the fp32 plain version, max abs
K4_REL_BOUND = 2e-2   # K4's dq, dk, dv against their fp32 plain versions, relative L2 each
TRAIN_LOSS_BOUND = 2e-2  # reduced-width train step, card against CPU: loss, relative
TRAIN_GRAD_BOUND = 5e-2  # ... and each parameter group's gradient, relative L2
TRAIN_STEPS = 3       # full-width train steps: one warm-up, two timed
REF_REL_BOUND = 5e-2  # reduced-width card (bf16, kernels) against CPU (fp32, plain), relative L2
GEMV_REL_BOUND = 1e-2  # K5-K7, K9, K11 and K5's act_int8 mode against their fp32 plain versions, relative L2
W4A8_REL_BOUND = 1e-6  # K10 against its plain version: exact integer sums, two rounded scale multiplies
CAP_REF_REL_BOUND = 5e-2  # reduced-width captioner logits, card against CPU, relative L2
CAP_TOKENS = 32       # max_new_tokens of the full-width caption
REF_STEPS = 8         # teacher-forced decode steps of the captioner reference
CLI_PNG = (768, 1152)  # (h, w) of the [cli] phase's photo; min_size 1024 takes it to 1024x1536
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOP_PER_S = 989e12   # H100 SXM dense bf16 tensor cores
FP32_FLOP_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores
TF32_FLOP_PER_S = 495e12   # H100 SXM dense TF32 tensor cores (K1 fp32 takes three TF32 products a product)
# the 13B decode projections per layer: name, cin, cout, prologue, residual
LLAMA_13B_SHAPES = (("qkv", 5120, 15360, "norm", False), ("o", 5120, 5120, None, True),
                    ("gateup", 5120, 27648, "norm", False), ("down", 13824, 5120, "siluglu", True))
# K9's two pairs per layer: label, first projection, second projection, SiLU-GLU before the first
LLAMA_13B_PAIRS = (("A: o + residual -> norm -> gate-up", "o", "gateup", False),
                   ("B: SiLU-GLU + down + residual -> norm -> next qkv", "down", "qkv", True))


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of fn() over `iters` calls, CUDA events."""
    import torch

    fn()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fns, replays: int = 5) -> float:
    """Mean device milliseconds per call of the calls in `fns`, captured in
    order into one CUDA graph and replayed: the card's time without the
    host's launch cost, which exceeds a small kernel's own time."""
    from supir_tpu_torch.tools.timing import chain_ms

    return chain_ms(fns, replays)


def _latent_hw(lat):
    """A latent's (h, w) from a side (a square latent) or an (h, w) pair."""
    return (lat, lat) if isinstance(lat, int) else tuple(lat)


def expected_flash_sites(cfg, lat, reuse: bool = False) -> int:
    """K1 sites per network call, derived from the config: every
    SpatialTransformer self-attention (UNet encoder, UNet decoder, GLVControl
    encoder, both middles) and every ZeroCrossAttn whose sequences hold at
    least 1024 tokens with 64- or 128-wide heads. `lat`: the latent's side,
    or its (h, w). `reuse`: a feature cache's reuse step, which runs only
    the UNet's decoder and the ZeroCrossAttns of those."""
    from supir_tpu_torch.ops.attention import flash_eligible

    h, w = _latent_hw(lat)
    u = cfg.unet
    n = 0
    for level in range(u.levels):
        ds = 2**level
        tokens = (h // ds) * (w // ds)
        if ds in u.attention_resolutions and flash_eligible(tokens, tokens, u.num_head_channels):
            if not reuse:
                n += 2 * u.num_res_blocks * u.transformer_depth[level]  # UNet + control encoders
            n += (u.num_res_blocks + 1) * u.transformer_depth[level]  # UNet decoder
        if level > 0 and flash_eligible(tokens, tokens, 64):
            n += 1  # ZeroCrossAttn before this level's upsample, 64-wide heads
    ds = 2 ** (u.levels - 1)
    mid = (h // ds) * (w // ds)
    if not reuse and ds in u.attention_resolutions and flash_eligible(mid, mid, u.num_head_channels):
        n += 2 * u.middle_depth
    return n


def expected_flash_launches(cfg, lat, steps: int, vae_passes: int) -> int:
    """K1 launches of `steps` network calls and `vae_passes` VAE passes
    (encoder or decoder, each holding one mid-block attention): that
    attention is one head as wide as the VAE's last level, which reaches K1
    only where that width is 64 or 128 (at reduced width, not at full
    width's 512)."""
    from supir_tpu_torch.ops.attention import flash_eligible

    h, w = _latent_hw(lat)
    vae_head = cfg.vae.ch * cfg.vae.ch_mult[-1]
    vae = vae_passes if flash_eligible(h * w, h * w, vae_head) else 0
    return expected_flash_sites(cfg, lat) * steps + vae


def expected_group_norm_launches(cfg, steps: int, vae_passes: int = 4, encodes=None, decodes=None,
                                 reuse_steps: int = 0) -> int:
    """K2 launches of `steps` network calls and the VAE passes: every
    GroupNorm32 of the UNet and of the control net (ZeroSFT and
    ZeroCrossAttn included) once per network call, and those of the encoder
    once per encode and of the decoder once per decode, counted on the
    config's modules built on the meta device. `vae_passes` alternate
    encode and decode (the counted [main] run's four: the denoise encoder,
    a decode, the encoder, a decode); `encodes` and `decodes` count them
    apart (the CLI's five: two encodes, three decodes). `reuse_steps`: the
    feature cache's reuse calls, each the UNet's sites without its input
    blocks and middle block. GroupNorm sites do not depend on the image
    size."""
    import torch

    from supir_tpu_torch.engine.supir import SUPIRModel
    from supir_tpu_torch.models.layers import GroupNorm32

    with torch.device("meta"):
        model = SUPIRModel(cfg)

    def sites(module):
        return sum(isinstance(m, GroupNorm32) for m in module.modules())

    encodes = vae_passes // 2 if encodes is None else encodes
    decodes = vae_passes - vae_passes // 2 if decodes is None else decodes
    unet = model.model["diffusion_model"]
    net = sites(unet) + sites(model.model["control_model"])
    reuse = sites(unet) - sites(unet.input_blocks) - sites(unet.middle_block)
    vae = model.first_stage_model
    return net * steps + reuse * reuse_steps + encodes * sites(vae.encoder) + decodes * sites(vae.decoder)


def expected_tiled_launches(cfg, lat, steps: int, tile_size: int = 128, tile_stride: int = 64,
                            tile_chunk=None, vae_flash: int = 0) -> dict:
    """K1 and K2 launches of the tiled path: each step runs the network once
    on all `tile_size` windows of the latent folded into one batch (once a
    group of `tile_chunk` windows with a chunk), each call K1 at the
    window's sites and K2 at every GroupNorm of the UNet and control net.
    The tiled VAE adds no K2 (its statistics are pooled over the tiles, in
    plain torch) and `vae_flash` K1 (expected_tiled_vae_flash)."""
    from supir_tpu_torch.utils.tiling import sliding_windows

    h, w = _latent_hw(lat)
    tiles = len(sliding_windows(h, w, tile_size, tile_stride))
    calls = steps * (-(-tiles // tile_chunk) if tile_chunk else 1)
    return {"K1": expected_flash_sites(cfg, tile_size) * calls + vae_flash,
            "K2": expected_group_norm_launches(cfg, calls, vae_passes=0)}


def tiled_vae_tiles(cfg, image_hw, enc_tile: int, dec_tile: int):
    """(encoder tiles, decoder tiles) of an image: enc_tile image px and
    dec_tile latent px a tile."""
    h, w = image_hw
    f = cfg.vae.downscale_factor
    return (math.ceil(h / enc_tile) * math.ceil(w / enc_tile),
            math.ceil(h // f / dec_tile) * math.ceil(w // f / dec_tile))


def expected_tiled_vae_flash(cfg, image_hw, enc_tile: int, dec_tile: int, chunk, encodes: int, decodes: int) -> int:
    """K1 launches of the tiled VAE's mid-block attention over `encodes`
    encodes and `decodes` decodes: one a call of the encoder or decoder
    (one call on all tiles, or one a chunk of tiles), where a tile's tokens
    (its halo included: 32 image px, 8 latent px) and the VAE's single head
    reach K1. At full width the 512-wide head reaches none."""
    from supir_tpu_torch.ops.attention import flash_eligible

    f = cfg.vae.downscale_factor
    head = cfg.vae.ch * cfg.vae.ch_mult[-1]

    def calls(tiles, side, per_call):
        if not flash_eligible(side * side, side * side, head):
            return 0
        return 1 if not per_call or tiles <= per_call else -(-tiles // per_call)

    enc_tiles, dec_tiles = tiled_vae_tiles(cfg, image_hw, enc_tile, dec_tile)
    return (encodes * calls(enc_tiles, (enc_tile + 64) // f, chunk and chunk[0])
            + decodes * calls(dec_tiles, dec_tile + 16, chunk and chunk[1]))


def rel_l2(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(bytes_moved: float, flops: float = 0.0, flop_rate: float = BF16_FLOP_PER_S):
    """(ms, "bytes" | "operations"): the least time the card could take, the
    larger of the bytes over the memory rate and the operations over their
    peak rate (by default bf16 on the tensor cores, dense)."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


@contextlib.contextmanager
def kernels_at_sites(k1, k2):
    """Route every K1 site through `k1` and every GroupNorm site through `k2`.
    Each K1 call's output is held to the plain version in fp32 on its own
    inputs; the relative L2 errors land in the list this yields."""
    from supir_tpu_torch.models import layers
    from supir_tpu_torch.ops import attention as attn_ops
    from supir_tpu_torch.ops.flash_attention import attention_plain

    rels = []

    def watched(q, k, v, causal=False, alibi_slopes=None):
        if alibi_slopes is not None:
            raise AssertionError("an ALiBi site on the restore path")
        out = k1(q, k, v, causal=causal)
        rels.append(rel_l2(out, attention_plain(q.float(), k.float(), v.float(), causal=causal)))
        return out

    saved = attn_ops.flash_attention, layers.group_norm
    attn_ops.flash_attention, layers.group_norm = watched, k2
    try:
        yield rels
    finally:
        attn_ops.flash_attention, layers.group_norm = saved


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    log("[device] tf32: matmul off, cudnn off")
    return smi


def _ptxas_summary(report: str) -> str:
    """One line from nvcc's -Xptxas -v output: kernels, register range,
    spills."""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
    stores = [int(r) for r in re.findall(r"(\d+) bytes spill stores", report)]
    loads = [int(r) for r in re.findall(r"(\d+) bytes spill loads", report)]
    if not regs:
        return "no ptxas report (library built earlier)"
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, spill stores max {max(stores, default=0)} B, "
            f"spill loads max {max(loads, default=0)} B")


def _instances(report: str, kernel: str):
    """(kernel, D, flags..., registers, spill stores, spill loads) of each
    instantiation of a flash kernel (`kernel`, a regex of its name, template
    arguments <int D, bool...>) in nvcc's -Xptxas -v output."""
    rows, current = [], None
    for line in report.splitlines():
        name = re.search(rf"(?:Compiling entry function|Function properties for) '?(\S*(?:{kernel})\S*?)'?(?: |$)",
                         line)
        if name:
            args = re.search(rf"({kernel})ILi(\d+)E((?:Lb[01]E)+)", name.group(1))
            current = ((args.group(1), int(args.group(2)), *(f == "1" for f in re.findall(r"Lb([01])E", args.group(3))))
                       if args else None)
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if current and spill:
            spills = (int(spill.group(1)), int(spill.group(2)))
        used = re.search(r"Used (\d+) registers", line)
        if current and used:
            rows.append(current + (int(used.group(1)),) + spills)
            current = None
    return rows


def _tc_instances(report: str):
    """(mode, n-tiles, registers, spill stores, spill loads) of each
    qgemv_tc_kernel<MODE, NT> instance in nvcc's -Xptxas -v output, and of
    each qpair_tc_kernel<NT> (K9) as mode "pair"."""
    rows, current, spills = [], None, (0, 0)
    for line in report.splitlines():
        name = re.search(r"(?:Compiling entry function|Function properties for) '?\S*qgemv_tc_kernelILi(\d+)ELi(\d+)E",
                         line)
        pair = re.search(r"(?:Compiling entry function|Function properties for) '?\S*qpair_tc_kernelILi(\d+)E", line)
        if name or pair:
            current = (int(name.group(1)), int(name.group(2))) if name else ("pair", int(pair.group(1)))
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if current and spill:
            spills = (int(spill.group(1)), int(spill.group(2)))
        used = re.search(r"Used (\d+) registers", line)
        if current and used:
            rows.append(current + (int(used.group(1)),) + spills)
            current, spills = None, (0, 0)
    return rows


def _fp32_instances(report: str):
    """(D, fault, registers, spill stores, spill loads) of each
    flash_fwd_fp32_kernel<D, FAULT> instance in nvcc's -Xptxas -v output."""
    rows, current, spills = [], None, (0, 0)
    for line in report.splitlines():
        name = re.search(r"(?:Compiling entry function|Function properties for) '?\S*flash_fwd_fp32_kernelILi(\d+)ELi(\d+)E",
                         line)
        if name:
            current = (int(name.group(1)), int(name.group(2)))
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if current and spill:
            spills = (int(spill.group(1)), int(spill.group(2)))
        used = re.search(r"Used (\d+) registers", line)
        if current and used:
            rows.append(current + (int(used.group(1)),) + spills)
            current, spills = None, (0, 0)
    return rows


def phase_build():
    from supir_tpu_torch.ops import cuda_build, groupnorm as k2
    from supir_tpu_torch.ops import flash_attention as k1, probes as kp, quantize as kq

    # K1 and K3 share flash_attn_fwd.cu; K1 fp32 is flash_attn_fwd_fp32.cu; K4 is
    # flash_attn_bwd.cu; K2 group_norm.cu
    sources = k1.SOURCES + k2.SOURCES + kq.SOURCES + kp.SOURCES
    t0 = time.perf_counter()
    seconds = cuda_build.build_all(sources)
    wall = time.perf_counter() - t0
    for source in sources:
        log(f"[build] {source}: nvcc {seconds[source]:.1f} s; ptxas: {_ptxas_summary(cuda_build.ptxas_report(source))}")
    # the forward's eight instantiations (K1 and K3, D 64/128, with and
    # without ALiBi) and the backward's eight (the dQ and the dK/dV kernel,
    # D 64/128, with and without ALiBi); setmaxnreg raises the consumers to
    # 240 past what ptxas reports for the block's 384 threads
    reports = {source: cuda_build.ptxas_report(source) for source in k1.SOURCES}
    fwd = _instances(reports[k1._FWD_SOURCE], "flash_fwd_kernel")
    for _, d, with_lse, alibi, regs, stores, loads in sorted(fwd):
        log(f"[build] flash_fwd_kernel<D={d}, lse={with_lse}, alibi={alibi}> ({'K3' if with_lse else 'K1'}"
            f"{' ALiBi' if alibi else ''}): {regs} registers, spill stores {stores} B, spill loads {loads} B")
    bwd = _instances(reports[k1._BWD_SOURCE], "flash_bwd_dq_kernel|flash_bwd_dkv_kernel")
    for name, d, alibi, regs, stores, loads in sorted(bwd):
        log(f"[build] {name}<D={d}, alibi={alibi}> (K4{' ALiBi' if alibi else ''} "
            f"{'dQ' if '_dq_' in name else 'dK/dV'}): {regs} registers, spill stores {stores} B, spill loads {loads} B")
    for source, rows in ((k1._FWD_SOURCE, fwd), (k1._BWD_SOURCE, bwd)):
        if reports[source] and len(rows) != 8:  # no report: the library was built earlier
            raise AssertionError(f"expected 8 instantiations in the ptxas report of {source}, found {len(rows)}")
    # K1 fp32's fourteen (D 64/128 x the kernel and its six planted
    # faults), which may not spill
    fp32 = _fp32_instances(reports[k1._FP32_SOURCE])
    for d, fault, regs, stores, loads in sorted(fp32):
        log(f"[build] flash_fwd_fp32_kernel<D={d}, fault={fault}> (K1 fp32{' planted fault' if fault else ''}): "
            f"{regs} registers, spill stores {stores} B, spill loads {loads} B")
    if reports[k1._FP32_SOURCE] and (len(fp32) != 14 or any(st or ld for *_, st, ld in fp32)):
        raise AssertionError(f"K1 fp32's instances: expected 14 without spills, found {fp32}")
    # the tensor-core GEMV's seventeen instances (K5/K6 paired, K7 half-split
    # int4, K7 int8, K11 native: 1, 2 or 4 n-tiles of 8 rows; K10/K5
    # act_int8 W4A8: 1 or 2, 16 rows a launch; K9's pair kernel: 1, 2 or 4):
    # registers and spills, and no spill allowed
    report = cuda_build.ptxas_report(kq._TC_SOURCE)
    tc = _tc_instances(report)
    layouts = {0: ("paired", "K5/K6"), 1: ("half", "K7 int4"), 2: ("int8", "K7 int8"), 3: ("native", "K11"),
               4: ("w4a8", "K10/K5 act_int8")}
    for mode, nt, regs, stores, loads in sorted(tc, key=str):
        kernel = (f"qpair_tc_kernel<n-tiles {nt}> (K9" if mode == "pair"
                  else f"qgemv_tc_kernel<{layouts[mode][0]}, n-tiles {nt}> ({layouts[mode][1]}")
        log(f"[build] {kernel}, up to {8 * nt} rows): {regs} registers, spill stores {stores} B, spill loads {loads} B")
    if report and (len(tc) != 17 or sum(m == "pair" for m, *_ in tc) != 3 or any(st or ld for *_, st, ld in tc)):
        raise AssertionError(f"the tensor-core GEMV's instances: expected 17 (3 of K9's pair) without spills, "
                             f"found {tc}")
    log(f"[build] K9's strip body (comparisons and calls the tensor-core pair does not take): grid "
        f"{kq.pair_grid_blocks(1)} co-resident blocks at 1 row, {kq.pair_grid_blocks(8)} at 8 (occupancy API x SMs)")
    t1 = time.perf_counter()
    k2.build_triton()
    log(f"[build] nvcc wall {wall:.1f} s for {len(sources)} sources in parallel; K2's Triton first design (the "
        f"comparator) imported in {time.perf_counter() - t1:.1f} s (Triton compiles each specialisation at its "
        f"first launch)")


def _vs(ms: float, bound_ms: float, lib_ms: float) -> str:
    """A kernel's time as a share of its bound and as a multiple of SDPA's."""
    return f"{bound_ms / ms:.1%} of the bound, {ms / lib_ms:.2f}x SDPA"


def _graph_vs(kernel, library, bound_ms: float, calls: int = 10) -> str:
    """The flash forward and its SDPA yardstick timed by CUDA-graph replay
    (device time without the host's launch cost, which the event times of
    the small shapes include), with _vs."""
    ms, lib_ms = graph_ms([kernel] * calls), graph_ms([library] * calls)
    return f"graph replay {ms:.4f} ms vs SDPA {lib_ms:.4f} ms: {_vs(ms, bound_ms, lib_ms)}"


def _k4_graph_vs(kernel, qkv, grad, bound_ms: float, calls: int = 10, **sdpa) -> str:
    """K4 and SDPA's backward timed by CUDA-graph replay, with _vs. Autograd
    runs a backward op on the stream of its forward, so SDPA's backward is
    captured together with its forward, on fresh leaves made from `qkv`
    ([B,H,N,D] views) inside the capture: its graph time is that of forward
    and backward less that of the forward alone."""
    import torch
    import torch.nn.functional as F

    def forward():
        leaves = [x.detach().requires_grad_() for x in qkv]
        return leaves, F.scaled_dot_product_attention(*leaves, **sdpa)

    def forward_backward():
        leaves, out = forward()
        return torch.autograd.grad(out, leaves, grad)

    ms = graph_ms([kernel] * calls)
    lib_ms = graph_ms([forward_backward] * calls) - graph_ms([forward] * calls)
    return f"graph replay {ms:.4f} ms vs SDPA backward {lib_ms:.4f} ms: {_vs(ms, bound_ms, lib_ms)}"


def _k4_faults(tag: str, run, q, k, v, out, lse, dout, grads, want, alibi: bool = False) -> None:
    """K4's planted faults, emulated on the sound kernel's inputs (or, for
    dK, its output `grads`): each must break the gradients' bound.
    `run(q, k, v, out, lse, dout)` is the kernel at the case's causal flag
    and slopes. The lse in log2 units (K3's exp2
    bookkeeping slipped), delta dropped (a zero out gives delta 0), dK
    without its scale, dO shifted by one query row and k/v shifted by one
    key (tile-offset errors in the TMA coordinates)."""
    import torch
    import torch.nn.functional as F

    name = "K4-alibi" if alibi else "K4"
    shift = (0, 0, 0, 0, 0, 1)
    _check_fault(f"{name} given lse in log2 units {tag}", max(_k4_rels(run(q, k, v, out, lse * LOG2E, dout), want)),
                 K4_REL_BOUND)
    _check_fault(f"{name} delta dropped {tag}", max(_k4_rels(run(q, k, v, torch.zeros_like(out), lse, dout), want)),
                 K4_REL_BOUND)
    _check_fault(f"{name} dK without scale {tag}", rel_l2(grads[1] * q.shape[-1] ** 0.5, want[1]), K4_REL_BOUND)
    _check_fault(f"{name} dO shifted by one query row {tag}",
                 max(_k4_rels(run(q, k, v, out, lse, F.pad(dout[:, 1:], shift)), want)), K4_REL_BOUND)
    _check_fault(f"{name} k/v shifted by one key {tag}",
                 max(_k4_rels(run(q, F.pad(k[:, 1:], shift), F.pad(v[:, 1:], shift), out, lse, dout), want)),
                 K4_REL_BOUND)


def _check_rel(label: str, rel: float, bound_: float):
    if not rel <= bound_:
        raise AssertionError(f"{label}: rel_l2 {rel:.3e} over its bound {bound_:g}")


def _check_fault(label: str, rel: float, bound_: float):
    """A planted fault must break the bound; a NaN reading breaks it too."""
    log(f"[kernels] control ({label}): rel_l2 {rel:.3e}")
    if rel <= bound_:
        raise AssertionError(f"the bound {bound_:g} misses a planted fault ({label}): rel_l2 {rel:.3e}")


def phase_kernels():
    """K1 and K2 at the restore path's shapes, K1 causal; returns each
    kernel's JSON numbers (times at the first shape)."""
    import torch
    import torch.nn.functional as F

    from supir_tpu_torch.ops.flash_attention import attention_plain, flash_attention

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    results = {}

    # K1's outputs on unit-normal inputs are small (max below 1), so an
    # absolute bound cannot see a fault that scales every output by a few
    # per cent, such as keys past T joining the softmax. The reference is the
    # plain version in fp32 on the same bf16 values, the bound a relative L2
    # error: bf16 rounding of P and of the output gives a few 1e-3.
    k1 = []
    for b, s, h, d in ((2, 4096, 10, 64), (2, 1024, 20, 64), (2, 1100, 10, 64)):
        q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
        t0 = time.perf_counter()
        out = flash_attention(q, k, v)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        want = attention_plain(q.float(), k.float(), v.float())
        err = (out.float() - want).abs().max().item()
        rel = rel_l2(out, want)
        ms = cuda_ms(lambda: flash_attention(q, k, v), 20)
        plain_ms = cuda_ms(lambda: attention_plain(q, k, v), 20)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 20)
        bound_ms, bound_by = bound(nbytes(q, k, v, out), 4 * b * h * s * s * d)
        graph = _graph_vs(lambda: flash_attention(q, k, v), lambda: F.scaled_dot_product_attention(qt, kt, vt),
                          bound_ms)
        log(f"[kernels] K1 [{b},{s},{h},{d}] bf16 vs fp32 plain: rel_l2 {rel:.3e} (bound {K1_REL_BOUND:g}), "
            f"max_abs_err {err:.3e} (bound 2e-2), max|ref| {want.abs().max().item():.3f}; "
            f"{ms:.4f} ms vs plain {plain_ms:.3f} ms, SDPA {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}): {_vs(ms, bound_ms, lib_ms)}; {graph}; first call {first:.2f} s")
        if not (rel <= K1_REL_BOUND and err <= 2e-2):
            raise AssertionError(f"K1 disagrees with its plain version at [{b},{s},{h},{d}]: rel {rel}, max {err}")
        k1.append(dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                       bound_by=bound_by))
        if s % 128:
            # planted faults the bound must catch: the kernel run on k/v
            # zero-padded to its 128-key tile is what a kernel that stops
            # masking keys past T computes; q scaled by ln 2 is exp2 without
            # the log2(e) fold; k/v shifted by one key (key 0 dropped, a zero
            # key after T) is a tile-offset error in the TMA coordinates
            pad = (0, 0, 0, 0, 0, -s % 128)
            _check_fault(f"K1 unmasked ragged tile [{b},{s},{h},{d}]",
                         rel_l2(flash_attention(q, F.pad(k, pad), F.pad(v, pad)), want), K1_REL_BOUND)
            _check_fault(f"K1 exp2 without log2(e) [{b},{s},{h},{d}]",
                         rel_l2(flash_attention((q.float() * math.log(2)).to(q.dtype), k, v), want), K1_REL_BOUND)
            shift = (0, 0, 0, 0, 0, 1)
            shifted = flash_attention(q, F.pad(k[:, 1:], shift), F.pad(v[:, 1:], shift))
            _check_fault(f"K1 k/v shifted by one key [{b},{s},{h},{d}]", rel_l2(shifted, want), K1_REL_BOUND)

    # K1 at the tiled path's batches: 2048^2 folds 9 windows into a batch of
    # 18 (CFG's two halves), 4096^2 49 into 98, where the grid's B*H and the
    # offsets are largest. The plain version runs 7 rows at a time; each
    # row's relative L2 is held to the bound, so that an offset gone wrong
    # at the end of the tensor shows.
    for b, s, h, d in ((98, 4096, 10, 64), (98, 1024, 20, 64)):
        q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
        out = flash_attention(q, k, v)
        want = torch.cat([attention_plain(q[i:i + 7].float(), k[i:i + 7].float(), v[i:i + 7].float())
                          for i in range(0, b, 7)])
        rows = [rel_l2(out[i], want[i]) for i in range(b)]
        ms = cuda_ms(lambda: flash_attention(q, k, v), 5)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 5)
        bound_ms, bound_by = bound(nbytes(q, k, v, out), 4 * b * h * s * s * d)
        log(f"[kernels] K1 tiled batch [{b},{s},{h},{d}] bf16 vs fp32 plain: worst row rel_l2 {max(rows):.3e} "
            f"(bound {K1_REL_BOUND:g}, last row {rows[-1]:.3e}), max_abs_err {(out.float() - want).abs().max().item():.3e}; "
            f"{ms:.3f} ms, SDPA {lib_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), {bound_ms / ms:.1%} of it, "
            f"{ms / lib_ms:.2f}x SDPA")
        _check_rel(f"K1 tiled batch [{b},{s},{h},{d}]", max(rows), K1_REL_BOUND)
        del q, k, v, out, want
        torch.cuda.empty_cache()

    # K1 with the TPU kernels' causal mask, at Llama-13B head shapes (the
    # caption prompt stays under 1024 tokens, so these are fixed shapes)
    for b, s, h, d in ((1, 1100, 40, 128), (1, 2048, 40, 128)):
        q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
        out = flash_attention(q, k, v, causal=True)
        want = attention_plain(q.float(), k.float(), v.float(), causal=True)
        rel = rel_l2(out, want)
        ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True), 20)
        plain_ms = cuda_ms(lambda: attention_plain(q, k, v, causal=True), 20)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 20)
        bound_ms, bound_by = bound(nbytes(q, k, v, out), 4 * b * h * d * s * (s + 1) // 2)
        graph = _graph_vs(lambda: flash_attention(q, k, v, causal=True),
                          lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), bound_ms)
        log(f"[kernels] K1 causal [{b},{s},{h},{d}] bf16 vs fp32 plain causal: rel_l2 {rel:.3e} "
            f"(bound {K1_REL_BOUND:g}), max_abs_err {(out.float() - want).abs().max().item():.3e}; "
            f"{ms:.4f} ms vs plain {plain_ms:.3f} ms, SDPA causal {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}): {_vs(ms, bound_ms, lib_ms)}; {graph}")
        _check_rel(f"K1 causal [{b},{s},{h},{d}]", rel, K1_REL_BOUND)
        _check_fault(f"K1 causal mask removed [{b},{s},{h},{d}]", rel_l2(flash_attention(q, k, v), want),
                     K1_REL_BOUND)
        shift = (0, 0, 0, 0, 0, 1)
        _check_fault(f"K1 causal k/v shifted by one key [{b},{s},{h},{d}]", rel_l2(flash_attention(
            q, F.pad(k[:, 1:], shift), F.pad(v[:, 1:], shift), causal=True), want), K1_REL_BOUND)
    results["K1"] = dict(k1[0], max_abs_err=max(r["max_abs_err"] for r in k1))

    results["K2"] = phase_group_norm()
    return results


# K1 fp32 at the restore's shapes (15 and 91 of its 106 sites a step in an
# fp32 engine at 1024^2), the fp32 CLI path's (the same sites at the
# 1024x1536 model image of [fp32]) and a ragged D = 128 shape, causal (its
# diagonal in the ragged last block) and not: b, s, h, d, causal
K1_FP32_SHAPES = ((2, 4096, 10, 64, False), (2, 1024, 20, 64, False), (2, 6144, 10, 64, False),
                  (2, 1536, 20, 64, False), (1, 1000, 2, 128, True), (1, 1000, 2, 128, False))


def phase_flash_fp32_kernels():
    """[kernels] K1 fp32 against the plain version in fp32 on the same
    inputs (relative L2 K1_FP32_REL_BOUND, which the bf16 kernel on the
    same values misses: nothing may cast down; two runs bit-identical),
    each planted fault where it can show breaking it (no rescale, S on one
    TF32 product, P V without V's lo part and V^T in key order everywhere;
    the ragged tile where T is not a whole number of key tiles and not
    causal; the diagonal where causal); timed by CUDA events and by
    CUDA-graph replay in turns with SDPA in fp32 (the library call),
    beside the plain version; bound: 3 x 4 B H S T D flops (causal: the
    visible half) at TF32's 495 TFLOP/s, the first design's CUDA-core
    bound (67 TFLOP/s fp32) beside it. Returns the JSON numbers (times at
    the first shape)."""
    import torch
    import torch.nn.functional as F

    from supir_tpu_torch.ops import flash_attention as FA
    from supir_tpu_torch.tools.timing import chain_ms, mean, turns

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)
    rows = []
    for b, s, h, d, causal in K1_FP32_SHAPES:
        tag = f"[{b},{s},{h},{d}]{' causal' if causal else ''}"
        q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev) for _ in range(3))
        t0 = time.perf_counter()
        out = FA.flash_attention(q, k, v, causal)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        same = torch.equal(out, FA.flash_attention(q, k, v, causal))
        want = FA.attention_plain(q, k, v, causal=causal)
        rel, err = rel_l2(out, want), (out - want).abs().max().item()
        cast = rel_l2(FA.flash_attention(*(x.bfloat16() for x in (q, k, v)), causal), want)
        _check_rel(f"K1 fp32 {tag}", rel, K1_FP32_REL_BOUND)
        if not same:
            raise AssertionError(f"K1 fp32 {tag}: two runs differ")
        if not cast > K1_FP32_REL_BOUND:
            raise AssertionError(f"the K1 fp32 bound does not tell a bf16 kernel from it: {cast}")
        faults = [(FA.FP32_FAULT_NO_RESCALE, "the accumulator not rescaled when the max rises"),
                  (FA.FP32_FAULT_ONE_PRODUCT, "S on one TF32 product (hi hi)"),
                  (FA.FP32_FAULT_NO_V_LO, "P V without V's lo part"),
                  (FA.FP32_FAULT_VT_ORDER, "V^T in key order (no fragment permutation)")]
        if s % FA.FP32_TILES[d][1] and not causal:
            faults.append((FA.FP32_FAULT_RAGGED, "the ragged last key tile not masked"))
        if causal:
            faults.append((FA.FP32_FAULT_DIAGONAL, "the causal diagonal not masked"))
        for fault, name in faults:
            _check_fault(f"K1 fp32 {name} {tag}", rel_l2(FA._forward_fp32(q, k, v, causal, fault), want),
                         K1_FP32_REL_BOUND)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def kernel():
            return FA.flash_attention(q, k, v, causal)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

        lib_rel = rel_l2(sdpa().transpose(1, 2), want)
        ms = cuda_ms(kernel, 10)
        plain_ms = cuda_ms(lambda: FA.attention_plain(q, k, v, causal=causal), 3)
        lib_ev = cuda_ms(sdpa, 10)
        graph = turns({"K1 fp32": [kernel] * 5, "SDPA fp32": [sdpa] * 5}, lambda calls: chain_ms(calls, 4))
        graph_k, graph_lib = mean(graph["K1 fp32"]), mean(graph["SDPA fp32"])
        flops = 4 * b * h * d * (s * (s + 1) // 2 if causal else s * s)
        bound_ms, bound_by = bound(nbytes(q, k, v, out), 3 * flops, TF32_FLOP_PER_S)
        core_ms, _ = bound(nbytes(q, k, v, out), flops, FP32_FLOP_PER_S)
        log(f"[kernels] K1 fp32 {tag} vs fp32 plain: rel_l2 {rel:.3e} (bound {K1_FP32_REL_BOUND:g}; the bf16 "
            f"kernel on the same values {cast:.3e}; SDPA fp32 {lib_rel:.3e}), max_abs_err {err:.3e}, two runs "
            f"bit-identical; events {ms:.4f} ms vs plain {plain_ms:.3f} ms, SDPA fp32 {lib_ev:.4f} ms; graph in "
            f"turns {'/'.join(f'{x:.4f}' for x in graph['K1 fp32'])} vs SDPA fp32 "
            f"{'/'.join(f'{x:.4f}' for x in graph['SDPA fp32'])} ms: {graph_k / graph_lib:.2f}x SDPA; bound "
            f"{bound_ms:.4f} ms ({bound_by}, 3 x {flops / 1e9:.1f} GFLOP at 495 TFLOP/s TF32): {bound_ms / graph_k:.1%} "
            f"of it by graph; CUDA-core bound {core_ms:.4f} ms (67 TFLOP/s fp32): {core_ms / graph_k:.1%}; first "
            f"call {first:.2f} s")
        # the JSON row's ms and library_ms: the in-turns graph times
        rows.append(dict(max_abs_err=err, ms=graph_k, event_ms=ms, plain_ms=plain_ms, library_ms=graph_lib,
                         library_event_ms=lib_ev, bound_ms=bound_ms, bound_by=bound_by))
        del q, k, v, out, want, qt, kt, vt
        _free()
    return dict(rows[0], max_abs_err=max(r["max_abs_err"] for r in rows))


# K2 at each shape class of the restore path (UNet, GLVControl and ZeroSFT
# at latent 128^2, CFG batch 2; the VAE at batch 1 on a 1024^2 image), the
# UNet's widest site at the tiled path's largest batch (49 windows of a
# 4096^2 image folded with CFG: 98 rows, 514 M elements) and one fp32
# shape: shape, eps, SiLU, dtype
K2_SHAPES = (((2, 320, 128, 128), 1e-5, True, "bfloat16"), ((2, 960, 128, 128), 1e-5, True, "bfloat16"),
             ((2, 1920, 64, 64), 1e-5, True, "bfloat16"), ((2, 1280, 32, 32), 1e-5, False, "bfloat16"),
             ((1, 512, 128, 128), 1e-6, True, "bfloat16"), ((1, 128, 1024, 1024), 1e-6, True, "bfloat16"),
             ((1, 512, 256, 256), 1e-6, True, "bfloat16"), ((98, 320, 128, 128), 1e-5, True, "bfloat16"),
             ((2, 640, 64, 64), 1e-5, True, "float32"))
K2_BOUND = 3e-2  # K2 against its fp32 plain version on the same values, max abs


def _gn_case(shape, dtype, g):
    """x with its own mean and scale per channel (statistics taken over the
    wrong elements show; on i.i.d. inputs per-part statistics would pass)
    and the affine."""
    import torch

    c = shape[1]
    view = (1, c) + (1,) * (len(shape) - 2)
    scale = 0.5 + torch.rand(c, generator=g, device="cuda")
    shift = 2.0 * torch.rand(c, generator=g, device="cuda") - 1.0
    # clamped at 3 sigma: the outputs stay under 8, where one bf16 rounding
    # (at most 2^-6) stays under K2's bound
    x = (torch.randn(shape, generator=g, device="cuda").clamp(-3, 3) * scale.view(view) + shift.view(view)).to(dtype)
    return x, 1.0 + 0.1 * torch.randn(c, generator=g, device="cuda"), 0.1 * torch.randn(c, generator=g, device="cuda")


def phase_group_norm():
    """K2 (csrc/group_norm.cu) at K2_SHAPES against its fp32 plain version,
    two runs bit-identical; by events and by CUDA-graph replay (10 calls a
    graph), in turns with the Triton first design (new, old, old, new),
    beside F.group_norm(+F.silu) and the bound; host µs per call of both
    designs; the planted faults. Returns the JSON numbers at the first shape."""
    import torch
    import torch.nn.functional as F

    from supir_tpu_torch.ops import groupnorm as G
    from supir_tpu_torch.tools.gemv_host_cost import host_us
    from supir_tpu_torch.tools.timing import mean, turns

    g = torch.Generator(device="cuda").manual_seed(2345)
    rows = []
    for shape, eps, silu, dname in K2_SHAPES:
        dtype = getattr(torch, dname)
        x, w, b = _gn_case(shape, dtype, g)
        plan = G.plan_for(x)
        placed = G.clusters(plan, dtype)
        t0 = time.perf_counter()
        out = G.group_norm(x, w, b, 32, eps, silu)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        want = G.group_norm_plain(x.float(), w, b, 32, eps, silu)
        err = (out.float() - want).abs().max().item()
        again = torch.equal(out, G.group_norm(x, w, b, 32, eps, silu))
        new = lambda: G.group_norm(x, w, b, 32, eps, silu)   # noqa: E731
        old = lambda: G.group_norm_triton(x, w, b, 32, eps, silu)   # noqa: E731
        old_err = (old().float() - want).abs().max().item()
        wb, bb = w.to(dtype), b.to(dtype)
        lib = (lambda: F.silu(F.group_norm(x, 32, wb, bb, eps))) if silu else (lambda: F.group_norm(x, 32, wb, bb, eps))
        ms, old_ms = cuda_ms(new, 20), cuda_ms(old, 20)
        plain_ms, lib_ms = cuda_ms(lambda: G.group_norm_plain(x, w, b, 32, eps, silu), 5), cuda_ms(lib, 20)
        t = turns({"new": [new] * 10, "old": [old] * 10}, graph_ms)
        graph, graph_old = mean(t["new"]), mean(t["old"])
        lib_graph = graph_ms([lib] * 10)
        us, us_old = host_us(new, 200), host_us(old, 200)
        bound_ms, bound_by = bound(nbytes(x, w, b, out))
        tag = f"K2 {list(shape)} {dname} eps {eps:g} silu {silu}"
        log(f"[kernels] {tag}: {plan.ranks} CTAs a cluster ({'portable' if plan.portable else 'non-portable'}), "
            f"{plan.part * plan.itemsize} bytes a part, "
            f"{plan.smem} B shared, {placed} clusters placed at once; max_abs_err {err:.3e} (bound {K2_BOUND:g}; "
            f"Triton {old_err:.3e}), two runs bit-identical {again}; first call {first:.2f} s")
        log(f"[kernels] {tag}: events {ms:.4f} ms (Triton first design {old_ms:.4f}, plain {plain_ms:.3f}, "
            f"F.group_norm{'+F.silu' if silu else ''} {lib_ms:.4f}); graph replay in turns new {t['new'][0]:.4f}, "
            f"old {t['old'][0]:.4f}, {t['old'][1]:.4f}, new {t['new'][1]:.4f} ms (library {lib_graph:.4f}); bound "
            f"{bound_ms:.4f} ms ({bound_by}): {bound_ms / graph:.1%} of it by graph, {bound_ms / ms:.1%} by events, "
            f"{graph_old / graph:.2f}x the first design; host {us:.1f} µs a call (Triton pair {us_old:.1f} µs)")
        if not (err <= K2_BOUND and again and placed > 0):
            raise AssertionError(f"{tag}: max_abs_err {err}, bit-identical {again}, clusters {placed}")
        if shape in ((2, 320, 128, 128), (2, 960, 128, 128), (1, 128, 1024, 1024)):
            faults = [("one rank's partials left out", G.FAULT_DROP_RANK),
                      ("each CTA on its own part's statistics", G.FAULT_OWN_SLICE),
                      ("the affine one channel off", G.FAULT_AFFINE_SHIFT),
                      ("pass 2 reading the next group", G.FAULT_NEIGHBOUR_GROUP)]
            for name, fault in faults:
                bad = (G._launch(x, w, b, 32, eps, silu, plan, fault=fault).float() - want).abs().max().item()
                log(f"[kernels] control ({tag} {name}): max_abs_err {bad:.3e}")
                if bad <= K2_BOUND:   # a NaN reading breaks it too
                    raise AssertionError(f"the bound {K2_BOUND:g} misses a planted fault ({tag} {name}): {bad:.3e}")
        rows.append(dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                         bound_by=bound_by))
        del x, out, want
        torch.cuda.empty_cache()
    return dict(rows[0], max_abs_err=max(r["max_abs_err"] for r in rows))


def _probe_counters():
    from supir_tpu_torch.ops import probes as P

    return {"T1a": P.column_sum, "T1b": P.column_sum_2d, "T1c": P.half_split_matmul, "T2": P.w4a8_preact,
            "T3a": P.unpack_nibbles, "T3b": P.int4_single_cast_matmul, "T4a": P.native_cast,
            "T4b": P.native_single_cast_matmul}


def _probe_row(label, kernel, plain, copies, moved_bytes, faults, want=None, rel_bound=None, library=None,
               lib_copies=None, lib_name="torch.sum"):
    """One probe kernel at one geometry: kernel(*copies[0]) against `want`
    (default plain(*copies[0])), bit for bit when rel_bound is None, else by
    relative L2; each planted fault (name, call) must break that. Device
    times chained over the copies through one CUDA graph (graph_ms), the
    plain version over at most four of them; `library` is one PyTorch
    call computing the same function, timed beside it over `copies`, or
    over `lib_copies` (its own layout of the same weights; then held to
    `want` by rel_bound first)."""
    import torch

    out = kernel(*copies[0])
    want = plain(*copies[0]) if want is None else want
    err = (out.float() - want.float()).abs().max().item()
    if rel_bound is None:
        ok, reading = torch.equal(out, want), f"bit for bit {torch.equal(out, want)}"
    else:
        rel = rel_l2(out, want)
        ok, reading = rel <= rel_bound, f"rel_l2 {rel:.3e} (bound {rel_bound:g})"
    if not ok:
        raise AssertionError(f"{label} disagrees with its plain version: {reading}, max_abs_err {err:.3e}")
    for name, bad in faults:
        got = bad()
        if rel_bound is None:
            broken = not torch.equal(got, want)
            log(f"[probes] control ({label} {name}): equal {not broken}")
        else:
            rel = rel_l2(got, want)
            broken = not rel <= rel_bound
            log(f"[probes] control ({label} {name}): rel_l2 {rel:.3e}")
        if not broken:
            raise AssertionError(f"the bound misses a planted fault ({label} {name})")
    ms = graph_ms([lambda c=c: kernel(*c) for c in copies])
    plain_ms = graph_ms([lambda c=c: plain(*c) for c in copies[:4]], replays=2)
    if lib_copies is not None:
        _check_rel(f"{label} {lib_name}", rel_l2(library(*lib_copies[0]), want), rel_bound)
    lib_ms = graph_ms([lambda c=c: library(*c) for c in lib_copies or copies]) if library else None
    bound_ms, bound_by = bound(moved_bytes)
    log(f"[probes] {label}: {reading}, max_abs_err {err:.3e}; {ms:.4f} ms vs plain {plain_ms:.4f} ms"
        f"{'' if lib_ms is None else f', {lib_name} {lib_ms:.4f} ms'} (device, CUDA graph over {len(copies)} "
        f"copies), bound {bound_ms:.4f} ms ({bound_by}, {bound_ms / ms:.0%} of it)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)


def phase_probes():
    """[probes]: the four probes' mains on the card at 3 replays, counted;
    the measured streaming ceiling and the ring alone against K6 at qkv and
    down (stream_ceiling); each probe kernel at one geometry against its
    plain version; the ring column sum and T2 exact at every slice count of
    the sweep; T1a-T2, T3b and T4b in turns with their first designs (where
    kept) and their PyTorch call or yardstick; T3a through both decodes
    beside the launch floor; T1c, T3b and T4b on all-positive x
    (_probe_precision). Returns the JSON numbers and the launches of
    T1a-T4b."""
    import gc

    import torch

    from supir_tpu_torch.ops import probes as P, quantize as Q
    from supir_tpu_torch.tools import bitcast_probe, gemv_sweep, int4_native_probe, stream_ceiling
    from supir_tpu_torch.tools.timing import tinygemm

    counters = _probe_counters()
    t0 = time.perf_counter()
    _reset(counters)
    found = stream_ceiling.main(["--reps", "3"])
    ceiling = found["ceiling"]
    sweep = gemv_sweep.main(["--reps", "3"])
    bitcast_probe.main(["--reps", "3"])
    int4_native_probe.main(["--reps", "3"])
    launches = _read(counters)
    log(f"[probes] the four probes' mains: {time.perf_counter() - t0:.1f} s; launches {launches}")
    log(f"[probes] measured streaming ceiling: {ceiling['gb_per_s']:.1f} GB/s read "
        f"({ceiling['share']:.1%} of 3.35 TB/s) by {ceiling['name']}")
    for name, n in launches.items():
        if not n > 0:
            raise AssertionError(f"{name} was never launched by the probes")
    for shape in ("qkv", "down"):
        ring, k6 = found[f"{shape} ring"], found[f"{shape} K6"]
        log(f"[probes] ring alone vs K6 at {shape} (one row, the same bytes and plan, in turns): ring "
            f"{ring['ms']:.4f} ms ({ring['share']:.1%} of 3.35 TB/s), K6 {k6['ms']:.4f} ms ({k6['share']:.1%}): "
            f"K6 {k6['ms'] / ring['ms']:.2f}x the ring's time")

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    cin, cout = 5120, 15360          # T1's weight, also the 13B qkv projection
    qs = [(torch.randint(0, 256, (cin // 2, cout), dtype=torch.uint8, generator=g, device=dev),) for _ in range(8)]
    per = cin // 2 * cout
    scale = torch.rand(1, cout, generator=g, device=dev) * 0.01 + 0.001
    q0 = qs[0][0]
    lib = lambda q: torch.sum(q, 0, dtype=torch.int32)  # noqa: E731
    rows, beside = {}, {}
    want = P.column_sum_plain(q0)
    rows["T1a"] = _probe_row(
        "T1a ring column sum [2560,15360] u8, 1 k-slice", P.column_sum, P.column_sum_plain, qs, per + cout * 4,
        [("bytes read as int8", lambda: P.column_sum(q0, _fault=P.RING_FAULT_SIGNED))], library=lib)
    rows["T1b"] = _probe_row(
        "T1b ring column sum [2560,15360] u8, 2 k-slices", lambda q: P.column_sum_2d(q, 2), P.column_sum_plain, qs,
        per + cout * 4, _ring_faults(q0, 2), library=lib)
    _ring_exact(q0)
    _probe_turns("T1a", want, {
        "T1a": [lambda q=q: P.column_sum(q) for (q,) in qs],
        "torch.sum": [lambda q=q: lib(q) for (q,) in qs]}, beside, exact=True)
    _probe_turns("T1b", want, {
        "T1b": [lambda q=q: P.column_sum_2d(q, 2) for (q,) in qs],
        "torch.sum": [lambda q=q: lib(q) for (q,) in qs]}, beside, exact=True)
    x8 = torch.randn(8, cin, generator=g, device=dev).to(torch.bfloat16)

    def yardstick(unpack, layouts, xx):
        """The int4 yardstick (tinygemm) of these weights' values, its own
        layout made once per copy; (fn of the copy, copies), or (None, None)."""
        made = [_try_library(tinygemm, unpack(q), scale) for (q,) in layouts]
        if any(m is None for m in made):
            return None, None
        return (lambda w_, s_: made[0][0](xx, w_, s_)), [m[1] for m in made]

    lib, lib_qs = yardstick(Q.unpack_int4, qs, x8)
    rows["T1c"] = _probe_row(
        "T1c half-split GEMV on the tensor-core body (K7 int4's instance) [8,5120]x[2560,15360]",
        lambda q: P.half_split_matmul(x8, q, scale), lambda q: P.half_split_matmul_plain(x8, q, scale), qs,
        per + nbytes(x8, scale) + 8 * cout * 4, _body_faults(P.half_split_matmul, x8, q0, scale),
        want=P.half_split_matmul_plain(x8.float(), q0, scale), rel_bound=GEMV_REL_BOUND, library=lib,
        lib_copies=lib_qs, lib_name="tinygemm")
    _probe_turns("T1c", P.half_split_matmul_plain(x8.float(), q0, scale), {
        "T1c": [lambda q=q: P.half_split_matmul(x8, q, scale) for (q,) in qs],
        "first design (K7's strip body, strip 128)": [lambda q=q: Q.int4_matmul(x8, q, scale, strip=128)
                                                      for (q,) in qs],
        "tinygemm": [lambda w=w: lib(*w) for w in lib_qs] if lib else None}, beside)
    xq = torch.randint(-127, 128, (1, cin), dtype=torch.int8, generator=g, device=dev)
    rows["T2"] = _probe_row(
        "T2 W4A8 on the tensor-core body qkv [1,5120]x[2560,15360], the plan's k-slices",
        lambda q: P.w4a8_preact(xq, q, scale), lambda q: P.w4a8_preact_plain(xq, q, scale), qs,
        per + nbytes(xq, scale) + cout * 4, _t2_faults(xq, q0, scale))
    _t2_exact(xq, q0, scale)
    _t2_turns(xq, qs, scale, sweep, beside)
    lib, lib_qs = yardstick(Q.unpack_int4_paired, qs, x8)
    rows["T3b"] = _probe_row(
        "T3b single-cast GEMV on the tensor-core body (K6's instance) qkv [8,5120]x[2560,15360]",
        lambda q: P.int4_single_cast_matmul(x8, q, scale), lambda q: P.int4_single_cast_matmul_plain(x8, q, scale),
        qs, per + nbytes(x8, scale) + 8 * cout * 4, _body_faults(P.int4_single_cast_matmul, x8, q0, scale),
        want=P.int4_single_cast_matmul_plain(x8.float(), q0, scale), rel_bound=GEMV_REL_BOUND, library=lib,
        lib_copies=lib_qs, lib_name="tinygemm")
    _probe_turns("T3b", P.int4_single_cast_matmul_plain(x8.float(), q0, scale), {
        "T3b": [lambda q=q: P.int4_single_cast_matmul(x8, q, scale) for (q,) in qs],
        "tinygemm": [lambda w=w: lib(*w) for w in lib_qs] if lib else None}, beside)
    del qs, q0, lib, lib_qs
    gc.collect()
    torch.cuda.empty_cache()

    dcin, dcout = 13824, 5120        # the 13B down projection
    qn = [(torch.randint(0, 256, (dcin, dcout // 2), dtype=torch.uint8, generator=g, device=dev),)
          for _ in range(8)]
    sn = torch.rand(1, dcout, generator=g, device=dev) * 0.01 + 0.001
    x1 = torch.randn(1, dcin, generator=g, device=dev).to(torch.bfloat16)
    scale = sn
    lib, lib_qs = yardstick(Q.unpack_int4_native, qn, x1)
    rows["T4b"] = _probe_row(
        "T4b native single-cast GEMV on the tensor-core body (K11's instance) down [1,13824]x[13824,5120]",
        lambda q: P.native_single_cast_matmul(x1, q, sn), lambda q: P.native_single_cast_matmul_plain(x1, q, sn), qn,
        dcin * dcout // 2 + nbytes(x1, sn) + dcout * 4, _body_faults(P.native_single_cast_matmul, x1, qn[0][0], sn),
        want=P.native_single_cast_matmul_plain(x1.float(), qn[0][0], sn), rel_bound=GEMV_REL_BOUND, library=lib,
        lib_copies=lib_qs, lib_name="tinygemm")
    _probe_turns("T4b", P.native_single_cast_matmul_plain(x1.float(), qn[0][0], sn), {
        "T4b": [lambda q=q: P.native_single_cast_matmul(x1, q, sn) for (q,) in qn],
        "first design (K11's strip body, strip 256)": [lambda q=q: Q.int4_native_matmul(x1, q, sn, strip=256)
                                                       for (q,) in qn],
        "tinygemm": [lambda w=w: lib(*w) for w in lib_qs] if lib else None}, beside)
    del qn, lib, lib_qs
    gc.collect()
    torch.cuda.empty_cache()

    rows["T3a"] = _t3a_rows(dev)
    # every int4 value, -8..7: the TPU probe's block (arange % 7) holds no
    # negative one, so a cast that drops the sign would pass it
    block = Q.pack_int4_native((torch.arange(128 * 128, device=dev).reshape(128, 128) % 16 - 8).to(torch.int8))
    rows["T4a"] = _probe_row(
        "T4a native cast [128,128] int4, every value -> bf16 x 2, through nib2 (csrc/tc_decode.cuh)",
        P.native_cast, P.native_cast_plain, [(block.clone(),) for _ in range(8)], block.numel() * 5,
        [("nibbles swapped (nib2's selector mirrored)", lambda: P.native_cast(block, _fault=P.ORDER_FAULT_SWAP)),
         ("sign not restored (the lop3's ^ 8 dropped)",
          lambda: P.native_cast(block, _fault=P.ORDER_FAULT_UNSIGNED))])
    walk = P.native_cast_emulate(block.cpu())
    if not torch.equal(P.native_cast(block).cpu().view(torch.int16), walk.view(torch.int16)):
        raise AssertionError("T4a differs from its CPU walk (native_cast_emulate)")
    floor = graph_ms([lambda: P.empty_launch(dev) for _ in range(8)])
    rows["T4a"]["floor_ms"] = floor
    log(f"[probes] T4a launch floor: an empty kernel {floor:.4f} ms by CUDA graph; T4a {rows['T4a']['ms']:.4f} ms "
        f"({rows['T4a']['ms'] / floor:.2f}x), equal to its CPU walk bit for bit")
    for probe, (label, ms) in beside.items():
        r = rows[probe]
        lib = "" if r["library_ms"] is None else f"; its PyTorch call {r['library_ms']:.4f} ms"
        log(f"[probes] {probe} {r['ms']:.4f} ms beside {label} {ms:.4f} ms: {r['ms'] / ms:.2f}x its time{lib}")
    _probe_precision(g)
    return rows, launches, ceiling


def _t2_faults(xq, q, s):
    """T2's planted faults, each a call on (xq, q, s) that must break bit
    equality: the tensor-core body's (gemv_plan.FAULT_*; the combine run
    twice at 2 k-slices) and the scale left out. FAULT_ROW_SCALE squares
    the row factor, which is 1.0 on T2, so T2 cannot see it."""
    import torch

    from supir_tpu_torch.ops import gemv_plan as GP, probes as P

    return [("one share dropped", lambda: P.w4a8_preact(xq, q, s, _fault=GP.FAULT_DROP_SHARE)),
            ("x staged in the wrong k order", lambda: P.w4a8_preact(xq, q, s, _fault=GP.FAULT_X_ORDER)),
            ("combine run twice (2 slices)", lambda: P.w4a8_preact(xq, q, s, 2, _fault=GP.FAULT_COMBINE_TWICE)),
            ("scale left out", lambda: P.w4a8_preact(xq, q, torch.ones_like(s)))]


def _t2_exact(xq, q, s):
    """T2 at 1, 2, 4 and 8 k-slices and the plan's count: each bit-equal to
    its plain version, and a second run the same bits."""
    import torch

    from supir_tpu_torch.ops import gemv_plan as GP, probes as P, quantize as Q

    want = P.w4a8_preact_plain(xq, q, s)
    own = GP.tc_plan("w4a8", xq.shape[0], xq.shape[1], q.shape[1], Q._sm_count(xq.device.index)).slices
    for n in sorted({1, 2, 4, 8, own}):
        got = P.w4a8_preact(xq, q, s, n)
        if not (torch.equal(got, want) and torch.equal(P.w4a8_preact(xq, q, s, n), got)):
            raise AssertionError(f"T2 at {n} k-slices differs from its plain version or from itself")
    log(f"[probes] T2 {tuple(xq.shape)} x {tuple(q.shape)} at k-slices {sorted({1, 2, 4, 8, own})} (plan {own}): "
        "each bit-equal to its plain version, two runs the same bits")


def _int_mm_yardstick(xq, qs, s):
    """T2's yardstick where this torch takes it: torch._int_mm over the
    weights unpacked once to int8 [cin, cout] (twice T2's bytes), x padded
    to 32 rows (its least m), then * scale: two calls. Returns the calls
    over the copies, or None with the refusal logged."""
    import torch

    from supir_tpu_torch.ops import quantize as Q

    xp = torch.zeros(32, xq.shape[1], dtype=torch.int8, device=xq.device)
    xp[:xq.shape[0]] = xq
    try:
        w8 = [Q.unpack_int4_paired(q).to(torch.int8) for (q,) in qs]
        torch._int_mm(xp, w8[0])
    except (RuntimeError, AttributeError) as exc:
        log(f"[probes] T2 yardstick torch._int_mm: none ({str(exc).splitlines()[0][:160]})")
        return None
    rows = xq.shape[0]
    return [lambda w=w: torch._int_mm(xp, w)[:rows] * s for w in w8]


def _t2_turns(xq, qs, s, sweep, beside):
    """T2 on the body in turns with its first design at strip 32, split-K 2
    (the row measured before) and at the old sweep's fastest geometry at
    qkv (gemv_sweep's sweep-strip lines of this run), and with the
    torch._int_mm yardstick (a yardstick: two calls and twice the bytes,
    not T2's library call); each bit-equal to the plain version first."""
    from supir_tpu_torch.ops import probes as P

    strip_rows = {k: v for k, v in sweep.items() if k.startswith("qkv sweep-strip ")}
    fastest = min(strip_rows, key=lambda k: strip_rows[k]["ms"])
    strip, split = (int(v) for v in fastest.split()[3::2])
    log(f"[probes] T2's first design, fastest in this run's sweep-strip at qkv: strip {strip} split-K {split} "
        f"({strip_rows[fastest]['ms']:.4f} ms)")
    variants = {
        "T2": [lambda q=q: P.w4a8_preact(xq, q, s) for (q,) in qs],
        "first design (strip 32, split-K 2)": [lambda q=q: P.w4a8_preact_strip(xq, q, s, 32, 2) for (q,) in qs],
        f"first design (sweep's fastest, strip {strip} split-K {split})": [
            lambda q=q: P.w4a8_preact_strip(xq, q, s, strip, split) for (q,) in qs],
        "yardstick torch._int_mm on int8 weights + * scale": _int_mm_yardstick(xq, qs, s)}
    _probe_turns("T2", P.w4a8_preact_plain(xq, qs[0][0], s), variants, beside, exact=True)


def _t3a_rows(dev):
    """T3a through each of the body's decodes on all 256 bytes, bit for bit
    with the plain unpack, with its planted faults; the paired decode's row
    is the JSON row (max_abs_err over both). Beside it, the launch floor:
    an empty kernel on the same stream, by CUDA graph."""
    import torch

    from supir_tpu_torch.ops import probes as P

    every = torch.arange(256, dtype=torch.int32).to(torch.uint8).reshape(2, 128).to(dev)
    copies = [(every.clone(),) for _ in range(8)]
    names = {P.ORDER_FAULT_SWAP: "nibbles swapped", P.ORDER_FAULT_UNSIGNED: "sign not restored",
             P.ORDER_FAULT_K_ORDER: "k order left permuted"}
    found = {}
    for decode, what in (("paired", "nib2"), ("w4a8", "quad16")):
        faults = [(names[f], lambda f=f, d=decode: P.unpack_nibbles(every, d, _fault=f))
                  for f in names if decode == "w4a8" or f != P.ORDER_FAULT_K_ORDER]
        found[decode] = _probe_row(f"T3a nibble unpack, all 256 bytes [2,128] u8, the {decode} decode ({what})",
                                   lambda q, d=decode: P.unpack_nibbles(q, d), P.unpack_nibbles_plain, copies,
                                   every.numel() * 9, faults)
    floor = graph_ms([lambda: P.empty_launch(dev) for _ in range(8)])
    log(f"[probes] T3a launch floor: an empty kernel {floor:.4f} ms by CUDA graph; T3a paired "
        f"{found['paired']['ms']:.4f} ms, w4a8 {found['w4a8']['ms']:.4f} ms: T3a's time is its launch")
    return dict(found["paired"], max_abs_err=max(r["max_abs_err"] for r in found.values()), floor_ms=floor)


def _ring_faults(q, slices):
    """The ring column sum's planted faults at `slices` k-slices, each a
    call on q: the bytes read as int8, slice 0's partial left out of the
    combine, the combine run twice."""
    from supir_tpu_torch.ops import probes as P

    return [("bytes read as int8", lambda: P.column_sum_2d(q, slices, _fault=P.RING_FAULT_SIGNED)),
            ("slice 0's partial dropped", lambda: P.column_sum_2d(q, slices, _fault=P.RING_FAULT_DROP_SLICE)),
            ("combine run twice", lambda: P.column_sum_2d(q, slices, _fault=P.RING_FAULT_COMBINE_TWICE))]


def _ring_exact(q):
    """The ring column sum of q at 1, 2, 4 and 8 k-slices and the plan's
    count: each equal to its plain version, and a second run the same bits."""
    import torch

    from supir_tpu_torch.ops import probes as P, quantize as Q

    want = P.column_sum_plain(q)
    own = P.ring_plan(*q.shape, Q._sm_count(q.device.index)).slices
    for n in sorted({1, 2, 4, 8, own}):
        got = P.column_sum_2d(q, n)
        if not (torch.equal(got, want) and torch.equal(P.column_sum_2d(q, n), got)):
            raise AssertionError(f"the ring column sum at {n} k-slices differs from its plain version or from itself")
    log(f"[probes] ring column sum {tuple(q.shape)} at k-slices {sorted({1, 2, 4, 8, own})} (plan {own}): each equal "
        "to its plain version, two runs the same bits")


def _body_faults(kernel, x, q, s):
    """T1c's, T3b's or T4b's planted faults, each a call of `kernel` on (x, q, s):
    the tensor-core body's (gemv_plan.FAULT_*; the combine run twice at 2
    k-slices) and the scale left out."""
    import torch

    from supir_tpu_torch.ops import gemv_plan as GP

    return [("one share dropped", lambda: kernel(x, q, s, _fault=GP.FAULT_DROP_SHARE)),
            ("x' staged in the wrong k order", lambda: kernel(x, q, s, _fault=GP.FAULT_X_ORDER)),
            ("combine run twice (2 slices)", lambda: kernel(x, q, s, 2, _fault=GP.FAULT_COMBINE_TWICE)),
            ("scale left out", lambda: kernel(x, q, torch.ones_like(s)))]


def _probe_turns(probe, want, variants, beside, exact=False):
    """A probe kernel in turns (a, b, c, c, b, a: tools/timing.py:turns)
    with its first design, if it keeps one, and its PyTorch call or
    yardstick over the same weight copies,
    each variant's output on the first copy held to `want` first: by
    GEMV_REL_BOUND, or bit for bit (`exact`, the column sums)."""
    import torch

    from supir_tpu_torch.tools.timing import mean, turns

    variants = {k: v for k, v in variants.items() if v is not None}
    if exact:
        same = {name: torch.equal(calls[0]().float().reshape(want.shape), want) for name, calls in variants.items()}
        log(f"[probes] {probe} in turns, each on the first copy: " + "; ".join(
            f"{name} equal {ok}" for name, ok in same.items()))
        for name, ok in same.items():
            if not ok:
                raise AssertionError(f"{probe} {name} differs from the plain column sum")
    else:
        rels = {name: rel_l2(calls[0](), want) for name, calls in variants.items()}
        log(f"[probes] {probe} in turns, each on the first copy: " + "; ".join(
            f"{name} rel_l2 {rel:.3e}" for name, rel in rels.items()) + f" (bound {GEMV_REL_BOUND:g})")
        for name, rel in rels.items():
            _check_rel(f"{probe} {name}", rel, GEMV_REL_BOUND)
    times = {name: mean(r) for name, r in turns(variants, graph_ms).items()}
    ms = times.pop(probe)
    log(f"[probes] {probe} in turns: {ms:.4f} ms; " + "; ".join(
        f"{name} {t:.4f} ms ({t / ms:.2f}x its time)" for name, t in times.items()))
    first = next((name for name in times if name.startswith("first design")), None)
    if first is not None:
        beside[probe] = (f"its {first} in turns", times[first])


def _probe_precision(g):
    """T1c, T3b and T4b on all-positive x (|N(0,1)|, as after SiLU) over the
    13B down projection (cin 13824), quantized random weights, 1 and 8
    rows, at each slice count of the probes' sweep: each within
    GEMV_REL_BOUND of its fp32 plain version."""
    import torch

    from supir_tpu_torch.ops import gemv_plan as GP, probes as P, quantize as Q

    cin, cout = 13824, 5120
    w = torch.randn(cin, cout, generator=g, device="cuda") * cin ** -0.5
    for probe, layout, kernel, quantize, plain in (
            ("T1c", "half", P.half_split_matmul, Q.quantize_int4, P.half_split_matmul_plain),
            ("T3b", "paired", P.int4_single_cast_matmul, Q.quantize_int4_paired, Q.int4_paired_matmul_plain),
            ("T4b", "native", P.native_single_cast_matmul, Q.quantize_int4_native, Q.int4_native_matmul_plain)):
        q, s = quantize(w)
        for nrows in (1, 8):
            x = torch.randn(nrows, cin, generator=g, device="cuda").abs().to(torch.bfloat16)
            want = plain(x.float(), q, s)
            own = GP.tc_plan(layout, nrows, cin, cout, Q._sm_count(0)).slices
            errs = {n: rel_l2(kernel(x, q, s, n), want) for n in sorted({1, 2, 4, 8, own})}
            log(f"[probes] {probe} [{nrows},{cin}]x[{cin},{cout}] all-positive x, rel_l2 by k-slices (plan {own}): "
                + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()) + f" (bound {GEMV_REL_BOUND:g})")
            for n, e in errs.items():
                _check_rel(f"{probe}, all-positive x, {nrows} rows, {n} slices", e, GEMV_REL_BOUND)
        del q
    del w
    torch.cuda.empty_cache()


def _swap_nibbles(packed):
    """Planted fault: the low and high nibbles of every byte exchanged (the
    paired layout's row order, the half-split layout's two halves)."""
    return ((packed >> 4) | (packed << 4)).contiguous()


L2_BYTES = 50 * 2**20  # H100 L2 cache


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def _worst_rel(got, want) -> float:
    """The largest relative L2 error over a call's outputs (K9 has two)."""
    return max(rel_l2(g_, w_) for g_, w_ in zip(_outputs(got), _outputs(want)))


def _copies(weights, w_bytes: int):
    """The weights and enough clones that together they exceed twice the L2
    cache, so each call of a chain streams its weights from device memory."""
    return [weights] + [tuple(t.clone() for t in weights) for _ in range(int(2 * L2_BYTES // w_bytes))]


def _library_row(label, library, x, want, rel_bound):
    """One PyTorch call computing a GEMV's function, library = (fn, weights
    in its own layout, made once): held to the plain version's `want` by
    `rel_bound` and timed like the kernel (CUDA graph over weight copies
    larger than L2). Returns (ms, note); ms None and the error in the note
    when the op raises at this shape."""
    import torch

    fn, lw = library
    try:
        rel = _worst_rel(fn(x, *lw), want)
    except RuntimeError as exc:  # the op refuses this shape or layout
        return None, f"none ({str(exc).splitlines()[0][:160]})"
    _check_rel(f"{label} library call", rel, rel_bound)
    copies = _copies(lw, nbytes(*lw))
    ms = graph_ms([lambda c=c: fn(x, *c) for c in copies])
    del copies
    torch.cuda.empty_cache()
    return ms, f"rel_l2 {rel:.3e}"


def _gemv_row(label, kernel, plain, x, weights, out_bytes, faults=(), rel_bound=GEMV_REL_BOUND, library=None,
              before=None):
    """Hold one GEMV kernel call, kernel(x, *weights), to its plain version
    in fp32 on the same inputs (each output by relative L2), and time both
    as the decode meets them: device time from a CUDA graph (graph_ms) of
    one call on each of several copies of the weights that together exceed
    twice the L2 cache, so each call streams its weights from device memory. Each planted fault (label, call
    of x) must break the bound. `library`: (fn, its weights), one PyTorch
    call computing the same function (_library_row). `before`: an older
    kernel of the same function, held to the same bound and timed in turns
    with this one (before, kernel, kernel, before). Returns the row's
    numbers."""
    import torch

    from supir_tpu_torch.tools.timing import mean, turns

    out = kernel(x, *weights)
    want = plain(x.float(), *weights)
    rel = _worst_rel(out, want)
    err = max((g_ - w_).abs().max().item() for g_, w_ in zip(_outputs(out), _outputs(want)))
    w_bytes = nbytes(*weights)
    copies = _copies(weights, w_bytes)
    chain = [lambda c=c: kernel(x, *c) for c in copies]  # each copy once: a copy read twice in a row hits L2
    before_ms = before_note = None
    if before is not None:
        brel = _worst_rel(before(x, *weights), want)
        _check_rel(f"{label} (before)", brel, rel_bound)
        old = [lambda c=c: before(x, *c) for c in copies]
        t = turns({"before": old, "now": chain}, graph_ms)
        ms, before_ms = mean(t["now"]), mean(t["before"])
        before_note = (f"; before {t['before'][0]:.4f}, {t['before'][1]:.4f} ms, now {t['now'][0]:.4f}, "
                       f"{t['now'][1]:.4f} ms in turns ({before_ms / ms:.2f}x)")
    else:
        ms = graph_ms(chain)
    plain_ms = graph_ms([lambda c=c: plain(x, *c) for c in copies[:4]], replays=2)
    bound_ms, bound_by = bound(nbytes(x) + w_bytes + out_bytes)
    ref = max(w_.abs().max().item() for w_ in _outputs(want))
    del copies, chain
    torch.cuda.empty_cache()
    lib_ms, lib_note = _library_row(label, library, x, want, rel_bound) if library else (None, "none")
    log(f"[kernels] {label}: rel_l2 {rel:.3e} (bound {rel_bound:g}), max_abs_err {err:.3e}, "
        f"max|ref| {ref:.2f}; {ms:.4f} ms vs plain {plain_ms:.4f} ms (device, CUDA graph, "
        f"{int(2 * L2_BYTES // w_bytes) + 1} weight copies), bound {bound_ms:.4f} ms ({bound_by}, "
        f"{bound_ms / ms:.0%} of it){before_note or ''}; library "
        + (lib_note if lib_ms is None else f"{lib_ms:.4f} ms ({lib_note}, kernel {lib_ms / ms:.2f}x its speed)"))
    _check_rel(label, rel, rel_bound)
    for name, bad in faults:
        _check_fault(f"{label} {name}", _worst_rel(bad(x), want), rel_bound)
    return dict(max_abs_err=err, rel=rel, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_ms, before_ms=before_ms, library_note=lib_note)


def _check_int8_quantizer(label, w, seeds: int = 64):
    """K8 at one shape: nearest mode bit for bit with the plain version; in
    stochastic mode every value on floor or ceil of w / scale, the same seed
    the same bytes, the first design's bytes for 3 seeds, and the mean of q
    over `seeds` seeds within 7 sigma of w / scale everywhere (one draw's
    rounding error has variance <= 1/4); the cluster kernel and the first
    design timed in turns (new, old, old, new, CUDA events); the planted
    faults (one rank's maxima left out, the Philox words rotated, the tile
    loaded one column off) must change the bytes."""
    import torch

    from supir_tpu_torch.ops import quantize as Q
    from supir_tpu_torch.tools.timing import mean, turns

    plan = Q.int8_plan(*w.shape)
    placed = Q.int8_clusters(plan)
    q, s = Q.quantize_int8(w, stochastic=False)
    want_q, want_s = Q.quantize_int8_plain(w)
    mismatched = (q != want_q).sum().item() + (s != want_s).sum().item()
    scaled = w / s
    a = Q.quantize_int8(w, seed=11)[0]
    same_seed = torch.equal(a, Q.quantize_int8(w, seed=11)[0])
    off_grid = (~((a.float() == scaled.floor()) | (a.float() == scaled.ceil()))).sum().item()
    first_design = [torch.equal(Q.quantize_int8(w, seed=seed)[0], Q.quantize_int8_first_design(w, seed=seed)[0])
                    for seed in (SEED, 11, 2**40 + 3)]
    total = torch.zeros_like(w)
    for seed in range(seeds):
        total += Q.quantize_int8(w, seed=seed)[0].float()
    dev_ = total / seeds - scaled
    del total
    sigma = 0.5 / seeds ** 0.5
    worst, bias_ = dev_.abs().max().item(), dev_.mean().item()
    del dev_, scaled
    new = lambda: Q.quantize_int8(w, seed=1)   # noqa: E731
    old = lambda: Q.quantize_int8_first_design(w, seed=1)   # noqa: E731
    t = turns({"new": new, "old": old}, lambda f: cuda_ms(f, 10))
    ms, old_ms = mean(t["new"]), mean(t["old"])
    nearest_ms = cuda_ms(lambda: Q.quantize_int8(w, stochastic=False), 10)
    u = torch.rand(w.shape, generator=torch.Generator(device=w.device).manual_seed(0), device=w.device)
    plain_ms = cuda_ms(lambda: Q.quantize_int8_plain(w, u), 5)
    del u
    bound_ms, bound_by = bound(nbytes(w, q, s))
    log(f"[kernels] {label}: {plan.ranks} CTAs a cluster x {plan.tiles} tiles of {plan.cols} columns, {plan.rows} rows "
        f"a slice in {plan.nboxes} TMA boxes, {plan.smem} B shared, {placed} clusters placed at once; nearest mode "
        f"{mismatched} values differ from plain (bound 0); stochastic: {off_grid} off floor/ceil, same seed same "
        f"bytes {same_seed}, the first design's bytes for 3 seeds {first_design}, mean over {seeds} seeds: worst "
        f"|mean - w/scale| {worst:.4f} (bound 7 sigma = {7 * sigma:.4f}), mean deviation {bias_:.2e}")
    log(f"[kernels] {label}: in turns new {t['new'][0]:.4f}, old {t['old'][0]:.4f}, {t['old'][1]:.4f}, new "
        f"{t['new'][1]:.4f} ms "
        f"(first design {old_ms / ms:.2f}x the time); nearest {nearest_ms:.4f} ms; plain {plain_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms ({bound_by}, {bound_ms / ms:.1%} of it)")
    if mismatched or off_grid or not same_seed or not all(first_design) or not worst <= 7 * sigma or placed < 1:
        raise AssertionError(f"{label} fails its checks")
    first_q = Q.quantize_int8_first_design(w, seed=1)[0]
    for name, fault, seed, stochastic, want in (
            ("one rank's maxima left out", Q.Q8_FAULT_DROP_RANK, 0, False, want_q),
            ("the Philox words rotated", Q.Q8_FAULT_ROTATE_WORDS, 1, True, first_q),
            ("the tile loaded one column off", Q.Q8_FAULT_SHIFT_TILE, 0, False, want_q)):
        differ = (Q._launch_int8(w, seed, stochastic, plan, fault=fault)[0] != want).sum().item()
        log(f"[kernels] control ({label} {name}): {differ} bytes differ")
        if not differ:
            raise AssertionError(f"the byte check misses a planted fault ({label} {name})")
    return dict(max_abs_err=float(mismatched), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                before_ms=old_ms)


def _int8_library(q8, s8):
    """K7's function as one PyTorch call, torch._weight_int8pack_mm: the
    int8 weight as [N, K] and the scales in bf16 (the layout work done once,
    here). Its output is bf16."""
    import torch

    return (lambda xx, w_, s_: torch._weight_int8pack_mm(xx, w_, s_)), (q8.t().contiguous(),
                                                                       s8.reshape(-1).to(torch.bfloat16))


def _try_library(make, *args):
    """(fn, weights) from `make`, or None with the error logged when the op
    is missing or refuses the layout."""
    try:
        return make(*args)
    except (RuntimeError, AttributeError) as exc:
        log(f"[kernels] library yardstick {make.__name__}: none ({str(exc).splitlines()[0][:160]})")
        return None


def _pair_yardstick(tag, x, weights, siluglu1):
    """K9's yardstick, timed in turns with K9 (yardstick, K9, K9,
    yardstick) as _gemv_row times a kernel: the same products as two
    tensor-core K5 calls, glue(x) W1 s1 + residual and then RMSNorm(small)
    W2 s2 on small rounded to bf16 once, outside the timing (no single
    PyTorch call computes the pair). Held to the plain version; returns (K9
    ms, yardstick ms)."""
    import torch

    from supir_tpu_torch.ops import quantize as Q
    from supir_tpu_torch.tools.timing import turns

    want = Q.int4_paired_fused_pair_plain(x.float(), *weights, siluglu1=siluglu1)
    small_bf16 = want[0].to(torch.bfloat16)

    def two_k5(w):
        qp1, sc1, residual, gamma, qp2, sc2 = w
        return (Q.int4_paired_fused_matmul(x, qp1, sc1, siluglu=siluglu1, residual=residual),
                Q.int4_paired_fused_matmul(small_bf16, qp2, sc2, gamma=gamma))

    _check_rel(f"{tag} yardstick", _worst_rel(two_k5(weights), want), GEMV_REL_BOUND)
    copies = _copies(weights, nbytes(*weights))
    yard = [lambda c=c: two_k5(c) for c in copies]
    pair = [lambda c=c: Q.int4_paired_fused_pair(x, *c, siluglu1=siluglu1) for c in copies]
    t = turns({"yardstick": yard, "K9": pair}, graph_ms)
    (t_y, t_y2), (t_k, t_k2) = t["yardstick"], t["K9"]
    log(f"[kernels] {tag}: yardstick (two tensor-core K5 calls) {t_y:.4f}, {t_y2:.4f} ms, K9 {t_k:.4f}, "
        f"{t_k2:.4f} ms in turns")
    del copies, yard, pair
    torch.cuda.empty_cache()
    return (t_k + t_k2) / 2, (t_y + t_y2) / 2


def phase_quant_kernels():
    """K5 (also in its act_int8 mode), K6, K7 (int8 and half-split int4),
    K8, K10 and K11 at the 13B decode shapes, and K9 at the layer's two
    pairs, for 1 and 8 rows, all but K6 also 32; K5 (both modes), K7, K9,
    K10 and K11 in turns with the strip body they replaced (K9 also with its
    two-K5 yardstick, _pair_yardstick); K10 as the
    kernel alone on int8 x (its JSON row) and as its wrapper with the torch
    activation quantizer; the library yardsticks of K6, K7 (int8 and int4)
    and K11. Returns each kernel's JSON numbers, its times summed over one
    layer's projections (K9: its two pairs) at 1 row (the main path's)."""
    import gc

    import torch

    from supir_tpu_torch.ops import gemv_plan as GP, quantize as Q
    from supir_tpu_torch.tools.timing import tinygemm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)
    names = ("K5", "K5-act", "K6", "K7", "K7-int4", "K8", "K9", "K10", "K11")
    layer = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_by="bytes", library_ms=0.0)
             for k in names}
    by_rows = {}  # (kernel, rows) -> [ms, before ms, bound ms] over the layer
    wrapper = {}  # rows -> K10's wrapper (quantizer + kernel) ms over the layer

    def add(name, row, rows=1):
        if rows == 1:
            acc = layer[name]
            acc["max_abs_err"] = max(acc["max_abs_err"], row["max_abs_err"])
            for key in ("ms", "plain_ms", "bound_ms"):
                acc[key] += row[key]
            lib = row.get("library_ms")
            acc["library_ms"] = None if lib is None or acc["library_ms"] is None else acc["library_ms"] + lib
        if row.get("before_ms") is not None:
            acc = by_rows.setdefault((name, rows), [0.0, 0.0, 0.0])
            for i, key in enumerate(("ms", "before_ms", "bound_ms")):
                acc[i] += row[key]

    def tc_faults(mode, cin, rows, cout, call, **kw):
        """The tensor-core body's planted faults (gemv_plan.FAULT_*; W4A8's
        row scale applied twice besides, launched through _launch_w4a8 with
        K10's row scales kw["xs"] or none), and two runs bit-identical."""
        first = call()
        if not torch.equal(first, call()):
            raise AssertionError(f"two runs of the tensor-core GEMV ({mode}, {rows} rows, cout {cout}) differ")
        faults = [("one share dropped", GP.FAULT_DROP_SHARE), ("x' staged in the wrong k order", GP.FAULT_X_ORDER)]
        if mode == "w4a8":
            faults.append(("row scale applied twice", GP.FAULT_ROW_SCALE))
        launch_rows = min(rows, GP.TC_W4A8_ROWS) if mode == "w4a8" else rows   # W4A8: 16 rows a launch
        if GP.tc_plan(mode, launch_rows, cin, cout,
                      torch.cuda.get_device_properties(dev).multi_processor_count).slices > 1:
            faults.append(("combine run twice", GP.FAULT_COMBINE_TWICE))
        args = (kw.get("gamma"), 1e-6, kw.get("prologue", 0), kw.get("residual"))
        if mode == "w4a8":
            return [(name, lambda xx, f=f: Q._launch_w4a8(xx, kw.get("xs"), *kw["weights"], *args, _fault=f))
                    for name, f in faults]
        return [(name, lambda xx, f=f: Q._launch_gemv(xx, *kw["weights"], mode, cin, *args, _fault=f))
                for name, f in faults]

    def same_bits(label, got, want):
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: the tensor-core body differs from the strip body "
                                 f"(max |diff| {(got - want).abs().max().item():.3e})")
        log(f"[kernels] {label}: equal to the strip body bit for bit")

    paired = {}
    for proj, cin, cout, prologue, with_residual in LLAMA_13B_SHAPES:
        w = torch.randn(cin, cout, generator=g, device=dev) * cin ** -0.5
        packed, scale = paired[proj] = Q.quantize_int4_paired(w)
        q4, s4 = Q.quantize_int4(w)
        qn, sn = Q.quantize_int4_native(w)
        add("K8", _check_int8_quantizer(f"K8 {proj} [{cin},{cout}] fp32", w))
        q8, s8 = Q.quantize_int8(w, seed=SEED)
        del w
        lib8 = _try_library(_int8_library, q8, s8)
        lib4 = _try_library(tinygemm, Q.unpack_int4_paired(packed), scale)
        for rows in (1, 8, 32):
            xin = 2 * cin if prologue == "siluglu" else cin
            x = torch.randn(rows, xin, generator=g, device=dev).to(torch.bfloat16)
            xg = x[:, :cin].contiguous()
            gamma = 1.0 + 0.1 * torch.randn(cin, generator=g, device=dev) if prologue == "norm" else None
            residual = torch.randn(rows, cout, generator=g, device=dev) if with_residual else None
            kw = dict(gamma=gamma, siluglu=prologue == "siluglu", residual=residual)
            out_bytes = rows * cout * 4
            tag = f"{proj} [{rows},{cin}]->[{rows},{cout}]"
            swapped = ("nibble order swapped", lambda xx: Q.int4_paired_fused_matmul(
                xx, _swap_nibbles(packed), scale, **kw))
            pro = 1 if gamma is not None else (2 if kw["siluglu"] else 0)
            faults = [swapped] + tc_faults("paired", cin, rows, cout,
                                           lambda: Q.int4_paired_fused_matmul(x, packed, scale, **kw),
                                           weights=(packed, scale), gamma=gamma, prologue=pro, residual=residual)
            if gamma is not None:
                faults.append(("RMSNorm without gamma", lambda xx: Q.int4_paired_fused_matmul(
                    xx, packed, scale, **dict(kw, gamma=torch.ones_like(gamma)))))
            extra = nbytes(gamma, residual)
            row = _gemv_row(f"K5 {tag} prologue {prologue} residual {with_residual}",
                            lambda xx, p, sc: Q.int4_paired_fused_matmul(xx, p, sc, **kw),
                            lambda xx, p, sc: Q.int4_paired_fused_matmul_plain(xx, p, sc, **kw), x,
                            (packed, scale), out_bytes + extra, faults,
                            before=lambda xx, p, sc: Q.strip_body_gemv(xx, p, sc, "paired", **kw))
            add("K5", row, rows)
            if lib4 is not None:
                # no torch call fuses the prologue: tinygemm on the same weights without it
                lib_ms, note = _library_row(f"K5 {tag} tinygemm", lib4, xg,
                                            Q.int4_paired_matmul_plain(xg.float(), packed, scale), GEMV_REL_BOUND)
                log(f"[kernels] K5 {tag}: tinygemm on the same weights without the prologue "
                    + (note if lib_ms is None else f"{lib_ms:.4f} ms ({note}); K5 {row['ms']:.4f} ms"))
            want8 = Q.qmm_plain(xg.float(), q8, s8, 8)
            row = _gemv_row(f"K7 int8 {tag}", Q.int8_matmul, lambda xx, q, sc: Q.qmm_plain(xx, q, sc, 8), xg,
                            (q8, s8), out_bytes,
                            tc_faults("int8", cin, rows, cout, lambda: Q.int8_matmul(xg, q8, s8), weights=(q8, s8)),
                            library=lib8, before=lambda xx, q, sc: Q.strip_body_gemv(xx, q, sc, "int8"))
            del want8
            add("K7", row, rows)
            row = _gemv_row(f"K11 {tag}", Q.int4_native_matmul, Q.int4_native_matmul_plain, xg, (qn, sn), out_bytes,
                            [("column nibbles swapped", lambda xx: Q.int4_native_matmul(xx, _swap_nibbles(qn), sn))]
                            + tc_faults("native", cin, rows, cout, lambda: Q.int4_native_matmul(xg, qn, sn),
                                        weights=(qn, sn)),
                            library=lib4, before=lambda xx, q, sc: Q.strip_body_gemv(xx, q, sc, "native"))
            add("K11", row, rows)
            row = _gemv_row(f"K7 int4 half-split {tag}", Q.int4_matmul, lambda xx, q, sc: Q.qmm_plain(xx, q, sc, 4),
                            xg, (q4, s4), out_bytes,
                            [("halves swapped", lambda xx: Q.int4_matmul(xx, _swap_nibbles(q4), s4))]
                            + tc_faults("half", cin, rows, cout, lambda: Q.int4_matmul(xg, q4, s4), weights=(q4, s4)),
                            library=lib4, before=lambda xx, q, sc: Q.strip_body_gemv(xx, q, sc, "half"))
            add("K7-int4", row, rows)
            act_faults = [("nibble order swapped", lambda xx: Q.int4_paired_fused_matmul(
                xx, _swap_nibbles(packed), scale, act_int8=True, **kw))]
            if gamma is not None:
                # the activation quantized after bf16 rounding of an RMSNorm without gamma
                act_faults.append(("quantized after bf16 rounding of RMSNorm without gamma",
                                   lambda xx: Q.int4_w4a8_matmul(Q._prologue(xx, cin, torch.ones_like(gamma), 1e-6,
                                                                             False).to(xx.dtype), packed, scale)))
            act_faults += tc_faults("w4a8", cin, rows, cout,
                                    lambda: Q.int4_paired_fused_matmul(x, packed, scale, act_int8=True, **kw),
                                    weights=(packed, scale), gamma=gamma, prologue=pro, residual=residual)
            row = _gemv_row(f"K5 act_int8 {tag} prologue {prologue} residual {with_residual}",
                            lambda xx, p, sc: Q.int4_paired_fused_matmul(xx, p, sc, act_int8=True, **kw),
                            lambda xx, p, sc: Q.int4_paired_fused_matmul_plain(xx, p, sc, act_int8=True, **kw), x,
                            (packed, scale), out_bytes + extra, act_faults,
                            before=lambda xx, p, sc: Q.strip_body_w4a8(xx, None, p, sc, **kw))
            add("K5-act", row, rows)
            if prologue is None:
                same_bits(f"K5 act_int8 {tag}", Q.int4_paired_fused_matmul(x, packed, scale, act_int8=True, **kw),
                          Q.strip_body_w4a8(x, None, packed, scale, **kw))
            # K10: the kernel alone on the int8 x and row scales the wrapper's
            # torch quantizer makes (the JSON row), then the wrapper
            xq, xs = Q.quantize_act_int8(xg)
            row = _gemv_row(f"K10 kernel {tag}", lambda xx, p, sc: Q._launch_w4a8(xx, xs, p, sc),
                            lambda xx, p, sc: Q.w4a8_gemv_plain(xx, xs, p, sc), xq, (packed, scale),
                            out_bytes + nbytes(xs),
                            [("activation scale without 1/127", lambda xx: Q._launch_w4a8(xx, xs, packed, scale) * 127),
                             ("nibble order swapped", lambda xx: Q._launch_w4a8(xx, xs, _swap_nibbles(packed), scale))]
                            + tc_faults("w4a8", cin, rows, cout, lambda: Q._launch_w4a8(xq, xs, packed, scale),
                                        weights=(packed, scale), xs=xs),
                            rel_bound=W4A8_REL_BOUND, before=lambda xx, p, sc: Q.strip_body_w4a8(xx, xs, p, sc))
            add("K10", row, rows)
            same_bits(f"K10 {tag}", Q._launch_w4a8(xq, xs, packed, scale), Q.strip_body_w4a8(xq, xs, packed, scale))
            row = _gemv_row(f"K10 wrapper (torch quantizer + kernel) {tag}", Q.int4_w4a8_matmul,
                            Q.int4_w4a8_matmul_plain, xg, (packed, scale), out_bytes,
                            [("nibble order swapped", lambda xx: Q.int4_w4a8_matmul(xx, _swap_nibbles(packed), scale))],
                            rel_bound=W4A8_REL_BOUND)
            wrapper[rows] = wrapper.get(rows, 0.0) + row["ms"]
            if rows == 32:
                continue
            row = _gemv_row(f"K6 {tag}", Q.int4_paired_matmul, Q.int4_paired_matmul_plain, xg, (packed, scale),
                            out_bytes,
                            [("nibble order swapped",
                              lambda xx: Q.int4_paired_matmul(xx, _swap_nibbles(packed), scale))]
                            + tc_faults("paired", cin, rows, cout, lambda: Q.int4_paired_matmul(xg, packed, scale),
                                        weights=(packed, scale)),
                            library=lib4)
            add("K6", row, rows)
        del q4, q8, qn, lib8, lib4
    yard = {}  # rows -> [K9 ms, its yardstick's ms] over the layer's two pairs, in turns
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, first, second, siluglu1 in LLAMA_13B_PAIRS:
        (qp1, sc1), (qp2, sc2) = paired[first], paired[second]
        cin1, cout1, cout2 = 2 * qp1.shape[0], qp1.shape[1], qp2.shape[1]
        for rows in (1, 8, 32):
            x = torch.randn(rows, 2 * cin1 if siluglu1 else cin1, generator=g, device=dev).to(torch.bfloat16)
            residual = torch.randn(rows, cout1, generator=g, device=dev)
            gamma = 1.0 + 0.1 * torch.randn(cout1, generator=g, device=dev)
            weights = (qp1, sc1, residual, gamma, qp2, sc2)
            if not GP.tc_pair_eligible(rows, cin1, cout1, cout2, qp1.data_ptr(), qp2.data_ptr(), x.data_ptr(),
                                       x.stride(0)):
                raise AssertionError(f"K9 at {rows} rows, {cin1} -> {cout1} -> {cout2} misses the tensor-core pair")
            tag = f"K9 pair {label} [{rows},{x.shape[1]}]->[{rows},{cout1}]->[{rows},{cout2}]"
            first_out = Q.int4_paired_fused_pair(x, *weights, siluglu1=siluglu1)
            again = Q.int4_paired_fused_pair(x, *weights, siluglu1=siluglu1)
            if not all(torch.equal(a_, b_) for a_, b_ in zip(first_out, again)):
                raise AssertionError(f"{tag}: two runs differ")
            # one strip's statistics: strip 0's sums of squares alone (a mean over 32 columns,
            # `_norm_cols=32`, can fall near the row's: on pair B at one row it moved big by 3.07e-3)
            pair_faults = [("phase 2 normalised by one strip's statistics", GP.FAULT_ONE_STRIP),
                           ("phase 2 staged without waiting for phase 1 (stale small)", GP.FAULT_STALE_SMALL),
                           ("one share dropped", GP.FAULT_DROP_SHARE),
                           ("x' staged in the wrong k order", GP.FAULT_X_ORDER)]
            if GP.tc_pair_plan(rows, cin1, cout1, cout2, sms).first.slices > 1:
                pair_faults.append(("phase 1's combine run twice", GP.FAULT_COMBINE_TWICE))
            row = _gemv_row(
                tag, lambda xx, *wt: Q.int4_paired_fused_pair(xx, *wt, siluglu1=siluglu1),
                lambda xx, *wt: Q.int4_paired_fused_pair_plain(xx, *wt, siluglu1=siluglu1), x, weights,
                rows * (cout1 + cout2) * 4,
                [("nibble order swapped", lambda xx: Q.int4_paired_fused_pair(
                     xx, qp1, sc1, residual, gamma, _swap_nibbles(qp2), sc2, siluglu1=siluglu1))]
                + [(name, lambda xx, f=f: Q.int4_paired_fused_pair(xx, *weights, siluglu1=siluglu1, _fault=f))
                   for name, f in pair_faults],
                before=lambda xx, *wt: Q.strip_body_pair(xx, *wt, siluglu1=siluglu1))
            log(f"[kernels] {tag}: two runs bit-identical")
            add("K9", row, rows)
            acc = yard.setdefault(rows, [0.0, 0.0])
            for i, ms in enumerate(_pair_yardstick(tag, x, weights, siluglu1)):
                acc[i] += ms
    w = torch.randn(5120, 32000, generator=g, device=dev) * 5120 ** -0.5
    _check_int8_quantizer("K8 the int8 head [5120,32000] fp32", w)
    del w
    for rows, (ms, yard_ms) in sorted(yard.items()):
        log(f"[kernels] K9 over one 13B layer's two pairs at {rows} rows, in turns with its yardstick (the same "
            f"products as two tensor-core K5 calls a pair): K9 {ms:.4f} ms, yardstick {yard_ms:.4f} ms "
            f"(K9 {yard_ms / ms:.2f}x its speed)")
    del paired
    gc.collect()  # the fault closures hold weights in reference cycles
    torch.cuda.empty_cache()
    for name in names:
        r = layer[name]
        what = "two pairs" if name == "K9" else "four projections"
        lib = "" if r["library_ms"] is None or not r["library_ms"] else f", library {r['library_ms']:.4f} ms"
        log(f"[kernels] {name} over one 13B layer's {what} (1 row): {r['ms']:.4f} ms vs plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, {r['bound_ms'] / r['ms']:.1%} "
            f"of it){lib}; x40 layers: {40 * r['ms']:.3f} ms, bound {40 * r['bound_ms']:.3f} ms")
        if name in ("K5", "K8", "K9", "K10", "K5-act") or not r["library_ms"]:
            r["library_ms"] = None   # no torch call computes the function (or it refused a projection)
    for (name, rows), (ms, before_ms, bound_ms) in sorted(by_rows.items()):
        log(f"[kernels] {name} over one 13B layer at {rows} rows: {ms:.4f} ms (the design before it, in turns, "
            f"{before_ms:.4f} ms, {before_ms / ms:.2f}x), bound {bound_ms:.4f} ms, {bound_ms / ms:.1%} of it; "
            f"{ms / by_rows[(name, 1)][0]:.2f}x its 1-row time")
    for rows, ms in sorted(wrapper.items()):
        log(f"[kernels] K10 over one 13B layer at {rows} rows: the kernel {by_rows[('K10', rows)][0]:.4f} ms, its "
            f"wrapper (torch activation quantizer + kernel) {ms:.4f} ms")
    return layer


def _inputs(cfg, size: int, device, seed: int):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand(1, size, size, 3, generator=g, device=device) * 2 - 1
    c = {"crossattn": torch.randn(1, 77, cfg.unet.context_dim, generator=g, device=device),
         "vector": torch.randn(1, cfg.unet.adm_in_channels, generator=g, device=device)}
    uc = {k: torch.randn(v.shape, generator=g, device=device) for k, v in c.items()}
    return x, c, uc


SAMPLE_KW = dict(restoration_scale=4.0, cfg_scale=4.0, use_linear_cfg=True,
                 cfg_scale_start=7.5, s_churn=5.0, color_fix_type="Wavelet")


def _instrument(engine, times):
    """Wrap the engine's stage methods so each call records its synchronized
    wall time under `times[name]` (a list, one entry per call)."""
    import torch

    import supir_tpu_torch.engine.supir as engine_module

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            times.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return wrapper

    engine.encode_first_stage_with_denoise = timed("stage1_encode", engine.encode_first_stage_with_denoise)
    engine.decode_first_stage = timed("decode", engine.decode_first_stage)
    engine.encode_first_stage = timed("center_encode", engine.encode_first_stage)
    engine._network = timed("network", engine._network)
    original = engine_module.wavelet_reconstruction
    engine_module.wavelet_reconstruction = timed("colorfix", original)
    return lambda: setattr(engine_module, "wavelet_reconstruction", original)


def phase_main(steps: int, repeat: int):
    import torch

    from supir_tpu_torch.config import SUPIRConfig
    from supir_tpu_torch.engine.factory import create_engine
    from supir_tpu_torch.ops.flash_attention import flash_attention
    from supir_tpu_torch.ops.groupnorm import group_norm

    cfg = SUPIRConfig()  # XL-base, bf16 for the VAE and the diffusion model
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    engine = create_engine(cfg, dev, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in engine.model.parameters())
    log(f"[main] full-width engine: {n_params / 1e9:.3f} B params ({cfg.diffusion_dtype}), "
        f"random init on the card {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    x, c, uc = _inputs(cfg, SIZE, dev, SEED + 1)

    def run():
        z = engine.encode_first_stage_with_denoise(x)
        return engine.batchify_sample(x, dict(c, control=z), dict(uc, control=z),
                                      num_steps=steps, seed=SEED, z_override=z, **SAMPLE_KW)

    # warm-up (cuDNN algorithm choice), which also holds K1 at every site
    # to the fp32 plain version on that site's inputs and counts the K2
    # calls by shape
    k2_shapes = collections.Counter()

    def k2_by_shape(x, *args):
        k2_shapes[(tuple(x.shape), str(x.dtype).replace("torch.", ""))] += 1
        return group_norm(x, *args)

    t0 = time.perf_counter()
    with kernels_at_sites(flash_attention, k2_by_shape) as site_rel:
        run()
    torch.cuda.synchronize()
    log(f"[main] warm-up run {time.perf_counter() - t0:.2f} s; K1 at its {len(site_rel)} site calls vs "
        f"fp32 plain: worst rel_l2 {max(site_rel):.3e} (bound {K1_REL_BOUND:g})")
    log("[main] K2 calls of one run by shape: " + ", ".join(
        f"{list(shape)} {dtype} x{n}" for (shape, dtype), n in sorted(k2_shapes.items(), key=lambda kv: -kv[1])))
    if not max(site_rel) <= K1_REL_BOUND:
        raise AssertionError(f"K1 disagrees with its plain version on the main path: rel_l2 {max(site_rel)}")

    torch.cuda.reset_peak_memory_stats()
    for i in range(repeat):
        # the headline's form: one synchronisation at the end, none per stage
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        log(f"[main] headline run {i + 1}/{repeat}: {time.perf_counter() - t0:.4f} s for {SIZE}^2, "
            f"{steps} RestoreEDM steps; peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    times: dict = {}
    restore = _instrument(engine, times)
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    group_norm.launches = 0
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {"K1": flash_attention.launches, "K2": group_norm.launches}
    restore()

    decode = times["decode"]
    stages = {
        "stage1_encode": times["stage1_encode"][0],
        "stage1_decode": decode[0],
        "center_encode": times["center_encode"][0],
        "sampling": total - sum(sum(v) for k, v in times.items() if k != "network"),
        "final_decode": decode[1],
        "colorfix": times["colorfix"][0],
    }
    for name, sec in stages.items():
        log(f"[main] stage {name}: {sec:.3f} s")
    log(f"[main] network call (CFG batch 2): mean {sum(times['network']) / len(times['network']):.3f} s "
        f"over {len(times['network'])} steps")
    log(f"[main] total {total:.3f} s for {SIZE}^2, {steps} RestoreEDM steps "
        f"(stage 1 + sampling + decode + colour fix; text towers excluded); "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    if tuple(out.shape) != (1, SIZE, SIZE, 3):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    if not torch.isfinite(out).all():
        raise AssertionError("output has non-finite values")
    log(f"[main] output {list(out.shape)} finite, range [{out.min().item():.3f}, {out.max().item():.3f}]")

    lat = SIZE // cfg.vae.downscale_factor
    # the counted run holds four VAE passes: stage-1 encode and decode,
    # the x_center encode, the final decode
    want_k1 = expected_flash_launches(cfg, lat, steps, vae_passes=4)
    want_k2 = expected_group_norm_launches(cfg, steps, vae_passes=4)
    k2_sites = expected_group_norm_launches(cfg, 1, vae_passes=0)
    log(f"[main] launches: K1 {launches['K1']} (expected {expected_flash_sites(cfg, lat)} sites x "
        f"{steps} steps + {want_k1 - expected_flash_sites(cfg, lat) * steps} VAE = {want_k1}), "
        f"K2 {launches['K2']} (expected {k2_sites} sites x {steps} steps + {want_k2 - k2_sites * steps} VAE = "
        f"{want_k2}; the warm-up's calls {sum(k2_shapes.values())})")
    if launches["K1"] != want_k1:
        raise AssertionError(f"K1 launched {launches['K1']} times, expected {want_k1}")
    if not launches["K2"] == want_k2 == sum(k2_shapes.values()):
        raise AssertionError(f"K2 launched {launches['K2']} times, expected {want_k2}")
    del engine, out
    torch.cuda.empty_cache()
    return launches


def _randomize_all(model, seed: int):
    """Fill every parameter, zero-initialised layers included, so that the
    whole network reaches the output (and, in training, every leaf gets a
    gradient from the first step). Draws on the parameters' device."""
    import torch

    device = next(model.parameters()).device
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=g, device=device)
            if p.dim() > 1:
                p.copy_(noise * p[0].numel() ** -0.5)
            elif name.endswith("weight"):
                p.copy_(1.0 + 0.1 * noise)
            else:
                p.copy_(0.1 * noise)


def _reduced_cfg():
    """The references' reduced width: model_channels 128, transformer depth
    1 per level, 64-wide heads, context and ADM 256, VAE ch 32. At 512^2 its
    32^2 level's self-attention (1024 tokens) still reaches flash attention."""
    from supir_tpu_torch.config import ControlConfig, SUPIRConfig, UNetConfig, VAEConfig

    unet = dataclasses.replace(UNetConfig(), model_channels=128, transformer_depth=(1, 1, 1),
                               context_dim=256, adm_in_channels=256)
    return SUPIRConfig(unet=unet, vae=VAEConfig().tiny(), control=ControlConfig().scaled_for(unet))


def _reduced_cond_cfg():
    """The references' text conditioner: CLIP-L-like (quick-GELU) and
    bigG-like (exact GELU) towers 128 wide in two 64-wide heads, 2 and 3
    layers; crossattn 128 + 128 and vector 64 + 6 x 32, the reduced UNet's
    context and ADM widths."""
    from supir_tpu_torch.config import CLIPTextConfig, ConditionerConfig

    return ConditionerConfig(
        clip_l=CLIPTextConfig(width=128, layers=2, heads=2),
        clip_bigg=CLIPTextConfig(width=128, layers=3, heads=2, use_quick_gelu=False, projection_dim=64),
        clip_l_hidden_layer=1, vector_outdim=32)


def _reference_conditioning(cfg, cpu_engine, gpu_engine):
    """The card's bf16 prepare_condition against the CPU's fp32 one on the
    same weights and token ids (the config's prompts through the tokenizer);
    bigG's last hidden state in place of its penultimate one must break the
    bound."""
    import torch

    from supir_tpu_torch.utils.tokenizer import tokenize

    tok, tok_n = tokenize([cfg.p_p]), tokenize([cfg.n_p])
    z = torch.randn(1, 64, 64, 4, generator=torch.Generator().manual_seed(SEED + 4))
    want = cpu_engine.prepare_condition(z, tok, tok, tok_n, tok_n)

    def worst(engine):
        got = engine.prepare_condition(z.cuda(), tok, tok, tok_n, tok_n)
        return max(rel_l2(g[k].cpu(), w[k]) for g, w in zip(got, want) for k in ("crossattn", "vector"))

    rel = worst(gpu_engine)
    tower = gpu_engine.model.conditioner.clip_bigg
    sound = tower.forward

    def last_for_penultimate(ids):
        out = sound(ids)
        out["hidden"] = out["hidden"][:-2] + [out["hidden"][-1]] * 2
        return out

    tower.forward = last_for_penultimate
    try:
        bad = worst(gpu_engine)
    finally:
        del tower.forward
    log(f"[reference] text conditioning (towers 128 wide, 2 + 3 layers; crossattn {cpu_engine.cond_cfg.context_dim}, "
        f"vector {cpu_engine.cond_cfg.adm_dim}): card bf16 vs CPU fp32 worst rel_l2 {rel:.4f} (bound "
        f"{REF_REL_BOUND:g}); control (bigG hidden[-1] for hidden[-2]): {bad:.4f}")
    if not rel <= REF_REL_BOUND:
        raise AssertionError(f"prepare_condition: card and CPU disagree, rel_l2 {rel}")
    if not bad > REF_REL_BOUND:
        raise AssertionError(f"the conditioning bound misses bigG's last hidden state: rel_l2 {bad}")


def phase_reference():
    import torch

    from supir_tpu_torch.engine.factory import build_model, create_engine
    from supir_tpu_torch.engine.supir import SUPIREngine
    from supir_tpu_torch.ops.flash_attention import flash_attention
    from supir_tpu_torch.ops.groupnorm import group_norm

    cfg = _reduced_cfg()
    cond = _reduced_cond_cfg()
    size = 512
    cpu_cfg = dataclasses.replace(cfg, ae_dtype="fp32", diffusion_dtype="fp32")
    cpu_model = build_model(cpu_cfg, "cpu", seed=SEED, cond_cfg=cond)
    _randomize_all(cpu_model, SEED)
    cpu_engine = SUPIREngine(cpu_cfg, cpu_model)
    gpu_engine = create_engine(cfg, "cuda", state_dict=cpu_model.state_dict(), cond_cfg=cond)
    _reference_conditioning(cfg, cpu_engine, gpu_engine)

    x, c, uc = _inputs(cfg, size, torch.device("cpu"), SEED + 2)
    g = torch.Generator().manual_seed(SEED + 3)
    lat = size // cfg.vae.downscale_factor
    noise = torch.randn(1, lat, lat, 4, generator=g)
    center = torch.randn(1, lat, lat, 4, generator=g)
    kw = dict(SAMPLE_KW, s_churn=0.0, num_steps=2, noise_override=noise, center_noise_override=center)

    z = cpu_engine.encode_first_stage_with_denoise(x)
    t0 = time.perf_counter()
    want = cpu_engine.batchify_sample(x, dict(c, control=z), dict(uc, control=z), z_override=z, **kw)
    cpu_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    cg = {k: v.to(dev) for k, v in c.items()}
    ug = {k: v.to(dev) for k, v in uc.items()}
    zg = z.to(dev)

    def card(k1=flash_attention, k2=group_norm):
        with kernels_at_sites(k1, k2) as site_rel:
            out = gpu_engine.batchify_sample(x.to(dev), dict(cg, control=zg), dict(ug, control=zg),
                                             z_override=zg, **kw).cpu()
        return out, max(site_rel)

    flash_attention.launches = 0
    got, site_rel = card()
    k1 = flash_attention.launches
    # z comes from outside the counted run, which then holds three VAE
    # passes: stage-1 decode, x_center encode, final decode
    want_k1 = expected_flash_launches(cfg, lat, 2, vae_passes=3)
    err = (got - want).abs().max().item()
    rel = rel_l2(got, want)
    log(f"[reference] reduced width (model_channels 128, 64-wide heads, VAE ch 32), {size}^2, 2 steps, "
        f"all weights random: card bf16 vs CPU fp32 ({cpu_s:.1f} s): max_abs_err {err:.4f}, "
        f"rel_l2 {rel:.4f} (bound {REF_REL_BOUND:g}); K1 launches {k1} (expected {want_k1}), "
        f"worst site vs fp32 plain rel_l2 {site_rel:.3e} (bound {K1_REL_BOUND:g})")
    if not (rel <= REF_REL_BOUND and math.isfinite(err) and site_rel <= K1_REL_BOUND):
        raise AssertionError(f"card and CPU disagree: rel_l2 {rel}, K1 site rel_l2 {site_rel}")
    if k1 != want_k1:
        raise AssertionError(f"reference run launched K1 {k1} times, expected {want_k1}")

    # Planted faults, each a kernel gone wrong at every site. K2 dropping its
    # fused SiLU must break the end-to-end bound. K1 using exp2 without the
    # log2(e) fold (its softmax at ln 2 of the temperature) moves the image
    # less than bf16 itself does (rel_l2 0.037 against 0.024 on an H100), so
    # it must break the per-site bound instead.
    bad, _ = card(k2=lambda x, w, b, groups=32, eps=1e-5, silu=False: group_norm(x, w, b, groups, eps, False))
    bad_rel = rel_l2(bad, want)
    log(f"[reference] control (K2 without SiLU): rel_l2 {bad_rel:.4f}, "
        f"max_abs_err {(bad - want).abs().max().item():.4f}")
    if not bad_rel > REF_REL_BOUND:
        raise AssertionError(f"the reference bound misses K2 without SiLU: rel_l2 {bad_rel}")
    bad, bad_site = card(k1=lambda q, k, v, causal=False: flash_attention(
        (q.float() * math.log(2)).to(q.dtype), k, v, causal=causal))
    log(f"[reference] control (K1 exp2 without log2(e)): rel_l2 {rel_l2(bad, want):.4f}, "
        f"worst site rel_l2 {bad_site:.3e}")
    if not bad_site > K1_REL_BOUND:
        raise AssertionError(f"the K1 site bound misses exp2 without log2(e): rel_l2 {bad_site}")


def _tiny_llava_dir(path: str) -> None:
    """An HF-layout llava directory at tiny widths (every one a multiple of
    16, so K5 takes the tensor-core body): config.json with its
    vision_config, and the port's own random tiny model's weights under
    HF's keys in model.safetensors."""
    from safetensors.torch import save_file

    from supir_tpu_torch.captioner.agent import CaptionerConfig, create_captioner

    cfg = CaptionerConfig.tiny()
    model = create_captioner(cfg, "cpu", seed=SEED + 6).model
    save_file({k: v.contiguous() for k, v in model.state_dict().items()}, f"{path}/model.safetensors")
    l, v = cfg.llama, cfg.vision
    with open(f"{path}/config.json", "w") as f:
        json.dump({"vocab_size": l.vocab_size, "hidden_size": l.dim, "num_hidden_layers": l.layers,
                   "num_attention_heads": l.heads, "num_key_value_heads": l.kv_heads,
                   "intermediate_size": l.hidden_dim, "max_position_embeddings": 2048,
                   "vision_config": {"image_size": v.image_size, "patch_size": v.patch_size,
                                     "hidden_size": v.width, "num_hidden_layers": v.layers,
                                     "num_attention_heads": v.heads}}, f)


def phase_cli(steps: int, smi: str):
    """The batch CLI, `supir_tpu_torch.apps.cli.main`, in-process at full
    width (options/SUPIR_v0.yaml, XL-base, bf16, random weights): a
    768x1152 PNG restored at 1024x1536 with --no_llava, then again with the
    tiny captioner (--load_4bit_llava, LLAVA_MODEL_PATH at a directory this
    phase writes). K1 and K2 must launch as the config says on the first
    run's path: per step the network's sites, and the VAE's over the CLI's
    two encodes (stage 1, x_center) and three decodes (stage 1, the
    sampler's own stage-1 decode under z_override, the final one); K5 must
    launch in the second. Returns the first run's launches."""
    import os
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from supir_tpu_torch.apps import cli
    from supir_tpu_torch.config import load_yaml_config
    from supir_tpu_torch.ops import quantize as Q
    from supir_tpu_torch.ops.flash_attention import flash_attention
    from supir_tpu_torch.ops.groupnorm import group_norm
    from supir_tpu_torch.utils.image import pil_to_array

    opt = "options/SUPIR_v0.yaml"
    cfg, _ = load_yaml_config(opt)
    h, w = CLI_PNG
    g = torch.Generator().manual_seed(SEED + 7)
    photo = Image.fromarray(torch.randint(0, 256, (h, w, 3), generator=g, dtype=torch.uint8).numpy())
    model_h, model_w = pil_to_array(photo, min_size=1024)[0].shape[:2]
    f = cfg.vae.downscale_factor
    lat = (model_h // f, model_w // f)
    with tempfile.TemporaryDirectory() as tmp:
        img_dir, out_dir, llava = (os.path.join(tmp, d) for d in ("in", "out", "llava"))
        for d in (img_dir, llava):
            os.makedirs(d)
        photo.save(os.path.join(img_dir, "photo.png"))
        argv = ["--img_dir", img_dir, "--save_dir", out_dir, "--opt", opt, "--random_weights",
                "--edm_steps", str(steps)]

        flash_attention.launches = 0
        group_norm.launches = 0
        t0 = time.perf_counter()
        rec, = cli.main(argv + ["--no_llava"])
        total = time.perf_counter() - t0
        launches = {"K1": flash_attention.launches, "K2": group_norm.launches}
        _free()
        out = np.asarray(Image.open(rec["saved"][0]))
        t = rec["timings"]
        log(f"[cli] {smi}: {opt}, {h}x{w} PNG -> {model_h}x{model_w} model image, "
            f"{steps} RestoreEDM steps, --no_llava: stage1 {t['stage1']:.3f} s, tokenize {t['tokenize']:.3f} s "
            f"(the process's first: it looks for HF's CLIP tokenizer once), conditioning {t['cond']:.3f} s, "
            f"sample {t['sample']:.3f} s, save {t['save']:.3f} s; main() {total:.2f} s with the engine's "
            f"random init")
        if out.shape != (h, w, 3) or out.std() == 0:
            raise AssertionError(f"[cli] saved PNG {out.shape}, std {out.std()}")
        want_k1 = expected_flash_launches(cfg, lat, steps, vae_passes=5)
        want_k2 = expected_group_norm_launches(cfg, steps, encodes=2, decodes=3)
        log(f"[cli] saved {out.shape[0]}x{out.shape[1]} PNG (the input's size x --upscale 1); launches: K1 "
            f"{launches['K1']} (expected {expected_flash_sites(cfg, lat)} sites x {steps} steps at the "
            f"{lat[0]}x{lat[1]} latent = {want_k1}), K2 {launches['K2']} (expected {want_k2})")
        if launches != {"K1": want_k1, "K2": want_k2}:
            raise AssertionError(f"[cli] launches {launches}, expected K1 {want_k1}, K2 {want_k2}")

        _tiny_llava_dir(llava)
        prompts = []
        tokenize = cli.tokenize
        cli.tokenize = lambda texts: prompts.extend(texts) or tokenize(texts)
        previous = os.environ.get("LLAVA_MODEL_PATH")
        os.environ["LLAVA_MODEL_PATH"] = llava
        Q.int4_paired_fused_matmul.launches = 0
        try:
            rec, = cli.main(argv + ["--load_4bit_llava"])
        finally:
            cli.tokenize = tokenize
            os.environ.pop("LLAVA_MODEL_PATH")
            if previous is not None:
                os.environ["LLAVA_MODEL_PATH"] = previous
        k5 = Q.int4_paired_fused_matmul.launches
        _free()
        caption, t = rec["caption"], rec["timings"]
        log(f"[cli] with the tiny captioner (--load_4bit_llava, HF directory of {sorted(os.listdir(llava))}): "
            f"caption {t['caption']:.3f} s, {len(caption)} characters {caption[:40]!r}; K5 launches {k5}; "
            f"stage1 {t['stage1']:.3f} s, tokenize {t['tokenize']:.3f} s, conditioning {t['cond']:.3f} s, "
            f"sample {t['sample']:.3f} s")
        if not (caption and prompts[0] == caption + cfg.p_p == rec["prompt"]):
            raise AssertionError(f"[cli] the caption {caption!r} is not in the prompt {prompts[:1]!r}")
        if not k5 > 0:
            raise AssertionError("[cli] the captioner run launched no K5")
    return launches


FP32_REF_BOUND = 1e-3  # [fp32 reference]: card fp32 (K1 fp32, K2 fp32) against CPU fp32 plain, relative L2


def _fp32_counters():
    from supir_tpu_torch.ops.flash_attention import flash_attention
    from supir_tpu_torch.ops.groupnorm import group_norm

    return flash_attention, group_norm


def phase_fp32(steps: int, smi: str, cli_launches: dict):
    """[fp32]: the batch CLI with --full_params at full width
    (options/SUPIR_v0.yaml, XL-base, every parameter fp32, random weights,
    --no_llava) on [cli]'s seeded 768x1152 PNG. Every flash site runs K1
    fp32 (106 a step) and none the bf16 K1; K2 launches as in [cli], now on
    fp32; the engine's parameters are all fp32 and the restored image
    finite. Seconds per phase and peak memory. Returns K1 fp32's launches."""
    import os
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from supir_tpu_torch.apps import cli
    from supir_tpu_torch.config import load_yaml_config
    from supir_tpu_torch.utils.image import pil_to_array

    k1, k2 = _fp32_counters()
    opt = "options/SUPIR_v0.yaml"
    cfg, _ = load_yaml_config(opt)
    h, w = CLI_PNG
    seen = {}
    make_engine, to_pil = cli.create_engine_from_args, cli.array_to_pil

    def engine_from_args(args):
        engine, c = make_engine(args)
        seen["dtypes"] = {p.dtype for p in engine.model.parameters()}
        seen["params"] = sum(p.numel() for p in engine.model.parameters())
        network = engine._network

        def first_call(*a, **kw):  # keeps the first network call's inputs for the profile
            seen.setdefault("call", (network, a, kw))
            return network(*a, **kw)

        engine._network = first_call
        return engine, c

    def array_to_pil(arr, *a):
        seen["finite"] = bool(torch.isfinite(arr).all())
        seen["dtype"] = arr.dtype
        return to_pil(arr, *a)

    with tempfile.TemporaryDirectory() as tmp:
        img_dir, out_dir = _photo_dir(tmp, h, w, SEED + 7), os.path.join(tmp, "out")  # [cli]'s photo
        model_h, model_w = pil_to_array(Image.open(os.path.join(img_dir, "photo.png")), min_size=1024)[0].shape[:2]
        lat = (model_h // cfg.vae.downscale_factor, model_w // cfg.vae.downscale_factor)
        cli.create_engine_from_args, cli.array_to_pil = engine_from_args, array_to_pil
        torch.cuda.reset_peak_memory_stats()
        k1.launches = k1.fp32_launches = k2.launches = 0
        t0 = time.perf_counter()
        try:
            rec, = cli.main(["--img_dir", img_dir, "--save_dir", out_dir, "--opt", opt, "--random_weights",
                             "--edm_steps", str(steps), "--no_llava", "--full_params"])
        finally:
            cli.create_engine_from_args, cli.array_to_pil = make_engine, to_pil
        total = time.perf_counter() - t0
        launches = {"K1": k1.launches, "K1-fp32": k1.fp32_launches, "K2": k2.launches}
        peak = torch.cuda.max_memory_allocated() / 2**30
        out = np.asarray(Image.open(rec["saved"][0]))
    profile = profile_fp32_network_call(*seen.pop("call"))
    _free()
    t = rec["timings"]
    want_k1 = expected_flash_launches(cfg, lat, steps, vae_passes=5)
    log(f"[fp32] {smi}: cli.main --full_params, {opt}, {seen['params'] / 1e9:.3f} B parameters in "
        f"{sorted(str(d) for d in seen['dtypes'])}, {h}x{w} PNG -> {model_h}x{model_w}, {steps} RestoreEDM "
        f"steps, --no_llava: stage1 {t['stage1']:.3f} s, tokenize {t['tokenize']:.3f} s, conditioning "
        f"{t['cond']:.3f} s, sample {t['sample']:.3f} s, save {t['save']:.3f} s; main() {total:.2f} s with the "
        f"engine's random init; peak memory {peak:.2f} GiB")
    sites = expected_flash_sites(cfg, lat)
    log(f"[fp32] launches: K1 fp32 {launches['K1-fp32']} (expected {sites} sites x {steps} steps + "
        f"{want_k1 - sites * steps} VAE = {want_k1}), bf16 K1 {launches['K1']} (expected 0), K2 {launches['K2']} ([cli]'s bf16 "
        f"run: {cli_launches['K2']}); sample {seen['dtype']}, finite {seen['finite']}; saved {out.shape}")
    log(f"[fp32] one network call again under torch.profiler (CFG batch 2, {lat[0]}x{lat[1]} latent): "
        f"kernel time {profile['busy_ms']:.1f} ms, K1 fp32 {profile['k1_ms']:.2f} ms in {profile['k1_count']} "
        f"launches ({profile['k1_ms'] / profile['busy_ms']:.1%} of it), wall {profile['wall_s']:.3f} s with the "
        f"profiler on")
    if seen["dtypes"] != {torch.float32}:
        raise AssertionError(f"[fp32] --full_params left parameters in {seen['dtypes']}")
    if profile["k1_count"] != sites:
        raise AssertionError(f"[fp32] the profiled network call ran {profile['k1_count']} K1 fp32 kernels, "
                             f"expected {sites}")
    if launches != {"K1": 0, "K1-fp32": want_k1, "K2": cli_launches["K2"]}:
        raise AssertionError(f"[fp32] launches {launches}, expected K1 fp32 {want_k1}, K1 0, K2 {cli_launches['K2']}")
    if not (seen["finite"] and seen["dtype"] == torch.float32 and out.shape == (h, w, 3) and out.std() > 0):
        raise AssertionError(f"[fp32] output: finite {seen['finite']}, {seen['dtype']}, PNG {out.shape} std "
                             f"{out.std()}")
    return launches["K1-fp32"]


def profile_fp32_network_call(network, args, kwargs) -> dict:
    """torch.profiler over one call of an fp32 engine's network on the
    inputs it was first given: wall seconds, kernel milliseconds, and K1
    fp32's milliseconds and launches (flash_fwd_fp32_kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        network(*args, **kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    k1 = [(us, n) for key, us, n in rows if "flash_fwd_fp32_kernel" in key]
    return {"wall_s": wall, "busy_ms": sum(r[1] for r in rows) / 1e3, "k1_ms": sum(us for us, _ in k1) / 1e3,
            "k1_count": sum(n for _, n in k1)}


def phase_fp32_reference():
    """[fp32 reference]: the references' reduced-width engine with every
    parameter fp32 on the card (K1 fp32 at every flash site, the 32^2
    level's self-attention and the VAE's 128-wide mid-block head; K2 on
    fp32) against the same weights on the CPU (fp32, plain versions), same
    injected noise, 512^2, 2 steps, TF32 off: the decoded image within
    FP32_REF_BOUND, each K1 fp32 site within K1_FP32_REL_BOUND of its plain
    version, bf16 K1 never launched; K1 fp32 without its rescale (planted
    fault 1) at every site must break the image's bound."""
    import torch

    from supir_tpu_torch.engine.factory import build_model, create_engine
    from supir_tpu_torch.engine.supir import SUPIREngine
    from supir_tpu_torch.ops import flash_attention as FA

    k1, k2 = _fp32_counters()
    cfg = dataclasses.replace(_reduced_cfg(), ae_dtype="fp32", diffusion_dtype="fp32")
    size = 512
    cpu_model = build_model(cfg, "cpu", seed=SEED)
    _randomize_all(cpu_model, SEED + 40)
    cpu_engine = SUPIREngine(cfg, cpu_model)
    gpu_engine = create_engine(cfg, "cuda", state_dict=cpu_model.state_dict(), param_dtype=torch.float32)
    x, c, uc = _inputs(cfg, size, torch.device("cpu"), SEED + 41)
    g = torch.Generator().manual_seed(SEED + 42)
    lat = size // cfg.vae.downscale_factor
    noise = torch.randn(1, lat, lat, 4, generator=g)
    center = torch.randn(1, lat, lat, 4, generator=g)
    kw = dict(SAMPLE_KW, s_churn=0.0, num_steps=2, noise_override=noise, center_noise_override=center)

    t0 = time.perf_counter()
    z = cpu_engine.encode_first_stage_with_denoise(x)
    want = cpu_engine.batchify_sample(x, dict(c, control=z), dict(uc, control=z), z_override=z, **kw)
    cpu_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    cg = {key: val.to(dev) for key, val in c.items()}
    ug = {key: val.to(dev) for key, val in uc.items()}

    def card(kernel):
        with kernels_at_sites(kernel, k2) as site_rel:
            zg = gpu_engine.encode_first_stage_with_denoise(x.to(dev))
            out = gpu_engine.batchify_sample(x.to(dev), dict(cg, control=zg), dict(ug, control=zg), z_override=zg,
                                             **kw).cpu()
        return out, site_rel

    k1.launches = k1.fp32_launches = 0
    t0 = time.perf_counter()
    got, site_rel = card(k1)
    card_s = time.perf_counter() - t0
    launches = (k1.launches, k1.fp32_launches)
    # the counted run holds four VAE passes: the denoise encode, stage-1
    # decode, x_center encode, final decode
    want_k1 = expected_flash_launches(cfg, lat, 2, vae_passes=4)
    rel = rel_l2(got, want)
    log(f"[fp32 reference] reduced width (model_channels 128, 64-wide heads, VAE ch 32), every parameter fp32, "
        f"{size}^2, 2 steps, injected noise, TF32 off: card ({card_s:.1f} s) vs CPU ({cpu_s:.1f} s): rel_l2 "
        f"{rel:.3e} (bound {FP32_REF_BOUND:g}), max_abs_err {(got - want).abs().max().item():.3e}; K1 fp32 "
        f"launches {launches[1]} (expected {want_k1}), bf16 K1 {launches[0]}; worst K1 fp32 site vs fp32 plain "
        f"rel_l2 {max(site_rel):.3e} over {len(site_rel)} sites (bound {K1_FP32_REL_BOUND:g})")
    if not (rel <= FP32_REF_BOUND and torch.isfinite(got).all() and max(site_rel) <= K1_FP32_REL_BOUND):
        raise AssertionError(f"[fp32 reference] card and CPU disagree: rel_l2 {rel}, worst site {max(site_rel)}")
    if launches != (0, want_k1):
        raise AssertionError(f"[fp32 reference] launches (bf16 K1, K1 fp32) {launches}, expected (0, {want_k1})")
    bad, bad_sites = card(lambda q, k, v, causal=False: FA._forward_fp32(q, k, v, causal, FA.FP32_FAULT_NO_RESCALE))
    bad_rel = rel_l2(bad, want)
    log(f"[fp32 reference] control (K1 fp32 without its rescale): rel_l2 {bad_rel:.3e}, worst site "
        f"{max(bad_sites):.3e}")
    if not bad_rel > FP32_REF_BOUND:
        raise AssertionError(f"the [fp32 reference] bound misses K1 fp32 without its rescale: rel_l2 {bad_rel}")
    del gpu_engine
    _free()


TILED_OPT = "options/SUPIR_v0_tiled.yaml"
TILED_PNG = 1024      # side of the [tiled] phase's photo; --upscale 2 takes it to 2048^2
TILED_VAE_SIDE = 4096  # side of the [tiled vae] phase's image
LIGHTNING_OPT = "options/SUPIR_v0_Juggernautv9_lightning.yaml"


@contextlib.contextmanager
def _watch_tiles(counts: dict):
    """Record the tile counts of the tiled VAE's splits (encoder image
    tiles and decoder latent tiles told apart by their channels) and of the
    tiled sampler's plans, as the path makes them."""
    from supir_tpu_torch.parallel import tiled_sampler as TS
    from supir_tpu_torch.parallel import tiled_vae as TV

    split, plan = TV.split_uniform_tiles, TS.make_tile_plan

    def watched_split(x, tile, pad):
        out = split(x, tile, pad)
        counts.setdefault("encoder" if x.shape[1] == 3 else "decoder", set()).add(out[0].shape[0])
        return out

    def watched_plan(*args):
        out = plan(*args)
        counts.setdefault("sampler", set()).add(len(out[0]))
        return out

    TV.split_uniform_tiles, TS.make_tile_plan = watched_split, watched_plan
    try:
        yield counts
    finally:
        TV.split_uniform_tiles, TS.make_tile_plan = split, plan


def _photo_dir(tmp: str, h: int, w: int, seed: int) -> str:
    import os

    import torch
    from PIL import Image

    img_dir = os.path.join(tmp, "in")
    os.makedirs(img_dir)
    g = torch.Generator().manual_seed(seed)
    Image.fromarray(torch.randint(0, 256, (h, w, 3), generator=g, dtype=torch.uint8).numpy()).save(
        os.path.join(img_dir, "photo.png"))
    return img_dir


def phase_tiled(steps: int, smi: str):
    """The tiled 4K path through the batch CLI at full width: a 1024^2 PNG
    at --upscale 2 (a 2048^2 model image, a 256^2 latent) with
    options/SUPIR_v0_tiled.yaml, --use_tile_vae --use_tiled_sampling,
    random weights, --no_llava: stage 1 through the tiled VAE (16 encoder
    tiles of 512 px plus their 32 px halo, 16 decoder tiles of 64 latent px
    plus 8), TiledRestoreEDM over 9 windows of 128 latent px at stride 64
    folded into one network batch of 18, the tiled decode and colour fix.
    K1 and K2 must launch as expected_tiled_launches says (the tiled VAE's
    pooled GroupNorm sites add no K2). Then [tiled vae]: the same engine's
    tiled denoise-encode and decode of one 4096^2 image, timed, with its
    peak memory. Returns the CLI run's launches."""
    import os
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from supir_tpu_torch.apps import cli
    from supir_tpu_torch.config import load_yaml_config
    from supir_tpu_torch.models import layers
    from supir_tpu_torch.models.layers import GroupNorm32
    from supir_tpu_torch.ops.flash_attention import flash_attention
    from supir_tpu_torch.ops.groupnorm import group_norm
    from supir_tpu_torch.utils.tiling import sliding_windows

    cfg, extras = load_yaml_config(TILED_OPT)
    side = 2 * TILED_PNG
    lat = side // cfg.vae.downscale_factor
    enc_tile, dec_tile = extras["tile_vae"]["encoder_tile_size"], extras["tile_vae"]["decoder_tile_size"]
    engines, times = [], {}

    def create_timed(args):
        engines.append(create(args))
        restores.append(_instrument(engines[-1][0], times))
        return engines[-1]

    create, restores = cli.create_engine_from_args, []
    cli.create_engine_from_args = create_timed
    with tempfile.TemporaryDirectory() as tmp:
        img_dir = _photo_dir(tmp, TILED_PNG, TILED_PNG, SEED + 8)
        argv = ["--img_dir", img_dir, "--save_dir", os.path.join(tmp, "out"), "--opt", TILED_OPT, "--random_weights",
                "--no_llava", "--edm_steps", str(steps), "--upscale", "2", "--use_tile_vae", "--use_tiled_sampling",
                "--encoder_tile_size", str(enc_tile), "--decoder_tile_size", str(dec_tile),
                "--sampler_tile_size", str(cfg.sampler.tile_size), "--sampler_tile_stride", str(cfg.sampler.tile_stride)]
        torch.cuda.reset_peak_memory_stats()
        pooled = GroupNorm32.pooled_sites
        flash_attention.launches = 0
        group_norm.launches = 0
        t0 = time.perf_counter()
        try:
            with _watch_tiles({}) as tiles:
                rec, = cli.main(argv)
        finally:
            cli.create_engine_from_args = create
            for restore in restores:
                restore()
        total = time.perf_counter() - t0
        launches = {"K1": flash_attention.launches, "K2": group_norm.launches}
        peak = torch.cuda.max_memory_allocated() / 2**30
        out = np.asarray(Image.open(rec["saved"][0]))
    t = rec["timings"]
    log(f"[tiled] {smi}: {TILED_OPT}, {TILED_PNG}^2 PNG at --upscale 2 -> {side}^2 model image ({lat}^2 latent), "
        f"{steps} TiledRestoreEDM steps, --no_llava: stage1 (tiled encode + decode) {t['stage1']:.3f} s, "
        f"conditioning {t['cond']:.3f} s, sample (tiled stage-1 decode, x_center encode, {steps} steps, tiled "
        f"decode, colour fix) {t['sample']:.3f} s, save {t['save']:.3f} s; main() {total:.2f} s with the engine's "
        f"random init; peak memory {peak:.2f} GiB")
    dec, net = times["decode"], times["network"]
    windows = len(sliding_windows(lat, lat, cfg.sampler.tile_size, cfg.sampler.tile_stride))
    log(f"[tiled] stages (synchronised): stage-1 tiled encode {times['stage1_encode'][0]:.3f} s, tiled decodes "
        f"{', '.join(f'{d:.3f}' for d in dec)} s (stage 1, the sampler's stage-1 image, the result), x_center "
        f"tiled encode {times['center_encode'][0]:.3f} s, network calls ({windows} windows x CFG 2 = batch "
        f"{2 * windows}) "
        f"{', '.join(f'{n:.3f}' for n in net)} s, colour fix {times['colorfix'][0]:.3f} s")
    want_tiles = dict(zip(("encoder", "decoder"), tiled_vae_tiles(cfg, (side, side), enc_tile, dec_tile)))
    want_tiles["sampler"] = windows
    log(f"[tiled] tiles: encoder {sorted(tiles.get('encoder', []))} of {enc_tile} px + 32 px halo, decoder "
        f"{sorted(tiles.get('decoder', []))} of {dec_tile} latent px + 8, sampler {sorted(tiles.get('sampler', []))} "
        f"windows of {cfg.sampler.tile_size} at stride {cfg.sampler.tile_stride} (expected {want_tiles})")
    if {k: sorted(v) for k, v in tiles.items()} != {k: [v] for k, v in want_tiles.items()}:
        raise AssertionError(f"[tiled] tile counts {tiles}, expected {want_tiles}")
    want = expected_tiled_launches(cfg, lat, steps, cfg.sampler.tile_size, cfg.sampler.tile_stride,
                                   vae_flash=expected_tiled_vae_flash(cfg, (side, side), enc_tile, dec_tile, (8, 4),
                                                                      encodes=2, decodes=3))
    log(f"[tiled] saved {out.shape[0]}x{out.shape[1]} PNG; launches: K1 {launches['K1']} (expected "
        f"{expected_flash_sites(cfg, cfg.sampler.tile_size)} sites x {steps} steps, one folded call of "
        f"{want_tiles['sampler']} windows a step = {want['K1']}), K2 {launches['K2']} (expected {want['K2']}: the "
        f"network's sites only); the tiled VAE's pooled GroupNorm sites {GroupNorm32.pooled_sites - pooled} "
        f"calls, plain torch, no K2")
    if out.shape != (side, side, 3) or out.std() == 0:
        raise AssertionError(f"[tiled] saved PNG {out.shape}, std {out.std()}")
    if launches != want or not GroupNorm32.pooled_sites > pooled:
        raise AssertionError(f"[tiled] launches {launches}, expected {want}")

    engine, _ = engines[0]
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    x = torch.rand(1, TILED_VAE_SIDE, TILED_VAE_SIDE, 3, generator=g, device="cuda") * 2 - 1
    group_norm.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _watch_tiles({}) as vae_tiles:
        z = engine.encode_first_stage_with_denoise(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        img = engine.decode_first_stage(z)
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() / 2**30
    enc_n, dec_n = tiled_vae_tiles(cfg, (TILED_VAE_SIDE, TILED_VAE_SIDE), enc_tile, dec_tile)
    log(f"[tiled vae] {smi}: {TILED_VAE_SIDE}^2 image, tiled denoise-encode {t1 - t0:.3f} s ({enc_n} tiles, "
        f"chunks of 8, staged exact), tiled decode {t2 - t1:.3f} s ({dec_n} tiles, chunks of 4); peak memory "
        f"{peak:.2f} GiB (the engine's weights included); K2 launches {group_norm.launches}")
    if tuple(img.shape) != (1, TILED_VAE_SIDE, TILED_VAE_SIDE, 3) or not torch.isfinite(img).all():
        raise AssertionError(f"[tiled vae] output {tuple(img.shape)} not finite or of the wrong shape")
    if group_norm.launches or vae_tiles != {"encoder": {enc_n}, "decoder": {dec_n}}:
        raise AssertionError(f"[tiled vae] K2 launches {group_norm.launches}, tiles {vae_tiles}")
    # the pooled GroupNorm sites' share: the same passes again with each such
    # call synchronised and timed (plain torch: moments, FMA, SiLU)
    pooled = layers.group_norm_pooled
    spent = []

    def timed_pooled(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = pooled(*args)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t)
        return out

    layers.group_norm_pooled = timed_pooled
    try:
        shares = []
        for run in (lambda: engine.encode_first_stage_with_denoise(x), lambda: engine.decode_first_stage(z)):
            spent.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            shares.append((sum(spent), time.perf_counter() - t, len(spent)))
    finally:
        layers.group_norm_pooled = pooled
    log("[tiled vae] pooled GroupNorm (plain torch) with each call synchronised: " + "; ".join(
        f"{name} {gn:.3f} s of {tot:.3f} s ({gn / tot:.1%}, {n} calls)"
        for name, (gn, tot, n) in zip(("encode", "decode"), shares)))
    del engines, engine, x, z, img
    _free()
    return launches


def phase_tiled_reference():
    """The tiled pipeline at the references' reduced width on the card (bf16,
    kernels) and on the CPU (fp32, plain versions), same weights and
    injected noise: a 768^2 image (a horizontal ramp over uniform noise, so
    that tiles differ in their statistics) through batchify_sample_tiled,
    2 TiledRestoreEDM steps over 4 windows of 64 latent px at stride 32,
    every VAE pass tiled (9 encoder tiles of 256 px, 9 decoder tiles of 32
    latent px, chunks of 4: the staged-exact executor). Two planted faults
    must break the bound: the blend without its normaliser, and chunk-local
    GroupNorm statistics in place of the pooled ones (fast mode)."""
    import torch

    from supir_tpu_torch.engine.factory import build_model, create_engine
    from supir_tpu_torch.engine.supir import SUPIREngine
    from supir_tpu_torch.ops.flash_attention import flash_attention
    from supir_tpu_torch.ops.groupnorm import group_norm
    from supir_tpu_torch.parallel import tiled_sampler as TS

    cfg = _reduced_cfg()
    size, enc_tile, dec_tile, chunk, steps = 768, 256, 32, (4, 4), 2
    cpu_cfg = dataclasses.replace(cfg, ae_dtype="fp32", diffusion_dtype="fp32")
    cpu_model = build_model(cpu_cfg, "cpu", seed=SEED)
    _randomize_all(cpu_model, SEED)
    cpu_engine = SUPIREngine(cpu_cfg, cpu_model)
    gpu_engine = create_engine(cfg, "cuda", state_dict=cpu_model.state_dict())
    for engine in (cpu_engine, gpu_engine):
        engine.init_tile_vae(enc_tile, dec_tile, chunk=chunk)

    x, c, uc = _inputs(cfg, size, torch.device("cpu"), SEED + 10)
    x = (0.5 * x + torch.linspace(-0.5, 0.5, size).view(1, 1, size, 1)).clamp(-1, 1)
    g = torch.Generator().manual_seed(SEED + 11)
    lat = size // cfg.vae.downscale_factor
    noise, center = (torch.randn(1, lat, lat, 4, generator=g) for _ in range(2))
    kw = dict(SAMPLE_KW, s_churn=0.0, num_steps=steps, tile_size=64, tile_stride=32, noise_override=noise,
              center_noise_override=center)
    z = cpu_engine.encode_first_stage_with_denoise(x)
    t0 = time.perf_counter()
    want = cpu_engine.batchify_sample_tiled(x, dict(c, control=z), dict(uc, control=z), z_override=z, **kw)
    cpu_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    cg, ug, zg = {k: v.to(dev) for k, v in c.items()}, {k: v.to(dev) for k, v in uc.items()}, z.to(dev)

    def card():
        return gpu_engine.batchify_sample_tiled(x.to(dev), dict(cg, control=zg), dict(ug, control=zg), z_override=zg,
                                                **kw).cpu()

    flash_attention.launches = 0
    group_norm.launches = 0
    got = card()
    launches = {"K1": flash_attention.launches, "K2": group_norm.launches}
    # z comes from outside: the run holds the stage-1 decode, the x_center encode and the final decode
    expected = expected_tiled_launches(cfg, lat, steps, 64, 32, vae_flash=expected_tiled_vae_flash(
        cfg, (size, size), enc_tile, dec_tile, chunk, encodes=1, decodes=2))
    rel = rel_l2(got, want)
    log(f"[tiled reference] reduced width (model_channels 128, VAE ch 32), {size}^2, {steps} steps, 4 windows of "
        f"64 at stride 32, tiled VAE ({enc_tile} px / {dec_tile} latent px tiles, chunks {chunk}, staged exact): "
        f"card bf16 vs CPU fp32 ({cpu_s:.1f} s): max_abs_err {(got - want).abs().max().item():.4f}, rel_l2 "
        f"{rel:.4f} (bound {REF_REL_BOUND:g}); launches {launches} (expected {expected})")
    if not rel <= REF_REL_BOUND:
        raise AssertionError(f"[tiled reference] card and CPU disagree: rel_l2 {rel}")
    if launches != expected:
        raise AssertionError(f"[tiled reference] launches {launches}, expected {expected}")

    call = TS._Blend.__call__
    TS._Blend.__call__ = lambda self, tiles: TS._scatter_tiles(tiles, self.starts, self.shape, self.weights)
    try:
        bad_blend = rel_l2(card(), want)
    finally:
        TS._Blend.__call__ = call
    gpu_engine.init_tile_vae(enc_tile, dec_tile, chunk=chunk, fast_mode=True)
    bad_stats = rel_l2(card(), want)
    log(f"[tiled reference] controls: the blend without its normaliser rel_l2 {bad_blend:.4f}; chunk-local "
        f"GroupNorm statistics (fast mode, chunks {chunk}) in place of the pooled ones rel_l2 {bad_stats:.4f}")
    if not (bad_blend > REF_REL_BOUND and bad_stats > REF_REL_BOUND):
        raise AssertionError(f"[tiled reference] the bound misses a planted fault: the blend without its "
                             f"normaliser {bad_blend}, chunk-local statistics {bad_stats}")
    del gpu_engine
    _free()


def phase_lightning(smi: str):
    """The Lightning option file through the batch CLI at full width: a
    768x1152 PNG restored at 1024x1536 with
    options/SUPIR_v0_Juggernautv9_lightning.yaml and its own settings (8
    RestoreDPMPP2M steps, eta 1, the SDE's Brownian-tree noise; CFG 2.0 from
    its default_setting), random weights, --no_llava. K1 and K2 must launch
    as the config says: per step the network's sites, and the VAE's over one
    encode and three decodes (DPM++2M takes no x_center encode). Returns
    the launches."""
    import os
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from supir_tpu_torch.apps import cli
    from supir_tpu_torch.config import load_yaml_config
    from supir_tpu_torch.ops.flash_attention import flash_attention
    from supir_tpu_torch.ops.groupnorm import group_norm
    from supir_tpu_torch.utils.image import pil_to_array

    cfg, extras = load_yaml_config(LIGHTNING_OPT)
    steps = extras["default_setting"]["edm_steps"]
    s_cfg = extras["default_setting"]["s_cfg_Quality"]
    h, w = CLI_PNG
    with tempfile.TemporaryDirectory() as tmp:
        img_dir = _photo_dir(tmp, h, w, SEED + 12)
        model_h, model_w = pil_to_array(Image.open(os.path.join(img_dir, "photo.png")), min_size=1024)[0].shape[:2]
        lat = (model_h // cfg.vae.downscale_factor, model_w // cfg.vae.downscale_factor)
        argv = ["--img_dir", img_dir, "--save_dir", os.path.join(tmp, "out"), "--opt", LIGHTNING_OPT,
                "--random_weights", "--no_llava", "--edm_steps", str(steps), "--s_cfg", str(s_cfg),
                "--spt_linear_CFG", str(extras["default_setting"]["spt_linear_CFG_Quality"])]
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        group_norm.launches = 0
        t0 = time.perf_counter()
        rec, = cli.main(argv)
        total = time.perf_counter() - t0
        launches = {"K1": flash_attention.launches, "K2": group_norm.launches}
        out = np.asarray(Image.open(rec["saved"][0]))
    t = rec["timings"]
    want = {"K1": expected_flash_launches(cfg, lat, steps, vae_passes=4),
            "K2": expected_group_norm_launches(cfg, steps, encodes=1, decodes=3)}
    log(f"[lightning] {smi}: {LIGHTNING_OPT}, {h}x{w} PNG -> {model_h}x{model_w} model image, {steps} "
        f"{cfg.sampler.name} steps (eta {cfg.sampler.eta}, CFG {s_cfg}), --no_llava: stage1 {t['stage1']:.3f} s, "
        f"conditioning {t['cond']:.3f} s, sample {t['sample']:.3f} s ({t['sample'] / steps:.3f} s a step with the "
        f"decodes), save {t['save']:.3f} s; main() {total:.2f} s with the engine's random init; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches: K1 {launches['K1']} (expected "
        f"{want['K1']}), K2 {launches['K2']} (expected {want['K2']})")
    if out.shape != (h, w, 3) or out.std() == 0:
        raise AssertionError(f"[lightning] saved PNG {out.shape}, std {out.std()}")
    if launches != want:
        raise AssertionError(f"[lightning] launches {launches}, expected {want}")
    _free()
    return launches


NEW_SAMPLERS = ("EulerEDM", "HeunEDM", "EulerAncestral", "DPMPP2SAncestral", "DPMPP2M", "LMS", "Substep")
SAMPLER_STEPS = 4     # [samplers]: Substep's cap
CACHE_STEPS = 8       # [feature cache], untiled
CACHE_TILED_SIDE = 2048  # [feature cache], tiled: 9 windows of 128 latent px at stride 64
CACHE_TILED_STEPS = 4


def expected_network_calls(name: str, steps: int, eta: float) -> int:
    """Network calls of `steps` steps of a sampler on the LegacyDDPM
    schedule: one a step, and Heun's correction where the step does not end
    at sigma 0, DPM++(2S)'s midpoint where sigma_down > 1e-14."""
    from supir_tpu_torch.diffusion import samplers as S

    sigmas = S.legacy_ddpm_sigmas(steps)
    if name == "HeunEDM":
        return steps + int((sigmas[1:] > 1e-14).sum())
    if name == "DPMPP2SAncestral":
        down, _ = S._ancestral_step_sigmas(sigmas[:-1], sigmas[1:], eta)
        return steps + int((down > 1e-14).sum())
    return steps


def _count_calls(engine, method: str, calls: list):
    """Wrap engine.<method> so each call appends its last argument (the
    recompute flag of `_network_cached`, the control scale of `_network`)."""
    sound = getattr(engine, method)

    def counted(*args):
        calls.append(args[-1])
        return sound(*args)

    setattr(engine, method, counted)
    return lambda: delattr(engine, method)


def _full_width_engine():
    """The XL-base engine at full width, bf16, on the card, every weight
    random (zero-initialised layers included: left at zero, the UNet's
    output head would make eps 0 whatever the features, and the samplers'
    and the cache's results would not depend on the network)."""
    from supir_tpu_torch.config import SUPIRConfig
    from supir_tpu_torch.engine.factory import create_engine

    engine = create_engine(SUPIRConfig(), "cuda", seed=SEED)
    _randomize_all(engine.model, SEED + 20)
    return engine


def phase_samplers(engine, smi: str):
    """The seven samplers beyond RestoreEDM and RestoreDPMPP2M through
    SUPIREngine.batchify_sample at full width, 1024^2, 4 steps each (Substep's
    cap), the main path's settings (churn 5, linear CFG, eta 1): stage 1 and
    the sample, synchronised. Each output must be finite, and K1 and K2 must
    launch at every site of every network call (Heun and DPM++(2S) call
    twice a step but on the last) plus the VAE's: one encode, two decodes
    (no x_center encode: only RestoreEDM takes one). Returns each sampler's
    launches."""
    import torch

    from supir_tpu_torch.ops.flash_attention import flash_attention
    from supir_tpu_torch.ops.groupnorm import group_norm

    cfg = engine.cfg
    lat = SIZE // cfg.vae.downscale_factor
    x, c, uc = _inputs(cfg, SIZE, torch.device("cuda"), SEED + 13)
    out = {}
    for name in NEW_SAMPLERS:
        calls = []
        restore = _count_calls(engine, "_network", calls)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        group_norm.launches = 0
        t0 = time.perf_counter()
        try:
            z = engine.encode_first_stage_with_denoise(x)
            img = engine.batchify_sample(x, dict(c, control=z), dict(uc, control=z), num_steps=SAMPLER_STEPS,
                                         seed=SEED, z_override=z, sampler_name=name, **SAMPLE_KW)
            torch.cuda.synchronize()
        finally:
            restore()
        sec = time.perf_counter() - t0
        launches = {"K1": flash_attention.launches, "K2": group_norm.launches}
        want_calls = expected_network_calls(name, SAMPLER_STEPS, cfg.sampler.eta)
        want = {"K1": expected_flash_launches(cfg, lat, len(calls), vae_passes=3),
                "K2": expected_group_norm_launches(cfg, len(calls), encodes=1, decodes=2)}
        log(f"[samplers] {smi}: {name}, {SIZE}^2, {SAMPLER_STEPS} steps: stage 1 + sample {sec:.3f} s, "
            f"{len(calls)} network calls (expected {want_calls}), launches K1 {launches['K1']} / K2 "
            f"{launches['K2']} (expected {want['K1']} / {want['K2']}: {expected_flash_sites(cfg, lat)} and "
            f"{expected_group_norm_launches(cfg, 1, vae_passes=0)} sites a call + one encode, two decodes), peak "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, output range "
            f"[{img.min().item():.3f}, {img.max().item():.3f}]")
        if tuple(img.shape) != (1, SIZE, SIZE, 3) or not torch.isfinite(img).all():
            raise AssertionError(f"[samplers] {name}: output {tuple(img.shape)} not finite or of the wrong shape")
        if len(calls) != want_calls or launches != want:
            raise AssertionError(f"[samplers] {name}: {len(calls)} calls, launches {launches}, expected "
                                 f"{want_calls} calls, {want}")
        out[name] = launches
    return out


def _cache_bytes(cache) -> int:
    control, (hs, h) = cache
    return nbytes(*control, *hs, h)


def _cached_run(engine, run, interval: int):
    """run(interval) with each network call of the cached path between two
    CUDA events: (result, seconds, {True: recompute ms list, False: reuse
    ms list}, launches, the last call's cache bytes)."""
    import torch

    from supir_tpu_torch.ops.flash_attention import flash_attention
    from supir_tpu_torch.ops.groupnorm import group_norm

    sound = engine._network_cached
    records = []

    def timed(x, t, cond, control_scale, cache, recompute):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = sound(x, t, cond, control_scale, cache, recompute)
        end.record()
        records.append((recompute, start, end, out[1]))
        return out

    engine._network_cached = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    group_norm.launches = 0
    t0 = time.perf_counter()
    try:
        img = run(interval)
        torch.cuda.synchronize()
    finally:
        del engine._network_cached
    sec = time.perf_counter() - t0
    launches = {"K1": flash_attention.launches, "K2": group_norm.launches}
    steps = {True: [], False: []}
    for rec, start, end, _ in records:
        steps[rec].append(start.elapsed_time(end))
    cache_bytes = _cache_bytes(records[-1][3]) if records else 0
    return img, sec, steps, launches, cache_bytes


def phase_feature_cache(engine, smi: str):
    """RestoreEDM's cross-step feature cache at full width: 1024^2, 8 steps,
    the main path's settings. The plain path twice (whether the card's run
    is deterministic), interval 1 (equal to the plain path: to 0 where the
    two plain runs agree bit for bit, else within REF_REL_BOUND), then
    intervals 2 and 4: each network call of the cached path timed by CUDA
    events, recompute and reuse steps apart; K1 and K2 launches (recompute
    calls at every site, reuse calls at the decoder's, adapters' and head's
    alone) asserted; the cache's bytes; peak memory. Then TiledRestoreEDM at
    2048^2 (tiled VAE, 9 windows folded into a batch of 18), 4 steps, at
    interval 2 and plain, with the same readings. Returns the launches."""
    import torch

    from supir_tpu_torch.utils.tiling import sliding_windows

    cfg = engine.cfg
    dev = torch.device("cuda")
    lat = SIZE // cfg.vae.downscale_factor
    x, c, uc = _inputs(cfg, SIZE, dev, SEED + 14)
    z = engine.encode_first_stage_with_denoise(x)
    cc, ucc = dict(c, control=z), dict(uc, control=z)

    def run(interval, steps=CACHE_STEPS):
        return engine.batchify_sample(x, cc, ucc, num_steps=steps, seed=SEED, z_override=z,
                                      feature_cache_interval=interval, **SAMPLE_KW)

    plain = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain.append(run(0))
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    deterministic = torch.equal(plain[0], plain[1])
    one, one_s, _, _, _ = _cached_run(engine, run, 1)
    diff = (one - plain[0]).abs().max().item()
    log(f"[feature cache] {smi}: RestoreEDM {SIZE}^2, {CACHE_STEPS} steps: plain {plain_s:.3f} s (two plain runs "
        f"bit-identical: {deterministic}); interval 1 {one_s:.3f} s, max |interval 1 - plain| {diff:.3e} "
        f"(bound {'0' if deterministic else f'rel_l2 {REF_REL_BOUND:g}'})")
    if deterministic and diff != 0:
        raise AssertionError(f"[feature cache] interval 1 differs from the plain path by {diff}")
    if not deterministic and not rel_l2(one, plain[0]) <= REF_REL_BOUND:
        raise AssertionError(f"[feature cache] interval 1 differs from the plain path: rel_l2 {rel_l2(one, plain[0])}")

    def check(label, interval, steps, img, sec, step_ms, launches, cache_bytes, lat_k1, vae_k1, vae_k2, want_shape):
        rec, reuse = len(step_ms[True]), len(step_ms[False])
        want = {"K1": expected_flash_sites(cfg, lat_k1) * rec + expected_flash_sites(cfg, lat_k1, reuse=True) * reuse
                + vae_k1, "K2": expected_group_norm_launches(cfg, rec, reuse_steps=reuse, **vae_k2)}
        mean = lambda v: sum(v) / len(v)  # noqa: E731
        log(f"[feature cache] {label}, interval {interval}: {sec:.3f} s; recompute steps {rec} at "
            f"{mean(step_ms[True]):.2f} ms ({', '.join(f'{m:.2f}' for m in step_ms[True])}), reuse steps {reuse} at "
            f"{mean(step_ms[False]):.2f} ms ({', '.join(f'{m:.2f}' for m in step_ms[False])}), reuse/recompute "
            f"{mean(step_ms[False]) / mean(step_ms[True]):.3f}; launches K1 {launches['K1']} / K2 {launches['K2']} "
            f"(expected {want['K1']} / {want['K2']}: {expected_flash_sites(cfg, lat_k1)} and "
            f"{expected_flash_sites(cfg, lat_k1, reuse=True)} K1 sites a recompute and a reuse call); cache "
            f"{cache_bytes / 2**20:.1f} MiB; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if rec != -(-steps // interval) or rec + reuse != steps:
            raise AssertionError(f"[feature cache] {label}: {rec} recompute and {reuse} reuse calls")
        if launches != want:
            raise AssertionError(f"[feature cache] {label}: launches {launches}, expected {want}")
        if tuple(img.shape) != want_shape or not torch.isfinite(img).all():
            raise AssertionError(f"[feature cache] {label}: output {tuple(img.shape)} not finite or misshapen")

    out = {}
    for interval in (2, 4):
        img, sec, step_ms, launches, cache_bytes = _cached_run(engine, run, interval)
        check(f"RestoreEDM {SIZE}^2, {CACHE_STEPS} steps", interval, CACHE_STEPS, img, sec, step_ms, launches,
              cache_bytes, lat, expected_flash_launches(cfg, lat, 0, vae_passes=3), dict(encodes=1, decodes=2),
              (1, SIZE, SIZE, 3))
        log(f"[feature cache] interval {interval} vs plain (random weights): rel_l2 {rel_l2(img, plain[0]):.4f}")
        out[f"interval {interval}"] = launches

    side = CACHE_TILED_SIDE
    tile = cfg.sampler.tile_size
    engine.init_tile_vae(512, 64)
    try:
        xt, ct, uct = _inputs(cfg, side, dev, SEED + 15)
        zt = engine.encode_first_stage_with_denoise(xt)
        ct, uct = dict(ct, control=zt), dict(uct, control=zt)

        def run_tiled(interval):
            return engine.batchify_sample_tiled(xt, ct, uct, num_steps=CACHE_TILED_STEPS, tile_size=tile,
                                                tile_stride=cfg.sampler.tile_stride, seed=SEED, z_override=zt,
                                                feature_cache_interval=interval, **SAMPLE_KW)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        base = run_tiled(0)
        torch.cuda.synchronize()
        base_s = time.perf_counter() - t0
        img, sec, step_ms, launches, cache_bytes = _cached_run(engine, run_tiled, 2)
        windows = len(sliding_windows(side // cfg.vae.downscale_factor, side // cfg.vae.downscale_factor, tile,
                                      cfg.sampler.tile_stride))
        check(f"TiledRestoreEDM {side}^2 ({windows} windows of {tile}, batch {2 * windows}, tiled VAE), "
              f"{CACHE_TILED_STEPS} steps", 2,
              CACHE_TILED_STEPS, img, sec, step_ms, launches, cache_bytes, tile,
              expected_tiled_vae_flash(cfg, (side, side), 512, 64, (8, 4), encodes=1, decodes=2),
              dict(vae_passes=0), (1, side, side, 3))
        log(f"[feature cache] tiled plain {base_s:.3f} s; interval 2 vs plain (random weights): rel_l2 "
            f"{rel_l2(img, base):.4f}")
        out["tiled interval 2"] = launches
    finally:
        engine._tile_vae = None
    return out


def phase_samplers_reference():
    """At the references' reduced width, 512^2, 2 steps: the card (bf16,
    kernels) against the CPU (fp32, plain versions) on the same weights and
    the same injected noise (the initial and x_center noise, and each
    step's draw through the samplers' noise hook, drawn on the CPU): each of
    the seven samplers; RestoreEDM's feature cache at interval 2 (churn 0),
    untiled, and tiled at 768^2 (4 windows of 64 at stride 32), folded and
    in chunks of 3 (a padded last group); the plain UNetModel; GLVControl
    with input_upscale 2. Two planted faults must break the bound: Heun
    without its correction, and a reuse step that keeps the recompute
    step's time embedding."""
    import functools

    import torch

    from supir_tpu_torch.diffusion import samplers as S
    from supir_tpu_torch.engine import supir as E
    from supir_tpu_torch.engine.factory import build_model, create_engine
    from supir_tpu_torch.engine.supir import SUPIREngine
    from supir_tpu_torch.models.control import GLVControl
    from supir_tpu_torch.models.unet import UNetModel

    cfg = _reduced_cfg()
    size, steps = 512, 2
    cpu_cfg = dataclasses.replace(cfg, ae_dtype="fp32", diffusion_dtype="fp32")
    cpu_model = build_model(cpu_cfg, "cpu", seed=SEED)
    _randomize_all(cpu_model, SEED + 1)
    cpu_engine = SUPIREngine(cpu_cfg, cpu_model)
    gpu_engine = create_engine(cfg, "cuda", state_dict=cpu_model.state_dict())
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(SEED + 16)

    def case(side):
        x, c, uc = _inputs(cfg, side, torch.device("cpu"), SEED + 17)
        lat = side // cfg.vae.downscale_factor
        noise, center = (torch.randn(1, lat, lat, 4, generator=g) for _ in range(2))
        z = cpu_engine.encode_first_stage_with_denoise(x)
        return x, dict(c, control=z), dict(uc, control=z), z, dict(noise_override=noise,
                                                                     center_noise_override=center)

    moved = lambda d: {k: v.to(dev) for k, v in d.items()}  # noqa: E731

    def card(method, x, c, uc, z, **kw):
        return getattr(gpu_engine, method)(x.to(dev), moved(c), moved(uc), z_override=z.to(dev), **kw).cpu()

    x, c, uc, z, noises = case(size)
    lat = size // cfg.vae.downscale_factor
    draws = [torch.randn(1, 4, lat, lat, generator=g) for _ in range(steps)]
    hooked = {}
    for entry in ("EulerEDM", "HeunEDM", "EulerAncestral", "DPMPP2SAncestral"):
        hooked[entry] = E.SAMPLERS[entry]
        E.SAMPLERS[entry] = functools.partial(hooked[entry], noise=lambda i, shape: draws[i])
    kw = dict(SAMPLE_KW, num_steps=steps, **noises)
    rels, wants = {}, {}
    try:
        for name in NEW_SAMPLERS:
            t0 = time.perf_counter()
            wants[name] = cpu_engine.batchify_sample(x, c, uc, z_override=z, sampler_name=name, **kw)
            rels[name] = rel_l2(card("batchify_sample", x, c, uc, z, sampler_name=name, **kw), wants[name])
            log(f"[samplers reference] {name}: reduced width, {size}^2, {steps} steps, churn 5, eta 1: card bf16 vs "
                f"CPU fp32 rel_l2 {rels[name]:.4f} (bound {REF_REL_BOUND:g}; {time.perf_counter() - t0:.1f} s)")
        correct = S.heun_correct
        S.heun_correct = lambda denoise, x, x_euler, *a: x_euler
        try:
            bad_heun = rel_l2(card("batchify_sample", x, c, uc, z, sampler_name="HeunEDM", **kw), wants["HeunEDM"])
        finally:
            S.heun_correct = correct
    finally:
        E.SAMPLERS.update(hooked)

    cached_kw = dict(kw, s_churn=0.0, feature_cache_interval=2)
    want_cached = cpu_engine.batchify_sample(x, c, uc, z_override=z, **cached_kw)
    rels["cache, untiled"] = rel_l2(card("batchify_sample", x, c, uc, z, **cached_kw), want_cached)
    unet = gpu_engine.model.model["diffusion_model"]
    sound_forward, sound_embed = unet.forward, unet.embed_time
    held = {}

    def stale_forward(*args, feature_cache=None, **kwargs):
        if feature_cache is None:  # a recompute step: keep its time embedding
            unet.embed_time = lambda t, y: held.__setitem__("emb", sound_embed(t, y)) or held["emb"]
        else:  # a reuse step: the recompute step's embedding, not its own
            unet.embed_time = lambda t, y: held["emb"]
        try:
            return sound_forward(*args, feature_cache=feature_cache, **kwargs)
        finally:
            del unet.embed_time

    unet.forward = stale_forward
    try:
        bad_emb = rel_l2(card("batchify_sample", x, c, uc, z, **cached_kw), want_cached)
    finally:
        del unet.forward

    xt, ct, uct, zt, tnoises = case(768)
    tiled_kw = dict(SAMPLE_KW, s_churn=0.0, num_steps=steps, tile_size=64, tile_stride=32, feature_cache_interval=2,
                    **tnoises)
    want_tiled = cpu_engine.batchify_sample_tiled(xt, ct, uct, z_override=zt, **tiled_kw)
    for chunk in (None, 3):
        got = card("batchify_sample_tiled", xt, ct, uct, zt, tile_chunk=chunk, **tiled_kw)
        rels[f"cache, tiled {'folded' if chunk is None else 'chunks of 3'}"] = rel_l2(got, want_tiled)

    gen = torch.Generator().manual_seed(SEED + 18)
    t = torch.tensor([999.0, 500.0])
    ca = torch.randn(2, 77, cfg.unet.context_dim, generator=gen)
    y = torch.randn(2, cfg.unet.adm_in_channels, generator=gen)
    xl = torch.randn(2, 4, lat, lat, generator=gen)
    plain_unet = UNetModel(cfg.unet)
    _randomize_all(plain_unet, SEED + 19)
    with torch.no_grad():
        want = plain_unet(xl, t, ca, y)
        card_unet = UNetModel(cfg.unet, device=dev, dtype=torch.bfloat16)
        card_unet.load_state_dict(plain_unet.state_dict())
        rels["UNetModel"] = rel_l2(card_unet(xl.to(dev), t.to(dev), ca.to(dev), y.to(dev)).cpu(), want)
        control = GLVControl(cfg.unet, input_upscale=2)
        control.load_state_dict(cpu_model.model["control_model"].state_dict())
        card_control = GLVControl(cfg.unet, input_upscale=2, device=dev, dtype=torch.bfloat16)
        card_control.load_state_dict(control.state_dict())
        hint = torch.randn(2, 4, lat // 2, lat // 2, generator=gen)
        want = control(hint, t, xl, ca, y)
        got = card_control(hint.to(dev), t.to(dev), xl.to(dev), ca.to(dev), y.to(dev))
        rels["GLVControl input_upscale 2"] = max(rel_l2(a.cpu(), b) for a, b in zip(got, want))
    for label in list(rels)[len(NEW_SAMPLERS):]:
        log(f"[samplers reference] {label}: card bf16 vs CPU fp32 rel_l2 {rels[label]:.4f} (bound {REF_REL_BOUND:g})")
    log(f"[samplers reference] controls: Heun without its correction rel_l2 {bad_heun:.4f}; a reuse step keeping "
        f"the recompute step's time embedding rel_l2 {bad_emb:.4f}")
    bad = {k: v for k, v in rels.items() if not v <= REF_REL_BOUND}
    if bad:
        raise AssertionError(f"[samplers reference] card and CPU disagree: {bad}")
    if not (bad_heun > REF_REL_BOUND and bad_emb > REF_REL_BOUND):
        raise AssertionError(f"[samplers reference] the bound misses a planted fault: Heun without its correction "
                             f"{bad_heun}, the stale time embedding {bad_emb}")
    del gpu_engine, card_unet, card_control
    _free()


def _caption_image():
    """The captioner's input: a seeded 1024^2 uint8 image."""
    import torch

    g = torch.Generator().manual_seed(SEED + 5)
    return torch.randint(0, 256, (SIZE, SIZE, 3), generator=g, dtype=torch.uint8).numpy()


GEMV_KERNELS = ("K5", "K5-act", "K6", "K7", "K9", "K10", "K11")
# the captioner's modes at full width: label -> (LlamaConfig flags, kv_dtype)
_INT4 = dict(quantize_int4=True, fused_qkv=True)
CAPTION_MODES = {
    "int4": (_INT4, "bfloat16"),
    "int4-unfused": (dict(_INT4, fused_glue=False), "bfloat16"),
    "int8": (dict(quantize_int8=True, fused_qkv=True), "bfloat16"),
    "int4-lean": (dict(_INT4, fused_pairs=True, head_int8=True), "int8"),
    "int4-w4a8": (dict(_INT4, act_int8=True), "bfloat16"),
    "int4-w4a8-unfused": (dict(_INT4, act_int8=True, fused_glue=False), "bfloat16"),
    "int4-native": (dict(_INT4, int4_native=True), "bfloat16"),
    "int4-half": (dict(_INT4, int4_paired=False), "bfloat16"),   # the JAX Int4Dense {q4, scale} layout
}


class _ActInt8Count:
    """K5's act_int8 launches, read and reset like a wrapper's counter."""

    def __init__(self, fn):
        self.fn = fn

    launches = property(lambda self: self.fn.act_int8_launches,
                        lambda self, n: setattr(self.fn, "act_int8_launches", n))


def _counters():
    from supir_tpu_torch.ops import quantize as Q

    return {"K5": Q.int4_paired_fused_matmul, "K5-act": _ActInt8Count(Q.int4_paired_fused_matmul),
            "K6": Q.int4_paired_matmul, "K7": Q.qmm, "K8": Q.quantize_int8, "K9": Q.int4_paired_fused_pair,
            "K10": Q.int4_w4a8_matmul, "K11": Q.int4_native_matmul}


def expected_caption_launches(llama, steps: int, load: bool = True) -> dict:
    """Kernel launches of `steps` decode steps, and of the load unless
    `load` is False, derived from the LlamaConfig. The prefill's rows exceed
    DECODE_ROWS, so it takes the plain versions and launches no GEMV. Per
    step: under fused_pairs 2 x layers - 1 K9 launches and 2 K5 (layer 0's
    qkv, the last layer's down); with fused glue 4 K5 per layer (counted
    also as K5-act under act_int8); else one launch per projection (4 per
    layer with merged qkv and gate-up, 7 without) of K11 (native), K10
    (act_int8), K6 (paired), K7 (half-split or int8); one K7 for an int8
    head. K8 quantizes at load every int8 projection and an int8 head."""
    n_layers = llama.layers
    per_layer = 4 if llama.fused_qkv else 7
    want = dict.fromkeys(("K5", "K5-act", "K6", "K7", "K8", "K9", "K10", "K11"), 0)
    if llama.fused_pairs:
        want["K9"], want["K5"] = (2 * n_layers - 1) * steps, 2 * steps
    elif llama.use_fused_glue:
        want["K5"] = 4 * n_layers * steps
        want["K5-act"] = want["K5"] if llama.act_int8 else 0
    elif llama.quantize_int4:
        kernel = ("K11" if llama.int4_native else ("K10" if llama.act_int8 else "K6") if llama.int4_paired
                  else "K7")
        want[kernel] = per_layer * n_layers * steps
    elif llama.quantize_int8:
        want["K7"] = per_layer * n_layers * steps
        want["K8"] = per_layer * n_layers if load else 0
    if llama.head_int8:
        want["K7"] += steps
        want["K8"] += 1 if load else 0
    return want


@contextlib.contextmanager
def gemv_sites():
    """Hold every K5, K6, K7, K9, K10 and K11 call of the captioner's Llama
    that reaches its kernel (at most DECODE_ROWS rows) to its plain version
    in fp32 on that call's inputs; the relative L2 errors (K9: the larger
    of its two outputs') land in the dict this yields, by kernel, K5's
    act_int8 calls under "K5-act". The Llama module sees a copy of the
    quantize module with watched wrappers; the wrappers themselves stay as
    they are."""
    import types

    from supir_tpu_torch.captioner import llama
    from supir_tpu_torch.ops import quantize as Q

    rels = {k: [] for k in GEMV_KERNELS}

    def watch(name, kernel, plain):
        def watched(x, *args, **kwargs):
            out = kernel(x, *args, **kwargs)
            if x.shape[0] <= Q.DECODE_ROWS:
                site = "K5-act" if name == "K5" and kwargs.get("act_int8") else name
                rels[site].append(_worst_rel(out, plain(x.float(), *args, **kwargs)))
            return out
        return watched

    proxy = types.SimpleNamespace(**vars(Q))
    proxy.int4_paired_fused_matmul = watch("K5", Q.int4_paired_fused_matmul, Q.int4_paired_fused_matmul_plain)
    proxy.int4_paired_matmul = watch("K6", Q.int4_paired_matmul, Q.int4_paired_matmul_plain)
    proxy.int8_matmul = watch("K7", Q.int8_matmul, lambda x, q, s: Q.qmm_plain(x, q, s, 8))
    proxy.int4_matmul = watch("K7", Q.int4_matmul, lambda x, q, s: Q.qmm_plain(x, q, s, 4))
    proxy.int4_paired_fused_pair = watch("K9", Q.int4_paired_fused_pair, Q.int4_paired_fused_pair_plain)
    proxy.int4_w4a8_matmul = watch("K10", Q.int4_w4a8_matmul, Q.int4_w4a8_matmul_plain)
    proxy.int4_native_matmul = watch("K11", Q.int4_native_matmul, Q.int4_native_matmul_plain)
    llama.Q = proxy
    try:
        yield rels
    finally:
        llama.Q = Q


def _site_bound(kernel: str) -> float:
    return W4A8_REL_BOUND if kernel == "K10" else GEMV_REL_BOUND


def _check_sites(label: str, rels, want_one_step) -> str:
    """Every GEMV call of one decode step within its bound, and as many calls
    of each kernel as one step launches; returns a summary."""
    want = dict(want_one_step, K5=want_one_step["K5"] - want_one_step["K5-act"])
    got = {k: len(v) for k, v in rels.items()}
    if any(got[k] != want[k] for k in GEMV_KERNELS):
        raise AssertionError(f"{label}: GEMV calls in one decode step {got}, expected "
                             f"{ {k: want[k] for k in GEMV_KERNELS} }")
    parts = []
    for k in GEMV_KERNELS:
        if rels[k]:
            _check_rel(f"{label} {k} sites", max(rels[k]), _site_bound(k))
            parts.append(f"{len(rels[k])} {k} calls worst rel_l2 {max(rels[k]):.3e} (bound {_site_bound(k):g})")
    return "; ".join(parts)


def profile_decode(label: str, agent, image, steps: int = 3):
    """torch.profiler over `steps` greedy decode steps after a prefill:
    wall time, the device's busy share of it, and device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        tok, plen, caches, _, _ = agent._prefill_images([image], None, "vicuna_v1")
        tok = agent._step(tok, plen, caches).argmax(-1)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                tok = agent._step(tok, plen + 1 + i, caches).argmax(-1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    # kernels only: an operator's device time is its kernels' time again
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows) / 1e3  # ms
    log(f"[profile {label}] {steps} decode steps: wall {wall * 1e3 / steps:.2f} ms/step with the profiler on, "
        f"device busy {busy / steps:.2f} ms/step ({busy / (wall * 1e3):.1%}), "
        f"{sum(r[2] for r in rows) // steps} kernels/step")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:10]:
        log(f"[profile {label}]   {us / 1e3 / steps:8.3f} ms/step  {count // steps:5d}/step  {key[:90]}")


def _mode_cfg(cfg, label: str):
    """cfg with the LlamaConfig flags and KV cache of CAPTION_MODES[label]."""
    flags, kv = CAPTION_MODES[label]
    return dataclasses.replace(cfg, kv_dtype=kv, llama=dataclasses.replace(cfg.llama, **flags))


def phase_captioner(label: str, image, chat: bool = False, then=None):
    """LLaVA-1.5-13B at full width on the card in one mode of CAPTION_MODES:
    load (random weights drawn and quantized layer by layer), one counted
    gen_image_caption, one timed again warm, then
    every GEMV call of one decode step held to its plain version, a profile
    of three decode steps and, with `chat`, one text-only chat turn; then
    `then(agent)`, where given, on the same agent. Returns the counted
    launches."""
    import gc

    import torch

    from supir_tpu_torch.captioner.agent import CaptionerConfig, create_captioner

    cfg = _mode_cfg(dataclasses.replace(CaptionerConfig(), compute_dtype="bfloat16", max_new_tokens=CAP_TOKENS), label)
    counters = _counters()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    agent = create_captioner(cfg, "cuda", seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model_bytes = nbytes(*agent.model.parameters(), *agent.model.buffers())

    marks = {}

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            marks[name] = time.perf_counter() - t
            marks[name + "_end"] = time.perf_counter()
            return out
        return wrapper

    def keep(fn):
        def wrapper(*a, **k):
            out = fn(*a, **k)
            marks["seqs"] = out[0]
            return out
        return wrapper

    agent._encode_image = timed("vision", agent._encode_image)
    agent._prefill = timed("prefill", agent._prefill)
    agent._decode_tokens = keep(agent._decode_tokens)

    def caption():
        text = agent.gen_image_caption([image], temperature=0.0)[0]
        torch.cuda.synchronize()
        n = marks["seqs"].shape[1]
        decode_ms = (time.perf_counter() - marks["prefill_end"]) * 1e3 / max(n - 1, 1)
        return text, n, decode_ms

    text, n, decode_ms = caption()
    launches = {k: fn.launches for k, fn in counters.items()}
    first = dict(marks)
    peak = torch.cuda.max_memory_allocated()
    text_warm, n_warm, decode_ms_warm = caption()
    log(f"[captioner {label}] LLaVA-1.5-13B full width, bf16 activations, {cfg.kv_dtype} KV cache "
        f"(cache_len {cfg.cache_len}), flags {CAPTION_MODES[label][0]}: {model_bytes / 1e9:.3f} GB of parameters "
        f"and buffers on the card; init and quantize {init_s:.1f} s; peak memory {peak / 2**30:.2f} GiB")
    log(f"[captioner {label}] first run: vision+projector {first['vision'] * 1e3:.1f} ms, prefill "
        f"{first['prefill'] * 1e3:.1f} ms, decode {decode_ms:.2f} ms/token over {n - 1} tokens; "
        f"warm run: vision+projector {marks['vision'] * 1e3:.1f} ms, prefill {marks['prefill'] * 1e3:.1f} ms, "
        f"decode {decode_ms_warm:.2f} ms/token over {n_warm - 1} tokens; caption {text[:48]!r}")
    if text_warm != text:
        raise AssertionError(f"greedy captions differ between two runs: {text!r} vs {text_warm!r}")

    want = expected_caption_launches(agent.cfg.llama, n - 1)
    log(f"[captioner {label}] launches {launches} (expected from the config for {n - 1} decoded tokens and the "
        f"load: {want})")
    if launches != want:
        raise AssertionError(f"captioner {label} launched {launches}, expected {want}")

    # every GEMV call of one decode step against its fp32 plain version
    with gemv_sites() as rels, torch.no_grad():
        tok, plen, caches, _, _ = agent._prefill_images([image], None, "vicuna_v1")
        agent._step(tok, plen, caches)
    summary = _check_sites(f"captioner {label}", rels, expected_caption_launches(agent.cfg.llama, 1, load=False))
    log(f"[captioner {label}] prompt {plen} tokens; one decode step vs fp32 plain: {summary}")
    profile_decode(label, agent, image)
    if chat:
        question = "What makes a photograph look sharp and detailed?"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reply = agent.chat(question, temperature=0.0)
        torch.cuda.synchronize()
        chat_s = time.perf_counter() - t0
        tokens = marks["seqs"].shape[1]
        log(f"[chat] {label}, full width: one text-only turn of {tokens} tokens in {chat_s:.3f} s "
            f"(prefill {marks['prefill'] * 1e3:.1f} ms, no image); reply {reply[:48]!r}")
        if tokens < 1:
            raise AssertionError("chat produced no token")
    if then is not None:
        then(agent)
    del agent, caches
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _logit_stream(agent, image, forced=None):
    """Prefill logits, then REF_STEPS decode steps' logits, fed greedily or
    with the `forced` tokens; -> (logits [REF_STEPS + 1, vocab] on the CPU,
    tokens)."""
    import torch

    with torch.no_grad():
        logits, plen, caches, _, _ = agent._prefill_logits([image], None, "vicuna_v1")
        rows, toks = [logits[0].float().cpu()], []
        for i in range(REF_STEPS):
            tok = logits.argmax(-1) if forced is None else forced[i].reshape(1).to(logits.device)
            toks.append(tok.cpu())
            logits = agent._step(tok, plen + i, caches)
            rows.append(logits[0].float().cpu())
    return torch.stack(rows), torch.cat(toks)


def phase_captioner_reference(image):
    """A reduced-width captioner (Llama dim 512, 4 layers, 8 heads of 64,
    hidden 1536; CLIP width 256, 2 layers, 112^2) with the same random
    weights on the card (bf16, kernels) and on the CPU (fp32, plain), in
    each mode of CAPTION_MODES; logits compared by relative L2, the card
    teacher-forced on the CPU's greedy tokens. The int8 KV cache and W4A8
    quantize activations on both sides, from bf16 values on the card and
    fp32 ones on the CPU, so a few roundings differ: the bound is the same."""
    import torch

    from supir_tpu_torch.captioner.agent import CaptionerConfig, create_captioner
    from supir_tpu_torch.captioner.llama import LlamaConfig
    from supir_tpu_torch.captioner.vision import CLIPVisionConfig

    cfg = CaptionerConfig(
        vision=CLIPVisionConfig(image_size=112, patch_size=14, width=256, layers=2, heads=4),
        llama=LlamaConfig(dim=512, layers=4, heads=8, kv_heads=8, hidden_dim=1536),
        max_new_tokens=REF_STEPS + 1, cache_len=512)
    sd = create_captioner(cfg, "cpu", seed=SEED + 7).model.state_dict()
    counters = _counters()
    for label in CAPTION_MODES:
        card_cfg = dataclasses.replace(_mode_cfg(cfg, label), compute_dtype="bfloat16")
        cpu_cfg = dataclasses.replace(card_cfg, compute_dtype="float32",
                                      kv_dtype="int8" if card_cfg.kv_dtype == "int8" else "float32")
        cpu = create_captioner(cpu_cfg, "cpu", state_dict=sd, stochastic=False)
        card = create_captioner(card_cfg, "cuda", state_dict=sd, stochastic=False)
        t0 = time.perf_counter()
        want, toks = _logit_stream(cpu, image)
        cpu_s = time.perf_counter() - t0
        for fn in counters.values():
            fn.launches = 0
        with gemv_sites() as rels:
            got, _ = _logit_stream(card, image, forced=toks)
        launches = {k: fn.launches for k, fn in counters.items()}
        expected = expected_caption_launches(card.cfg.llama, REF_STEPS, load=False)
        rel = max(rel_l2(g_, w_) for g_, w_ in zip(got, want))
        sites = _check_sites(f"captioner reference {label}", rels,
                             expected_caption_launches(card.cfg.llama, REF_STEPS, load=False))
        log(f"[captioner reference {label}] reduced width, card bf16 ({card_cfg.kv_dtype} KV) vs CPU fp32 "
            f"({cpu_cfg.kv_dtype} KV, "
            f"{cpu_s:.1f} s): prefill and {REF_STEPS} teacher-forced decode steps, worst logits rel_l2 {rel:.4e} "
            f"(bound {CAP_REF_REL_BOUND:g}), prefill rel_l2 {rel_l2(got[0], want[0]):.4e}; launches "
            f"{ {k: v for k, v in launches.items() if v} } (expected {expected}); {sites}")
        if not (rel <= CAP_REF_REL_BOUND and torch.isfinite(got).all()):
            raise AssertionError(f"captioner reference {label}: card and CPU disagree (rel_l2 {rel})")
        if launches != expected:
            raise AssertionError(f"captioner reference {label}: launched {launches}, expected {expected}")
        if label in ("int4", "int4-lean"):
            # planted fault: every packed byte with its nibbles exchanged
            packed = [m.qp for m in card.model.modules() if hasattr(m, "qp")]
            for t in packed:
                t.copy_(_swap_nibbles(t))
            bad, _ = _logit_stream(card, image, forced=toks)
            bad_rel = max(rel_l2(g_, w_) for g_, w_ in zip(bad, want))
            log(f"[captioner reference {label}] control (nibble order swapped in every projection): "
                f"worst logits rel_l2 {bad_rel:.4e}")
            if not bad_rel > CAP_REF_REL_BOUND:
                raise AssertionError(f"the captioner reference bound misses swapped nibbles: {bad_rel}")
        del cpu, card


# ------------------------------------------------------------- training

LOG2E = 1.4426950408889634
# K3/K4 at the training path's two self-attention shapes (the 64^2 and 32^2
# levels of a 1024^2 latent, batch 1) and causal at Llama-13B's heads
FLASH_TRAIN_SHAPES = ((1, 4096, 10, 64, False), (1, 1024, 20, 64, False), (1, 2048, 40, 128, True))


def _flash_flops(b: int, s: int, h: int, d: int, causal: bool, products: int) -> int:
    """Operations of `products` [S x T x D] products (two per multiply-add)
    over the query-key pairs the mask keeps (S == T)."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return 2 * products * b * h * pairs * d


def _k4_rels(grads, want):
    return [rel_l2(a, w) for a, w in zip(grads, want)]


def phase_flash_train_kernels():
    """K3 and K4 against their fp32 plain versions at FLASH_TRAIN_SHAPES,
    with planted faults; returns each kernel's JSON numbers (times at the
    first shape)."""
    import torch
    import torch.nn.functional as F

    from supir_tpu_torch.ops.flash_attention import (
        attention_bwd_plain,
        attention_fwd_lse_plain,
        flash_attention_bwd,
        flash_attention_fwd_lse,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4242)
    rows = {"K3": [], "K4": []}
    for b, s, h, d, causal in FLASH_TRAIN_SHAPES:
        tag = f"[{b},{s},{h},{d}]{' causal' if causal else ''}"
        q, k, v, dout = (torch.randn(b, s, h, d, generator=g, device=dev).to(torch.bfloat16) for _ in range(4))
        out, lse = flash_attention_fwd_lse(q, k, v, causal)
        want_out, want_lse = attention_fwd_lse_plain(q.float(), k.float(), v.float(), causal)
        rel, lse_err = rel_l2(out, want_out), (lse - want_lse).abs().max().item()
        # K4 on K3's residuals; its plain version on the same values in fp32
        grads = flash_attention_bwd(q, k, v, out, lse, dout, causal)
        want = attention_bwd_plain(q.float(), k.float(), v.float(), out.float(), lse, dout.float(), causal)
        rels = _k4_rels(grads, want)
        same = all(torch.equal(a, a2) for a, a2 in zip(grads, flash_attention_bwd(q, k, v, out, lse, dout, causal)))

        k3_ms = cuda_ms(lambda: flash_attention_fwd_lse(q, k, v, causal), 20)
        k3_plain = cuda_ms(lambda: attention_fwd_lse_plain(q, k, v, causal), 5)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        k3_lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal), 20)
        k3_bound, k3_by = bound(nbytes(q, k, v, out, lse), _flash_flops(b, s, h, d, causal, 2))
        graph = _graph_vs(lambda: flash_attention_fwd_lse(q, k, v, causal),
                          lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal), k3_bound)
        k4_ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, out, lse, dout, causal), 20)
        k4_plain = cuda_ms(lambda: attention_bwd_plain(q, k, v, out, lse, dout, causal), 5)
        # the library yardstick: SDPA's backward alone, through autograd
        leaves = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
        lib_grad = dout.transpose(1, 2)
        k4_lib = cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, lib_grad, retain_graph=True), 20)
        k4_bound, k4_by = bound(nbytes(q, k, v, out, dout, lse, *grads), _flash_flops(b, s, h, d, causal, 5))
        k4_graph = _k4_graph_vs(lambda: flash_attention_bwd(q, k, v, out, lse, dout, causal), (qt, kt, vt), lib_grad,
                                k4_bound, is_causal=causal)
        del leaves, lib_out
        log(f"[kernels] K3 {tag} bf16 vs fp32 plain: out rel_l2 {rel:.3e} (bound {K1_REL_BOUND:g}), lse max_abs_err "
            f"{lse_err:.3e} (bound {K3_LSE_BOUND:g}); {k3_ms:.4f} ms vs plain {k3_plain:.3f} ms, SDPA forward "
            f"{k3_lib:.4f} ms, bound {k3_bound:.4f} ms ({k3_by}): {_vs(k3_ms, k3_bound, k3_lib)}; {graph}")
        log(f"[kernels] K4 {tag} bf16 vs fp32 plain: rel_l2 dq {rels[0]:.3e}, dk {rels[1]:.3e}, dv {rels[2]:.3e} "
            f"(bound {K4_REL_BOUND:g} each), two runs bit-identical {same}; {k4_ms:.3f} ms vs plain "
            f"{k4_plain:.3f} ms, SDPA backward {k4_lib:.3f} ms, bound {k4_bound:.4f} ms ({k4_by}): "
            f"{_vs(k4_ms, k4_bound, k4_lib)}; {k4_graph}")
        _check_rel(f"K3 {tag}", rel, K1_REL_BOUND)
        if not lse_err <= K3_LSE_BOUND:
            raise AssertionError(f"K3 {tag}: lse max_abs_err {lse_err} over {K3_LSE_BOUND}")
        _check_rel(f"K4 {tag}", max(rels), K4_REL_BOUND)
        if not same:
            raise AssertionError(f"K4 {tag}: two runs differ")

        # planted faults: K3's lse in log2 units (its exp2 bookkeeping
        # slipped), and K4's (_k4_faults)
        _check_fault(f"K3 lse in log2 units {tag}: lse max_abs_err", (lse * LOG2E - want_lse).abs().max().item(),
                     K3_LSE_BOUND)
        _k4_faults(tag, lambda *a: flash_attention_bwd(*a, causal), q, k, v, out, lse, dout, grads, want)
        rows["K3"].append(dict(max_abs_err=(out.float() - want_out).abs().max().item(), ms=k3_ms,
                               plain_ms=k3_plain, library_ms=k3_lib, bound_ms=k3_bound, bound_by=k3_by))
        rows["K4"].append(dict(max_abs_err=max((a.float() - w).abs().max().item() for a, w in zip(grads, want)),
                               ms=k4_ms, plain_ms=k4_plain, library_ms=k4_lib, bound_ms=k4_bound, bound_by=k4_by))
        del q, k, v, dout, out, lse, grads, want, want_out, want_lse
        torch.cuda.empty_cache()
    return {name: dict(r[0], max_abs_err=max(x["max_abs_err"] for x in r)) for name, r in rows.items()}


def expected_train_launches(cfg, lat: int, remat: bool) -> dict:
    """Kernel launches of one train step, derived from the config. K1 runs
    at the frozen UNet encoder's flash sites (nothing there is
    differentiated); K3 and K4 at every flash site that trains (the control
    net's encoder and middle, the UNet's middle and decoder, the
    ZeroCrossAttns), K3 twice where remat recomputes the SpatialTransformer
    in the backward pass (all but the ZeroCrossAttns); K2 at the frozen
    encoder's GroupNorms, two per ResBlock and one per SpatialTransformer.
    Every other GroupNorm is differentiated and takes the plain form."""
    from supir_tpu_torch.ops.attention import flash_eligible

    u = cfg.unet
    frozen = transformer = xattn = 0
    for level in range(u.levels):
        ds = 2**level
        tokens = (lat // ds) ** 2
        if ds in u.attention_resolutions and flash_eligible(tokens, tokens, u.num_head_channels):
            frozen += u.num_res_blocks * u.transformer_depth[level]             # UNet encoder
            transformer += u.num_res_blocks * u.transformer_depth[level]        # control encoder
            transformer += (u.num_res_blocks + 1) * u.transformer_depth[level]  # UNet decoder
        if level > 0 and flash_eligible(tokens, tokens, 64):
            xattn += 1
    mid = (lat // 2 ** (u.levels - 1)) ** 2
    if (2 ** (u.levels - 1)) in u.attention_resolutions and flash_eligible(mid, mid, u.num_head_channels):
        transformer += 2 * u.middle_depth
    if frozen + transformer + xattn != expected_flash_sites(cfg, lat):
        raise AssertionError("the training site count disagrees with expected_flash_sites")
    encoder_transformers = sum(u.num_res_blocks for level in range(u.levels) if 2**level in u.attention_resolutions)
    return {"K1": frozen, "K2": 2 * u.levels * u.num_res_blocks + encoder_transformers,
            "K3": transformer * (2 if remat else 1) + xattn, "K4": transformer + xattn}


def _train_counters():
    from supir_tpu_torch.ops import flash_attention as fa
    from supir_tpu_torch.ops.groupnorm import group_norm

    return {"K1": fa.flash_attention, "K2": group_norm, "K3": fa.flash_attention_fwd_lse,
            "K4": fa.flash_attention_bwd}


class _Watched:
    """A kernel wrapper that runs `check(result, *args)` after each call.
    It stands in the wrapper's own module, where the wrapper counts its
    launches through its module-level name, so `launches` and
    `alibi_launches` here are the wrapped function's: a launch counts once,
    whichever name it goes by."""

    def __init__(self, fn, check):
        self.fn, self.check = fn, check

    def __call__(self, *args):
        result = self.fn(*args)
        self.check(result, *args)
        return result

    launches = property(lambda self: self.fn.launches, lambda self, n: setattr(self.fn, "launches", n))
    alibi_launches = property(lambda self: self.fn.alibi_launches,
                              lambda self, n: setattr(self.fn, "alibi_launches", n))


@contextlib.contextmanager
def flash_train_sites():
    """Hold every K3 and K4 call to its fp32 plain version on that call's
    inputs (K4's plain version on K4's own residuals); the readings land in
    the dict this yields."""
    from supir_tpu_torch.ops import flash_attention as fa

    readings = {"K3 out": [], "K3 lse": [], "K4": []}
    k3, k4 = fa.flash_attention_fwd_lse, fa.flash_attention_bwd

    def check_k3(result, q, k, v, causal=False, alibi_slopes=None):
        out, lse = result
        want_out, want_lse = fa.attention_fwd_lse_plain(q.float(), k.float(), v.float(), causal, alibi_slopes)
        readings["K3 out"].append(rel_l2(out, want_out))
        readings["K3 lse"].append((lse - want_lse).abs().max().item())

    def check_k4(grads, q, k, v, out, lse, dout, causal=False, alibi_slopes=None):
        want = fa.attention_bwd_plain(q.float(), k.float(), v.float(), out.float(), lse, dout.float(), causal,
                                      alibi_slopes)
        readings["K4"].append(max(_k4_rels(grads, want)))

    fa.flash_attention_fwd_lse, fa.flash_attention_bwd = _Watched(k3, check_k3), _Watched(k4, check_k4)
    try:
        yield readings
    finally:
        fa.flash_attention_fwd_lse, fa.flash_attention_bwd = k3, k4


def _check_train_sites(label: str, readings) -> None:
    log(f"[{label}] every K3/K4 call vs fp32 plain: {len(readings['K3 out'])} K3 calls, worst out rel_l2 "
        f"{max(readings['K3 out']):.3e} (bound {K1_REL_BOUND:g}), worst lse max_abs_err {max(readings['K3 lse']):.3e} "
        f"(bound {K3_LSE_BOUND:g}); {len(readings['K4'])} K4 calls, worst rel_l2 {max(readings['K4']):.3e} "
        f"(bound {K4_REL_BOUND:g})")
    if not (max(readings["K3 out"]) <= K1_REL_BOUND and max(readings["K3 lse"]) <= K3_LSE_BOUND
            and max(readings["K4"]) <= K4_REL_BOUND):
        raise AssertionError(f"{label}: a K3/K4 site disagrees with its plain version")


@contextlib.contextmanager
def group_norm_sites():
    """Hold every K2 call of the GroupNorm32 sites to its fp32 plain version
    on that call's inputs: per shape, the worst error in units of
    max(1, |y|) lands in the dict this yields. At |y| <= 1 that is the
    absolute error that K2_BOUND bounds in [kernels] (whose inputs are
    clamped so that |y| stays small); above, one bf16 rounding grows with
    |y| (2^-9 |y|), and so does the bound."""
    from supir_tpu_torch.models import layers
    from supir_tpu_torch.ops.groupnorm import group_norm_plain

    readings = collections.defaultdict(list)
    k2 = layers.group_norm

    def check(out, x, w, b, groups=32, eps=1e-5, silu=False):
        want = group_norm_plain(x.float(), w, b, groups, eps, silu)
        err = ((out.float() - want).abs() / want.abs().clamp_min(1.0)).max().item()
        readings[(tuple(x.shape), str(x.dtype).removeprefix("torch."), eps, silu)].append(err)

    layers.group_norm = _Watched(k2, check)
    try:
        yield readings
    finally:
        layers.group_norm = k2


def _check_norm_sites(label: str, readings) -> None:
    worst = {k: max(v, key=lambda e: (math.isnan(e), e)) for k, v in readings.items()}
    log(f"[{label}] every K2 call vs fp32 plain: {sum(map(len, readings.values()))} calls at {len(readings)} "
        f"shapes, worst error in units of max(1, |y|) by shape (bound {K2_BOUND:g}): "
        + "; ".join(f"{list(k[0])} {k[1]} eps {k[2]:g} silu {k[3]}: {e:.3e} ({len(readings[k])} calls)"
                    for k, e in worst.items()))
    if not readings or not all(e <= K2_BOUND for e in worst.values()):
        raise AssertionError(f"{label}: a K2 site disagrees with its plain version")


@contextlib.contextmanager
def detached_grad_sites():
    """Planted fault: the port before its repair. Every attention and
    GroupNorm site that trains runs K1 or K2 on detached inputs, so no
    gradient flows through it."""
    from supir_tpu_torch.models import layers
    from supir_tpu_torch.ops import attention as attn_ops
    from supir_tpu_torch.ops.flash_attention import flash_attention
    from supir_tpu_torch.ops.groupnorm import group_norm

    class Detached:
        @staticmethod
        def apply(q, k, v, causal=False, alibi_slopes=None):
            return flash_attention(q.detach(), k.detach(), v.detach(), causal, alibi_slopes)

    def detached_norm(x, w, b, groups=32, eps=1e-5, silu=False):
        return group_norm(x.detach().contiguous(), w.detach(), b.detach(), groups, eps, silu)

    saved = attn_ops.FlashAttention, layers.group_norm_plain
    attn_ops.FlashAttention, layers.group_norm_plain = Detached, detached_norm
    try:
        yield
    finally:
        attn_ops.FlashAttention, layers.group_norm_plain = saved


def _bit_sums(tensors):
    """Per tensor, the int64 sum of its bit patterns (int32 words; int16
    for 2-byte types): it changes when an element changes (short of a
    cancellation no optimizer step makes)."""
    import torch

    return torch.stack([t.detach().view(torch.int16 if t.element_size() == 2 else torch.int32).sum(dtype=torch.int64)
                        for t in tensors]).cpu()


# kernel name -> category of the train profile; the first match wins
TRAIN_PROFILE_GROUPS = (
    ("K1 (flash_fwd_kernel<D, false, *>)", lambda k: re.search(r"flash_fwd_kernel<\d+, false", k) is not None),
    ("K3 (flash_fwd_kernel<D, true, *>)", lambda k: re.search(r"flash_fwd_kernel<\d+, true", k) is not None),
    ("K4 (flash_bwd_*)", lambda k: "flash_bwd" in k),
    ("K2 (_gn_*)", lambda k: "_gn_" in k),
    ("convolutions (cuDNN, with its layout transposes)",
     lambda k: any(w in k for w in ("cudnn", "fprop", "dgrad", "wgrad", "conv", "Conv"))),
    ("GEMMs (cuBLAS)", lambda k: any(w in k for w in ("nvjet", "gemm", "Gemm", "xmma", "cutlass"))),
    ("optimizer and EMA (multi_tensor_apply)", lambda k: "multi_tensor_apply" in k),
    ("copies and casts", lambda k: "copy_kernel" in k),
    ("everything else (elementwise, reductions, norms)", lambda k: True),
)


def profile_train_step(trainer, z, cond, generator):
    """torch.profiler over one train step: wall time, device busy share,
    device time by category (TRAIN_PROFILE_GROUPS) and the top 12 kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(z, cond, generator)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernels only: the optimizer's annotation carries device time too
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False) and not e.key.startswith("Optimizer.")]
    busy = sum(r[1] for r in rows) / 1e3  # ms
    log(f"[profile train] one step: wall {wall:.3f} s with the profiler on, device busy {busy:.1f} ms "
        f"({busy / (wall * 1e3):.1%}), {sum(r[2] for r in rows)} kernels")
    sums = {name: [0.0, 0] for name, _ in TRAIN_PROFILE_GROUPS}
    for key, us, count in rows:
        name = next(n for n, match in TRAIN_PROFILE_GROUPS if match(key))
        sums[name][0] += us / 1e3
        sums[name][1] += count
    for name, (ms, count) in sums.items():
        log(f"[profile train]   {name}: {ms:.1f} ms ({ms / busy:.1%} of busy), {count} kernels")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"[profile train]   {us / 1e3:9.2f} ms  {count:6d}x  {key[:90]}")


def phase_train():
    """The full-width control-path trainer: TRAIN_STEPS steps, then one
    forward+backward with every K3/K4 call checked, then a profiled step.
    Returns the counted launches of the TRAIN_STEPS steps."""
    import gc

    import torch

    from supir_tpu_torch.config import SUPIRConfig
    from supir_tpu_torch.engine.factory import create_trainer
    from supir_tpu_torch.models.layers import GroupNorm32

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = SUPIRConfig()
    dev = torch.device("cuda")
    lat = SIZE // cfg.vae.downscale_factor
    t0 = time.perf_counter()
    trainer = create_trainer(cfg, dev, seed=SEED, remat=True, learning_rate=1e-5, ema_decay=0.9999)
    _randomize_all(trainer.engine.model, SEED + 8)
    trainer.init_state()
    torch.cuda.synchronize()
    model = trainer.engine.model
    n_train = sum(p.numel() for p in trainer.params.values())
    n_all = sum(p.numel() for p in model.parameters())
    log(f"[train] XL-base trainer, fp32 parameters, bf16 autocast, remat: {n_all / 1e9:.3f} B parameters, "
        f"{n_train / 1e9:.3f} B train ({len(trainer.params)} leaves), {len(trainer.stopped)} stop-gradient leaves; "
        f"AdamW lr 1e-5, EMA 0.9999; built and randomised on the card in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    z = torch.randn(1, lat, lat, 4, generator=g, device=dev)
    cond = {"crossattn": torch.randn(1, 77, cfg.unet.context_dim, generator=g, device=dev),
            "vector": torch.randn(1, cfg.unet.adm_in_channels, generator=g, device=dev),
            "control": torch.randn(1, lat, lat, 4, generator=g, device=dev)}
    frozen = {k: p for k, p in model.named_parameters() if not p.requires_grad}
    frozen_saved = {k: p.detach().cpu() for k, p in frozen.items()}
    params_before, ema_before = _bit_sums(trainer.params.values()), _bit_sums(trainer.ema_params.values())

    split = {"optimizer": [], "ema": []}

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            split[name].append(time.perf_counter() - t)
            return out
        return wrapper

    trainer.optimizer.step = timed("optimizer", trainer.optimizer.step)
    trainer.ema.update = timed("ema", trainer.ema.update)
    counters = _train_counters()
    for fn in counters.values():
        fn.launches = 0
    GroupNorm32.plain_sites = 0
    losses, steps, fwd_bwd = [], [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.loss_and_grads(z, cond, g)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.apply_gradients()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        losses.append(loss.item())
        steps.append(t2 - t0)
        fwd_bwd.append(t1 - t0)
        log(f"[train] step {i + 1}/{TRAIN_STEPS}{' (warm-up)' if i == 0 else ''}: loss {losses[-1]:.6g}, "
            f"{steps[-1]:.3f} s (forward+backward {fwd_bwd[-1]:.3f} s, optimizer {split['optimizer'][-1]:.3f} s, "
            f"EMA {split['ema'][-1]:.3f} s); peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    launches = {name: fn.launches for name, fn in counters.items()}
    plain_sites = GroupNorm32.plain_sites
    n_timed = TRAIN_STEPS - 1
    log(f"[train] {SIZE}^2 image (latent {lat}^2), batch 1: {sum(steps[1:]) / n_timed:.3f} s/step over {n_timed} "
        f"timed steps (forward+backward {sum(fwd_bwd[1:]) / n_timed:.3f} s, optimizer "
        f"{sum(split['optimizer'][1:]) / n_timed:.3f} s, EMA {sum(split['ema'][1:]) / n_timed:.3f} s); "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    per_step = expected_train_launches(cfg, lat, remat=True)
    want = {k: n * TRAIN_STEPS for k, n in per_step.items()}
    log(f"[train] launches over {TRAIN_STEPS} steps {launches} (expected {want}: per step {per_step}); "
        f"GroupNorm calls on the plain differentiable form {plain_sites} ({plain_sites // TRAIN_STEPS} per step)")
    if launches != want:
        raise AssertionError(f"train launches {launches}, expected {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    changed = [k for k, p in frozen.items() if not torch.equal(p.detach().cpu(), frozen_saved[k])]
    unmoved = [k for k, a, b in zip(trainer.params, params_before, _bit_sums(trainer.params.values())) if a == b]
    ema_unmoved = [k for k, a, b in zip(trainer.ema_params, ema_before, _bit_sums(trainer.ema_params.values()))
                   if a == b]
    log(f"[train] after {TRAIN_STEPS} steps: {len(frozen) - len(changed)}/{len(frozen)} frozen leaves bit-identical "
        f"(stop-gradient UNet encoder and the VAE), {len(trainer.params) - len(unmoved)}/{len(trainer.params)} "
        f"trainable leaves moved, {len(trainer.ema_params) - len(ema_unmoved)}/{len(trainer.ema_params)} EMA leaves moved")
    if changed or unmoved or ema_unmoved:
        raise AssertionError(f"frozen changed {changed[:3]}, trainable unmoved {unmoved[:3]}, "
                             f"EMA unmoved {ema_unmoved[:3]}")
    del frozen_saved

    with flash_train_sites() as readings:
        trainer.loss_and_grads(z, cond, g)
    _check_train_sites("train", readings)
    profile_train_step(trainer, z, cond, g)
    del trainer, model, frozen
    gc.collect()
    torch.cuda.empty_cache()
    return launches


GRAD_GROUPS = {
    "control": ("model.control_model.",),
    "UNet middle+decoder": ("model.diffusion_model.middle_block.", "model.diffusion_model.output_blocks.",
                            "model.diffusion_model.out."),
    "adapters": ("model.diffusion_model.project_modules.",),
}


def _group_rels(got, want):
    """Relative L2 of each GRAD_GROUPS group's gradients, all its leaves
    taken as one vector; a missing gradient counts as zero."""
    rels = {}
    for group, prefixes in GRAD_GROUPS.items():
        keys = [k for k in want if k.startswith(prefixes)]
        err = sum(float(((got[k] if got[k] is not None else 0.0) - want[k]).norm() ** 2) for k in keys)
        rels[group] = (err / sum(float(want[k].norm() ** 2) for k in keys)) ** 0.5
    return rels


def phase_train_reference():
    """One reduced-width train step on the card (bf16 autocast, kernels) and
    on the CPU (fp32, plain versions) from the same state with the same
    sigma and noise: loss and gradients must agree; the detached-sites
    fault must break the bound."""
    import torch

    from supir_tpu_torch.diffusion.sigma_sampling import discrete_sampling
    from supir_tpu_torch.engine.factory import create_trainer

    cfg = _reduced_cfg()
    size = 512
    lat = size // cfg.vae.downscale_factor
    cpu = create_trainer(cfg, "cpu", seed=SEED, remat=False)
    _randomize_all(cpu.engine.model, SEED + 10)
    card = create_trainer(cfg, "cuda", state_dict=cpu.engine.model.state_dict())
    g = torch.Generator().manual_seed(SEED + 11)
    z = torch.randn(1, lat, lat, 4, generator=g)
    cond = {"crossattn": torch.randn(1, 77, cfg.unet.context_dim, generator=g),
            "vector": torch.randn(1, cfg.unet.adm_in_channels, generator=g),
            "control": torch.randn(1, lat, lat, 4, generator=g)}
    sigma, _ = discrete_sampling(g, 1)
    noise = torch.randn(1, lat, lat, 4, generator=g)

    t0 = time.perf_counter()
    want_loss = cpu.loss_and_grads(z, cond, sigma=sigma, noise=noise).item()
    cpu_s = time.perf_counter() - t0
    want = {k: p.grad for k, p in cpu.params.items()}
    dev = torch.device("cuda")
    args = (z.to(dev), {k: v.to(dev) for k, v in cond.items()})
    kw = dict(sigma=sigma.to(dev), noise=noise.to(dev))

    def step():
        loss = card.loss_and_grads(*args, **kw).item()
        return loss, {k: None if p.grad is None else p.grad.float().cpu() for k, p in card.params.items()}

    counters = _train_counters()
    for fn in counters.values():
        fn.launches = 0
    with flash_train_sites() as readings:
        got_loss, got = step()
    launches = {name: fn.launches for name, fn in counters.items()}
    expected = expected_train_launches(cfg, lat, remat=True)
    loss_rel = abs(got_loss - want_loss) / abs(want_loss)
    rels = _group_rels(got, want)
    log(f"[train reference] reduced width, {size}^2, sigma {sigma.item():.4f}: card bf16 loss {got_loss:.6g} vs "
        f"CPU fp32 {want_loss:.6g} ({cpu_s:.1f} s), relative {loss_rel:.3e} (bound {TRAIN_LOSS_BOUND:g}); gradients "
        f"rel_l2 " + ", ".join(f"{k} {v:.3e}" for k, v in rels.items()) + f" (bound {TRAIN_GRAD_BOUND:g}); "
        f"launches {launches} (expected {expected})")
    _check_train_sites("train reference", readings)
    if not (loss_rel <= TRAIN_LOSS_BOUND and max(rels.values()) <= TRAIN_GRAD_BOUND and math.isfinite(got_loss)):
        raise AssertionError(f"train reference: card and CPU disagree (loss {loss_rel}, gradients {rels})")
    if launches != expected:
        raise AssertionError(f"train reference launched {launches}, expected {expected}")

    with detached_grad_sites():
        bad_loss, bad = step()
    bad_rels = _group_rels(bad, want)
    log(f"[train reference] control (gradient sites sent to K1/K2, detached): loss relative "
        f"{abs(bad_loss - want_loss) / abs(want_loss):.3e}, gradients rel_l2 "
        + ", ".join(f"{k} {v:.3e}" for k, v in bad_rels.items()))
    if not max(bad_rels.values()) > TRAIN_GRAD_BOUND:
        raise AssertionError(f"the train reference bound misses detached gradient sites: {bad_rels}")
    del cpu, card


# ------------------------------------------------------------------- MPT

MPT_PROMPT = 1536     # prompt tokens of the full-width generate (random ids)
MPT_TOKENS = 32       # greedy tokens decoded after it
MPT_CACHE = 2048      # cache_len: MPT-7B's context
MPT_GRAD_TOKENS = 2048  # one sequence of the gradient phase
MPT_REF_TOKENS = 1024  # reduced-width reference: flash-eligible sequences
MPT_REF_NEW = 16      # greedy tokens of the reduced-width reference
# K3/K4 ALiBi: the MPT-7B prefill of 2048 tokens (causal), and a non-causal shape
ALIBI_SHAPES = ((1, 2048, 32, 128, True), (1, 1024, 8, 64, False))


class _AlibiCount:
    """The ALiBi launches of `fns` (their `alibi_launches`), read as one
    counter and reset together: K3 ALiBi runs under K1's wrapper (no lse,
    no grad) and K3's (with lse, under grad)."""

    def __init__(self, *fns):
        self.fns = fns

    launches = property(lambda self: sum(f.alibi_launches for f in self.fns),
                        lambda self, n: [setattr(f, "alibi_launches", n) for f in self.fns])


def _mpt_counters():
    from supir_tpu_torch.ops import flash_attention as fa

    return {"K3-alibi": _AlibiCount(fa.flash_attention, fa.flash_attention_fwd_lse),
            "K3-alibi lse": _AlibiCount(fa.flash_attention_fwd_lse), "K4-alibi": _AlibiCount(fa.flash_attention_bwd),
            "K1": fa.flash_attention, "K3": fa.flash_attention_fwd_lse, "K4": fa.flash_attention_bwd}


def _reset(counters):
    for c in counters.values():
        c.launches = 0


def _read(counters):
    return {name: c.launches for name, c in counters.items()}


def phase_alibi_kernels():
    """K3 ALiBi and K4 ALiBi against their fp32 plain versions at
    ALIBI_SHAPES with MPT's slopes, and their planted faults; returns each
    kernel's JSON numbers (times at the MPT-7B prefill shape)."""
    import torch
    import torch.nn.functional as F

    from supir_tpu_torch.captioner.mpt import alibi_slopes
    from supir_tpu_torch.ops.flash_attention import (
        alibi_bias,
        attention_bwd_plain,
        attention_fwd_lse_plain,
        flash_attention,
        flash_attention_bwd,
        flash_attention_fwd_lse,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5151)
    rows = {"K3-alibi": [], "K4-alibi": []}
    for b, s, h, d, causal in ALIBI_SHAPES:
        tag = f"[{b},{s},{h},{d}]{' causal' if causal else ''}"
        q, k, v, dout = (torch.randn(b, s, h, d, generator=g, device=dev).to(torch.bfloat16) for _ in range(4))
        slopes = torch.from_numpy(alibi_slopes(h)).to(dev)
        out, lse = flash_attention_fwd_lse(q, k, v, causal, slopes)
        want_out, want_lse = attention_fwd_lse_plain(q.float(), k.float(), v.float(), causal, slopes)
        rel, lse_err = rel_l2(out, want_out), (lse - want_lse).abs().max().item()
        same_primal = torch.equal(flash_attention(q, k, v, causal, slopes), out)
        grads = flash_attention_bwd(q, k, v, out, lse, dout, causal, slopes)
        want = attention_bwd_plain(q.float(), k.float(), v.float(), out.float(), lse, dout.float(), causal, slopes)
        rels = _k4_rels(grads, want)
        same = all(torch.equal(a, a2) for a, a2 in zip(grads, flash_attention_bwd(q, k, v, out, lse, dout, causal,
                                                                                   slopes)))

        k3_ms = cuda_ms(lambda: flash_attention_fwd_lse(q, k, v, causal, slopes), 20)
        # the instantiation without lse, which the generate path's prefill runs
        k3_primal_ms = cuda_ms(lambda: flash_attention(q, k, v, causal, slopes), 20)
        k3_plain = cuda_ms(lambda: attention_fwd_lse_plain(q, k, v, causal, slopes), 5)
        # the library yardstick: SDPA with the ALiBi bias (and the causal
        # mask) materialised as a float attn_mask
        mask = alibi_bias(slopes, s, dev).expand(b, h, s, s)
        if causal:
            mask = mask.masked_fill(~torch.ones(s, s, dtype=torch.bool, device=dev).tril(), float("-inf"))
        mask = mask.to(torch.bfloat16).contiguous()
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        k3_lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), 20)
        k3_bound, k3_by = bound(nbytes(q, k, v, out, lse, slopes), _flash_flops(b, s, h, d, causal, 2))
        graph = _graph_vs(lambda: flash_attention_fwd_lse(q, k, v, causal, slopes),
                          lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), k3_bound)
        k4_ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, out, lse, dout, causal, slopes), 20)
        k4_plain = cuda_ms(lambda: attention_bwd_plain(q, k, v, out, lse, dout, causal, slopes), 5)
        leaves = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        lib_grad = dout.transpose(1, 2)
        k4_lib = cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, lib_grad, retain_graph=True), 20)
        k4_bound, k4_by = bound(nbytes(q, k, v, out, dout, lse, slopes, *grads), _flash_flops(b, s, h, d, causal, 5))
        k4_graph = _k4_graph_vs(lambda: flash_attention_bwd(q, k, v, out, lse, dout, causal, slopes), (qt, kt, vt),
                                lib_grad, k4_bound, attn_mask=mask)
        del leaves, lib_out, mask
        log(f"[kernels] K3-alibi {tag} bf16 vs fp32 plain: out rel_l2 {rel:.3e} (bound {K1_REL_BOUND:g}), lse "
            f"max_abs_err {lse_err:.3e} (bound {K3_LSE_BOUND:g}), without lse the same output {same_primal}; "
            f"{k3_ms:.4f} ms (without lse {k3_primal_ms:.4f} ms) vs plain {k3_plain:.3f} ms, SDPA forward with "
            f"the bias as attn_mask {k3_lib:.4f} ms, bound {k3_bound:.4f} ms ({k3_by}): "
            f"{_vs(k3_ms, k3_bound, k3_lib)}; {graph}")
        log(f"[kernels] K4-alibi {tag} bf16 vs fp32 plain: rel_l2 dq {rels[0]:.3e}, dk {rels[1]:.3e}, dv "
            f"{rels[2]:.3e} (bound {K4_REL_BOUND:g} each), two runs bit-identical {same}; {k4_ms:.3f} ms vs plain "
            f"{k4_plain:.3f} ms, SDPA backward with the mask {k4_lib:.3f} ms, bound {k4_bound:.4f} ms ({k4_by}): "
            f"{_vs(k4_ms, k4_bound, k4_lib)}; {k4_graph}")
        _check_rel(f"K3-alibi {tag}", rel, K1_REL_BOUND)
        if not lse_err <= K3_LSE_BOUND:
            raise AssertionError(f"K3-alibi {tag}: lse max_abs_err {lse_err} over {K3_LSE_BOUND}")
        _check_rel(f"K4-alibi {tag}", max(rels), K4_REL_BOUND)
        if not (same and same_primal):
            raise AssertionError(f"K3/K4-alibi {tag}: two runs differ")

        # planted faults: the bias in scaled instead of raw units (the kernel
        # adding slope * dist to raw q.k), the heads' slopes reversed, and K4
        # recomputing P without the bias. The -(T - 1) offset dropped is
        # emulated on the sound kernel's lse (slope_h * (T - 1) more on every
        # row): no kernel is built without it, and the O it prints is the
        # sound kernel's, which the per-row constant cannot change in exact
        # arithmetic; the lse bound must see it, and K4 given that lse
        scaled, _ = flash_attention_fwd_lse(q, k, v, causal, slopes * d ** -0.5)
        _check_fault(f"K3-alibi bias in scaled units {tag}: out", rel_l2(scaled, want_out), K1_REL_BOUND)
        flipped, _ = flash_attention_fwd_lse(q, k, v, causal, slopes.flip(0))
        _check_fault(f"K3-alibi slopes reversed {tag}: out", rel_l2(flipped, want_out), K1_REL_BOUND)
        no_offset = lse + (slopes * (s - 1))[None, :, None]
        log(f"[kernels] control (K3-alibi offset -(T-1) dropped {tag}, emulated on the lse): the sound "
            f"kernel's out rel_l2 {rel:.3e} (inside {K1_REL_BOUND:g}), emulated lse max_abs_err "
            f"{(no_offset - want_lse).abs().max().item():.3e}")
        _check_fault(f"K3-alibi offset dropped (emulated) {tag}: lse max_abs_err",
                     (no_offset - want_lse).abs().max().item(), K3_LSE_BOUND)
        _check_fault(f"K4-alibi given the emulated offset-dropped lse {tag}",
                     max(_k4_rels(flash_attention_bwd(q, k, v, out, no_offset, dout, causal, slopes), want)),
                     K4_REL_BOUND)
        _check_fault(f"K4-alibi without the bias {tag}",
                     max(_k4_rels(flash_attention_bwd(q, k, v, out, lse, dout, causal), want)), K4_REL_BOUND)
        _k4_faults(tag, lambda *a: flash_attention_bwd(*a, causal, slopes), q, k, v, out, lse, dout, grads, want,
                   alibi=True)
        rows["K3-alibi"].append(dict(max_abs_err=(out.float() - want_out).abs().max().item(), ms=k3_ms,
                                     plain_ms=k3_plain, library_ms=k3_lib, bound_ms=k3_bound, bound_by=k3_by))
        rows["K4-alibi"].append(dict(max_abs_err=max((a.float() - w).abs().max().item() for a, w in zip(grads, want)),
                                     ms=k4_ms, plain_ms=k4_plain, library_ms=k4_lib, bound_ms=k4_bound,
                                     bound_by=k4_by))
        del q, k, v, dout, out, lse, grads, want, want_out, want_lse
        torch.cuda.empty_cache()
    return {name: dict(r[0], max_abs_err=max(x["max_abs_err"] for x in r)) for name, r in rows.items()}


@contextlib.contextmanager
def alibi_prefill_sites():
    """Hold every K3-alibi call without lse (the prefill's attention sites)
    to its fp32 plain version on that call's inputs; the relative L2 errors
    land in the list this yields."""
    from supir_tpu_torch.ops import attention as attn_ops
    from supir_tpu_torch.ops.flash_attention import attention_plain

    rels = []
    k1 = attn_ops.flash_attention

    def check(out, q, k, v, causal=False, alibi_slopes=None):
        rels.append(rel_l2(out, attention_plain(q.float(), k.float(), v.float(), causal, alibi_slopes=alibi_slopes)))

    attn_ops.flash_attention = _Watched(k1, check)
    try:
        yield rels
    finally:
        attn_ops.flash_attention = k1


def _free():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def profile_mpt_decode(model, tok, plen: int, caches, steps: int = 3):
    """torch.profiler over `steps` cached decode steps: wall per step, the
    device's busy share, kernels per step and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                logits, caches = model(tok[:, None], caches=caches, cache_index=plen + i)
                tok = logits[:, -1].argmax(-1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows) / 1e3
    log(f"[profile mpt] {steps} decode steps: wall {wall * 1e3 / steps:.2f} ms/step with the profiler on, device "
        f"busy {busy / steps:.2f} ms/step ({busy / (wall * 1e3):.1%}), {sum(r[2] for r in rows) // steps} kernels/step")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:8]:
        log(f"[profile mpt]   {us / 1e3 / steps:8.3f} ms/step  {count // steps:5d}/step  {key[:90]}")


def phase_mpt_generate():
    """MPT-7B at full width and depth (random bf16 weights drawn on the
    card) generates MPT_TOKENS greedy tokens after a MPT_PROMPT-token prompt
    through mpt_generate: the prefill's attention is K3 ALiBi at every layer,
    the decode steps take the plain biased route; the launches of that run
    must match the config."""
    import torch

    from supir_tpu_torch.captioner.mpt import MPTConfig, create_mpt, mpt_generate

    _free()
    torch.cuda.reset_peak_memory_stats()
    cfg = MPTConfig()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = create_mpt(cfg, dev, torch.bfloat16, seed=SEED + 20).requires_grad_(False)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    log(f"[mpt generate] MPT-7B (d_model {cfg.d_model}, {cfg.n_layers} layers, {cfg.n_heads} heads of "
        f"{cfg.head_dim}, vocab {cfg.vocab_size}): {n / 1e9:.3f} B parameters, bf16, drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    ids = torch.randint(0, cfg.vocab_size, (1, MPT_PROMPT), generator=torch.Generator().manual_seed(SEED + 21))
    ids = ids.to(dev)
    mpt_generate(model, ids, max_new_tokens=2, cache_len=MPT_CACHE, eos_id=-1)  # warm-up
    counters = _mpt_counters()
    _reset(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = mpt_generate(model, ids, max_new_tokens=MPT_TOKENS, cache_len=MPT_CACHE, eos_id=-1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read(counters)
    want = {"K3-alibi": cfg.n_layers, "K3-alibi lse": 0, "K4-alibi": 0, "K1": 0, "K3": 0, "K4": 0}
    log(f"[mpt generate] mpt_generate, prompt {MPT_PROMPT} tokens, cache_len {MPT_CACHE}, {toks.shape[1]} greedy "
        f"tokens in {wall:.3f} s; launches {launches} (expected {want}); tokens {toks[0, :12].tolist()}...")
    if launches != want:
        raise AssertionError(f"mpt generate launched {launches}, expected {want}")
    if toks.shape != (1, MPT_TOKENS) or not (0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size):
        raise AssertionError(f"mpt generate: tokens {tuple(toks.shape)} out of shape or range")

    with torch.no_grad():
        caches = model.init_cache(1, MPT_CACHE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model(ids, caches=caches, cache_index=0)
        torch.cuda.synchronize()
        prefill = time.perf_counter() - t0
        finite = bool(torch.isfinite(logits).all())
        tok = logits[:, -1].argmax(-1)
        steps = 8
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            step_logits, caches = model(tok[:, None], caches=caches, cache_index=MPT_PROMPT + i)
            tok = step_logits[:, -1].argmax(-1)
        torch.cuda.synchronize()
        per_token = (time.perf_counter() - t0) / steps
        log(f"[mpt generate] prefill {MPT_PROMPT} tokens {prefill * 1e3:.1f} ms (logits {tuple(logits.shape)} "
            f"{logits.dtype}, finite {finite}); decode {per_token * 1e3:.2f} ms/token over {steps} steps "
            f"(synchronised each step); peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if not finite:
            raise AssertionError("mpt prefill logits are not finite")
        profile_mpt_decode(model, tok, MPT_PROMPT + steps, caches)
        del caches, logits, step_logits
        with alibi_prefill_sites() as rels:
            model(ids, caches=model.init_cache(1, MPT_CACHE), cache_index=0)
    log(f"[mpt generate] every prefill attention (K3-alibi) vs fp32 plain: {len(rels)} calls, worst rel_l2 "
        f"{max(rels):.3e} (bound {K1_REL_BOUND:g})")
    if len(rels) != cfg.n_layers or not max(rels) <= K1_REL_BOUND:
        raise AssertionError(f"mpt prefill sites: {len(rels)} calls, worst {max(rels)}")
    del model
    _free()


def _mpt_labels(n: int):
    """(ids, labels) of one n-token sequence: a generated conversation in
    MPT's template through preprocess_mpt on the byte tokenizer (no bos),
    the user turns masked, cut to n tokens."""
    import numpy as np

    from supir_tpu_torch.captioner.preprocess import ByteTokenizer, preprocess_mpt

    rng = np.random.default_rng(SEED + 22)
    words = ["harbor", "ship", "amber", "teal", "light", "water", "sail", "grey", "dusk", "wave", "stone", "mast"]
    turns = []
    while sum(len(t["value"]) for t in turns) < 2 * n:
        for who in ("human", "gpt"):
            turns.append({"from": who, "value": " ".join(rng.choice(words, 40)) + "."})
    out = preprocess_mpt([turns], ByteTokenizer(bos=False))
    ids, labels = np.asarray(out["input_ids"][0][:n]), np.asarray(out["labels"][0][:n])
    if len(ids) != n or (labels == -100).all():
        raise AssertionError(f"the generated conversation holds {len(ids)} tokens (wanted {n}), "
                             f"{int((labels != -100).sum())} unmasked labels")
    return ids, labels


def phase_mpt_grad():
    """One causal-LM loss and its backward through MPT-7B at full width and
    depth, bf16 parameters, one MPT_GRAD_TOKENS-token sequence: a warm-up
    with every K3/K4 ALiBi call held to its plain version, then the counted
    and timed run. Returns the counted launches."""
    import torch

    from supir_tpu_torch.captioner.mpt import MPTConfig, create_mpt
    from supir_tpu_torch.captioner.train import IGNORE_INDEX, causal_lm_loss

    _free()
    torch.cuda.reset_peak_memory_stats()
    cfg = MPTConfig()
    dev = torch.device("cuda")
    model = create_mpt(cfg, dev, torch.bfloat16, seed=SEED + 23)
    ids, labels = _mpt_labels(MPT_GRAD_TOKENS)
    ids, labels = torch.from_numpy(ids)[None].to(dev), torch.from_numpy(labels)[None].to(dev)
    log(f"[mpt grad] MPT-7B, bf16 parameters ({sum(p.numel() for p in model.parameters()) / 1e9:.3f} B, all "
        f"trained), one sequence of {MPT_GRAD_TOKENS} tokens from preprocess_mpt, "
        f"{int((labels != IGNORE_INDEX).sum())} unmasked labels")

    def step():
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = causal_lm_loss(model(ids), labels)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), time.perf_counter() - t0

    with flash_train_sites() as readings:
        warm_loss, warm_s = step()
    _check_train_sites("mpt grad", readings)
    counters = _mpt_counters()
    _reset(counters)
    loss, seconds = step()
    launches = _read(counters)
    want = {"K3-alibi": cfg.n_layers, "K3-alibi lse": cfg.n_layers, "K4-alibi": cfg.n_layers, "K1": 0, "K3": 0,
            "K4": 0}
    grads = [p.grad for p in model.parameters()]
    sq = sum(float(g.float().pow(2).sum()) for g in grads if g is not None)
    missing = sum(g is None for g in grads)
    log(f"[mpt grad] loss {loss:.6g} (warm-up, sites checked: {warm_loss:.6g}, {warm_s:.3f} s); forward+backward "
        f"{seconds:.3f} s; gradient norm {sq ** 0.5:.4g}, {missing} parameters without a gradient; launches "
        f"{launches} (expected {want}); peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches != want:
        raise AssertionError(f"mpt grad launched {launches}, expected {want}")
    if not (math.isfinite(loss) and math.isfinite(sq) and sq > 0 and missing == 0):
        raise AssertionError(f"mpt grad: loss {loss}, gradient norm^2 {sq}, {missing} missing")
    del model, grads
    _free()
    return launches


MPT_GRAD_GROUPS = {
    "embedding": (".wte.",),
    "attention": (".attn.",),
    "MLP": (".ffn.",),
    "norms": (".norm_",),
}


def _mpt_group_rels(got, want):
    rels = {}
    for group, keys in MPT_GRAD_GROUPS.items():
        names = [k for k in want if any(s in k for s in keys)]
        err = sum(float((got[k] - want[k]).norm() ** 2) for k in names)
        rels[group] = (err / sum(float(want[k].norm() ** 2) for k in names)) ** 0.5
    return rels


def phase_mpt_reference():
    """Reduced-width MPT (d_model 512, 8 heads of 64, 4 layers; multiquery
    too; six heads on the plain route) on the card (bf16 parameters,
    kernels) and on the CPU (fp32, plain versions) with the same weights:
    logits, gradient groups, greedy tokens, prefix-LM logits."""
    import numpy as np
    import torch

    from supir_tpu_torch.captioner.mpt import MPTConfig, create_mpt, init_mpt_params, mpt_generate
    from supir_tpu_torch.captioner.train import causal_lm_loss
    from supir_tpu_torch.ops.attention import flash_eligible
    from supir_tpu_torch.utils.weights import mpt_state_dict_from_jax

    dev = torch.device("cuda")
    base = MPTConfig(d_model=512, n_layers=4, n_heads=8)
    variants = {
        "8 heads": (base, MPT_REF_TOKENS),
        "multiquery": (dataclasses.replace(base, multiquery=True), MPT_REF_TOKENS),
        "6 heads, plain route": (dataclasses.replace(base, d_model=384, n_heads=6), MPT_REF_TOKENS // 2),
    }
    counters = _mpt_counters()
    for label, (cfg, n) in variants.items():
        sd = mpt_state_dict_from_jax(init_mpt_params(cfg, seed=SEED + 24), cfg)
        cpu = create_mpt(cfg, "cpu", torch.float32, state_dict=sd)
        card = create_mpt(cfg, dev, torch.bfloat16, state_dict=sd)
        rng = np.random.default_rng(SEED + 25)
        ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n)))
        labels = ids.clone()
        labels[:, : n // 4] = -100
        flash = flash_eligible(n, n, cfg.head_dim)

        t0 = time.perf_counter()
        want_logits = cpu(ids)
        want_loss = causal_lm_loss(want_logits, labels)
        want_loss.backward()
        cpu_s = time.perf_counter() - t0
        want = {k: p.grad for k, p in cpu.named_parameters()}
        _reset(counters)
        with torch.no_grad():
            logits = card(ids.to(dev))
        fwd = _read(counters)
        _reset(counters)
        loss = causal_lm_loss(card(ids.to(dev)), labels.to(dev))
        loss.backward()
        bwd = _read(counters)
        got = {k: p.grad.float().cpu() for k, p in card.named_parameters()}
        logit_rel = rel_l2(logits.cpu(), want_logits.detach())
        loss_rel = abs(loss.item() - want_loss.item()) / abs(want_loss.item())
        rels = _mpt_group_rels(got, want)
        log(f"[mpt reference] {label} (d_model {cfg.d_model}, {cfg.n_layers} layers, {n} tokens): card bf16 vs CPU "
            f"fp32 ({cpu_s:.1f} s): logits rel_l2 {logit_rel:.3e}, loss {loss.item():.6g} vs {want_loss.item():.6g} "
            f"(relative {loss_rel:.3e}); gradients rel_l2 " + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
            + f" (bound {REF_REL_BOUND:g}); launches forward {fwd}, forward+backward {bwd}")
        k = cfg.n_layers if flash else 0
        if fwd["K3-alibi"] != k or bwd["K3-alibi lse"] != k or bwd["K4-alibi"] != k:
            raise AssertionError(f"mpt reference {label}: launches {fwd} / {bwd}, expected {k} of each")
        if not (logit_rel <= REF_REL_BOUND and max(rels.values()) <= REF_REL_BOUND):
            raise AssertionError(f"mpt reference {label}: card and CPU disagree ({logit_rel}, {rels})")
        del want, got, logits, want_logits

        if label == "8 heads":
            # greedy tokens up to the first divergence (bf16 against fp32:
            # a near tie may flip a token, after which the streams part)
            want_toks = mpt_generate(cpu, ids, max_new_tokens=MPT_REF_NEW, eos_id=-1)
            got_toks = mpt_generate(card, ids.to(dev), max_new_tokens=MPT_REF_NEW, eos_id=-1)
            agree = next((i for i in range(MPT_REF_NEW) if got_toks[0, i] != want_toks[0, i]), MPT_REF_NEW)
            log(f"[mpt reference] greedy: {agree}/{MPT_REF_NEW} tokens agree before the first divergence "
                f"(card {got_toks[0, :8].tolist()}, CPU {want_toks[0, :8].tolist()})")
            # prefix-LM on the plain route (no kernel): the first quarter is the prefix
            pcfg = dataclasses.replace(cfg, prefix_lm=True)
            pcpu = create_mpt(pcfg, "cpu", torch.float32, state_dict=sd)
            pcard = create_mpt(pcfg, dev, torch.bfloat16, state_dict=sd)
            mask = torch.zeros(1, n, dtype=torch.long)
            mask[:, : n // 4] = 1
            _reset(counters)
            with torch.no_grad():
                prel = rel_l2(pcard(ids.to(dev), prefix_mask=mask.to(dev)).cpu(), pcpu(ids, prefix_mask=mask))
            plaunch = _read(counters)
            log(f"[mpt reference] prefix-LM ({n // 4}-token prefix): logits rel_l2 {prel:.3e} (bound "
                f"{REF_REL_BOUND:g}); launches {plaunch} (the plain route: none)")
            if not prel <= REF_REL_BOUND or any(plaunch.values()):
                raise AssertionError(f"mpt reference prefix-LM: rel_l2 {prel}, launches {plaunch}")
            del pcpu, pcard
        del cpu, card
        _free()


# ------------------------------------------------------------ training, the rest

CAPTRAIN_LORA = (64, 16.0)   # LoRA rank and alpha of [captioner train]
CAPTRAIN_LR = 2e-5           # the JAX CaptionerTrainer's default
CAPTRAIN_FULL_LAYERS = 2     # [captioner train] full mode: full width, 2 of the 40 layers
AE_SIDE, AE_BATCH = 512, 2   # [ae train]: a 512^2 HQ batch of 2
AE_LR = 4.5e-6               # the JAX AETrainer's default
TRAIN_REF_BOUND = 5e-2       # card bf16 against CPU fp32: loss and gradients, relative
AE_REF_GRAD_BOUND = 1e-2     # [ae train reference], card fp32 against CPU fp32: gradients, relative L2
ADAM_FORM_BOUND = 1e-2       # a card step's change against the closed-form first Adam(W) step, relative L2


def _caption_train_batch(image_size: int, tokens: int, seed: int):
    """One `collate` batch on the host: a seeded image_size^2 image,
    CLIP-normalised, and a generated vicuna_v1 conversation with the image
    marker through preprocess(has_image=True) on the byte tokenizer, the
    user turns masked, cut to `tokens` ids. The tokenizer reads the round
    separator "</s>" as one eos id, as Llama's does: preprocess_v1's round
    walk (llava train.py:407-489) counts on that, and with the separator as
    four bytes it finds a mismatch and masks every label."""
    import numpy as np

    from supir_tpu_torch.captioner.preprocess import (
        IGNORE_INDEX,
        IMAGE_TOKEN_INDEX,
        ByteTokenizer,
        collate,
        normalize_multimodal,
        preprocess,
    )
    from supir_tpu_torch.captioner.vision import preprocess_images

    rng = np.random.default_rng(seed)
    words = ["harbor", "ship", "amber", "teal", "light", "water", "sail", "grey", "dusk", "wave", "stone", "mast"]
    turns = []
    while sum(len(t["value"]) for t in turns) < 2 * tokens:
        ask = " ".join(rng.choice(words, 12)) + "?"
        turns.append({"from": "human", "value": ask if turns else "<image>\n" + ask})
        turns.append({"from": "gpt", "value": " ".join(rng.choice(words, 40)) + "."})
    class EosByteTokenizer(ByteTokenizer):
        def encode(self, text):
            parts = text.split("</s>")
            return [self.bos_token_id] * self.bos + [t for i, part in enumerate(parts)
                                                     for t in [self.eos_token_id] * (i > 0) + [b + 3 for b in part.encode()]]

    out = preprocess(normalize_multimodal([turns]), EosByteTokenizer(), has_image=True, template_name="vicuna_v1")
    image = rng.integers(0, 256, (image_size, image_size, 3), dtype=np.uint8)
    item = {"input_ids": np.asarray(out["input_ids"][0]), "labels": np.asarray(out["labels"][0]),
            "image": preprocess_images([image], image_size)[0].numpy()}
    batch = collate([item], pad_id=0, max_len=tokens)
    ids, labels = batch["input_ids"][0], batch["labels"][0]
    if len(item["input_ids"]) < tokens or (ids == IMAGE_TOKEN_INDEX).sum() != 1 or (labels == IGNORE_INDEX).all():
        raise AssertionError(f"the generated conversation holds {len(item['input_ids'])} tokens (wanted {tokens}), "
                             f"{int((ids == IMAGE_TOKEN_INDEX).sum())} markers, "
                             f"{int((labels != IGNORE_INDEX).sum())} unmasked labels")
    return {k: batch[k] for k in ("input_ids", "labels", "images")}


def _captrain_counters():
    from supir_tpu_torch.ops import flash_attention as fa
    from supir_tpu_torch.ops.groupnorm import group_norm

    return {"K1": fa.flash_attention, "K2": group_norm, "K3": fa.flash_attention_fwd_lse, "K4": fa.flash_attention_bwd}


def _timed(obj, attr: str) -> list:
    """Wrap obj.<attr> to record the seconds of each call, synchronised
    before and after; returns the list."""
    import torch

    seconds, fn = [], getattr(obj, attr)

    def timed(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
        return out

    setattr(obj, attr, timed)
    return seconds


def _captrain_step(trainer, batch, counters):
    """One counted and timed train_step_tokens: (loss, forward+backward s,
    optimizer s, launches)."""
    import torch

    opt_s = _timed(trainer.optimizer, "step")
    _reset(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = trainer.train_step_tokens(batch).item()
    total = time.perf_counter() - t0
    return loss, total - opt_s[-1], opt_s[-1], _read(counters)


def phase_captioner_train(smi: str):
    """The captioner trainer at LLaVA-1.5-13B's full width and depth
    (create_captioner's default: dense bf16, random weights): one batch of
    one 336^2 image and a vicuna_v1 conversation spliced to max_seq_len
    positions; "lora" (rank 64, alpha 16) takes a warm-up step with every
    K3/K4 call held to its plain version, then a counted and timed step;
    "projector" one counted step on the same model; then "full" one step
    at full width and CAPTRAIN_FULL_LAYERS layers. Returns K3's and K4's
    launches of one counted lora step."""
    import dataclasses as dc

    import torch

    from supir_tpu_torch.captioner.agent import CaptionerConfig, create_captioner
    from supir_tpu_torch.captioner.llama import LlamaConfig
    from supir_tpu_torch.captioner.train import PROJECTOR, CaptionerTrainer

    _free()
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda")
    cfg = dc.replace(CaptionerConfig(), compute_dtype="bfloat16", kv_dtype="bfloat16")
    t0 = time.perf_counter()
    agent = create_captioner(cfg, dev, seed=SEED + 41)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    tokens = cfg.llama.max_seq_len - cfg.vision.num_patches + 1
    host = _caption_train_batch(cfg.vision.image_size, tokens, SEED + 42)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    layers = cfg.llama.layers
    log(f"[captioner train] {smi}: LLaVA-1.5-13B, dense bf16 parameters ({sum(p.numel() for p in agent.model.parameters()) / 1e9:.3f} B), "
        f"built and randomised on the card in {build_s:.1f} s; one {tokens}-token vicuna_v1 "
        f"conversation (byte tokenizer, {int((host['labels'] != -100).sum())} unmasked labels) and one "
        f"{cfg.vision.image_size}^2 image, spliced to {cfg.llama.max_seq_len} positions")
    counters = _captrain_counters()
    want = {"K1": 0, "K2": 0, "K3": layers, "K4": layers}
    base = {k: p for k, p in agent.model.named_parameters() if not k.startswith(PROJECTOR)}
    base_sums = _bit_sums(base.values())
    out = {}
    for mode in ("lora", "projector"):
        torch.cuda.reset_peak_memory_stats()
        trainer = CaptionerTrainer(agent, learning_rate=CAPTRAIN_LR, mode=mode, lora_rank=CAPTRAIN_LORA[0],
                                   lora_alpha=CAPTRAIN_LORA[1])
        trainer.init_state(seed=SEED + 43)
        n_train = sum(p.numel() for p in trainer.params.values())
        if mode == "lora":
            with flash_train_sites() as readings:
                t0 = time.perf_counter()
                warm = trainer.train_step_tokens(batch).item()
                warm_s = time.perf_counter() - t0
            _check_train_sites("captioner train", readings)
            log(f"[captioner train] lora warm-up step (every K3/K4 call held to its plain version): loss {warm:.6g}, "
                f"{warm_s:.3f} s")
        before = _bit_sums(trainer.params.values())
        loss, fb, opt, launches = _captrain_step(trainer, batch, counters)
        peak = torch.cuda.max_memory_allocated() / 2**30
        unmoved = [k for k, a, b in zip(trainer.params, before, _bit_sums(trainer.params.values())) if a == b]
        changed = [k for k, a, b in zip(base, base_sums, _bit_sums(base.values())) if a != b]
        log(f"[captioner train] {mode}: {n_train / 1e6:.2f} M trainable fp32 parameters ({len(trainer.params)} "
            f"leaves); loss {loss:.6g}; forward+backward {fb:.3f} s, optimizer {opt:.4f} s; peak memory "
            f"{peak:.2f} GiB; launches {launches} (expected {want}); {len(trainer.params) - len(unmoved)}/"
            f"{len(trainer.params)} trainable leaves moved, {len(base) - len(changed)}/{len(base)} base leaves "
            f"bit-identical")
        if launches != want:
            raise AssertionError(f"captioner train {mode} launched {launches}, expected {want}")
        if not math.isfinite(loss) or unmoved or changed:
            raise AssertionError(f"captioner train {mode}: loss {loss}, unmoved {unmoved[:3]}, changed {changed[:3]}")
        out[mode] = launches
        del trainer
        _free()
    del agent, base
    _free()

    torch.cuda.reset_peak_memory_stats()
    fcfg = dc.replace(cfg, llama=dc.replace(LlamaConfig(), layers=CAPTRAIN_FULL_LAYERS))
    agent = create_captioner(fcfg, dev, seed=SEED + 44)
    trainer = CaptionerTrainer(agent, learning_rate=CAPTRAIN_LR, mode="full")
    trainer.init_state()
    frozen = {k: p for k, p in agent.model.named_parameters() if k not in trainer.params}
    frozen_sums, before = _bit_sums(frozen.values()), _bit_sums(trainer.params.values())
    loss, fb, opt, launches = _captrain_step(trainer, batch, counters)
    fwant = dict(want, K3=CAPTRAIN_FULL_LAYERS, K4=CAPTRAIN_FULL_LAYERS)
    unmoved = [k for k, a, b in zip(trainer.params, before, _bit_sums(trainer.params.values())) if a == b]
    changed = [k for k, a, b in zip(frozen, frozen_sums, _bit_sums(frozen.values())) if a != b]
    log(f"[captioner train] full, {CAPTRAIN_FULL_LAYERS} of {layers} layers at full width: "
        f"{sum(p.numel() for p in trainer.params.values()) / 1e9:.3f} B trainable fp32 parameters; loss {loss:.6g}; "
        f"forward+backward {fb:.3f} s, optimizer {opt:.4f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches} (expected {fwant}); "
        f"{len(trainer.params) - len(unmoved)}/{len(trainer.params)} leaves moved, {len(frozen) - len(changed)}/"
        f"{len(frozen)} vision-tower leaves bit-identical")
    if launches != fwant or not math.isfinite(loss) or unmoved or changed:
        raise AssertionError(f"captioner train full: launches {launches}, loss {loss}, unmoved {unmoved[:3]}, "
                             f"changed {changed[:3]}")
    del trainer, agent, frozen
    _free()
    return out["lora"]


def _reduced_captioner_cfg(dtype: str):
    """The captioner references' reduced width: CLIP 256 wide, 2 layers, at
    336^2 (576 patches); Llama 512 wide in 4 heads of 128, 2 layers,
    max_seq_len 2048, so the spliced sequence still reaches K3/K4."""
    from supir_tpu_torch.captioner.agent import CaptionerConfig
    from supir_tpu_torch.captioner.llama import LlamaConfig
    from supir_tpu_torch.captioner.vision import CLIPVisionConfig

    return CaptionerConfig(vision=CLIPVisionConfig(width=256, layers=2, heads=4),
                           llama=LlamaConfig(dim=512, layers=2, heads=4, kv_heads=4, hidden_dim=1024),
                           compute_dtype=dtype, kv_dtype=dtype)


def _moment_rels(got, want):
    """Relative L2 of the trainable tree's first Adam moments ((1 - b1) x
    the gradient after one step), all leaves as one vector."""
    keys = sorted(want)
    err = sum(float((got[k].float().cpu() - want[k]).norm()) ** 2 for k in keys)
    return (err / sum(float(want[k].norm()) ** 2 for k in keys)) ** 0.5


def _change_rel(got, want):
    """Relative L2 of one step's change of the trainable tree, all leaves
    as one vector; got and want are {'before', 'after'} runs."""
    keys = sorted(want["before"])
    change = {name: {k: run["after"][k] - run["before"][k] for k in keys} for name, run in (("got", got), ("want", want))}
    err = sum(float((change["got"][k] - change["want"][k]).norm()) ** 2 for k in keys)
    return (err / sum(float(change["want"][k].norm()) ** 2 for k in keys)) ** 0.5


def _adam_form_rel(run, lr: float, betas, weight_decay: float = 0.0) -> float:
    """Relative L2, every leaf the optimizer holds as one vector, of one
    step's change (run['after'] - run['before']) against the closed-form
    first step of optax's adam/adamw from the moments the optimizer kept
    (run['m'], run['v']): -lr (m^ / (sqrt(v^) + 1e-8) + wd p), with
    m^ = m / (1 - b1) and v^ = v / (1 - b2); in float64. It holds the
    fused optimizer's learning rate, bias corrections and eps on the card;
    the weight decay's share of one step (lr wd p, ~1e-9 p here) is below
    fp32 resolution, and the CPU parity tests, which run the same fused
    optimizer, hold it."""
    b1, b2 = betas
    err = ref = 0.0
    for k, m in run["m"].items():
        p = run["before"][k].double()
        form = -lr * ((m.double() / (1 - b1)) / ((run["v"][k].double() / (1 - b2)).sqrt() + 1e-8) + weight_decay * p)
        err += float((run["after"][k].double() - p - form).norm()) ** 2
        ref += float(form.norm()) ** 2
    return (err / ref) ** 0.5


def _check_adam_form(label: str, run, lr: float, betas, weight_decay: float = 0.0) -> str:
    """_adam_form_rel within ADAM_FORM_BOUND, and the same form at twice the
    learning rate (a planted control) far outside it; returns the log."""
    rel = _adam_form_rel(run, lr, betas, weight_decay)
    control = _adam_form_rel(run, 2 * lr, betas, weight_decay)
    if not (rel <= ADAM_FORM_BOUND and control > 10 * ADAM_FORM_BOUND):
        raise AssertionError(f"{label}: the card's step against the closed-form Adam step {rel}, "
                             f"control (2 lr) {control}")
    return (f"step against the closed-form Adam step rel_l2 {rel:.3e} (bound {ADAM_FORM_BOUND:g}; control at 2 lr "
            f"{control:.3e})")


def phase_captioner_train_reference():
    """The captioner trainer's token-level step at the reduced width on the
    card (bf16 base, fp32 trainable leaves, bf16 autocast, K3/K4) and on
    the CPU (fp32, plain versions) from the same weights and adapters, in
    every mode: the loss and the gradients (the first Adam moments, every
    trainable leaf as one vector) must agree to TRAIN_REF_BOUND, and the
    card's step must be the closed-form AdamW step (optax's defaults) from
    its own moments (_check_adam_form). The change of the trainable leaves
    against the CPU's is printed beside them: Adam's first step is about
    lr x sign(gradient), so its difference counts the elements whose tiny
    gradients differ in sign between bf16 and fp32."""
    import torch

    from supir_tpu_torch.captioner.agent import create_captioner
    from supir_tpu_torch.captioner.train import MODES, CaptionerTrainer, init_lora

    cpu_cfg, card_cfg = _reduced_captioner_cfg("float32"), _reduced_captioner_cfg("bfloat16")
    tokens = cpu_cfg.llama.max_seq_len - cpu_cfg.vision.num_patches + 1
    host = _caption_train_batch(cpu_cfg.vision.image_size, tokens, SEED + 45)
    sd = create_captioner(cpu_cfg, "cpu", seed=SEED + 46).model.state_dict()
    counters = _captrain_counters()
    for mode in MODES:
        runs = {}
        for name, cfg, dev in (("cpu", cpu_cfg, torch.device("cpu")), ("card", card_cfg, torch.device("cuda"))):
            agent = create_captioner(cfg, dev, state_dict=sd)
            trainer = CaptionerTrainer(agent, learning_rate=CAPTRAIN_LR, mode=mode, lora_rank=16, lora_alpha=16.0)
            if mode == "lora" and name == "cpu":
                lora = init_lora(agent.model, 16, torch.Generator().manual_seed(SEED + 47))
            trainer.init_state(lora=lora if mode == "lora" else None)
            before = {k: p.detach().float().cpu().clone() for k, p in trainer.params.items()}
            _reset(counters)
            t0 = time.perf_counter()
            loss = trainer.train_step_tokens({k: torch.from_numpy(v).to(dev) for k, v in host.items()}).item()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            runs[name] = dict(loss=loss, s=time.perf_counter() - t0, launches=_read(counters), before=before,
                              after={k: p.detach().float().cpu() for k, p in trainer.params.items()},
                              m={k: v.float().cpu() for k, v in trainer.state()["exp_avg"].items()},
                              v={k: v.float().cpu() for k, v in trainer.state()["exp_avg_sq"].items()})
            del trainer, agent
        cpu, card = runs["cpu"], runs["card"]
        loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
        grad_rel = _moment_rels(card["m"], cpu["m"])
        change_rel = _change_rel(card, cpu)
        # optax's adamw defaults: b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4
        form = _check_adam_form(f"captioner train reference {mode}", card, CAPTRAIN_LR, (0.9, 0.999), 1e-4)
        want = {"K1": 0, "K2": 0, "K3": cpu_cfg.llama.layers, "K4": cpu_cfg.llama.layers}
        log(f"[captioner train reference] {mode} (Llama 512 wide, 2 layers, {cpu_cfg.llama.max_seq_len} positions): "
            f"card bf16 loss {card['loss']:.6g} vs CPU fp32 {cpu['loss']:.6g} ({cpu['s']:.1f} s), relative "
            f"{loss_rel:.3e}; gradients (first moments) rel_l2 {grad_rel:.3e} (bound {TRAIN_REF_BOUND:g}); "
            f"one-step change rel_l2 {change_rel:.3e} (printed); card {form}; card launches {card['launches']} "
            f"(expected {want})")
        if not (loss_rel <= TRAIN_REF_BOUND and grad_rel <= TRAIN_REF_BOUND) or card["launches"] != want:
            raise AssertionError(f"captioner train reference {mode}: loss {loss_rel}, gradients {grad_rel}, "
                                 f"launches {card['launches']}")
        _free()


def expected_ae_train_launches(cfg) -> int:
    """K2 launches of one AE train step: the discriminator phase's
    reconstruction (no grad), the encoder's and the decoder's GroupNorm
    sites once each (the denoise encoder has the encoder's); every
    generator-phase site is differentiated and takes the plain form."""
    import torch

    from supir_tpu_torch.models.layers import GroupNorm32
    from supir_tpu_torch.models.vae import AutoencoderKL

    with torch.device("meta"):
        vae = AutoencoderKL(cfg)
    return sum(isinstance(m, GroupNorm32) for part in (vae.encoder, vae.decoder) for m in part.modules())


def _ae_images(side: int, n: int, seed: int):
    """(LQ, HQ) NHWC fp32 on the host in [-1, 1]: HQ a seeded smooth random
    image (a 32^2 field, bicubically upsampled, plus fine noise), LQ its
    copy degraded: Gaussian blur (ksize 9, sigma 2), noise sigma 0.1."""
    import torch
    import torch.nn.functional as F

    from supir_tpu_torch.ops.resize import gaussian_blur

    g = torch.Generator().manual_seed(seed)
    field = F.interpolate(torch.rand(n, 3, 32, 32, generator=g), size=(side, side), mode="bicubic",
                          align_corners=False)
    hq = (2 * field - 1 + 0.05 * torch.randn(n, 3, side, side, generator=g)).clamp(-1, 1).permute(0, 2, 3, 1)
    lq = (gaussian_blur(hq.contiguous(), 9, 2.0) + 0.1 * torch.randn(hq.shape, generator=g)).clamp(-1, 1)
    return lq.contiguous(), hq.contiguous()


def _random_lpips(device):
    from supir_tpu_torch.utils.metrics import LPIPS, convert_lpips_state

    lpips = LPIPS()
    lpips.load_state_dict(convert_lpips_state(*_lpips_sources(SEED + 48)), strict=True)
    return lpips.to(device).eval().requires_grad_(False)


def phase_ae_train(smi: str):
    """The autoencoder GAN trainer at SDXL's full VAE width (VAEConfig():
    fp32 parameters, bf16 autocast) with its denoise encoder, LPIPS with
    random weights as the perceptual term, disc_start 0: two
    denoise-encoder steps (LQ in, HQ target: SUPIR's stage-1 recipe), then
    one step of the whole autoencoder. K2 runs only in the discriminator
    phase's reconstruction; the first step holds each of its calls to the
    plain version (group_norm_sites). Returns K2's launches per step."""
    import torch

    from supir_tpu_torch.config import VAEConfig
    from supir_tpu_torch.diffusion.ae_losses import AELossConfig
    from supir_tpu_torch.engine.ae_training import METRICS, AETrainer
    from supir_tpu_torch.engine.factory import create_ae_trainer
    from supir_tpu_torch.models.layers import GroupNorm32

    _free()
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda")
    cfg = VAEConfig()
    lpips = _random_lpips(dev)
    lq, hq = (t.to(dev) for t in _ae_images(AE_SIDE, AE_BATCH, SEED + 49))
    loss_cfg = AELossConfig(disc_start=0)
    trainer = create_ae_trainer(cfg, dev, seed=SEED + 50, loss_cfg=loss_cfg, learning_rate=AE_LR,
                                train_branch="denoise_encoder", perceptual_fn=lpips)
    g = torch.Generator(device=dev).manual_seed(SEED + 51)
    per_step = expected_ae_train_launches(cfg)
    counters = _captrain_counters()
    want = {"K1": 0, "K2": per_step, "K3": 0, "K4": 0}
    log(f"[ae train] {smi}: SDXL AutoencoderKL with its denoise encoder, fp32 parameters "
        f"({sum(p.numel() for p in trainer.model.parameters()) / 1e6:.1f} M), bf16 autocast; NLayerDiscriminator "
        f"({sum(p.numel() for p in trainer.disc.parameters()) / 1e6:.2f} M); LPIPS-VGG (random) perceptual; "
        f"{AE_BATCH} x {AE_SIDE}^2, disc_start 0, Adam lr {AE_LR:g} (b1 0.5, b2 0.9)")
    frozen = {k: p for k, p in trainer.model.named_parameters() if not k.startswith("denoise_encoder.")}
    frozen_sums = _bit_sums(frozen.values())
    k2 = None
    for branch, steps in (("denoise_encoder", 2), ("all", 1)):
        if branch == "all":
            trainer = AETrainer(trainer.model, loss_cfg, AE_LR, train_branch="all", perceptual_fn=lpips,
                                seed=SEED + 52)
        seconds = {name: _timed(trainer, f"_{name}_phase") for name in ("generator", "discriminator")}
        before = _bit_sums(trainer.params.values())
        for i in range(steps):
            _reset(counters)
            GroupNorm32.plain_sites = 0
            torch.cuda.reset_peak_memory_stats()
            # the first step holds every K2 call to its plain version
            check = branch == "denoise_encoder" and i == 0
            with group_norm_sites() if check else contextlib.nullcontext() as norms:
                m = trainer.train_step(lq if branch == "denoise_encoder" else hq, hq, g)
            if check:
                _check_norm_sites("ae train", norms)
            metrics = {k: float(v) for k, v in m.items()}
            launches, plain = _read(counters), GroupNorm32.plain_sites
            log(f"[ae train] {branch} step {i + 1}/{steps}{' (K2 held to plain)' if check else ''}: generator "
                f"phase {seconds['generator'][-1]:.3f} s, discriminator phase {seconds['discriminator'][-1]:.3f} s; peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches} (expected {want}), "
                f"{plain} GroupNorm calls on the plain differentiable form; "
                + ", ".join(f"{k} {metrics[k]:.5g}" for k in METRICS))
            if launches != want or plain != per_step:
                raise AssertionError(f"ae train {branch}: launches {launches}, plain GroupNorm calls {plain}, "
                                     f"expected {want} and {per_step}")
            if not all(math.isfinite(v) for v in metrics.values()):
                raise AssertionError(f"ae train {branch}: non-finite metrics {metrics}")
            d_weight = metrics["d_weight"]
            if (branch == "all" and not 0.0 <= d_weight <= 1e4) or (branch == "denoise_encoder" and d_weight != 1.0):
                raise AssertionError(f"ae train {branch}: d_weight {d_weight}")
        unmoved = [k for k, a, b in zip(trainer.params, before, _bit_sums(trainer.params.values())) if a == b]
        if branch == "denoise_encoder":
            changed = [k for k, a, b in zip(frozen, frozen_sums, _bit_sums(frozen.values())) if a != b]
            log(f"[ae train] denoise_encoder: {len(trainer.params) - len(unmoved)}/{len(trainer.params)} branch "
                f"leaves moved, {len(frozen) - len(changed)}/{len(frozen)} encoder, decoder and quant-conv leaves "
                f"bit-identical")
            if unmoved or changed:
                raise AssertionError(f"ae train denoise_encoder: unmoved {unmoved[:3]}, changed {changed[:3]}")
            k2 = launches["K2"]
        else:
            # the denoise encoder is outside the "all" forward and stays put
            moved = [k for k in trainer.params if k not in unmoved]
            log(f"[ae train] all: {len(moved)}/{len(trainer.params)} leaves moved (the denoise encoder's "
                f"{sum(k.startswith('denoise_encoder.') for k in trainer.params)} get no gradient)")
            if any(not k.startswith("denoise_encoder.") for k in unmoved):
                raise AssertionError(f"ae train all: unmoved {unmoved[:3]}")
    del trainer, lpips, frozen
    _free()
    return k2


def phase_ae_train_reference():
    """One AE train step in each branch at the reduced width (VAEConfig
    ch 32, 128^2, batch 2, LPIPS random) on the CPU (fp32, plain) and on
    the card twice, as the trainer runs (bf16 autocast, K2 in the
    reconstruction) and with autocast off (fp32, K2 on fp32 tensors), same
    weights, same discriminator, same posterior draws. The generator's
    losses must agree to TRAIN_REF_BOUND in both; in fp32 the gradients of
    the generator's trainable tree and of the discriminator (first Adam
    moments, each tree as one vector) must agree to AE_REF_GRAD_BOUND, and
    both card runs' steps must be the closed-form Adam step from their own
    moments (_check_adam_form). In bf16 the gradients are printed only: the L1 loss's sign(recon - target) and the
    discriminator's LeakyReLU kinks flip wherever bf16's ~1e-2 error
    crosses them, a discrete change of the gradient no bound on rounding
    covers (even fp32's different summation orders flip a few kinks of the
    discriminator's small maps: ~1e-3). At 128^2 the mid-block attention (256 tokens) takes the plain
    route, as the full width's 512-wide head does: no flash kernel runs,
    and none takes fp32 under grad."""
    import torch

    from supir_tpu_torch.config import VAEConfig
    from supir_tpu_torch.diffusion.ae_losses import AELossConfig
    from supir_tpu_torch.engine import ae_training
    from supir_tpu_torch.engine.factory import create_ae_trainer

    cfg, side = VAEConfig().tiny(), 128
    lq, hq = _ae_images(side, 2, SEED + 53)
    latent = (2, cfg.embed_dim, side // cfg.downscale_factor, side // cfg.downscale_factor)
    g = torch.Generator().manual_seed(SEED + 54)
    draws = [torch.randn(latent, generator=g) for _ in range(2)]
    counters = _captrain_counters()
    unit_normal, autocast = ae_training.unit_normal, ae_training.train_autocast
    want_launches = {"K1": 0, "K2": expected_ae_train_launches(cfg), "K3": 0, "K4": 0}
    cpu, card = torch.device("cpu"), torch.device("cuda")
    for branch in ("denoise_encoder", "all"):
        runs, state = {}, None
        for name, dev in (("cpu", cpu), ("card bf16", card), ("card fp32", card)):
            queue = list(draws)
            ae_training.unit_normal = lambda shape, generator, device: queue.pop(0).to(device)
            trainer = create_ae_trainer(cfg, dev, seed=SEED + 55, loss_cfg=AELossConfig(disc_start=0),
                                        learning_rate=AE_LR, train_branch=branch, perceptual_fn=_random_lpips(dev))
            # the fp32 card run: the trainer's bf16 autocast off
            ae_training.train_autocast = autocast if name != "card fp32" else lambda device: contextlib.nullcontext()
            if state is None:
                state = {"gen": {k: v.detach().clone() for k, v in trainer.state()["gen"].items()},
                         "disc": {k: v.detach().clone() for k, v in trainer.state()["disc"].items()},
                         "opt_g": {"exp_avg": {}, "exp_avg_sq": {}}, "opt_d": {"exp_avg": {}, "exp_avg_sq": {}},
                         "step": 0}
            trainer.load_state(state)
            _reset(counters)
            t0 = time.perf_counter()
            m = trainer.train_step((lq if branch == "denoise_encoder" else hq).to(dev), hq.to(dev))
            st = trainer.state()
            runs[name] = dict(metrics={k: float(v) for k, v in m.items()}, s=time.perf_counter() - t0,
                              launches=_read(counters))
            for tree, opt in (("gen", "opt_g"), ("disc", "opt_d")):
                runs[name][tree] = dict(before=state[tree], after={k: st[tree][k].detach().float().cpu() for k in
                                                                   st[opt]["exp_avg"]},
                                        m={k: v.float().cpu() for k, v in st[opt]["exp_avg"].items()},
                                        v={k: v.float().cpu() for k, v in st[opt]["exp_avg_sq"].items()})
            del trainer
        ae_training.unit_normal, ae_training.train_autocast = unit_normal, autocast
        want = runs["cpu"]
        for name in ("card bf16", "card fp32"):
            got = runs[name]
            rels = {k: abs(got["metrics"][k] - want["metrics"][k]) / abs(want["metrics"][k])
                    for k in ("loss_g", "rec", "kl")}
            grads = {"generator": _moment_rels(got["gen"]["m"], want["gen"]["m"]),
                     "discriminator": _moment_rels(got["disc"]["m"], want["disc"]["m"])}
            bound = AE_REF_GRAD_BOUND if name == "card fp32" else None
            # optax's adam(lr, b1=0.5, b2=0.9), eps 1e-8, for both phases
            forms = [_check_adam_form(f"ae train reference {branch}, {name}, {tree}", got[tree], AE_LR, (0.5, 0.9))
                     for tree in ("gen", "disc")]
            log(f"[ae train reference] {branch} (VAE ch {cfg.ch}, 2 x {side}^2): {name} vs CPU fp32 "
                f"({want['s']:.1f} s): " + ", ".join(f"{k} {got['metrics'][k]:.5g} vs {want['metrics'][k]:.5g}"
                                                     for k in ("loss_g", "rec", "kl", "d_weight"))
                + "; relative " + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
                + f" (bound {TRAIN_REF_BOUND:g}); gradients (first moments) rel_l2 "
                + ", ".join(f"{k} {v:.3e}" for k, v in grads.items())
                + (f" (bound {bound:g})" if bound else " (printed: kinks, see the docstring)")
                + f"; generator {forms[0]}; discriminator {forms[1]}; launches {got['launches']} "
                f"(expected {want_launches})")
            if max(rels.values()) > TRAIN_REF_BOUND or (bound and max(grads.values()) > bound):
                raise AssertionError(f"ae train reference {branch}, {name}: losses {rels}, gradients {grads}")
            if got["launches"] != want_launches:
                raise AssertionError(f"ae train reference {branch}, {name}: launches {got['launches']}, "
                                     f"expected {want_launches}")
        _free()


# ------------------------------------------------------------------ the apps

WEB_OPT = "options/SUPIR_v0.yaml"
WEB_PNG = 512         # side of the [web demo]'s photo; stage 2 at --upscale 2 restores it at 1024^2
WEB_MIN_SIZE = 1024   # stage 2's min_size (the demo's default)
FACE_IMAGE = (1024, 1536)  # (h, w) of the [face] phase's image
FACE_RESOLUTION = 1024
APPS_REF_BOUND = 1e-3  # [apps reference]: card fp32 against CPU fp32, relative L2 of each output


def _png_b64(arr) -> str:
    import base64
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _unpng(b64: str):
    import base64
    import io

    import numpy as np
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB"))


def _http(port: int, path: str, body=None):
    """One request to a server on 127.0.0.1 (the demo, the controller) ->
    (decoded JSON or page text, wall seconds)."""
    import urllib.request

    url = f"http://127.0.0.1:{port}{path}"
    req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode(),
                                 method="GET" if body is None else "POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        raw = r.read()
    wall = time.perf_counter() - t0
    return (raw.decode() if body is None else json.loads(raw)), wall


def two_faces(img):
    """A landmark callable: two faces of the [face] phase's image, the
    template at a third and at a quarter of its height."""
    import numpy as np

    from supir_tpu_torch.utils.face_restore import FACE_TEMPLATE_512

    h, w = img.shape[:2]
    return np.stack([(FACE_TEMPLATE_512 - 256.0) * (h / 3 / 512) + np.array([w * 0.3, h * 0.45], np.float32),
                     (FACE_TEMPLATE_512 - 256.0) * (h / 4 / 512) + np.array([w * 0.72, h * 0.55], np.float32)])


def phase_web_demo(steps: int, smi: str, apps_dir: str):
    """The web demo's HTTP server at full width (options/SUPIR_v0.yaml,
    XL-base, bf16, every weight random; the engine and the tiny captioner
    built by web_demo.create_demo_from_args from the CLI's flags with
    --load_4bit_llava) on 127.0.0.1, port 0, in a thread, driven over HTTP:
    the page, stage 1 on a 512^2 PNG, caption, stage 2 at --upscale 2
    (1024^2) with Quality and with Fidelity, feedback, stage 2 after a
    swap to F (a synthetic SDXL + SUPIR checkpoint pair this phase writes,
    loaded lazily through convert_and_cache), stage 2 after the swap back
    (equal to the first Quality one), then two stage-2 requests at once
    (equal to the serial ones). No answer may carry "error"; K1/K2 launch
    per stage-2 request as the config says, K5 in the caption request.
    Returns (engine, cfg) for [face]."""
    import os
    import threading

    import numpy as np
    import torch

    from supir_tpu_torch.apps import web_demo
    from supir_tpu_torch.ops import quantize as Q
    from supir_tpu_torch.ops.flash_attention import flash_attention
    from supir_tpu_torch.ops.groupnorm import group_norm
    from supir_tpu_torch.utils.checkpoint import convert_and_cache

    torch.cuda.reset_peak_memory_stats()
    llava = os.path.join(apps_dir, "llava")
    os.makedirs(llava)
    _tiny_llava_dir(llava)
    previous = os.environ.get("LLAVA_MODEL_PATH")
    os.environ["LLAVA_MODEL_PATH"] = llava
    t0 = time.perf_counter()
    try:
        args = web_demo.build_parser().parse_args(["--opt", WEB_OPT, "--random_weights", "--load_4bit_llava",
                                                   "--port", "0", "--device", "cuda"])
        demo = web_demo.create_demo_from_args(args, history_dir=os.path.join(apps_dir, "history"))
    finally:
        os.environ.pop("LLAVA_MODEL_PATH")
        if previous is not None:
            os.environ["LLAVA_MODEL_PATH"] = previous
    engine, cfg = demo.engine, demo.cfg
    _randomize_all(engine.model, SEED + 30)  # the zero-initialised heads would make eps 0
    build_s = time.perf_counter() - t0

    # the F checkpoint: the reference's two files, Q's weights with the
    # control net's signs flipped; convert_and_cache merges them once
    ckpt_dir = os.path.join(apps_dir, "ckpt")
    os.makedirs(ckpt_dir)
    t0 = time.perf_counter()
    from safetensors.torch import save_file

    sd = {k: (-v if k.startswith("model.control_model.") else v).to("cpu").contiguous()
          for k, v in engine.model.state_dict().items()}
    supir_keys = ("model.control_model.", "model.diffusion_model.project_modules.", "first_stage_model.denoise_encoder.")
    sdxl_path, supir_path = os.path.join(ckpt_dir, "sdxl.safetensors"), os.path.join(ckpt_dir, "supir_F.safetensors")
    save_file({k: v for k, v in sd.items() if not k.startswith(supir_keys)}, sdxl_path)
    save_file({k: v for k, v in sd.items() if k.startswith(supir_keys)}, supir_path)
    del sd
    write_s = time.perf_counter() - t0
    loads = []

    def load_f():
        t = time.perf_counter()
        out = convert_and_cache(cfg, sdxl_path, supir_path, os.path.join(ckpt_dir, "cache"), sign="F",
                                cond_cfg=engine.cond_cfg)
        loads.append(time.perf_counter() - t)
        return out

    demo.param_sets["F"] = load_f
    swaps = []
    select = demo.select_model

    def timed_select(sign):
        t = time.perf_counter()
        out = select(sign)
        torch.cuda.synchronize()
        swaps.append((demo.active_sign, time.perf_counter() - t))
        return out

    demo.select_model = timed_select
    samples = []
    sample = engine.batchify_sample

    def timed_sample(*a, **k):
        t = time.perf_counter()
        out = sample(*a, **k)
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t)
        return out

    engine.batchify_sample = timed_sample

    httpd = web_demo.serve_demo(demo, host="127.0.0.1", port=0)
    port = httpd.server_address[1]
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    g = torch.Generator().manual_seed(SEED + 31)
    photo = torch.randint(0, 256, (WEB_PNG, WEB_PNG, 3), generator=g, dtype=torch.uint8).numpy()
    image = _png_b64(photo)
    from PIL import Image

    from supir_tpu_torch.utils.image import pil_to_array

    side = pil_to_array(Image.fromarray(photo), upscale=2, min_size=WEB_MIN_SIZE)[0].shape[0]
    lat = side // cfg.vae.downscale_factor
    want = {"K1": expected_flash_launches(cfg, lat, steps, vae_passes=4),
            "K2": expected_group_norm_launches(cfg, steps, encodes=2, decodes=2)}
    walls, outs = {}, {}

    def request(label, path, body, counted=None):
        flash_attention.launches = 0
        group_norm.launches = 0
        Q.int4_paired_fused_matmul.launches = 0
        out, wall = _http(port, path, body)
        if "error" in out:
            raise AssertionError(f"[web demo] {label}: the server answered {out}")
        walls[label] = wall
        got = {"K1": flash_attention.launches, "K2": group_norm.launches, "K5": Q.int4_paired_fused_matmul.launches}
        if counted is not None and {k: got[k] for k in counted} != counted:
            raise AssertionError(f"[web demo] {label}: launches {got}, expected {counted}")
        return out, got

    try:
        page, walls["page"] = _http(port, "/")
        if "<h2>" not in page:
            raise AssertionError("[web demo] GET / returned no page")
        out, got = request("stage1", "/api/stage1", {"image": image},
                           {"K2": expected_group_norm_launches(cfg, 0, encodes=1, decodes=1)})
        s1 = _unpng(out["image"])
        cap, got_cap = request("caption", "/api/caption", {"image": image})
        if not (cap["caption"] and got_cap["K5"] > 0):
            raise AssertionError(f"[web demo] caption {cap!r}, K5 launches {got_cap['K5']}")
        stage2 = {"image": image, "edm_steps": steps, "upscale": 2, "min_size": WEB_MIN_SIZE,
                  "prompt": cap["caption"] + ", "}
        quality, got_q = request("stage2 Quality", "/api/stage2", dict(stage2, preset="Quality"), want)
        fidelity, _ = request("stage2 Fidelity", "/api/stage2", dict(stage2, preset="Fidelity"), want)
        fb, _ = request("feedback", "/api/feedback", {"event_id": quality["event_id"], "score": 1})
        if fb != {"ok": True}:
            raise AssertionError(f"[web demo] feedback answered {fb}")
        swapped, _ = request("stage2 F (lazy load)", "/api/stage2", dict(stage2, preset="Quality", model_select="F"),
                             want)
        back, _ = request("stage2 Q (swap back)", "/api/stage2", dict(stage2, preset="Quality", model_select="Q"),
                          want)
        outs = {k: _unpng(v["image"]) for k, v in (("Quality", quality), ("Fidelity", fidelity), ("F", swapped),
                                                      ("back", back))}
        both = [None, None]

        def send(i, preset):
            both[i] = _http(port, "/api/stage2", dict(stage2, preset=preset))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=send, args=(i, p)) for i, p in enumerate(("Quality", "Fidelity"))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        walls["two stage2 at once"] = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
        del engine.batchify_sample
    peak = torch.cuda.max_memory_allocated() / 2**30

    for i, preset in enumerate(("Quality", "Fidelity")):
        if both[i] is None or "error" in both[i][0]:
            raise AssertionError(f"[web demo] concurrent {preset} request: {both[i]}")
        diff = np.abs(_unpng(both[i][0]["image"]).astype(np.int16) - outs[preset]).max()
        log(f"[web demo] concurrent {preset} stage 2 ({both[i][1]:.3f} s) against the serial one: max diff {diff}")
        if diff:
            raise AssertionError(f"[web demo] the concurrent {preset} request differs from the serial one by {diff}")
    back_diff = np.abs(outs["back"].astype(np.int16) - outs["Quality"]).max()
    f_diff = np.abs(outs["F"].astype(np.int16) - outs["Quality"]).mean()
    if back_diff or not f_diff > 0:
        raise AssertionError(f"[web demo] swap back differs from the first Quality run by {back_diff}; "
                             f"F against Q mean diff {f_diff}")
    if [sign for sign, _ in swaps] != ["F", "Q"] or len(loads) != 1:
        raise AssertionError(f"[web demo] swaps {swaps}, lazy loads {loads}")
    events = sorted(os.listdir(demo.history_dir))
    kinds = collections.Counter(json.load(open(os.path.join(demo.history_dir, e, "params.json")))["kind"]
                                for e in events)
    if kinds != {"stage1": 1, "caption": 1, "stage2": 6} or not os.path.exists(
            os.path.join(demo.history_dir, quality["event_id"], "feedback.json")):
        raise AssertionError(f"[web demo] history {dict(kinds)}")
    for o in outs.values():
        if o.shape != (side, side, 3) or o.std() == 0:
            raise AssertionError(f"[web demo] stage-2 PNG {o.shape}, std {o.std()}")
    Image.fromarray(photo).save(os.path.join(apps_dir, "ref", "demo.png"))
    Image.fromarray(outs["Quality"]).save(os.path.join(apps_dir, "pred", "demo_0.png"))
    log(f"[web demo] {smi}: {WEB_OPT}, {WEB_PNG}^2 PNG, stage 2 at --upscale 2 ({side}^2), {steps} steps; "
        f"built in {build_s:.2f} s (engine, tiny 4-bit captioner); stage1 {s1.shape[0]}^2; caption "
        f"{cap['caption'][:40]!r}; launches per stage-2 request K1 {got_q['K1']}, K2 {got_q['K2']} (expected "
        f"{want}), caption K5 {got_cap['K5']}")
    log("[web demo] wall per request (HTTP, synchronised by the answer): "
        + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items())
        + "; batchify_sample in the six stage-2 requests, in order: " + ", ".join(f"{t:.3f}" for t in samples)
        + " s (the rest of a request: the stage-1 encode, conditioning, the host's resize, PNG encodes, "
        "base64 and the history's files)")
    log(f"[web demo] F checkpoint: two safetensors files ({os.path.getsize(sdxl_path) / 2**30:.2f} + "
        f"{os.path.getsize(supir_path) / 2**30:.2f} GiB) written in {write_s:.2f} s; convert_and_cache "
        f"{loads[0]:.2f} s (once); swaps " + ", ".join(f"to {s} {t:.3f} s" for s, t in swaps)
        + f" (to F: the lazy load, then the host copy of Q and the copy to the card); peak memory "
        f"{peak:.2f} GiB; history {dict(kinds)}")
    httpd = demo = None
    return engine, cfg


def phase_face(engine, cfg, steps: int, smi: str, apps_dir: str):
    """restore_with_faces at full width, face_resolution 1024, on a
    1536x1024 image with two faces given by a landmark callable: two
    1024^2 face restores and the 1024x1536 background, each
    batchify_sample timed, pasted back through ParsedPasteBack with a
    random FaceParser at 512. K1/K2 must launch as the three restores'
    shapes say. RetinaFaceDetector (canvas 640, random weights) timed on
    the same image; FaceParser.parse_mask timed on one face."""
    import os

    import numpy as np
    import torch
    from PIL import Image

    from supir_tpu_torch.apps.face_demo import restore_with_faces
    from supir_tpu_torch.models.parsenet import FaceParser
    from supir_tpu_torch.models.retinaface import RetinaFaceDetector
    from supir_tpu_torch.ops.flash_attention import flash_attention
    from supir_tpu_torch.ops.groupnorm import group_norm
    from supir_tpu_torch.utils.face_restore import detector_from_models

    torch.cuda.reset_peak_memory_stats()
    h, w = FACE_IMAGE
    g = torch.Generator().manual_seed(SEED + 32)
    photo = torch.randint(0, 256, (h, w, 3), generator=g, dtype=torch.uint8).numpy()
    image = photo.astype(np.float32) / 127.5 - 1.0
    detector = RetinaFaceDetector.create(seed=SEED + 33, canvas=640, device="cuda")
    parser = FaceParser.create(seed=SEED + 34, in_size=512, device="cuda")

    def timed(fn, *a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    detector.detect_faces(photo[..., ::-1])  # warm-up
    _, net_s = timed(detector.forward_canvas, photo[..., ::-1])
    dets, det_s = timed(detector.detect_faces, photo[..., ::-1], conf_threshold=0.5)
    lms, lm_s = timed(detector_from_models(detector), image * 0.5 + 0.5)
    face = torch.rand(512, 512, 3, generator=g).numpy() * 255
    parser.parse_mask(face)
    mask, parse_s = timed(parser.parse_mask, face)
    if not (torch.isfinite(mask).all() and mask.shape == (512, 512)):
        raise AssertionError(f"[face] parse mask {tuple(mask.shape)}")

    samples = []
    sound = engine.batchify_sample

    def counted(x, *a, **k):
        out, s = timed(sound, x, *a, **k)
        samples.append((tuple(x.shape[1:3]), s))
        return out

    engine.batchify_sample = counted
    flash_attention.launches = 0
    group_norm.launches = 0
    try:
        out, total_s = timed(restore_with_faces, engine, cfg, image, prompt="two people, ",
                             face_resolution=FACE_RESOLUTION, num_steps=steps, cfg_scale=7.5, seed=SEED,
                             detector=two_faces, parser=parser)
    finally:
        del engine.batchify_sample
    launches = {"K1": flash_attention.launches, "K2": group_norm.launches}
    f = cfg.vae.downscale_factor
    lats = [(s[0] // f, s[1] // f) for s, _ in samples]
    want = {"K1": sum(expected_flash_launches(cfg, lat, steps, vae_passes=4) for lat in lats),
            "K2": len(lats) * expected_group_norm_launches(cfg, steps, encodes=2, decodes=2)}
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = out.cpu().numpy()
    log(f"[face] {smi}: restore_with_faces at face_resolution {FACE_RESOLUTION}, {h}x{w} image, two faces "
        f"(landmark callable), {steps} steps, ParsedPasteBack with a random FaceParser at 512: "
        f"{total_s:.3f} s; batchify_sample " + ", ".join(f"{a}x{b} {s:.3f} s" for (a, b), s in samples)
        + f"; the rest (align, encode, conditioning, paste with the parse mask) "
        f"{total_s - sum(s for _, s in samples):.3f} s; launches K1 {launches['K1']}, K2 {launches['K2']} "
        f"(expected {want}); peak memory {peak:.2f} GiB")
    log(f"[face] RetinaFaceDetector canvas 640, random weights, on the {h}x{w} image: detect_faces "
        f"{det_s * 1e3:.2f} ms ({dets.shape[0]} rows at conf 0.5; the resize, letterbox and network "
        f"{net_s * 1e3:.2f} ms, the rest the host's decode and NMS), through detector_from_models "
        f"{lm_s * 1e3:.2f} ms ({len(lms)} faces at conf 0.8, eye distance 5); FaceParser 512 parse_mask "
        f"{parse_s * 1e3:.2f} ms")
    if [s for s, _ in samples] != [(FACE_RESOLUTION, FACE_RESOLUTION)] * 2 + [(h, w)]:
        raise AssertionError(f"[face] restores {[s for s, _ in samples]}")
    if launches != want:
        raise AssertionError(f"[face] launches {launches}, expected {want}")
    if out.shape != (h, w, 3) or not np.isfinite(out).all() or np.abs(out - image).max() == 0:
        raise AssertionError(f"[face] output {out.shape}")
    Image.fromarray(photo).save(os.path.join(apps_dir, "ref", "face.png"))
    Image.fromarray(((out + 1) * 127.5).round().clip(0, 255).astype(np.uint8)).save(
        os.path.join(apps_dir, "pred", "face_0.png"))


def _lpips_sources(seed: int):
    """A torchvision-keyed vgg16 `features` state dict and taming `vgg.pth`
    heads, random (N(0, 1/fan_in) convs, |N(0, 1)| heads)."""
    import torch

    from supir_tpu_torch.utils.metrics import VGG_CHANNELS, VGG_SLICES, VGG_TORCH_CONV_IDX

    g = torch.Generator().manual_seed(seed)
    chans = [c for n, c in zip(VGG_SLICES, VGG_CHANNELS) for _ in range(n)]
    vgg, cin = {}, 3
    for t, cout in zip(VGG_TORCH_CONV_IDX, chans):
        vgg[f"features.{t}.weight"] = torch.randn(cout, cin, 3, 3, generator=g) * (9 * cin) ** -0.5
        vgg[f"features.{t}.bias"] = 0.05 * torch.randn(cout, generator=g)
        cin = cout
    lin = {f"lin{i}.model.1.weight": torch.randn(1, c, 1, 1, generator=g).abs() for i, c in enumerate(VGG_CHANNELS)}
    return vgg, lin


def phase_eval(apps_dir: str, smi: str):
    """evaluate_dirs over [web demo]'s and [face]'s outputs against their
    inputs on the card, LPIPS with random weights: a torchvision-keyed
    vgg16 state dict and heads written here, converted by
    convert_lpips_state and saved as the port's state dict."""
    import os

    import torch

    from supir_tpu_torch.apps.eval import evaluate_dirs
    from supir_tpu_torch.utils import metrics
    from supir_tpu_torch.utils.checkpoint import save_params

    vgg, lin = _lpips_sources(SEED + 35)
    torch.save(vgg, os.path.join(apps_dir, "vgg16.pth"))
    torch.save(lin, os.path.join(apps_dir, "vgg.pth"))
    from supir_tpu_torch.utils.ckpt import load_torch_file

    path = os.path.join(apps_dir, "lpips.safetensors")
    save_params(path, metrics.convert_lpips_state(load_torch_file(os.path.join(apps_dir, "vgg16.pth")),
                                                  load_torch_file(os.path.join(apps_dir, "vgg.pth"))))
    t0 = time.perf_counter()
    out = evaluate_dirs(os.path.join(apps_dir, "pred"), os.path.join(apps_dir, "ref"), path, device="cuda")
    wall = time.perf_counter() - t0
    log(f"[eval] {smi}: evaluate_dirs over {out['n']} pairs ([web demo] stage 2 at 1024^2 against its 512^2 "
        f"input, [face] against its input) on the card: {json.dumps(out)} in {wall:.3f} s (PNG reads, bicubic "
        f"resizes, LPIPS-VGG with random weights)")
    if out["n"] != 2 or not all(math.isfinite(out[k]) for k in ("psnr", "ssim", "lpips")):
        raise AssertionError(f"[eval] {out}")
    if next(metrics._lpips_model.parameters()).device.type != "cuda":
        raise AssertionError("[eval] LPIPS did not run on the card")
    metrics._lpips_model = None


SERVE_SIDE = 1024     # [serve]: side of the restoration requests' PNG (upscale 1, min_size 1024)
DRILL_STEPS = 5       # [load_real]: the drill's restore, as tools/load_real.py runs it
DRILL_SIZE = 512
DRILL_PSNR_MIN = 35.0  # the drill's own --psnr_min default


def _stream(addr: str, body: dict):
    """POST to a worker's /worker_generate_stream -> (every frame, wall s)."""
    import urllib.request

    from supir_tpu_torch.serve.worker import iter_stream_frames

    req = urllib.request.Request(addr + "/worker_generate_stream", data=json.dumps(body).encode())
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        frames = list(iter_stream_frames(r))
    return frames, time.perf_counter() - t0


@contextlib.contextmanager
def serve_cluster(work_fn, model: str):
    """The port's controller and one model worker over `work_fn`, both on
    127.0.0.1 at port 0 in threads, the worker registered -> the
    controller's port; both stopped on exit."""
    import threading

    from supir_tpu_torch.serve import controller, worker

    ctl, _ = controller.serve_controller("127.0.0.1", 0)
    httpd = worker.serve_worker(None, "127.0.0.1", 0)
    servers = (ctl, httpd)
    for s in servers:
        threading.Thread(target=s.serve_forever, daemon=True).start()
    ctl_addr, addr = (f"http://127.0.0.1:{s.server_address[1]}" for s in servers)
    w = worker.ModelWorker(ctl_addr, addr, work_fn, model_names=(model,))
    httpd.RequestHandlerClass.worker = w
    try:
        yield ctl.server_address[1]
    finally:
        w.stop()
        for s in servers:
            s.shutdown()
            s.server_close()


@contextlib.contextmanager
def timed_restoration_work(engine, cfg):
    """serve/worker.py:restoration_work_fn with each request's seconds taken
    from outside it -> (the work function, the list it appends to): `decode`
    (base64 and PNG, the worker's _decode_image), `prepare` (the host's
    resize and the tokenizer, and any wait on the worker's device lock),
    `device` (from the stage-1 encode to the end of array_to_pil, whose copy
    back synchronises) and `encode` (PNG and base64, to the work function's
    return). Every wrapper is undone on exit."""
    import threading

    from supir_tpu_torch.serve import worker
    from supir_tpu_torch.utils import image as I

    marks, timings = threading.local(), []

    def mark_after(fn, name):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            setattr(marks, name, time.perf_counter())
            return out
        return wrapped

    encode = engine.encode_first_stage_with_denoise

    def timed_encode(*a, **k):
        marks.device = time.perf_counter()
        return encode(*a, **k)

    decode, to_pil = worker._decode_image, I.array_to_pil
    I.array_to_pil = mark_after(to_pil, "copied")
    try:
        work = worker.restoration_work_fn(engine, cfg)  # binds the wrapped array_to_pil
    finally:
        I.array_to_pil = to_pil

    def timed_work(params):
        t0 = time.perf_counter()
        out = work(params)
        timings.append({"decode": marks.decoded - t0, "prepare": marks.device - marks.decoded,
                        "device": marks.copied - marks.device, "encode": time.perf_counter() - marks.copied})
        return out

    worker._decode_image = mark_after(decode, "decoded")
    engine.encode_first_stage_with_denoise = timed_encode
    try:
        yield timed_work, timings
    finally:
        worker._decode_image = decode
        del engine.encode_first_stage_with_denoise


def _restore_counters():
    from supir_tpu_torch.ops.flash_attention import flash_attention
    from supir_tpu_torch.ops.groupnorm import group_norm

    return {"K1": flash_attention, "K2": group_norm}


def phase_serve(engine, cfg, steps: int, smi: str):
    """Serving at full width: the port's controller and a restoration worker
    (serve/worker.py:restoration_work_fn) over [web demo]'s engine
    (options/SUPIR_v0.yaml, XL-base, bf16, random weights), on 127.0.0.1 at
    port 0 in threads, each request dispatched through /get_worker_address
    and sent to /worker_generate_stream: a 1024^2 restoration equal to a
    direct batchify_sample on the same inputs and seed, pixel for pixel,
    with K1/K2 per request as the config says; a second seed
    serially; both at once, each equal to its serial answer; a request
    without an image, answered with an error payload. Seconds per request:
    HTTP wall, batchify_sample, the rest of the device part, and the
    host's base64/PNG work."""
    import threading

    import numpy as np
    import torch
    from PIL import Image

    from supir_tpu_torch.serve.worker import ErrorCode_ERROR
    from supir_tpu_torch.utils.image import array_to_pil, pil_to_array
    from supir_tpu_torch.utils.tokenizer import tokenize

    g = torch.Generator().manual_seed(SEED + 40)
    photo = torch.randint(0, 256, (SERVE_SIDE, SERVE_SIDE, 3), generator=g, dtype=torch.uint8).numpy()
    image = _png_b64(photo)
    prompt = "a photo of a lake, "
    lat = SERVE_SIDE // cfg.vae.downscale_factor
    want = {"K1": expected_flash_launches(cfg, lat, steps, vae_passes=4),
            "K2": expected_group_norm_launches(cfg, steps, encodes=2, decodes=2)}

    def direct(seed):
        arr, h0, w0 = pil_to_array(Image.fromarray(photo), upscale=1, min_size=SERVE_SIDE)
        x = torch.from_numpy(arr)[None]
        tok_p, tok_n = tokenize([prompt + cfg.p_p]), tokenize([cfg.n_p])
        z = engine.encode_first_stage_with_denoise(x)
        c, uc = engine.prepare_condition(z, tok_p, tok_p, tok_n, tok_n)
        out = engine.batchify_sample(x, c, uc, num_steps=steps, cfg_scale=7.5, seed=seed, color_fix_type="Wavelet",
                                     z_override=z)
        return np.asarray(array_to_pil(out[0], h0, w0))

    t0 = time.perf_counter()
    want_img = direct(0)
    torch.cuda.synchronize()
    direct_s = time.perf_counter() - t0
    samples = []
    sample = engine.batchify_sample

    def timed_sample(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = sample(*a, **k)
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t)
        return out

    engine.batchify_sample = timed_sample
    counters = _restore_counters()
    request = {"image": image, "edm_steps": steps, "upscale": 1, "min_size": SERVE_SIDE, "prompt": prompt}
    try:
        with timed_restoration_work(engine, cfg) as (work, timings), serve_cluster(work, "supir") as ctl:
            def send(seed, count=False):
                addr = _http(ctl, "/get_worker_address", {"model": "supir"})[0]["address"]
                if not addr:
                    raise AssertionError("[serve] the controller dispatched to no worker")
                if count:
                    for fn in counters.values():
                        fn.launches = 0
                frames, wall = _stream(addr, dict(request, seed=seed) if seed is not None else {"edm_steps": 1})
                got = {k: fn.launches for k, fn in counters.items()}
                return frames, wall, got

            frames, wall_a, got = send(0, count=True)
            if got != want:
                raise AssertionError(f"[serve] launches per restoration request {got}, expected {want}")
            serial = {0: _unpng(frames[-1]["image"])}
            frames_b, wall_b, _ = send(1)
            serial[1] = _unpng(frames_b[-1]["image"])
            both = [None, None]

            def run(i):
                both[i] = send(i)

            t0 = time.perf_counter()
            threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall_both = time.perf_counter() - t0
            err, wall_err, _ = send(None)
    finally:
        del engine.batchify_sample
    diff = np.abs(serial[0].astype(np.int16) - want_img).max() if serial[0].shape == want_img.shape else None
    log(f"[serve] {smi}: options/SUPIR_v0.yaml, {SERVE_SIDE}^2 PNG, {steps} steps, through the controller's "
        f"dispatch to one restoration worker: against a direct batchify_sample on the same inputs and seed, max "
        f"diff {diff} (bound 0); launches per request K1 {got['K1']}, K2 {got['K2']} (expected {want})")
    if serial[0].shape != (SERVE_SIDE, SERVE_SIDE, 3) or diff != 0:
        raise AssertionError(f"[serve] restoration {serial[0].shape} differs from the direct run by {diff}")
    if not np.abs(serial[1].astype(np.int16) - serial[0]).mean() > 0:
        raise AssertionError("[serve] two seeds gave the same image")
    for i in (0, 1):
        if both[i] is None or "image" not in both[i][0][-1]:
            raise AssertionError(f"[serve] concurrent request {i}: {both[i] and both[i][0][-1]}")
        d = np.abs(_unpng(both[i][0][-1]["image"]).astype(np.int16) - serial[i]).max()
        log(f"[serve] concurrent request seed {i} ({both[i][1]:.3f} s) against the serial one: max diff {d}")
        if d:
            raise AssertionError(f"[serve] the concurrent request {i} differs from the serial one by {d}")
    if len(err) != 1 or err[0].get("error_code") != ErrorCode_ERROR or "image" in err[0]:
        raise AssertionError(f"[serve] the request without an image answered {err}")
    log(f"[serve] error request: {err[0]} in {wall_err:.3f} s")
    parts = []
    for i, (t, s_, w) in enumerate(zip(timings[:2], samples[:2], (wall_a, wall_b))):
        host = t["decode"] + t["encode"]
        parts.append(f"request {i + 1}: wall {w:.3f} s = batchify_sample {s_:.3f} s + encode/conditioning/copy back "
                     f"{t['device'] - s_:.3f} s + host I/O {host:.3f} s (base64+PNG decode {t['decode']:.3f}, PNG+"
                     f"base64 encode {t['encode']:.3f}) + resize/tokenize {t['prepare']:.3f} s + HTTP and JSON "
                     f"{w - t['device'] - host - t['prepare']:.3f} s")
    log("[serve] seconds per restoration request, serial: " + "; ".join(parts) + f"; two at once {wall_both:.3f} s "
        f"(one after the other on the worker's device lock; batchify_sample "
        + ", ".join(f"{t:.3f}" for t in samples[2:4]) + f" s); the direct run {direct_s:.3f} s")
    return got


def _multipart(fields: dict, image: bytes):
    boundary = "----chipsmoke"
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
             for k, v in fields.items()]
    parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="image"; filename="a.png"\r\n'
                 f"Content-Type: image/png\r\n\r\n".encode() + image + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return f"multipart/form-data; boundary={boundary}", b"".join(parts)


def phase_serve_caption(agent, image, smi: str):
    """The caption side of serving: a caption worker
    (serve/worker.py:caption_work_fn) over [captioner int4]'s full-width
    agent behind the port's controller, and the web chat
    (serve/web_chat.py) in front of it, all on 127.0.0.1 at port 0: one
    /send with a 1024^2 PNG and a question, the reply equal to the agent's
    own caption of that image at the same temperature, top_p and seed, with
    K5 per request as the config says for its tokens."""
    import base64
    import urllib.request

    import torch

    from supir_tpu_torch.ops import quantize as Q
    from supir_tpu_torch.serve import web_chat
    from supir_tpu_torch.serve.worker import caption_work_fn

    question = "Describe this photo."
    png = base64.b64decode(_png_b64(image))
    t0 = time.perf_counter()
    seqs, stop_at, stop_str = agent.generate([image], temperature=0.2, top_p=0.7, qs=question, seed=0)
    want = agent._texts_from(seqs, stop_at, 2, stop_str)[0]
    direct_s = time.perf_counter() - t0
    tokens = seqs.shape[1]
    want_k5 = expected_caption_launches(agent.cfg.llama, tokens - 1, load=False)["K5"]
    model = "llava-v1.5-13b-int4"
    with serve_cluster(caption_work_fn(agent), model) as ctl:
        chat = web_chat.serve_web_chat(f"http://127.0.0.1:{ctl}", "127.0.0.1", 0)
        try:
            ctype, body = _multipart({"text": question, "session": "smoke", "model": model}, png)
            req = urllib.request.Request(f"http://127.0.0.1:{chat.server_address[1]}/send", data=body,
                                         headers={"Content-Type": ctype})
            Q.int4_paired_fused_matmul.launches = 0
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=600) as r:
                page = r.read().decode()
            wall = time.perf_counter() - t0
            k5 = Q.int4_paired_fused_matmul.launches
            turns = chat.RequestHandlerClass.state.turns("smoke")
        finally:
            chat.shutdown()
            chat.server_close()
    torch.cuda.synchronize()
    reply = turns[-1]["text"] if turns else ""
    log(f"[serve] {smi}: web chat /send with a {image.shape[0]}^2 PNG through the controller to a caption worker "
        f"over LLaVA-1.5-13B int4 (full width): {wall:.3f} s for {tokens} tokens (the agent alone "
        f"{direct_s:.3f} s); K5 launches {k5} (expected {want_k5}); reply {reply[:40]!r}")
    if reply != want or not want or f'value="{model}"' not in page:
        raise AssertionError(f"[serve] the chat's reply {reply!r} is not the caption {want!r}")
    if k5 != want_k5:
        raise AssertionError(f"[serve] K5 launched {k5} times in the caption request, expected {want_k5}")
    return k5


def phase_captioner_eval(agent, smi: str):
    """captioner/eval.py at full width: run_vqa over three synthetic
    questions on [captioner int4]'s agent (K5 counted against each
    answer's tokens), then `score-pope` on synthetic labels over those
    answers."""
    import io
    import os
    import tempfile

    import numpy as np
    from PIL import Image

    from supir_tpu_torch.captioner import eval as ev
    from supir_tpu_torch.ops import quantize as Q

    decoded = []
    decode = agent._decode_tokens

    def counted(*a, **k):
        out = decode(*a, **k)
        decoded.append(out[0].shape[1])
        return out

    agent._decode_tokens = counted
    try:
        with tempfile.TemporaryDirectory() as d:
            for sub in ("img", "pope"):
                os.makedirs(os.path.join(d, sub))
            rng = np.random.default_rng(SEED + 41)
            with open(os.path.join(d, "q.jsonl"), "w") as fq, \
                    open(os.path.join(d, "pope", "coco_pope_random.json"), "w") as fa:
                for i in range(3):
                    Image.fromarray(rng.integers(0, 256, (336, 448, 3), dtype=np.uint8)).save(
                        os.path.join(d, "img", f"{i}.png"))
                    fq.write(json.dumps({"question_id": i, "image": f"{i}.png", "text": f"Is there a dog {i}?",
                                         "category": "random"}) + "\n")
                    fa.write(json.dumps({"label": ["yes", "no", "yes"][i]}) + "\n")
            Q.int4_paired_fused_matmul.launches = 0
            t0 = time.perf_counter()
            n = ev.run_vqa(agent, os.path.join(d, "q.jsonl"), os.path.join(d, "img"), os.path.join(d, "a.jsonl"))
            wall = time.perf_counter() - t0
            k5 = Q.int4_paired_fused_matmul.launches
            with open(os.path.join(d, "a.jsonl")) as f:
                answers = [json.loads(line) for line in f]
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                ev.main(["score-pope", "--annotation-dir", os.path.join(d, "pope"), "--question-file",
                         os.path.join(d, "q.jsonl"), "--result-file", os.path.join(d, "a.jsonl")])
            pope = json.loads(out.getvalue())
    finally:
        agent._decode_tokens = decode
    want_k5 = sum(expected_caption_launches(agent.cfg.llama, t - 1, load=False)["K5"] for t in decoded)
    log(f"[captioner eval] {smi}: run_vqa over {n} synthetic questions on LLaVA-1.5-13B int4 (full width) in "
        f"{wall:.3f} s ({wall / max(n, 1):.3f} s a question; tokens {decoded}); K5 launches {k5} (expected "
        f"{want_k5}); answers {[a['text'][:16] for a in answers]}; score-pope {json.dumps(pope)}")
    if n != 3 or len(answers) != 3 or not all(a["text"] for a in answers):
        raise AssertionError(f"[captioner eval] answered {n}: {answers}")
    if k5 != want_k5 or not k5:
        raise AssertionError(f"[captioner eval] K5 launched {k5} times, expected {want_k5}")
    r = pope.get("random", {})
    if sum(r.get(k, 0) for k in ("TP", "FP", "TN", "FN")) != 3:
        raise AssertionError(f"[captioner eval] score-pope {pope}")


def _drill(argv):
    """tools/load_real.main on `argv` -> (return code, its printed lines, s)."""
    import io

    from supir_tpu_torch.tools import load_real

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = load_real.main(argv)
    wall = time.perf_counter() - t0
    _free()
    return rc, out.getvalue().splitlines(), wall


def phase_load_real(apps_dir: str, smi: str):
    """The port's real-weight drill (tools/load_real.py) at full width on
    the synthetic SDXL + SUPIR file pair [web demo] wrote and the tiny HF
    llava directory: conversion, tokenizer (the hash fallback allowed),
    a 5-step 512^2 restore and a caption must PASS; a rerun with the first
    output as --ref_out must reach --psnr_min; a copy of the SUPIR file
    with one key removed must FAIL at the conversion, naming that key."""
    import os

    from safetensors.torch import load_file, save_file

    sdxl, supir = os.path.join(apps_dir, "ckpt", "sdxl.safetensors"), os.path.join(apps_dir, "ckpt", "supir_F.safetensors")
    first, again = os.path.join(apps_dir, "drill.png"), os.path.join(apps_dir, "drill_again.png")
    flags = ["--opt", WEB_OPT, "--sdxl", sdxl, "--llava", os.path.join(apps_dir, "llava"), "--steps",
             str(DRILL_STEPS), "--size", str(DRILL_SIZE), "--allow_hash_tokenizer", "--device", "cuda"]
    counters = _restore_counters()
    for fn in counters.values():
        fn.launches = 0
    rc, lines, wall = _drill(flags + ["--supir", supir, "--save", first])
    launches = {k: fn.launches for k, fn in counters.items()}
    for line in lines:
        log(f"[load_real] {line}")
    if rc or "VERDICT: PASS (4 stages)" not in lines:
        raise AssertionError(f"[load_real] the drill failed on the good pair (rc {rc})")
    rc2, lines2, wall2 = _drill(flags + ["--supir", supir, "--save", again, "--ref_out", first, "--psnr_min",
                                         str(DRILL_PSNR_MIN)])
    psnr = [line for line in lines2 if line.startswith("[PASS] psnr")]
    log(f"[load_real] rerun against the first output: {psnr[0] if psnr else lines2[-3:]}")
    if rc2 or not psnr:
        raise AssertionError(f"[load_real] the PSNR rerun failed (rc {rc2}): {lines2}")
    t0 = time.perf_counter()
    sd = load_file(supir)
    gone = sorted(k for k in sd if k.startswith("model.control_model."))[0]
    del sd[gone]
    bad = os.path.join(apps_dir, "ckpt", "supir_missing.safetensors")
    save_file(sd, bad)
    del sd
    write_s = time.perf_counter() - t0
    rc3, lines3, wall3 = _drill(flags + ["--supir", bad, "--save", os.path.join(apps_dir, "drill_bad.png")])
    os.remove(bad)
    fail = [line for line in lines3 if line.startswith("[FAIL] conversion")]
    log(f"[load_real] the SUPIR file without {gone}: rc {rc3}, {fail[0][:160] if fail else lines3}")
    if rc3 != 1 or not fail or gone not in fail[0] or "VERDICT: FAIL" not in lines3[-1]:
        raise AssertionError(f"[load_real] the planted missing key did not fail the drill: {lines3}")
    log(f"[load_real] {smi}: options/SUPIR_v0.yaml at full width, {DRILL_STEPS} steps at {DRILL_SIZE}^2, the "
        f"tiny llava directory in int4: drill {wall:.1f} s (K1 {launches['K1']}, K2 {launches['K2']} launches: "
        f"the restore and the caption's stage-1 denoise), rerun with --ref_out {wall2:.1f} s, the missing-key "
        f"copy written in {write_s:.1f} s and refused in {wall3:.1f} s")
    if not (launches["K1"] > 0 and launches["K2"] > 0):
        raise AssertionError(f"[load_real] the drill's restore launched {launches}")


def phase_chat_weights(apps_dir: str):
    """captioner/chat.py with --weights on the tiny HF llava directory, on
    the card: one question about an image, greedy."""
    import io
    import os

    import torch
    from PIL import Image

    from supir_tpu_torch.captioner import chat

    g = torch.Generator().manual_seed(SEED + 42)
    path = os.path.join(apps_dir, "chat.png")
    Image.fromarray(torch.randint(0, 256, (336, 336, 3), generator=g, dtype=torch.uint8).numpy()).save(path)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        chat.main(["--weights", os.path.join(apps_dir, "llava"), "--image", path, "--query", "What is this?",
                   "--temperature", "0", "--device", "cuda"])
    wall = time.perf_counter() - t0
    answer = out.getvalue().strip().splitlines()[-1]
    log(f"[chat] --weights (the tiny HF llava directory, bf16 on the card): one greedy answer in {wall:.3f} s "
        f"with the load: {answer[:40]!r}")
    if not answer or "captioner conversion" in answer:
        raise AssertionError(f"[chat] --weights printed no answer: {out.getvalue()!r}")
    _free()


def _zero_pad_blur(x, ksize: int, sigma: float):
    """gaussian_blur with its border padded with zeros, not reflected (a
    planted fault)."""
    import torch

    half = ksize // 2
    t = torch.arange(-half, half + 1, dtype=torch.float32, device=x.device)
    k = torch.exp(-0.5 * (t / sigma) ** 2)
    k = (k / k.sum()).to(x.dtype)
    c = x.shape[-1]
    y = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (half,) * 4)
    y = torch.nn.functional.conv2d(y, k.view(1, 1, ksize, 1).expand(c, 1, ksize, 1), groups=c)
    y = torch.nn.functional.conv2d(y, k.view(1, 1, 1, ksize).expand(c, 1, 1, ksize), groups=c)
    return y.permute(0, 2, 3, 1).contiguous()


def phase_apps_reference():
    """The tiny face and eval pipeline on the card (fp32) against the same
    on the CPU (fp32): alignment warps of two faces, the border-mask paste,
    the parse-mask paste (ParseNet 64, depth 2), RetinaFace at canvas 128,
    PSNR, SSIM and LPIPS; each output by relative L2 against
    APPS_REF_BOUND. Planted on the card side, the paste through the
    matrix itself (the inverse affine not inverted) and the blur padded
    with zeros must break it."""
    import numpy as np
    import torch

    from supir_tpu_torch.models import parsenet
    from supir_tpu_torch.models.parsenet import FaceParser
    from supir_tpu_torch.models.retinaface import RetinaFaceDetector
    from supir_tpu_torch.utils import face_restore as FR
    from supir_tpu_torch.utils import metrics

    g = torch.Generator().manual_seed(SEED + 36)
    img = torch.rand(96, 128, 3, generator=g)
    restored = [torch.rand(64, 64, 3, generator=g) for _ in range(2)]
    photo = (torch.rand(100, 90, 3, generator=g) * 255).round()
    det_cpu = RetinaFaceDetector.create(seed=SEED + 37, canvas=128, device="cpu")
    parser_cpu = FaceParser.create(seed=SEED + 38, in_size=64, res_depth=2, device="cpu")
    vgg, lin = _lpips_sources(SEED + 39)
    lpips_sd = metrics.convert_lpips_state(vgg, lin)
    x_cpu = img[None] * 2 - 1
    y_cpu = (x_cpu + 0.2 * torch.randn(x_cpu.shape, generator=g)).clamp(-1, 1)

    def pipeline(device, invert=True):
        det = RetinaFaceDetector.from_state_dict(det_cpu.model.state_dict(), canvas=128, device=device)
        parser = FaceParser.from_state_dict(parser_cpu.model.state_dict(), in_size=64, res_depth=2, device=device)
        helper = FR.FaceRestoreHelper(face_size=64, detector=two_faces)
        faces = helper.align_warp_faces(img.to(device))
        if not invert:
            faces = [FR.AlignedFace(f.crop, FR.invert_affine(f.affine)) for f in faces]
        rest = [r.to(device) for r in restored]
        (loc, conf, ldm), _ = det.forward_canvas(photo.numpy())
        metrics.load_lpips_state(lpips_sd, device)
        x, y = x_cpu.to(device), y_cpu.to(device)
        out = {"crops": torch.stack([f.crop for f in faces]), "paste": helper.paste_faces_to_input_image(
            img.to(device), faces, rest), "parsed paste": FR.ParsedPasteBack(helper, parser)(img.to(device), faces,
                                                                                              rest),
               "parse logits": parser.logits(rest[0].flip(-1) * 255), "retinaface loc": loc, "retinaface conf": conf,
               "retinaface landmarks": ldm, "psnr": metrics.psnr(x, y),
               "ssim": metrics.ssim(x, y), "lpips": metrics.lpips(x, y)}
        metrics._lpips_model = None
        return {k: v.float().cpu() for k, v in out.items()}

    want = pipeline("cpu")
    got = pipeline("cuda")
    rels = {k: rel_l2(got[k], want[k]) for k in want}
    log("[apps reference] tiny face and eval pipeline, card fp32 vs CPU fp32, rel_l2: "
        + ", ".join(f"{k} {v:.2e}" for k, v in rels.items()) + f" (bound {APPS_REF_BOUND:g})")
    if not max(rels.values()) <= APPS_REF_BOUND:
        raise AssertionError(f"[apps reference] card and CPU disagree: {rels}")
    bad = pipeline("cuda", invert=False)
    bad_rel = max(rel_l2(bad[k], want[k]) for k in ("paste", "parsed paste"))
    blur = FR.gaussian_blur
    FR.gaussian_blur = parsenet.gaussian_blur = _zero_pad_blur
    try:
        zero = pipeline("cuda")
    finally:
        FR.gaussian_blur = parsenet.gaussian_blur = blur
    zero_rel = rel_l2(zero["parsed paste"], want["parsed paste"])
    log(f"[apps reference] controls: paste through the matrix not inverted rel_l2 {bad_rel:.3e}; blur padded "
        f"with zeros: parsed paste rel_l2 {zero_rel:.3e}")
    if not (bad_rel > APPS_REF_BOUND and zero_rel > APPS_REF_BOUND):
        raise AssertionError(f"[apps reference] a planted fault stays under the bound: {bad_rel}, {zero_rel}")


# ------------------------------------------------------------------ [multi-device]

MD_RANKS = 2           # [multi-device]: two gloo ranks on one card, or NCCL at world size 2 on two or more
MD_TILED_SIDE = 2048   # (c): the [tiled] configuration's model image
MD_RING_SIDE = 2048    # (b): an untiled network call at a 256^2 latent: 16384 tokens at the first attention level
MD_RING_SHAPE = (2, 16384, 10, 64)  # (b): ring_attention alone, at those sites' shape
MD_REL_BOUND = 5e-2    # (b), (c): the split run against the one-process run, relative L2 (bf16 sums in another order)
MD_ROWS = 1024         # attention_plain's row chunk at MD_RING_SHAPE (a whole fp32 logit tensor is 21 GB)


def _md_collective_timer():
    """Wrap the port's collective helpers, in every module that holds them,
    in synchronised timers: returns (seconds list, restore). On a gloo group
    their time is the staging through host memory and gloo's transfer."""
    import torch

    from supir_tpu_torch.parallel import mesh, ring_attention, sharding, tiled_sampler, tiled_vae

    spent = [0.0]
    saved = []
    for module, name in ((mesh, "all_reduce_"), (sharding, "all_gather"), (ring_attention, "all_gather"),
                         (ring_attention, "ring_shift"), (tiled_vae, "all_gather"), (tiled_sampler, "all_gather")):
        fn = getattr(module, name)

        def timed(*a, _fn=fn, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t
            return out

        saved.append((module, name, fn))
        setattr(module, name, timed)
    return spent, lambda: [setattr(m, n, f) for m, n, f in saved]


def _md_counters():
    from supir_tpu_torch.ops import quantize as Q
    from supir_tpu_torch.ops.flash_attention import flash_attention, flash_attention_fwd_lse
    from supir_tpu_torch.ops.groupnorm import group_norm

    return {"K1": flash_attention, "K2": group_norm, "K3": flash_attention_fwd_lse, "K5": Q.int4_paired_fused_matmul}


def _md_zero():
    for fn in _md_counters().values():
        fn.launches = 0


def _md_read():
    return {k: fn.launches for k, fn in _md_counters().items()}


def _md_rank(rank: int, world: int, tmp: str, backend: str, steps: int):
    """One rank of [multi-device]: (a) the sharded 1024^2 restore, (b) the
    ring at 2048^2 and alone, (c) the tile axis at 2048^2, (d) the sharded
    LLaVA-13B int4 captioner. Rank 0 also runs the one-process references
    (the other rank waits); every split run is held to them there. Writes
    its readings to tmp/rank<r>.pt."""
    import torch
    import torch.distributed as dist

    if backend == "nccl":
        torch.cuda.set_device(rank)
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'store')}", rank=rank, world_size=world)
    try:
        out = _md_body(rank, world, dev, backend, steps)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def _md_body(rank, world, dev, backend, steps):
    import torch
    import torch.distributed as dist

    from supir_tpu_torch.captioner.agent import CaptionerConfig, create_captioner
    from supir_tpu_torch.config import load_yaml_config
    from supir_tpu_torch.engine.factory import create_engine
    from supir_tpu_torch.ops.flash_attention import attention_plain, flash_attention
    from supir_tpu_torch.parallel import ring_attention as RA
    from supir_tpu_torch.parallel.mesh import make_mesh

    out = {"secs": {}, "launches": {}, "peak": {}, "staging": {}}
    spent, restore_timers = _md_collective_timer()
    lead = rank == 0

    def sync_time(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        y = fn()
        torch.cuda.synchronize()
        return y, time.perf_counter() - t

    def split_run(label, fn):
        """fn on every rank with the counters zeroed just before and read
        just after, its seconds, its collectives' seconds and its peak."""
        dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        _md_zero()
        spent[0] = 0.0
        y, secs = sync_time(fn)
        out["launches"][label] = _md_read()
        out["secs"][label] = secs
        out["staging"][label] = spent[0]
        out["peak"][label] = torch.cuda.max_memory_allocated() / 2**30
        return y

    def reference(label, fn):
        """fn on rank 0 alone, the others waiting: the one-process run."""
        y = None
        if lead:
            torch.cuda.reset_peak_memory_stats()
            _md_zero()
            y, out["secs"][label] = sync_time(fn)
            out["launches"][label] = _md_read()
            out["peak"][label] = torch.cuda.max_memory_allocated() / 2**30
        dist.barrier()
        return y

    t_all = time.perf_counter()
    cfg, extras = load_yaml_config(TILED_OPT)
    engine, out["secs"]["build"] = sync_time(lambda: create_engine(cfg, dev, seed=SEED))
    _randomize_all(engine.model, SEED + 20)
    out["params_gib"] = sum(p.numel() * p.element_size() for p in engine.model.parameters()) / 2**30

    # (a)'s inputs and its one-process run, the [main] path's settings
    x, c, uc = _inputs(cfg, SIZE, dev, SEED + 1)

    def restore():
        z = engine.encode_first_stage_with_denoise(x)
        return engine.batchify_sample(x, dict(c, control=z), dict(uc, control=z), num_steps=steps, seed=SEED,
                                      z_override=z, sampler_name="RestoreEDM", **SAMPLE_KW)

    a_ref = reference("a one-process", restore)

    # (b) one untiled network call at a 256^2 latent, the 16384-token sites on the ring
    lat = MD_RING_SIDE // cfg.vae.downscale_factor
    g = torch.Generator(device=dev).manual_seed(SEED + 40)
    xb = torch.randn(2, 4, lat, lat, generator=g, device=dev)
    tb = torch.full((2,), 500.0, device=dev)
    cond = {"crossattn": torch.randn(2, 77, cfg.unet.context_dim, generator=g, device=dev),
            "vector": torch.randn(2, cfg.unet.adm_in_channels, generator=g, device=dev),
            "control": torch.randn(2, 4, lat, lat, generator=g, device=dev)}

    def network():
        with torch.no_grad(), engine._seq_ctx():
            return engine._network(xb, tb, cond, 1.0)

    b_ref = reference("b one-process", network)
    ring_calls = []
    real_ring = RA.ring_attention

    def counted(*a, **k):
        ring_calls.append(tuple(a[0].shape))
        return real_ring(*a, **k)

    seq = make_mesh((world,), ("seq",))
    engine.set_sequence_mesh(seq)
    RA.ring_attention = counted
    try:
        b_got = split_run("b ring", network)
    finally:
        RA.ring_attention = real_ring
        engine.set_sequence_mesh(None)
    out["ring_sites"] = collections.Counter(ring_calls)
    if lead:
        out["b_rel"] = rel_l2(b_got, b_ref)
    del b_got, b_ref, xb, cond

    # ring_attention alone at the ring sites' shape, keys whose halves differ
    # in scale (so that the blocks' lse differ and the merge's rescale matters)
    q, k, v = (torch.randn(MD_RING_SHAPE, generator=g, device=dev) for _ in range(3))
    k[:, MD_RING_SHAPE[1] // 2:] *= 2.0
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    ring = split_run("ring alone", lambda: RA.ring_attention(q, k, v, seq, axis="seq"))

    def no_rescale(o, lse, o_i, lse_i):  # the planted fault: the accumulator is not rescaled
        m = torch.maximum(lse, lse_i)
        a, b = torch.exp(lse - m), torch.exp(lse_i - m)
        a_, b_ = (w.transpose(1, 2)[..., None] for w in (a, b))
        return (o + o_i.float() * b_) / (a_ + b_), m + torch.log(a + b)

    real_merge = RA._merge
    RA._merge = no_rescale
    try:
        faulty = RA.ring_attention(q, k, v, seq, axis="seq")
    finally:
        RA._merge = real_merge
    if lead:
        k1 = flash_attention(q, k, v)
        plain = torch.cat([attention_plain(q[:, i:i + MD_ROWS].float(), k.float(), v.float())
                           for i in range(0, MD_RING_SHAPE[1], MD_ROWS)], dim=1)
        out["ring_rel"] = {"plain": rel_l2(ring, plain), "k1": rel_l2(ring, k1), "k1 vs plain": rel_l2(k1, plain),
                           "fault": rel_l2(faulty, plain)}
        del k1, plain
    for bad, label in ((q.float(), "fp32"), (q.clone().requires_grad_(True), "grad")):
        try:
            RA.ring_attention(bad, bad.detach() if label == "grad" else bad, bad.detach() if label == "grad" else bad,
                              seq, axis="seq")
            out[f"ring_{label}"] = "accepted"
        except (TypeError, RuntimeError) as e:
            out[f"ring_{label}"] = f"{type(e).__name__}: {e}"
    del q, k, v, ring, faulty
    torch.cuda.empty_cache()

    # (c) the [tiled] configuration at 2048^2 over a (1, 2, 1) tile mesh
    enc_tile, dec_tile = extras["tile_vae"]["encoder_tile_size"], extras["tile_vae"]["decoder_tile_size"]
    engine.init_tile_vae(enc_tile, dec_tile)
    xc, cc, ucc = _inputs(cfg, MD_TILED_SIDE, dev, SEED + 8)

    def tiled():
        z = engine.encode_first_stage_with_denoise(xc)
        return engine.batchify_sample_tiled(xc, dict(cc, control=z), dict(ucc, control=z), num_steps=steps,
                                            seed=SEED, z_override=z, tile_size=cfg.sampler.tile_size,
                                            tile_stride=cfg.sampler.tile_stride, **SAMPLE_KW)

    c_ref = reference("c one-process", tiled)
    engine.set_tiled_mesh(make_mesh((1, world, 1), ("data", "tile", "model")))
    c_got = split_run("c tile axis", tiled)
    engine.set_tiled_mesh(None)
    engine._tile_vae = None
    if lead:
        out["c_rel"] = rel_l2(c_got, c_ref)
    out["c_shape"] = tuple(c_got.shape)
    out["c_finite"] = bool(torch.isfinite(c_got).all())
    del c_got, c_ref, xc, cc, ucc
    torch.cuda.empty_cache()

    # (a) the engine sharded over a (1, 1, 2) mesh's 'model' axis
    engine.shard_for_inference(make_mesh((1, 1, world), ("data", "tile", "model")))
    torch.cuda.empty_cache()
    out["resident_gib"] = torch.cuda.memory_allocated() / 2**30
    a_got = split_run("a sharded", restore)
    if lead:
        out["a_equal"] = bool(torch.equal(a_got, a_ref))
        out["a_rel"] = rel_l2(a_got, a_ref)
        out["a_max_abs"] = (a_got.float() - a_ref.float()).abs().max().item()
    out["a_finite"] = bool(torch.isfinite(a_got).all()) and tuple(a_got.shape) == (1, SIZE, SIZE, 3)
    del engine, a_got, a_ref, x, c, uc
    import gc

    gc.collect()
    torch.cuda.empty_cache()

    # (d) LLaVA-13B int4, sharded over 'model'
    ccfg = _mode_cfg(dataclasses.replace(CaptionerConfig(), compute_dtype="bfloat16", max_new_tokens=CAP_TOKENS),
                     "int4")
    agent, out["secs"]["captioner build"] = sync_time(lambda: create_captioner(ccfg, dev, seed=SEED))
    image = _caption_image()

    def caption():
        return [int(t) for t in agent.generate([image], temperature=0.0)[0][0]]

    d_ref = reference("d one-process", caption)
    agent.shard(make_mesh((1, world), ("data", "model")))
    torch.cuda.empty_cache()
    d_got = split_run("d sharded", caption)
    out["tokens"] = d_got
    if lead:
        out["tokens_one"] = d_ref
    restore_timers()
    out["secs"]["rank total"] = time.perf_counter() - t_all
    return out


def phase_multi_device(steps: int, smi: str) -> dict:
    """[multi-device]: the JAX package's multi-chip inference drill on the
    port, one spawn of MD_RANKS ranks (two gloo ranks sharing card 0 on a
    one-card machine, NCCL with one rank per card on two or more) that runs
    every sub-phase at full XL-base width, bf16, random weights, `steps`
    steps: (a) `shard_for_inference` on a (1, 1, 2) mesh and a 1024^2
    batchify_sample, held to the one-process run (bit for bit where the
    gathered weights are exact); (b) `set_sequence_mesh` over the two ranks
    and one untiled 2048^2 network call, its 16384-token self-attention
    sites on ring attention with K3 blocks of [2, 8192, 10, 64], held to the
    one-process call on K1 at 5e-2, and ring_attention alone at
    [2, 16384, 10, 64] against the one-process K1 and attention_plain by row
    chunks at K1's 1e-2, a skipped rescale in the merge breaking it, fp32
    and requires-grad inputs refused; (c) the [tiled] configuration at
    2048^2 on a (1, 2, 1) tile mesh (16 VAE tiles, 9 windows: one padded
    duplicate of zero weight), held to the one-process tiled run at 5e-2;
    (d) LLaVA-13B int4 `shard`ed over 'model', 31 greedy tokens equal to the
    one-process tokens. Prints seconds, per-rank peaks, collectives' share
    and launches per rank. Returns rank 0's launches of its split runs."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from supir_tpu_torch.config import load_yaml_config

    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= MD_RANKS else "gloo"
    cfg, _ = load_yaml_config(TILED_OPT)
    lat = SIZE // cfg.vae.downscale_factor
    want = {"K1": expected_flash_launches(cfg, lat, steps, vae_passes=4),
            "K2": expected_group_norm_launches(cfg, steps, vae_passes=4)}
    _free()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_md_rank, args=(MD_RANKS, tmp, backend, steps), nprocs=MD_RANKS, join=True,
                           start_method="spawn")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(MD_RANKS)]
    return _md_report(ranks, backend, cards, time.perf_counter() - t0, want, smi)


def _md_report(ranks, backend: str, cards: int, total: float, want: dict, smi: str) -> dict:
    """[multi-device]'s lines and checks from the ranks' readings."""
    lead = ranks[0]
    where = (f"{MD_RANKS} gloo ranks sharing card 0" if backend == "gloo"
             else f"NCCL, {MD_RANKS} ranks on cards 0-{MD_RANKS - 1} of {cards}")
    log(f"[multi-device] {smi}: {where}; one spawn, {total:.1f} s with start-up (rank 0's body "
        f"{lead['secs']['rank total']:.1f} s); XL-base bf16, {lead['params_gib']:.2f} GiB of parameters")
    if backend == "gloo":
        log("[multi-device] parallel/mesh.py gathers by send/recv, which gloo takes on host tensors only: staged "
            "through pinned host memory, split over the mesh line's lanes (python -m "
            "supir_tpu_torch.tools.gloo_cuda_probe asks this PyTorch what gloo takes on CUDA tensors)")
    for label in ("a one-process", "b one-process", "c one-process", "d one-process"):
        log(f"[multi-device] {label} (rank 0 alone): {lead['secs'][label]:.3f} s, peak {lead['peak'][label]:.2f} GiB, "
            f"launches {lead['launches'][label]}")
    for label in ("a sharded", "b ring", "ring alone", "c tile axis", "d sharded"):
        log(f"[multi-device] {label}: " + "; ".join(
            f"rank {r} {rk['secs'][label]:.3f} s (collectives {rk['staging'][label]:.3f} s, "
            f"{rk['staging'][label] / rk['secs'][label]:.1%}), peak {rk['peak'][label]:.2f} GiB, launches "
            f"{rk['launches'][label]}" for r, rk in enumerate(ranks)))
    resident = ", ".join(f"{rk['resident_gib']:.2f}" for rk in ranks)
    log(f"[multi-device] (a) resident after sharding {resident} GiB "
        f"a rank; sharded restore equal to the one-process restore bit for bit: {lead['a_equal']} (rel-L2 "
        f"{lead['a_rel']:.3e}, max abs {lead['a_max_abs']:.3e}); K1/K2 a rank expected {want['K1']}/{want['K2']}")
    log(f"[multi-device] (b) ring sites {dict(lead['ring_sites'])}; network call rel-L2 against one-process K1 "
        f"{lead['b_rel']:.3e} (bound {MD_REL_BOUND:g}); ring alone {MD_RING_SHAPE}: rel-L2 vs attention_plain "
        f"{lead['ring_rel']['plain']:.3e}, vs one-process K1 {lead['ring_rel']['k1']:.3e} (K1 vs plain "
        f"{lead['ring_rel']['k1 vs plain']:.3e}; bound {K1_REL_BOUND:g}); planted fault (merge without the "
        f"rescale) {lead['ring_rel']['fault']:.3e}; fp32 input: {lead['ring_fp32'][:90]}; requires grad: "
        f"{lead['ring_grad'][:60]}")
    log(f"[multi-device] (c) {MD_TILED_SIDE}^2 tiled over the tile axis: rel-L2 against one-process "
        f"{lead['c_rel']:.3e} (bound {MD_REL_BOUND:g}), shape {lead['c_shape']}")
    log(f"[multi-device] (d) {len(lead['tokens'])} greedy tokens sharded, equal to one-process: "
        f"{all(rk['tokens'] == lead['tokens_one'] for rk in ranks)}")
    failures = []
    for r, rk in enumerate(ranks):
        la = rk["launches"]
        if (la["a sharded"]["K1"], la["a sharded"]["K2"]) != (want["K1"], want["K2"]):
            failures.append(f"rank {r} (a) launches {la['a sharded']}, expected K1/K2 {want}")
        sites = sum(rk["ring_sites"].values())
        if not sites or la["b ring"]["K3"] != MD_RANKS * sites or la["ring alone"]["K3"] != MD_RANKS:
            failures.append(f"rank {r} (b) K3 {la['b ring']['K3']} for {sites} ring sites, alone "
                            f"{la['ring alone']['K3']}")
        if not la["d sharded"]["K5"] or la["d sharded"]["K5"] != lead["launches"]["d one-process"]["K5"]:
            failures.append(f"rank {r} (d) K5 {la['d sharded']['K5']}, one-process "
                            f"{lead['launches']['d one-process']['K5']}")
        if rk["tokens"] != lead["tokens_one"] or len(rk["tokens"]) < CAP_TOKENS - 1:
            failures.append(f"rank {r} (d) tokens differ from the one-process tokens")
        if not (rk["a_finite"] and rk["c_finite"]) or rk["c_shape"] != (1, MD_TILED_SIDE, MD_TILED_SIDE, 3):
            failures.append(f"rank {r} outputs not finite or of the wrong shape")
    if not lead["a_rel"] <= MD_REL_BOUND:
        failures.append(f"(a) rel-L2 {lead['a_rel']}")
    if not lead["b_rel"] <= MD_REL_BOUND or not lead["c_rel"] <= MD_REL_BOUND:
        failures.append(f"(b) {lead['b_rel']}, (c) {lead['c_rel']} over {MD_REL_BOUND}")
    rr = lead["ring_rel"]
    if not (rr["plain"] <= K1_REL_BOUND and rr["k1"] <= K1_REL_BOUND and rr["fault"] > K1_REL_BOUND):
        failures.append(f"ring alone {rr}")
    if not (lead["ring_fp32"].startswith("TypeError") and lead["ring_grad"].startswith("RuntimeError")):
        failures.append(f"ring refusals: {lead['ring_fp32']}, {lead['ring_grad']}")
    if failures:
        raise AssertionError("[multi-device] " + "; ".join(failures))
    la = lead["launches"]
    return {"K1": la["a sharded"]["K1"] + la["b ring"]["K1"], "K2": la["a sharded"]["K2"],
            "K3": la["b ring"]["K3"], "K5": la["d sharded"]["K5"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4, help="RestoreEDM steps of the main path")
    ap.add_argument("--repeat", type=int, default=0,
                    help="timed main-path runs after the warm-up, each synchronised only at its end "
                         "(the headline is --steps 50 --repeat 3)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the GPU", file=sys.stderr)
        return 1
    smi = phase_device()
    phase_build()
    results = phase_kernels()
    results["K1-fp32"] = phase_flash_fp32_kernels()
    results.update(phase_quant_kernels())
    results.update(phase_flash_train_kernels())
    results.update(phase_alibi_kernels())
    probe_rows, probe_launches, ceiling = phase_probes()
    results.update(probe_rows)
    launches = phase_main(args.steps, args.repeat)
    launches.update(probe_launches)
    cli_launches = phase_cli(args.steps, smi)
    t0 = time.perf_counter()
    launches["K1-fp32"] = phase_fp32(args.steps, smi, cli_launches)
    phase_reference()
    phase_fp32_reference()
    log(f"[fp32] the two fp32 phases took {time.perf_counter() - t0:.1f} s with [reference]")
    tiled = phase_tiled(args.steps, smi)
    phase_tiled_reference()
    lightning = phase_lightning(smi)
    engine = _full_width_engine()
    samplers = phase_samplers(engine, smi)
    cache = phase_feature_cache(engine, smi)
    del engine
    _free()
    phase_samplers_reference()
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as apps_dir:
        for d in ("pred", "ref"):
            os.makedirs(os.path.join(apps_dir, d))
        engine, cfg = phase_web_demo(args.steps, smi, apps_dir)
        t1 = time.perf_counter()
        serve = phase_serve(engine, cfg, args.steps, smi)
        serve_s = time.perf_counter() - t1
        phase_face(engine, cfg, args.steps, smi, apps_dir)
        del engine
        _free()
        phase_eval(apps_dir, smi)
        t1 = time.perf_counter()
        phase_load_real(apps_dir, smi)
        phase_chat_weights(apps_dir)
        drill_s = time.perf_counter() - t1
    phase_apps_reference()
    log(f"[apps] the app phases took {time.perf_counter() - t0:.1f} s ([serve]'s restoration side {serve_s:.1f} s, "
        f"[load_real] and [chat] --weights {drill_s:.1f} s)")
    log(f"[launches] K1 and K2 on the other restore paths: tiled {tiled}, lightning {lightning}, samplers "
        f"{samplers}, feature cache {cache}")
    image = _caption_image()
    # each captioner kernel takes the launches of the mode whose path it serves
    # (K5's act_int8 mode, K10 and K11 their W4A8 and native modes, K9 the
    # lean one, K7's half-split instance the half-split one): row -> (mode, counter)
    counted_in = {"K5": ("int4", "K5"), "K6": ("int4-unfused", "K6"), "K7": ("int8", "K7"), "K8": ("int8", "K8"),
                  "K9": ("int4-lean", "K9"), "K5-act": ("int4-w4a8", "K5-act"), "K10": ("int4-w4a8-unfused", "K10"),
                  "K11": ("int4-native", "K11"), "K7-int4": ("int4-half", "K7")}
    def serve_and_eval(agent):
        t = time.perf_counter()
        serve["K5"] = phase_serve_caption(agent, image, smi)
        phase_captioner_eval(agent, smi)
        log(f"[serve] [captioner eval] the caption side of serving and the eval took {time.perf_counter() - t:.1f} s")

    for label in CAPTION_MODES:
        counted = phase_captioner(label, image, chat=label == "int4-lean",
                                  then=serve_and_eval if label == "int4" else None)
        launches.update({row: counted[k] for row, (mode, k) in counted_in.items() if mode == label})
    log(f"[launches] serving: K1 {serve['K1']} and K2 {serve['K2']} a 1024^2 restoration request, K5 {serve['K5']} "
        f"a caption request")
    phase_captioner_reference(image)
    # K1 and K2 keep the restore path's counts; K3 and K4 run on the trainer's
    train = phase_train()
    launches.update({k: train[k] for k in ("K3", "K4")})
    phase_train_reference()
    # the generate path's prefill (K3 ALiBi without lse) asserts its launches
    # in its phase; the K3 ALiBi row is the instantiation with lse, timed at
    # the gradient's shape, so it takes the gradient path's launches
    phase_mpt_generate()
    grad = phase_mpt_grad()
    launches.update({"K3-alibi": grad["K3-alibi lse"], "K4-alibi": grad["K4-alibi"]})
    phase_mpt_reference()
    # the rest of training: K3 and K4 causal on the captioner trainer's step,
    # K2 in the AE trainer's no-grad reconstruction, added to their rows
    t0 = time.perf_counter()
    captrain = phase_captioner_train(smi)
    phase_captioner_train_reference()
    ae_k2 = phase_ae_train(smi)
    phase_ae_train_reference()
    launches.update({"K3": launches["K3"] + captrain["K3"], "K4": launches["K4"] + captrain["K4"],
                     "K2": launches["K2"] + ae_k2})
    log(f"[train] [captioner train], [ae train] and their references took {time.perf_counter() - t0:.1f} s")
    multi = phase_multi_device(args.steps, smi)
    launches.update({k: launches[k] + n for k, n in multi.items()})

    sources = {
        "K1": ("cuda", "supir_tpu_torch/csrc/flash_attn_fwd.cu", "supir_tpu/ops/flash_attention.py:35"),
        "K1-fp32": ("cuda", "supir_tpu_torch/csrc/flash_attn_fwd_fp32.cu", "supir_tpu/ops/flash_attention.py:35"),
        "K2": ("cuda", "supir_tpu_torch/csrc/group_norm.cu", "supir_tpu/ops/groupnorm.py:40"),
        "K3": ("cuda", "supir_tpu_torch/csrc/flash_attn_fwd.cu", "supir_tpu/ops/flash_attention.py:164"),
        "K4": ("cuda", "supir_tpu_torch/csrc/flash_attn_bwd.cu", "supir_tpu/ops/flash_attention.py:499"),
        "K5": ("cuda", "supir_tpu_torch/csrc/quant_gemv_tc.cu", "supir_tpu/ops/quantize.py:260"),
        "K6": ("cuda", "supir_tpu_torch/csrc/quant_gemv_tc.cu", "supir_tpu/ops/quantize.py:116"),
        "K7": ("cuda", "supir_tpu_torch/csrc/quant_gemv_tc.cu", "supir_tpu/ops/quantize.py:606"),
        "K7-int4": ("cuda", "supir_tpu_torch/csrc/quant_gemv_tc.cu", "supir_tpu/ops/quantize.py:606"),
        "K8": ("cuda", "supir_tpu_torch/csrc/quantize_int8.cu", "supir_tpu/ops/quantize.py:21"),
        "K5-act": ("cuda", "supir_tpu_torch/csrc/quant_gemv_tc.cu", "supir_tpu/ops/quantize.py:291"),
        "K9": ("cuda", "supir_tpu_torch/csrc/quant_gemv_tc.cu", "supir_tpu/ops/quantize.py:398"),
        "K10": ("cuda", "supir_tpu_torch/csrc/quant_gemv_tc.cu", "supir_tpu/ops/quantize.py:191"),
        "K11": ("cuda", "supir_tpu_torch/csrc/quant_gemv_tc.cu", "supir_tpu/ops/quantize.py:555"),
        "K3-alibi": ("cuda", "supir_tpu_torch/csrc/flash_attn_fwd.cu", "supir_tpu/ops/flash_attention.py:197"),
        "K4-alibi": ("cuda", "supir_tpu_torch/csrc/flash_attn_bwd.cu", "supir_tpu/ops/flash_attention.py:481"),
        "T1a": ("cuda", "supir_tpu_torch/csrc/colsum_tc.cu", "tools/stream_ceiling.py:48"),
        "T1b": ("cuda", "supir_tpu_torch/csrc/colsum_tc.cu", "tools/stream_ceiling.py:99"),
        "T1c": ("cuda", "supir_tpu_torch/csrc/quant_gemv_tc.cu", "tools/stream_ceiling.py:162"),
        "T2": ("cuda", "supir_tpu_torch/csrc/quant_gemv_tc.cu", "tools/gemv_sweep.py:48"),
        "T3a": ("cuda", "supir_tpu_torch/csrc/nibble_order.cu", "tools/bitcast_probe.py:33"),
        "T3b": ("cuda", "supir_tpu_torch/csrc/quant_gemv_tc.cu", "tools/bitcast_probe.py:63"),
        "T4a": ("cuda", "supir_tpu_torch/csrc/nibble_order.cu", "tools/int4_native_probe.py:46"),
        "T4b": ("cuda", "supir_tpu_torch/csrc/quant_gemv_tc.cu", "tools/int4_native_probe.py:58"),
    }
    # where each kernel's times were taken
    at = {"K1": "[2,4096,10,64] bf16", "K1-fp32": "[2,4096,10,64] fp32", "K2": "[2,320,128,128] bf16, SiLU",
          "K3": "[1,4096,10,64] bf16, with lse", "K4": "[1,4096,10,64] bf16, dq dk dv",
          "K5": "one 13B layer (qkv, o, gate-up, down), 1 row", "K6": "one 13B layer, 1 row",
          "K7": "one 13B layer, int8, 1 row", "K7-int4": "one 13B layer, half-split int4, 1 row", "K8": "one 13B layer's four fp32 kernels",
          "K5-act": "one 13B layer, act_int8, 1 row", "K9": "one 13B layer's two pairs, 1 row",
          "K10": "one 13B layer, 1 row, the kernel alone on int8 x", "K11": "one 13B layer, 1 row",
          "K3-alibi": "[1,2048,32,128] bf16 causal, with lse (the MPT-7B gradient's forward)",
          "K4-alibi": "[1,2048,32,128] bf16 causal, dq dk dv",
          "T1a": "u8 [2560,15360], 1 k-slice", "T1b": "u8 [2560,15360], 2 k-slices",
          "T1c": "K7 int4 [8,5120]x[2560,15360], the plan's k-slices", "T2": "W4A8 qkv, 1 row, the plan's k-slices",
          "T3a": "u8 [2,128], all 256 bytes, the paired decode (nib2)",
          "T3b": "qkv [8,5120]x[2560,15360], the plan's k-slices",
          "T4a": "int4 [128,128], every value -8..7, through nib2",
          "T4b": "down [1,13824]x[13824,5120], the plan's k-slices"}
    kernels = []
    for name, (route, source, replaces) in sources.items():
        r = results[name]
        kernels.append({
            "name": {"K5-act": "K5 act_int8", "K7-int4": "K7 int4", "K3-alibi": "K3 ALiBi",
                     "K4-alibi": "K4 ALiBi", "K1-fp32": "K1 fp32"}.get(name, name),
            "route": route, "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"), "at": at[name],
        })
        if not launches[name] > 0:
            raise AssertionError(f"{name} was never launched on its path")
    # each bytes-bound row's read rate (its bound's bytes over its time) as a
    # share of the streaming ceiling that [probes] measured in this run
    for k in kernels:
        if k["bound_by"] == "bytes":
            rate = k["bound_ms"] / k["ms"] * HBM_BYTES_PER_S / 1e9
            log(f"[ceiling] {k['name']} ({k['at']}): {rate:.1f} GB/s, {rate / ceiling['gb_per_s']:.1%} of the "
                f"measured {ceiling['gb_per_s']:.1f} GB/s, {rate * 1e9 / HBM_BYTES_PER_S:.1%} of 3.35 TB/s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
