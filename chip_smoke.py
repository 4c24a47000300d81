#!/usr/bin/env python3
"""Smoke run of supir_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py [--steps 4] [--repeat 0]
    python3 chip_smoke.py --steps 50 --repeat 3    # the 50-step headline

Phases, each printing its own lines:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions; TF32 is switched off for matmuls and cuDNN convolutions.
  2. build: K1 (CUDA C++, nvcc into build/supir_tpu_torch/) and K2 (Triton).
  3. kernels against their plain PyTorch versions, bf16 on the card, at
     the main path's shapes, with CUDA-event times of both. K1 is held to
     its fp32 plain version by a relative bound, and two planted faults
     (an unmasked ragged tile, exp2 without the log2(e) fold) must break it.
  4. main path: a full-width SDXL/SUPIR engine (XL-base, bf16, random
     weights from a seeded CUDA generator) restores one image through
     SUPIREngine.batchify_sample with bench.py's headline settings: a
     warm-up run, `--repeat` timed runs synchronised only at their end,
     then one run timed per stage. The launch counters are zeroed just
     before that last run and must show K1 at every eligible attention
     site of every step and K2 at work.
  5. reference: a reduced-width engine whose self-attention still reaches
     K1 runs the same path on the card (bf16, kernels) and on the CPU
     (fp32, plain versions) with the same weights and noise; the two
     images must agree, and two planted faults (K2 without its SiLU, K1
     with exp2 without the log2(e) fold) must break the bound.
Then one JSON line with each kernel's numbers, the card line, and last
`{"ok": true, "device": {...}}`. There is no fallback: without a CUDA
device, or outside a checkout of the repository, it exits non-zero before
printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time


SIZE = 1024  # image side of the main path, as bench.py's headline
SEED = 0
K1_REL_BOUND = 1e-2   # K1 against its fp32 plain version, relative L2
REF_REL_BOUND = 5e-2  # reduced-width card (bf16, kernels) against CPU (fp32, plain), relative L2


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


def expected_flash_sites(cfg, lat: int) -> int:
    """K1 sites per network call, derived from the config: every
    SpatialTransformer self-attention (UNet encoder, UNet decoder, GLVControl
    encoder, both middles) and every ZeroCrossAttn whose sequences hold at
    least 1024 tokens with 64- or 128-wide heads."""
    from supir_tpu_torch.ops.attention import flash_eligible

    u = cfg.unet
    n = 0
    for level in range(u.levels):
        ds = 2**level
        tokens = (lat // ds) ** 2
        if ds in u.attention_resolutions and flash_eligible(tokens, tokens, u.num_head_channels):
            n += 2 * u.num_res_blocks * u.transformer_depth[level]   # UNet + control encoders
            n += (u.num_res_blocks + 1) * u.transformer_depth[level]  # UNet decoder
        if level > 0 and flash_eligible(tokens, tokens, 64):
            n += 1  # ZeroCrossAttn before this level's upsample, 64-wide heads
    mid = (lat // 2 ** (u.levels - 1)) ** 2
    if (2 ** (u.levels - 1)) in u.attention_resolutions and flash_eligible(mid, mid, u.num_head_channels):
        n += 2 * u.middle_depth
    return n


def expected_flash_launches(cfg, lat: int, steps: int, vae_passes: int) -> int:
    """K1 launches of `steps` network calls and `vae_passes` VAE passes: the
    VAE's mid-block attention is one head as wide as its last level, which
    reaches K1 only where that width is 64 or 128 (at reduced width, not at
    full width's 512)."""
    from supir_tpu_torch.ops.attention import flash_eligible

    vae_head = cfg.vae.ch * cfg.vae.ch_mult[-1]
    vae = vae_passes if flash_eligible(lat * lat, lat * lat, vae_head) else 0
    return expected_flash_sites(cfg, lat) * steps + vae


def rel_l2(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


@contextlib.contextmanager
def kernels_at_sites(k1, k2):
    """Route every K1 site through `k1` and every GroupNorm site through `k2`.
    Each K1 call's output is held to the plain version in fp32 on its own
    inputs; the relative L2 errors land in the list this yields."""
    from supir_tpu_torch.models import layers
    from supir_tpu_torch.ops import attention as attn_ops
    from supir_tpu_torch.ops.flash_attention import attention_plain

    rels = []

    def watched(q, k, v):
        out = k1(q, k, v)
        rels.append(rel_l2(out, attention_plain(q.float(), k.float(), v.float())))
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


def phase_build():
    from supir_tpu_torch.ops import flash_attention as k1, groupnorm as k2

    t0 = time.perf_counter()
    k1.build()
    t1 = time.perf_counter()
    k2.build()
    t2 = time.perf_counter()
    log(f"[build] K1 nvcc {t1 - t0:.1f} s; K2 triton import {t2 - t1:.1f} s "
        "(Triton compiles each specialisation at its first launch)")


def phase_kernels():
    import torch
    import torch.nn.functional as F

    from supir_tpu_torch.ops.flash_attention import attention_plain, flash_attention
    from supir_tpu_torch.ops.groupnorm import group_norm, group_norm_plain

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
        log(f"[kernels] K1 [{b},{s},{h},{d}] bf16 vs fp32 plain: rel_l2 {rel:.3e} (bound {K1_REL_BOUND:g}), "
            f"max_abs_err {err:.3e} (bound 2e-2), max|ref| {want.abs().max().item():.3f}; "
            f"{ms:.3f} ms vs plain {plain_ms:.3f} ms, first call {first:.2f} s")
        if not (rel <= K1_REL_BOUND and err <= 2e-2):
            raise AssertionError(f"K1 disagrees with its plain version at [{b},{s},{h},{d}]: rel {rel}, max {err}")
        k1.append((err, ms, plain_ms))
        if s % 64:
            # planted faults the bound must catch: the kernel run on k/v
            # zero-padded to its 64-key tile is what a kernel that stops
            # masking keys past T computes; q scaled by ln 2 is exp2 without
            # the log2(e) fold
            pad = (0, 0, 0, 0, 0, 64 - s % 64)
            controls = {
                "unmasked ragged tile": flash_attention(q, F.pad(k, pad), F.pad(v, pad)),
                "exp2 without log2(e)": flash_attention((q.float() * math.log(2)).to(q.dtype), k, v),
            }
            for name, bad in controls.items():
                bad_rel = rel_l2(bad, want)
                log(f"[kernels] K1 control ({name}) [{b},{s},{h},{d}]: rel_l2 {bad_rel:.3e}, "
                    f"max_abs_err {(bad.float() - want).abs().max().item():.3e}")
                if not bad_rel > K1_REL_BOUND:
                    raise AssertionError(f"K1's bound misses a planted fault ({name}): rel {bad_rel}")
    results["K1"] = k1

    k2 = []
    for shape, eps, silu in (((2, 320, 128, 128), 1e-5, True),
                             ((1, 128, 1024, 1024), 1e-6, True),
                             ((2, 1280, 32, 32), 1e-5, False)):
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        w = 1.0 + 0.1 * torch.randn(shape[1], generator=g, device=dev)
        bias = 0.1 * torch.randn(shape[1], generator=g, device=dev)
        t0 = time.perf_counter()
        out = group_norm(x, w, bias, 32, eps, silu)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        # the plain version on the same values in fp32 is the reference: the
        # bound then covers the kernel's single bf16 rounding of its output
        err = (out.float() - group_norm_plain(x.float(), w, bias, 32, eps, silu)).abs().max().item()
        ms = cuda_ms(lambda: group_norm(x, w, bias, 32, eps, silu), 20)
        plain_ms = cuda_ms(lambda: group_norm_plain(x, w, bias, 32, eps, silu), 20)
        log(f"[kernels] K2 {list(shape)} eps {eps:g} silu {silu}: max_abs_err {err:.3e} (bound 3e-2), "
            f"{ms:.3f} ms vs plain {plain_ms:.3f} ms, first call {first:.2f} s")
        if not err <= 3e-2:
            raise AssertionError(f"K2 disagrees with its plain version at {list(shape)}: {err}")
        k2.append((err, ms, plain_ms))
    results["K2"] = k2
    return results


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

    # warm-up (Triton specialisations, cuDNN algorithm choice), which also
    # holds K1 at every site to the fp32 plain version on that site's inputs
    t0 = time.perf_counter()
    with kernels_at_sites(flash_attention, group_norm) as site_rel:
        run()
    torch.cuda.synchronize()
    log(f"[main] warm-up run {time.perf_counter() - t0:.2f} s; K1 at its {len(site_rel)} site calls vs "
        f"fp32 plain: worst rel_l2 {max(site_rel):.3e} (bound {K1_REL_BOUND:g})")
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
    log(f"[main] launches: K1 {launches['K1']} (expected {expected_flash_sites(cfg, lat)} sites x "
        f"{steps} steps + {want_k1 - expected_flash_sites(cfg, lat) * steps} VAE = {want_k1}), "
        f"K2 {launches['K2']}")
    if launches["K1"] != want_k1:
        raise AssertionError(f"K1 launched {launches['K1']} times, expected {want_k1}")
    if launches["K2"] <= 0:
        raise AssertionError("K2 was never launched on the main path")
    del engine, out
    torch.cuda.empty_cache()
    return launches


def _randomize_all(model, seed: int):
    """Fill every parameter, zero-initialised layers included, so that the
    whole network reaches the output."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() > 1:
                p.copy_(torch.randn(p.shape, generator=g) * p[0].numel() ** -0.5)
            elif name.endswith("weight"):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))


def phase_reference():
    import torch

    from supir_tpu_torch.config import ControlConfig, SUPIRConfig, UNetConfig, VAEConfig
    from supir_tpu_torch.engine.factory import build_model, create_engine
    from supir_tpu_torch.engine.supir import SUPIREngine
    from supir_tpu_torch.ops.flash_attention import flash_attention
    from supir_tpu_torch.ops.groupnorm import group_norm

    unet = dataclasses.replace(UNetConfig(), model_channels=128, transformer_depth=(1, 1, 1),
                               context_dim=256, adm_in_channels=256)
    cfg = SUPIRConfig(unet=unet, vae=VAEConfig().tiny(), control=ControlConfig().scaled_for(unet))
    size = 512
    cpu_cfg = dataclasses.replace(cfg, ae_dtype="fp32", diffusion_dtype="fp32")
    cpu_model = build_model(cpu_cfg, "cpu", seed=SEED)
    _randomize_all(cpu_model, SEED)
    cpu_engine = SUPIREngine(cpu_cfg, cpu_model)
    gpu_engine = create_engine(cfg, "cuda", state_dict=cpu_model.state_dict())

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
    bad, bad_site = card(k1=lambda q, k, v: flash_attention((q.float() * math.log(2)).to(q.dtype), k, v))
    log(f"[reference] control (K1 exp2 without log2(e)): rel_l2 {rel_l2(bad, want):.4f}, "
        f"worst site rel_l2 {bad_site:.3e}")
    if not bad_site > K1_REL_BOUND:
        raise AssertionError(f"the K1 site bound misses exp2 without log2(e): rel_l2 {bad_site}")


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
    kernel_results = phase_kernels()
    launches = phase_main(args.steps, args.repeat)
    phase_reference()

    sources = {
        "K1": ("cuda", "supir_tpu_torch/csrc/flash_attn_fwd.cu",
               "supir_tpu/ops/flash_attention.py:35"),
        "K2": ("triton", "supir_tpu_torch/ops/groupnorm.py",
               "supir_tpu/ops/groupnorm.py:40"),
    }
    kernels = []
    for name, rows in kernel_results.items():
        route, source, replaces = sources[name]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r[0] for r in rows),
            "ms": rows[0][1], "plain_ms": rows[0][2],  # at the first (largest main-path) shape
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
