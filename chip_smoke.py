#!/usr/bin/env python3
"""Smoke run of supir_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py [--steps 4] [--repeat 0]
    python3 chip_smoke.py --steps 50 --repeat 3    # the 50-step headline

Phases, each printing its own lines:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions; TF32 is switched off for matmuls and cuDNN convolutions.
  2. build: the CUDA C++ kernels (K1, K5-K7, K8; one nvcc per source, all
     at once, into build/supir_tpu_torch/) with ptxas' registers and spills,
     and K2 (Triton).
  3. kernels against their plain PyTorch versions on the card, with
     CUDA-event times of both, the least time the card could take (bound)
     and, where one PyTorch call computes the same function, its time:
     K1 and K2 at the restore path's shapes, K1 causal, and K5, K6, K7 and
     K8 at the 13B captioner's decode shapes for 1 and 8 rows. Each is held
     to a stated bound, and planted faults must break it.
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
  6. captioner: LLaVA-1.5-13B at full width (CLIP ViT-L/14-336, Llama-13B,
     random weights drawn and quantized layer by layer on the card) captions
     a 1024^2 image through CaptionerAgent.gen_image_caption, greedy, in
     three weight modes: int4 (K5), int4 without fused glue (K6) and int8
     (K8 at load, K7 in decode). The counters are zeroed before each mode's
     load and read after its caption; every GEMV call of one decode step is
     then held to its fp32 plain version on that call's inputs, and
     torch.profiler reads three decode steps (device busy share, kernels).
  7. captioner reference: a reduced-width captioner on the card (bf16,
     kernels) and on the CPU (fp32, plain versions) with the same weights:
     prefill logits and the logits of decode steps teacher-forced on the
     CPU's tokens must agree; a planted fault (nibble order swapped) must
     break the bound.
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
GEMV_REL_BOUND = 1e-2  # K5-K7 against their fp32 plain versions, relative L2
CAP_REF_REL_BOUND = 5e-2  # reduced-width captioner logits, card against CPU, relative L2
CAP_TOKENS = 32       # max_new_tokens of the full-width caption
REF_STEPS = 8         # teacher-forced decode steps of the captioner reference
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOP_PER_S = 989e12   # H100 SXM dense bf16 tensor cores
# the 13B decode projections per layer: name, cin, cout, prologue, residual
LLAMA_13B_SHAPES = (("qkv", 5120, 15360, "norm", False), ("o", 5120, 5120, None, True),
                    ("gateup", 5120, 27648, "norm", False), ("down", 13824, 5120, "siluglu", True))


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
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * len(fns))


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(bytes_moved: float, flops: float = 0.0):
    """(ms, "bytes" | "operations"): the least time the card could take, the
    larger of the bytes over the memory rate and the bf16 operations over
    the tensor cores' dense peak."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
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

    def watched(q, k, v, causal=False):
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
    import re

    regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
    stores = [int(r) for r in re.findall(r"(\d+) bytes spill stores", report)]
    loads = [int(r) for r in re.findall(r"(\d+) bytes spill loads", report)]
    if not regs:
        return "no ptxas report (library built earlier)"
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, spill stores max {max(stores, default=0)} B, "
            f"spill loads max {max(loads, default=0)} B")


def phase_build():
    from supir_tpu_torch.ops import cuda_build, groupnorm as k2
    from supir_tpu_torch.ops import flash_attention as k1, quantize as kq

    sources = k1.SOURCES + kq.SOURCES
    t0 = time.perf_counter()
    seconds = cuda_build.build_all(sources)
    wall = time.perf_counter() - t0
    for source in sources:
        log(f"[build] {source}: nvcc {seconds[source]:.1f} s; ptxas: {_ptxas_summary(cuda_build.ptxas_report(source))}")
    t1 = time.perf_counter()
    k2.build()
    log(f"[build] nvcc wall {wall:.1f} s for {len(sources)} sources in parallel; K2 triton import "
        f"{time.perf_counter() - t1:.1f} s (Triton compiles each specialisation at its first launch)")


def _check_rel(label: str, rel: float, bound_: float):
    if not rel <= bound_:
        raise AssertionError(f"{label}: rel_l2 {rel:.3e} over its bound {bound_:g}")


def _check_fault(label: str, rel: float, bound_: float):
    log(f"[kernels] control ({label}): rel_l2 {rel:.3e}")
    if not rel > bound_:
        raise AssertionError(f"the bound {bound_:g} misses a planted fault ({label}): rel_l2 {rel:.3e}")


def phase_kernels():
    """K1 and K2 at the restore path's shapes, K1 causal; returns each
    kernel's JSON numbers (times at the first shape)."""
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
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 20)
        bound_ms, bound_by = bound(nbytes(q, k, v, out), 4 * b * h * s * s * d)
        log(f"[kernels] K1 [{b},{s},{h},{d}] bf16 vs fp32 plain: rel_l2 {rel:.3e} (bound {K1_REL_BOUND:g}), "
            f"max_abs_err {err:.3e} (bound 2e-2), max|ref| {want.abs().max().item():.3f}; "
            f"{ms:.3f} ms vs plain {plain_ms:.3f} ms, SDPA {lib_ms:.3f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}); first call {first:.2f} s")
        if not (rel <= K1_REL_BOUND and err <= 2e-2):
            raise AssertionError(f"K1 disagrees with its plain version at [{b},{s},{h},{d}]: rel {rel}, max {err}")
        k1.append(dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                       bound_by=bound_by))
        if s % 64:
            # planted faults the bound must catch: the kernel run on k/v
            # zero-padded to its 64-key tile is what a kernel that stops
            # masking keys past T computes; q scaled by ln 2 is exp2 without
            # the log2(e) fold
            pad = (0, 0, 0, 0, 0, 64 - s % 64)
            _check_fault(f"K1 unmasked ragged tile [{b},{s},{h},{d}]",
                         rel_l2(flash_attention(q, F.pad(k, pad), F.pad(v, pad)), want), K1_REL_BOUND)
            _check_fault(f"K1 exp2 without log2(e) [{b},{s},{h},{d}]",
                         rel_l2(flash_attention((q.float() * math.log(2)).to(q.dtype), k, v), want), K1_REL_BOUND)

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
        log(f"[kernels] K1 causal [{b},{s},{h},{d}] bf16 vs fp32 plain causal: rel_l2 {rel:.3e} "
            f"(bound {K1_REL_BOUND:g}), max_abs_err {(out.float() - want).abs().max().item():.3e}; "
            f"{ms:.3f} ms vs plain {plain_ms:.3f} ms, SDPA causal {lib_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        _check_rel(f"K1 causal [{b},{s},{h},{d}]", rel, K1_REL_BOUND)
        _check_fault(f"K1 causal mask removed [{b},{s},{h},{d}]", rel_l2(flash_attention(q, k, v), want),
                     K1_REL_BOUND)
    results["K1"] = dict(k1[0], max_abs_err=max(r["max_abs_err"] for r in k1))

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
        wb, bb = w.to(x.dtype), bias.to(x.dtype)
        if silu:
            lib_ms = cuda_ms(lambda: F.silu(F.group_norm(x, 32, wb, bb, eps)), 20)
        else:
            lib_ms = cuda_ms(lambda: F.group_norm(x, 32, wb, bb, eps), 20)
        bound_ms, bound_by = bound(nbytes(x, w, bias, out))
        log(f"[kernels] K2 {list(shape)} eps {eps:g} silu {silu}: max_abs_err {err:.3e} (bound 3e-2), "
            f"{ms:.3f} ms vs plain {plain_ms:.3f} ms, F.group_norm{'+F.silu' if silu else ''} {lib_ms:.3f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}); first call {first:.2f} s")
        if not err <= 3e-2:
            raise AssertionError(f"K2 disagrees with its plain version at {list(shape)}: {err}")
        k2.append(dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                       bound_by=bound_by))
    results["K2"] = dict(k2[0], max_abs_err=max(r["max_abs_err"] for r in k2))
    return results


def _swap_nibbles(packed):
    """Planted fault: the low and high nibbles of every byte exchanged (the
    paired layout's row order, the half-split layout's two halves)."""
    return ((packed >> 4) | (packed << 4)).contiguous()


L2_BYTES = 50 * 2**20  # H100 L2 cache


def _gemv_row(label, kernel, plain, x, weights, out_bytes, faults=()):
    """Hold one GEMV kernel call, kernel(x, *weights), to its plain version
    in fp32 on the same inputs, and time both as the decode meets them:
    device time from a CUDA graph (graph_ms) over copies of the weights
    that together exceed the L2 cache, so each call streams its weights
    from device memory. Each planted fault (label, call of x) must break
    the bound. Returns the row's numbers."""
    import torch

    out = kernel(x, *weights)
    want = plain(x.float(), *weights)
    rel, err = rel_l2(out, want), (out - want).abs().max().item()
    w_bytes = nbytes(*weights)
    copies = [weights] + [tuple(t.clone() for t in weights) for _ in range(int(2 * L2_BYTES // w_bytes))]
    ms = graph_ms([lambda c=c: kernel(x, *c) for c in copies for _ in range(2)])
    plain_ms = graph_ms([lambda c=c: plain(x, *c) for c in copies[:4]], replays=2)
    bound_ms, bound_by = bound(nbytes(x) + w_bytes + out_bytes)
    log(f"[kernels] {label}: rel_l2 {rel:.3e} (bound {GEMV_REL_BOUND:g}), max_abs_err {err:.3e}, "
        f"max|ref| {want.abs().max().item():.2f}; {ms:.4f} ms vs plain {plain_ms:.4f} ms (device, CUDA graph, "
        f"{len(copies)} weight copies), bound {bound_ms:.4f} ms ({bound_by}, {bound_ms / ms:.0%} of it)")
    _check_rel(label, rel, GEMV_REL_BOUND)
    for name, bad in faults:
        _check_fault(f"{label} {name}", rel_l2(bad(x), want), GEMV_REL_BOUND)
    del copies
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, rel=rel, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def _check_int8_quantizer(label, w, seeds: int = 64):
    """K8 at one shape: nearest mode bit for bit with the plain version; in
    stochastic mode every value on floor or ceil of w / scale, the same seed
    the same bytes, and the mean of q over `seeds` seeds within 7 sigma of
    w / scale everywhere (one draw's rounding error has variance <= 1/4)."""
    import torch

    from supir_tpu_torch.ops import quantize as Q

    q, s = Q.quantize_int8(w, stochastic=False)
    want_q, want_s = Q.quantize_int8_plain(w)
    mismatched = (q != want_q).sum().item() + (s != want_s).sum().item()
    scaled = w / s
    a = Q.quantize_int8(w, seed=11)[0]
    same_seed = torch.equal(a, Q.quantize_int8(w, seed=11)[0])
    off_grid = (~((a.float() == scaled.floor()) | (a.float() == scaled.ceil()))).sum().item()
    total = torch.zeros_like(w)
    for seed in range(seeds):
        total += Q.quantize_int8(w, seed=seed)[0].float()
    dev_ = total / seeds - scaled
    sigma = 0.5 / seeds ** 0.5
    worst, bias_ = dev_.abs().max().item(), dev_.mean().item()
    u = torch.rand(w.shape, generator=torch.Generator(device=w.device).manual_seed(0), device=w.device)
    ms = cuda_ms(lambda: Q.quantize_int8(w, seed=1), 10)
    plain_ms = cuda_ms(lambda: Q.quantize_int8_plain(w, u), 5)
    bound_ms, bound_by = bound(nbytes(w, q, s))
    log(f"[kernels] {label}: nearest mode {mismatched} values differ from plain (bound 0); stochastic: "
        f"{off_grid} off floor/ceil, same seed same bytes {same_seed}, mean over {seeds} seeds: worst "
        f"|mean - w/scale| {worst:.4f} (bound 7 sigma = {7 * sigma:.4f}), mean deviation {bias_:.2e}; "
        f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    if mismatched or off_grid or not same_seed or not worst <= 7 * sigma:
        raise AssertionError(f"{label} fails its checks")
    return dict(max_abs_err=float(mismatched), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)


def phase_quant_kernels():
    """K5, K6, K7 (int8 and half-split int4) and K8 at the 13B decode shapes,
    for 1 and 8 rows; returns each kernel's JSON numbers, its times summed
    over one layer's four projections at 1 row (the main path's)."""
    import gc

    import torch

    from supir_tpu_torch.ops import quantize as Q

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)
    names = ("K5", "K6", "K7", "K7-int4", "K8")
    layer = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_by="bytes") for k in names}

    def add(name, row):
        acc = layer[name]
        acc["max_abs_err"] = max(acc["max_abs_err"], row["max_abs_err"])
        for key in ("ms", "plain_ms", "bound_ms"):
            acc[key] += row[key]

    for proj, cin, cout, prologue, with_residual in LLAMA_13B_SHAPES:
        w = torch.randn(cin, cout, generator=g, device=dev) * cin ** -0.5
        packed, scale = Q.quantize_int4_paired(w)
        q4, s4 = Q.quantize_int4(w)
        add("K8", _check_int8_quantizer(f"K8 {proj} [{cin},{cout}] fp32", w))
        q8, s8 = Q.quantize_int8(w, seed=SEED)
        del w
        for rows in (1, 8):
            xin = 2 * cin if prologue == "siluglu" else cin
            x = torch.randn(rows, xin, generator=g, device=dev).to(torch.bfloat16)
            xg = x[:, :cin].contiguous()
            gamma = 1.0 + 0.1 * torch.randn(cin, generator=g, device=dev) if prologue == "norm" else None
            residual = torch.randn(rows, cout, generator=g, device=dev) if with_residual else None
            kw = dict(gamma=gamma, siluglu=prologue == "siluglu", residual=residual)
            out_bytes = rows * cout * 4
            tag = f"{proj} [{rows},{cin}]->[{rows},{cout}]"
            faults = [("nibble order swapped", lambda xx: Q.int4_paired_fused_matmul(
                xx, _swap_nibbles(packed), scale, **kw))]
            if gamma is not None:
                faults.append(("RMSNorm without gamma", lambda xx: Q.int4_paired_fused_matmul(
                    xx, packed, scale, **dict(kw, gamma=torch.ones_like(gamma)))))
            extra = nbytes(gamma, residual)
            row = _gemv_row(f"K5 {tag} prologue {prologue} residual {with_residual}",
                            lambda xx, p, sc: Q.int4_paired_fused_matmul(xx, p, sc, **kw),
                            lambda xx, p, sc: Q.int4_paired_fused_matmul_plain(xx, p, sc, **kw), x,
                            (packed, scale), out_bytes + extra, faults)
            if rows == 1:
                add("K5", row)
            row = _gemv_row(f"K6 {tag}", Q.int4_paired_matmul, Q.int4_paired_matmul_plain, xg, (packed, scale),
                            out_bytes,
                            [("nibble order swapped", lambda xx: Q.int4_paired_matmul(xx, _swap_nibbles(packed), scale))])
            if rows == 1:
                add("K6", row)
            row = _gemv_row(f"K7 int8 {tag}", Q.int8_matmul, lambda xx, q, sc: Q.qmm_plain(xx, q, sc, 8), xg,
                            (q8, s8), out_bytes)
            if rows == 1:
                add("K7", row)
            row = _gemv_row(f"K7 int4 half-split {tag}", Q.int4_matmul, lambda xx, q, sc: Q.qmm_plain(xx, q, sc, 4),
                            xg, (q4, s4), out_bytes,
                            [("halves swapped", lambda xx: Q.int4_matmul(xx, _swap_nibbles(q4), s4))])
            if rows == 1:
                add("K7-int4", row)
        del packed, q4, q8
    gc.collect()  # the fault closures hold weights in reference cycles
    torch.cuda.empty_cache()
    for name in names:
        r = layer[name]
        log(f"[kernels] {name} over one 13B layer's four projections (1 row): {r['ms']:.4f} ms vs plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); x40 layers: "
            f"{40 * r['ms']:.3f} ms, bound {40 * r['bound_ms']:.3f} ms")
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
    bad, bad_site = card(k1=lambda q, k, v, causal=False: flash_attention(
        (q.float() * math.log(2)).to(q.dtype), k, v, causal=causal))
    log(f"[reference] control (K1 exp2 without log2(e)): rel_l2 {rel_l2(bad, want):.4f}, "
        f"worst site rel_l2 {bad_site:.3e}")
    if not bad_site > K1_REL_BOUND:
        raise AssertionError(f"the K1 site bound misses exp2 without log2(e): rel_l2 {bad_site}")


def _caption_image():
    """The captioner's input: a seeded 1024^2 uint8 image."""
    import torch

    g = torch.Generator().manual_seed(SEED + 5)
    return torch.randint(0, 256, (SIZE, SIZE, 3), generator=g, dtype=torch.uint8).numpy()


GEMV_KERNELS = ("K5", "K6", "K7")


def _counters():
    from supir_tpu_torch.ops import quantize as Q

    return {"K5": Q.int4_paired_fused_matmul, "K6": Q.int4_paired_matmul, "K7": Q.qmm, "K8": Q.quantize_int8}


@contextlib.contextmanager
def gemv_sites():
    """Hold every K5, K6 and K7 call of the captioner's Llama that reaches
    its kernel (at most DECODE_ROWS rows) to its plain version in fp32 on
    that call's inputs; the relative L2 errors land in the dict this
    yields, by kernel. The Llama module sees a copy of the quantize module
    with watched wrappers; the wrappers themselves stay as they are."""
    import types

    from supir_tpu_torch.captioner import llama
    from supir_tpu_torch.ops import quantize as Q

    rels = {k: [] for k in GEMV_KERNELS}

    def watch(name, kernel, plain):
        def watched(x, *args, **kwargs):
            out = kernel(x, *args, **kwargs)
            if x.shape[0] <= Q.DECODE_ROWS:
                rels[name].append(rel_l2(out, plain(x.float(), *args, **kwargs)))
            return out
        return watched

    proxy = types.SimpleNamespace(**vars(Q))
    proxy.int4_paired_fused_matmul = watch("K5", Q.int4_paired_fused_matmul, Q.int4_paired_fused_matmul_plain)
    proxy.int4_paired_matmul = watch("K6", Q.int4_paired_matmul, Q.int4_paired_matmul_plain)
    proxy.int8_matmul = watch("K7", Q.int8_matmul, lambda x, q, s: Q.qmm_plain(x, q, s, 8))
    proxy.int4_matmul = watch("K7", Q.int4_matmul, lambda x, q, s: Q.qmm_plain(x, q, s, 4))
    llama.Q = proxy
    try:
        yield rels
    finally:
        llama.Q = Q


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


def phase_captioner(label: str, bits, fused_glue: bool, image):
    """LLaVA-1.5-13B at full width on the card in one weight mode: load
    (random weights drawn and quantized layer by layer), one counted
    gen_image_caption, one timed again warm, then every GEMV call of one
    decode step held to its plain version, and a profile of three decode
    steps. Returns the counted launches."""
    import gc

    import torch

    from supir_tpu_torch.captioner.agent import CaptionerConfig, create_captioner

    cfg = dataclasses.replace(CaptionerConfig(), compute_dtype="bfloat16", kv_dtype="bfloat16",
                              max_new_tokens=CAP_TOKENS)
    counters = _counters()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    agent = create_captioner(cfg, "cuda", bits=bits, fused_glue=fused_glue, seed=SEED)
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
    log(f"[captioner {label}] LLaVA-1.5-13B full width, bf16 activations and KV cache (cache_len {cfg.cache_len}): "
        f"{model_bytes / 1e9:.3f} GB of parameters and buffers on the card; init and quantize {init_s:.1f} s; "
        f"peak memory {peak / 2**30:.2f} GiB")
    log(f"[captioner {label}] first run: vision+projector {first['vision'] * 1e3:.1f} ms, prefill "
        f"{first['prefill'] * 1e3:.1f} ms, decode {decode_ms:.2f} ms/token over {n - 1} tokens; "
        f"warm run: vision+projector {marks['vision'] * 1e3:.1f} ms, prefill {marks['prefill'] * 1e3:.1f} ms, "
        f"decode {decode_ms_warm:.2f} ms/token over {n_warm - 1} tokens; caption {text[:48]!r}")
    if text_warm != text:
        raise AssertionError(f"greedy captions differ between two runs: {text!r} vs {text_warm!r}")

    # launches: each decode step after the first token runs 4 GEMVs per layer
    layers = agent.cfg.llama.layers
    decode_kernel = "K7" if bits == 8 else ("K5" if fused_glue else "K6")
    want = {k: 0 for k in counters}
    want[decode_kernel] = 4 * layers * (n - 1)
    if bits == 8:
        want["K8"] = 4 * layers
    log(f"[captioner {label}] launches {launches} (expected {want}: 4 x {layers} layers x {n - 1} decoded tokens"
        f"{f'; K8 4 x {layers} at load' if bits == 8 else ''})")
    if launches != want:
        raise AssertionError(f"captioner {label} launched {launches}, expected {want}")

    # every GEMV call of one decode step against its fp32 plain version
    with gemv_sites() as rels, torch.no_grad():
        tok, plen, caches, _, _ = agent._prefill_images([image], None, "vicuna_v1")
        agent._step(tok, plen, caches)
    site = rels[decode_kernel]
    log(f"[captioner {label}] prompt {plen} tokens; one decode step: {len(site)} {decode_kernel} calls vs fp32 "
        f"plain, worst rel_l2 {max(site):.3e} (bound {GEMV_REL_BOUND:g})")
    if len(site) != 4 * layers or any(rels[k] for k in GEMV_KERNELS if k != decode_kernel):
        raise AssertionError(f"unexpected GEMV calls in one decode step: { {k: len(v) for k, v in rels.items()} }")
    _check_rel(f"captioner {label} per-site", max(site), GEMV_REL_BOUND)
    profile_decode(label, agent, image)
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
    each weight mode; logits compared by relative L2, the card teacher-forced
    on the CPU's greedy tokens."""
    import torch

    from supir_tpu_torch.captioner.agent import CaptionerConfig, create_captioner
    from supir_tpu_torch.captioner.llama import LlamaConfig
    from supir_tpu_torch.captioner.vision import CLIPVisionConfig

    cfg = CaptionerConfig(
        vision=CLIPVisionConfig(image_size=112, patch_size=14, width=256, layers=2, heads=4),
        llama=LlamaConfig(dim=512, layers=4, heads=8, kv_heads=8, hidden_dim=1536),
        max_new_tokens=REF_STEPS + 1, cache_len=512)
    card_cfg = dataclasses.replace(cfg, compute_dtype="bfloat16", kv_dtype="bfloat16")
    sd = create_captioner(cfg, "cpu", seed=SEED + 7).model.state_dict()
    counters = _counters()
    for label, bits, fused_glue in (("int4", 4, True), ("int4-unfused", 4, False), ("int8", 8, True)):
        kernel = "K7" if bits == 8 else ("K5" if fused_glue else "K6")
        cpu = create_captioner(cfg, "cpu", bits=bits, fused_glue=fused_glue, state_dict=sd, stochastic=False)
        card = create_captioner(card_cfg, "cuda", bits=bits, fused_glue=fused_glue, state_dict=sd, stochastic=False)
        t0 = time.perf_counter()
        want, toks = _logit_stream(cpu, image)
        cpu_s = time.perf_counter() - t0
        counters[kernel].launches = 0
        with gemv_sites() as rels:
            got, _ = _logit_stream(card, image, forced=toks)
        launches = counters[kernel].launches
        rel = max(rel_l2(g_, w_) for g_, w_ in zip(got, want))
        site = max(rels[kernel])
        log(f"[captioner reference {label}] reduced width, card bf16 vs CPU fp32 ({cpu_s:.1f} s): prefill and "
            f"{REF_STEPS} teacher-forced decode steps, worst logits rel_l2 {rel:.4e} (bound {CAP_REF_REL_BOUND:g}), "
            f"prefill rel_l2 {rel_l2(got[0], want[0]):.4e}; {kernel} launches {launches} (expected "
            f"{4 * cfg.llama.layers * REF_STEPS}), worst site rel_l2 {site:.3e} (bound {GEMV_REL_BOUND:g})")
        if not (rel <= CAP_REF_REL_BOUND and site <= GEMV_REL_BOUND and torch.isfinite(got).all()):
            raise AssertionError(f"captioner reference {label}: card and CPU disagree (rel_l2 {rel}, site {site})")
        if launches != 4 * cfg.llama.layers * REF_STEPS:
            raise AssertionError(f"captioner reference {label}: {kernel} launched {launches} times")
        if label == "int4":
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
    results.update(phase_quant_kernels())
    launches = phase_main(args.steps, args.repeat)
    phase_reference()
    image = _caption_image()
    for label, bits, fused_glue, kernels_of_mode in (("int4", 4, True, ("K5",)),
                                                     ("int4-unfused", 4, False, ("K6",)),
                                                     ("int8", 8, True, ("K7", "K8"))):
        counted = phase_captioner(label, bits, fused_glue, image)
        launches.update({k: counted[k] for k in kernels_of_mode})
    phase_captioner_reference(image)

    sources = {
        "K1": ("cuda", "supir_tpu_torch/csrc/flash_attn_fwd.cu", "supir_tpu/ops/flash_attention.py:35"),
        "K2": ("triton", "supir_tpu_torch/ops/groupnorm.py", "supir_tpu/ops/groupnorm.py:40"),
        "K5": ("cuda", "supir_tpu_torch/csrc/quant_gemv.cu", "supir_tpu/ops/quantize.py:260"),
        "K6": ("cuda", "supir_tpu_torch/csrc/quant_gemv.cu", "supir_tpu/ops/quantize.py:116"),
        "K7": ("cuda", "supir_tpu_torch/csrc/quant_gemv.cu", "supir_tpu/ops/quantize.py:606"),
        "K8": ("cuda", "supir_tpu_torch/csrc/quantize_int8.cu", "supir_tpu/ops/quantize.py:21"),
    }
    # where each kernel's times were taken
    at = {"K1": "[2,4096,10,64] bf16", "K2": "[2,320,128,128] bf16, SiLU",
          "K5": "one 13B layer (qkv, o, gate-up, down), 1 row", "K6": "one 13B layer, 1 row",
          "K7": "one 13B layer, int8, 1 row", "K8": "one 13B layer's four fp32 kernels"}
    kernels = []
    for name, (route, source, replaces) in sources.items():
        r = results[name]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"), "at": at[name],
        })
        if not launches[name] > 0:
            raise AssertionError(f"{name} was never launched on its path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
