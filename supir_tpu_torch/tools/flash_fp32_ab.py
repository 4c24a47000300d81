"""K1 fp32 (or, with `--backward`, K4 fp32 and K4 ALiBi fp32) from several
source trees on one card, in turns: the tool that compares a change of
`csrc/flash_attn_fwd_fp32.cu` (or `csrc/flash_attn_bwd_fp32.cu`) with the
kernel it replaces, the sibling of `flash_bwd_ab` (K4), whose variant
loading it shares.

Each variant is NAME=DIR, DIR a directory holding a
`flash_attn_fwd_fp32.cu` and the headers it includes (`csrc` names the
package's own sources; a copy of an older source, e.g. unpacked with `git
archive` under the gitignored `build/`, names that). A source that
includes `flash_attn_tma.cuh` takes the TMA plans (the 3xTF32 design, the
wrapper's own launch; one from before the ALiBi instance, whose entry
points take no slopes pointer, through `_without_slopes`); one that does
not takes the first design's twelve element strides. For each variant it builds the library (ops/cuda_build.py,
the same flags) and prints ptxas's spills, holds the kernel to its fp32
plain version at the tile edges (relative L2, two runs bit-identical;
beside it the distance to the walk, flash_fp32_emulate), then at
`[kernels] K1 fp32`'s six shapes gives every variant's, SDPA fp32's (the
library call's) and the plain version's distance to an fp64 reference,
times the variants and SDPA fp32 by CUDA-graph replay in turns (the
order, then the order reversed), each beside the 3xTF32 bound and the
CUDA-core bound, and names the kernel the SDPA call runs
(torch.profiler).

With `--backward` each variant's `flash_attn_bwd_fp32.cu` is built; one
that includes `flash_attn_tma.cuh` takes the TMA plans (the 3xTF32
design, the wrapper's own launch), one that does not takes the first
design's fifteen element strides (its fp32 FMA tiles on the CUDA cores).
It holds every variant to the fp32 plain version at the tile edges (worst
relative L2 of dQ, dK, dV, two runs bit-identical, the distance to the
walk, flash_bwd_fp32_emulate), then at every K4 fp32 and K4 ALiBi fp32
shape of `chip_smoke.py` gives each variant's, SDPA fp32's backward's and
the plain version's distance to an fp64 reference, and times the variants
and SDPA fp32's backward (forward and backward less forward; ALiBi's bias
as an fp32 mask) by CUDA-graph replay in turns, beside the 3xTF32 bound of
five products.

Run on the card: python -m supir_tpu_torch.tools.flash_fp32_ab
--variant new=csrc --variant old=build/old/supir_tpu_torch/csrc
[--backward]
"""

from __future__ import annotations

import argparse
import ctypes
import math

import torch
import torch.nn.functional as F

from supir_tpu_torch.tools import timing
from supir_tpu_torch.tools.flash_bwd_ab import build, parse_variants

TF32_FLOP_PER_S = 495e12  # H100 SXM dense TF32 (data sheet); a 3xTF32 product is three
FP32_FLOP_PER_S = 67e12   # H100 SXM fp32 outside the tensor cores
REL_BOUND = 1e-5          # K1 fp32 against its fp32 plain version, relative L2
# (b, s, t, h, d, causal, layout): the tile edges of the gpu tests
EDGES = [(1, 300, 300, 2, 64, True, "contiguous"), (2, 1100, 1500, 3, 64, False, "contiguous"),
         (1, 1100, 1100, 4, 64, True, "packed"), (1, 1030, 1030, 8, 128, False, "mqa"),
         (1, 1000, 1000, 2, 128, True, "contiguous"), (2, 65, 129, 2, 64, False, "contiguous")]
# (b, s, h, d, causal): chip_smoke.K1_FP32_SHAPES
SHAPES = [(2, 4096, 10, 64, False), (2, 1024, 20, 64, False), (2, 6144, 10, 64, False), (2, 1536, 20, 64, False),
          (1, 1000, 2, 128, True), (1, 1000, 2, 128, False)]


def _strided_launcher(lib):
    """The first design's entry point: q, k, v, out, B H S T D causal, twelve
    element strides (batch, seq, head of q, k, v, out), scale, fault (1-3),
    stream."""
    fn = lib.supir_flash_attn_fwd_fp32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

    def run(q, k, v, causal, fault=0):
        b, s, h, d = q.shape
        out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        strides = (ctypes.c_longlong * 12)(*[x for t in (q, k, v, out) for x in t.stride()[:3]])
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, s, k.shape[1], d, int(causal),
                 strides, d ** -0.5, fault, torch.cuda.current_stream(q.device).cuda_stream)
        if err:
            raise RuntimeError(f"K1 fp32 (first design) launch failed: cudaError {err}")
        return out

    return run


class _without_slopes:
    """A 3xTF32 library from before the ALiBi instance, seen through the
    current entry points: their slopes pointer (null without ALiBi) is
    dropped before the call."""

    def __init__(self, lib):
        def entry(fn, n_ptrs):
            def call(*args):
                return fn(*args[:n_ptrs], *args[n_ptrs + 1:])
            return call

        self.supir_flash_attn_fwd_fp32 = entry(lib.supir_flash_attn_fwd_fp32, 4)
        self.supir_flash_attn_fwd_lse_fp32 = entry(lib.supir_flash_attn_fwd_lse_fp32, 5)
        for fn, n_ptrs in ((lib.supir_flash_attn_fwd_fp32, 4), (lib.supir_flash_attn_fwd_lse_fp32, 5)):
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
                           + [ctypes.c_longlong] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def launchers(variants: dict, libs: dict) -> dict:
    """name -> (run(q, k, v, causal, fault=0), whether it takes TMA plans)
    for each built variant."""
    from supir_tpu_torch.ops import cuda_build, flash_attention as fa

    runs = {}
    for name, lib in libs.items():
        text = (variants[name] / fa._FP32_SOURCE).read_text()
        tma = '#include "flash_attn_tma.cuh"' in text
        if tma:
            if "const void* slopes" not in text:
                lib = _without_slopes(lib)

            def run(q, k, v, causal, fault=0, lib=lib):
                cuda_build._loaded[fa._FP32_SOURCE] = lib
                fa._fp32_library.cache_clear()
                return fa._forward_fp32(q, k, v, causal, fault)
        else:
            run = _strided_launcher(lib)
        runs[name] = run, tma
    return runs


def _inputs(g, dev, b, s, t, h, d, layout):
    if layout == "packed":
        return torch.randn(b, s, 3, h, d, generator=g, device=dev).unbind(2)
    q = torch.randn(b, s, h, d, generator=g, device=dev)
    if layout == "mqa":
        return (q, *(torch.randn(b, t, 1, d, generator=g, device=dev).expand(b, t, h, d) for _ in range(2)))
    return q, torch.randn(b, t, h, d, generator=g, device=dev), torch.randn(b, t, h, d, generator=g, device=dev)


def _rel(got, want) -> float:
    return ((got.double() - want.double()).norm() / want.double().norm()).item()


def check(runs: dict, dev) -> bool:
    """Every variant against the fp32 plain version at EDGES; True if all
    hold REL_BOUND and repeat bit for bit. Beside it, each variant's
    distance to the walk of the package's design (flash_fp32_emulate, on
    the CPU) and, for a 3xTF32 variant, its one-product instance's (plain
    TF32) to that fault's walk and to the plain version: the walk's TF32
    rounding against the card's."""
    from supir_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(0)
    ok = True
    for b, s, t, h, d, causal, layout in EDGES:
        q, k, v = _inputs(g, dev, b, s, t, h, d, layout)
        want = fa.attention_plain(q, k, v, causal=causal)
        cpu = [x.cpu() for x in (q, k, v)]
        walk = fa.flash_fp32_emulate(*cpu, causal)
        walk_tf32 = fa.flash_fp32_emulate(*cpu, causal, fa.FP32_FAULT_ONE_PRODUCT)
        row = []
        for name, (run, tma) in runs.items():
            got, again = run(q, k, v, causal), run(q, k, v, causal)
            rel, same = _rel(got, want), torch.equal(got, again)
            ok = ok and rel <= REL_BOUND and same
            line = f"{name} rel_l2 {rel:.3e}, bit-identical {same}, walk {_rel(got.cpu(), walk):.3e}"
            if tma:
                tf32 = run(q, k, v, causal, fa.FP32_FAULT_ONE_PRODUCT)
                line += f"; one product: walk {_rel(tf32.cpu(), walk_tf32):.3e}, plain {_rel(tf32, want):.3e}"
            row.append(line)
        print(f"[check] {(b, s, t, h, d)} causal {causal} {layout}: " + "; ".join(row), flush=True)
    return ok


def bench(runs: dict, dev) -> dict:
    """Every variant and SDPA fp32 at SHAPES in turns by CUDA-graph replay,
    and each one's distance to an fp64 reference; returns {shape: {name:
    graph ms}}."""
    from supir_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(1)
    results = {}
    for b, s, h, d, causal in SHAPES:
        q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev) for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ref = fa.attention_plain(q.double(), k.double(), v.double(), causal=causal)
        errors = {name: _rel(run(q, k, v, causal), ref) for name, (run, _) in runs.items()}
        errors["SDPA fp32"] = _rel(F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal).transpose(1, 2), ref)
        errors["plain fp32"] = _rel(fa.attention_plain(q, k, v, causal=causal), ref)
        del ref
        calls = {name: [lambda run=run: run(q, k, v, causal)] * 5 for name, (run, _) in runs.items()}
        calls["SDPA fp32"] = [lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)] * 5
        readings = timing.turns(calls, lambda c: timing.chain_ms(c, 4))
        flops = 4 * b * h * d * (s * (s + 1) // 2 if causal else s * s)
        tf32, core = 3 * flops / TF32_FLOP_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
        tag = f"[{b},{s},{h},{d}]{' causal' if causal else ''}"
        results[tag] = {name: timing.mean(r) for name, r in readings.items()}
        lib = results[tag]["SDPA fp32"]
        print(f"[time] {tag}, 3xTF32 bound {tf32:.4f} ms, CUDA-core bound {core:.4f} ms: " + "; ".join(
            f"{name} {'/'.join(f'{x:.4f}' for x in r)} ms ({tf32 / timing.mean(r):.1%} of the 3xTF32 bound, "
            f"{core / timing.mean(r):.1%} of the CUDA-core one, {timing.mean(r) / lib:.2f}x SDPA)"
            for name, r in readings.items()), flush=True)
        print(f"[error] {tag} against fp64: " + ", ".join(f"{n} {e:.3e}" for n, e in errors.items()), flush=True)
        print(f"[sdpa] {tag}: the library call runs {', '.join(sdpa_kernels(qt, kt, vt, causal))}", flush=True)
        del q, k, v, qt, kt, vt
    return results


def sdpa_kernels(q, k, v, causal) -> list[str]:
    """The device kernels one SDPA fp32 call launches (torch.profiler):
    which of PyTorch's backends the yardstick takes."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]


# K4 fp32 (b, s, t, h, d, causal, alibi, layout): the tile edges of the gpu tests
BWD_EDGES = [(1, 300, 300, 2, 64, True, False, "contiguous"), (2, 1100, 1500, 3, 64, False, False, "contiguous"),
             (1, 1000, 1000, 2, 128, True, True, "contiguous"), (1, 1030, 1030, 8, 128, True, True, "mqa"),
             (2, 65, 129, 2, 64, False, False, "contiguous")]
# (b, s, h, d, causal, alibi, layout): chip_smoke.FLASH_FP32_TRAIN_SHAPES' K4 rows, then
# ALIBI_FP32_SHAPES' K4 ALiBi rows
BWD_SHAPES = [(1, 4096, 10, 64, False, False, "contiguous"), (2, 1024, 1, 128, False, False, "contiguous"),
              (1, 1000, 2, 128, True, False, "contiguous"), (1, 2048, 32, 128, True, True, "contiguous"),
              (1, 1024, 8, 64, False, True, "contiguous"), (1, 1024, 8, 128, True, True, "mqa")]
BWD_REL_BOUND = 2e-5  # K4 fp32 against its fp32 plain version, relative L2 (K4 ALiBi fp32's is 1e-5)


def _bwd_strided_launcher(lib):
    """The first design's entry point: q, k, v, out, dout, lse, delta
    scratch, slopes, dq, dk, dv, B H S T D causal, fifteen element strides
    (batch, seq, head of q, k, v, out, dout), scale, fault (1-4), stream."""
    fn = lib.supir_flash_attn_bwd_fp32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

    def run(q, k, v, out, lse, dout, causal, fault=0, slopes=None):
        b, s, h, d = q.shape
        t = k.shape[1]
        dq, dk, dv = (torch.empty(x.shape, dtype=torch.float32, device=q.device) for x in (q, k, v))
        delta = torch.empty(b * h * s, dtype=torch.float32, device=q.device)
        strides = (ctypes.c_longlong * 15)(*[x for y in (q, k, v, out, dout) for x in y.stride()[:3]])
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), None if slopes is None else slopes.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), b, h, s, t, d, int(causal), strides, d ** -0.5, fault,
                 torch.cuda.current_stream(q.device).cuda_stream)
        if err:
            raise RuntimeError(f"K4 fp32 (first design) launch failed: cudaError {err}")
        return dq, dk, dv

    return run


def bwd_launchers(variants: dict, libs: dict) -> dict:
    """name -> run(q, k, v, out, lse, dout, causal, fault=0, slopes=None)
    for each built K4 fp32 variant."""
    from supir_tpu_torch.ops import cuda_build, flash_attention as fa

    runs = {}
    for name, lib in libs.items():
        if '#include "flash_attn_tma.cuh"' in (variants[name] / fa._BWD_FP32_SOURCE).read_text():
            def run(q, k, v, out, lse, dout, causal, fault=0, slopes=None, lib=lib):
                cuda_build._loaded[fa._BWD_FP32_SOURCE] = lib
                fa._bwd_fp32_library.cache_clear()
                return fa._backward_fp32(q, k, v, out, lse, dout, causal, fault, slopes)
        else:
            run = _bwd_strided_launcher(lib)
        runs[name] = run
    return runs


def _bwd_inputs(g, dev, b, s, t, h, d, layout, alibi):
    from supir_tpu_torch.captioner.mpt import alibi_slopes

    q, dout = (torch.randn(b, s, h, d, generator=g, device=dev) for _ in range(2))
    kv_heads = 1 if layout == "mqa" else h
    k, v = (torch.randn(b, t, kv_heads, d, generator=g, device=dev).expand(b, t, h, d) for _ in range(2))
    slopes = torch.from_numpy(alibi_slopes(h)).to(dev) if alibi else None
    return q, k, v, dout, slopes


def _rel3(got, want) -> float:
    return max(_rel(a, w) for a, w in zip(got, want))


def bwd_check(runs: dict, dev) -> bool:
    """Every K4 fp32 variant against the fp32 plain version at BWD_EDGES;
    True if all hold BWD_REL_BOUND and repeat bit for bit. Beside it each
    variant's distance to the walk of the package's design."""
    from supir_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(0)
    ok = True
    for b, s, t, h, d, causal, alibi, layout in BWD_EDGES:
        q, k, v, dout, slopes = _bwd_inputs(g, dev, b, s, t, h, d, layout, alibi)
        out, lse = fa.attention_fwd_lse_plain(q, k, v, causal, slopes)
        want = fa.attention_bwd_plain(q, k, v, out, lse, dout, causal, slopes)
        cpu = [x.cpu() for x in (q, k, v, out, lse, dout)]
        walk = fa.flash_bwd_fp32_emulate(*cpu, causal, alibi_slopes=None if slopes is None else slopes.cpu())
        row = []
        for name, run in runs.items():
            got, again = run(q, k, v, out, lse, dout, causal, slopes=slopes), run(q, k, v, out, lse, dout, causal,
                                                                                slopes=slopes)
            rel, same = _rel3(got, want), all(torch.equal(a, a2) for a, a2 in zip(got, again))
            ok = ok and rel <= BWD_REL_BOUND and same
            row.append(f"{name} rel_l2 {rel:.3e}, bit-identical {same}, walk {_rel3([x.cpu() for x in got], walk):.3e}")
        print(f"[check] {(b, s, t, h, d)} causal {causal} alibi {alibi} {layout}: " + "; ".join(row), flush=True)
    return ok


def _sdpa_backward_ms(qkv, grad, calls: int, **sdpa) -> float:
    """SDPA's backward by CUDA-graph replay: forward and backward (autograd
    runs a backward on its forward's stream) less the forward alone."""
    def forward():
        leaves = [x.detach().requires_grad_() for x in qkv]
        return leaves, F.scaled_dot_product_attention(*leaves, **sdpa)

    def forward_backward():
        leaves, out = forward()
        return torch.autograd.grad(out, leaves, grad)

    return timing.chain_ms([forward_backward] * calls, 4) - timing.chain_ms([forward] * calls, 4)


def bwd_bench(runs: dict, dev) -> dict:
    """Every K4 fp32 variant and SDPA fp32's backward at BWD_SHAPES in turns
    by CUDA-graph replay, each one's distance to an fp64 reference; returns
    {shape: {name: graph ms}}."""
    from supir_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(1)
    results = {}
    for b, s, h, d, causal, alibi, layout in BWD_SHAPES:
        q, k, v, dout, slopes = _bwd_inputs(g, dev, b, s, s, h, d, layout, alibi)
        out, lse = fa.flash_attention_fwd_lse(q, k, v, causal, slopes)
        qt, kt, vt, gt = (x.transpose(1, 2) for x in (q, k, v, dout))
        sdpa = {"is_causal": causal}
        if alibi:
            mask = fa.alibi_bias(slopes, s, dev).expand(b, h, s, s)
            if causal:
                mask = mask.masked_fill(~torch.ones(s, s, dtype=torch.bool, device=dev).tril(), float("-inf"))
            sdpa = {"attn_mask": mask.contiguous()}
        w64 = fa.attention_bwd_plain(*(x.double() for x in (q, k, v, out)), lse, dout.double(), causal,
                                     None if slopes is None else slopes.double())
        errors = {name: _rel3(run(q, k, v, out, lse, dout, causal, slopes=slopes), w64) for name, run in runs.items()}
        leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
        lib = torch.autograd.grad(F.scaled_dot_product_attention(*leaves, **sdpa), leaves, gt)
        errors["SDPA fp32"] = _rel3([x.transpose(1, 2) for x in lib], w64)
        errors["plain fp32"] = _rel3(fa.attention_bwd_plain(q, k, v, out, lse, dout, causal, slopes), w64)
        del w64, lib, leaves
        calls = {name: ([lambda run=run: run(q, k, v, out, lse, dout, causal, slopes=slopes)] * 5, None)
                 for name, run in runs.items()}
        calls["SDPA fp32"] = ((qt, kt, vt), gt)
        readings = timing.turns(calls, lambda c: timing.chain_ms(c[0], 4) if c[1] is None
                                else _sdpa_backward_ms(c[0], c[1], 5, **sdpa))
        pairs = s * (s + 1) // 2 if causal else s * s
        tf32 = 3 * 2 * 5 * b * h * pairs * d / TF32_FLOP_PER_S * 1e3
        tag = f"[{b},{s},{h},{d}]{' causal' if causal else ''}{' ALiBi' if alibi else ''}" + (
            " multiquery" if layout == "mqa" else "")
        results[tag] = {name: timing.mean(r) for name, r in readings.items()}
        lib_ms = results[tag]["SDPA fp32"]
        print(f"[time] {tag}, 3xTF32 bound {tf32:.4f} ms (5 products): " + "; ".join(
            f"{name} {'/'.join(f'{x:.4f}' for x in r)} ms ({tf32 / timing.mean(r):.1%} of the bound, "
            f"{timing.mean(r) / lib_ms:.2f}x SDPA's time)" for name, r in readings.items()), flush=True)
        print(f"[error] {tag} against fp64: " + ", ".join(f"{n} {e:.3e}" for n, e in errors.items()), flush=True)
        del q, k, v, dout, out, lse, qt, kt, vt, gt, sdpa
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="K1 fp32 (or K4 fp32) from several source trees, in turns (see the "
                                             "docstring)")
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=DIR",
                    help="a csrc directory holding flash_attn_fwd_fp32.cu (flash_attn_bwd_fp32.cu with --backward); "
                         "'csrc' is the package's own")
    ap.add_argument("--backward", action="store_true", help="K4 fp32 and K4 ALiBi fp32 instead of K1 fp32")
    args = ap.parse_args(argv)
    dev = timing.require_cuda("flash_fp32_ab")
    torch.backends.cuda.matmul.allow_tf32 = False
    from supir_tpu_torch.ops import flash_attention as fa

    variants = parse_variants(args.variant)
    print(f"flash_fp32_ab on {timing.card_line()}; torch {torch.__version__}", flush=True)
    if args.backward:
        runs = bwd_launchers(variants, build(variants, fa._BWD_FP32_SOURCE))
        held = bwd_check(runs, dev)
        results = bwd_bench(runs, dev)
    else:
        runs = launchers(variants, build(variants, fa._FP32_SOURCE))
        held = check(runs, dev)
        results = bench(runs, dev)  # a variant that missed is still timed: it may be the one to learn from
    if not held:
        raise SystemExit("flash_fp32_ab: a variant misses its bound or differs between two runs")
    if not all(math.isfinite(ms) for row in results.values() for ms in row.values()):
        raise SystemExit("flash_fp32_ab: a time is not finite")
    return results


if __name__ == "__main__":
    main()
