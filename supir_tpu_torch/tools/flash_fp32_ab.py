"""K1 fp32 from several source trees on one card, in turns: the tool that
compares a change of `csrc/flash_attn_fwd_fp32.cu` with the kernel it
replaces, the sibling of `flash_bwd_ab` (K4), whose variant loading it
shares.

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

Run on the card: python -m supir_tpu_torch.tools.flash_fp32_ab
--variant new=csrc --variant old=build/old/supir_tpu_torch/csrc
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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="K1 fp32 from several source trees, in turns (see the docstring)")
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=DIR",
                    help="a csrc directory holding flash_attn_fwd_fp32.cu; 'csrc' is the package's own")
    args = ap.parse_args(argv)
    dev = timing.require_cuda("flash_fp32_ab")
    torch.backends.cuda.matmul.allow_tf32 = False
    from supir_tpu_torch.ops import flash_attention as fa

    variants = parse_variants(args.variant)
    print(f"flash_fp32_ab on {timing.card_line()}; torch {torch.__version__}", flush=True)
    runs = launchers(variants, build(variants, fa._FP32_SOURCE))
    held = check(runs, dev)
    results = bench(runs, dev)  # a variant that missed is still timed: it may be the one to learn from
    if not held:
        raise SystemExit("flash_fp32_ab: a variant misses the 1e-5 bound or differs between two runs")
    if not all(math.isfinite(ms) for row in results.values() for ms in row.values()):
        raise SystemExit("flash_fp32_ab: a time is not finite")
    return results


if __name__ == "__main__":
    main()
