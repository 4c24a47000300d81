"""K4 from several source trees on one card, in turns: the tool that
compares a change of `csrc/flash_attn_bwd.cu` with the kernel it replaces.

Each variant is NAME=DIR, DIR a directory holding a `flash_attn_bwd.cu` and
the headers it includes (`csrc` names the package's own sources; a copy of
an older source, e.g. unpacked with `git archive` under the gitignored
`build/`, names that). For each variant it builds the library
(ops/cuda_build.py, the same flags) and prints ptxas's spills, holds the
kernel to its fp32 plain version at the tile edges (worst rel-L2 of dq, dk,
dv; two runs bit-identical), then times every variant at the main paths'
K4 shapes in turns (the order, then the order reversed): CUDA events over
`--reps` calls and CUDA-graph replay of 10 calls, each beside the bound's
share, and the device time of each of the backward's kernels from
torch.profiler.

Run on the card: python -m supir_tpu_torch.tools.flash_bwd_ab
--variant new=csrc --variant old=build/old/supir_tpu_torch/csrc [--reps 30]
"""

from __future__ import annotations

import argparse
import math
import re
from pathlib import Path

import torch

from supir_tpu_torch.tools import timing

BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 (data sheet)
KERNEL = re.compile(r"flash_bwd_\w+<[^>]*>")  # a backward kernel's name in a profiler key
# (b, s, t, h, d, causal, alibi, multiquery): the tile edges of the gpu tests
EDGES = [(1, 1100, 1100, 4, 64, True, False, False), (2, 1000, 1500, 3, 64, False, False, False),
         (1, 1030, 1030, 4, 128, True, True, False), (1, 1088, 1088, 4, 64, True, True, False),
         (2, 65, 129, 2, 64, False, False, False), (1, 1100, 1100, 8, 128, True, False, True),
         (2, 1000, 1000, 4, 64, False, True, True), (10, 300, 300, 40, 64, True, False, False)]
# (b, s, h, d, causal, alibi): the training path's two shapes, Llama-13B's
# causal heads, the MPT-7B gradient's and a short ALiBi shape
SHAPES = [(1, 4096, 10, 64, False, False), (1, 1024, 20, 64, False, False), (1, 2048, 40, 128, True, False),
          (1, 2048, 32, 128, True, True), (1, 1024, 8, 64, False, True)]


def _slopes(h: int, dev):
    return torch.tensor([2.0 ** (-8 * (i + 1) / h) for i in range(h)], device=dev)


def _rel(got, want) -> float:
    return ((got.float() - want).norm() / want.norm()).item()


def build(variants: dict[str, Path], source: str | None = None) -> dict:
    """The loaded library of `source` (by default K4's flash_attn_bwd.cu)
    from each variant's directory; prints its spills."""
    from supir_tpu_torch.ops import cuda_build, flash_attention as fa

    source = source or fa._BWD_SOURCE
    own, libs = cuda_build.CSRC, {}
    try:
        for name, src in variants.items():
            cuda_build.CSRC = src.resolve()
            cuda_build._loaded.pop(source, None)
            libs[name] = cuda_build.load_library(source)
            report = cuda_build.ptxas_report(source)
            spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", report)]
            print(f"[build] {name} ({src}): {len(spills)} kernels, spill stores max {max(spills, default=0)} B",
                  flush=True)
    finally:
        cuda_build.CSRC = own
    return libs


def check(libs: dict, dev) -> None:
    """Every variant against the fp32 plain version at EDGES."""
    from supir_tpu_torch.ops import cuda_build, flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(0)
    for b, s, t, h, d, causal, alibi, mqa in EDGES:
        q, dout = (torch.randn(b, s, h, d, generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
        kv_heads = 1 if mqa else h
        k, v = (torch.randn(b, t, kv_heads, d, generator=g, device=dev).to(torch.bfloat16).expand(b, t, h, d)
                for _ in range(2))
        slopes = _slopes(h, dev) if alibi else None
        out, lse = fa.flash_attention_fwd_lse(q, k, v, causal, slopes)
        want = fa.attention_bwd_plain(q.float(), k.float(), v.float(), out.float(), lse, dout.float(), causal, slopes)
        row = []
        for name, lib in libs.items():
            cuda_build._loaded[fa._BWD_SOURCE] = lib
            got = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal, slopes)
            again = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal, slopes)
            same = all(torch.equal(a, a2) for a, a2 in zip(got, again))
            row.append(f"{name} rel_l2 {max(_rel(a, w) for a, w in zip(got, want)):.3e}, bit-identical {same}")
        print(f"[check] {(b, s, t, h, d)} causal {causal} alibi {alibi} multiquery {mqa}: " + "; ".join(row),
              flush=True)


def bench(libs: dict, dev, reps: int) -> dict:
    """Every variant at SHAPES in turns; returns {shape: {name: graph ms}}."""
    from supir_tpu_torch.ops import cuda_build, flash_attention as fa

    def event_ms(fn) -> float:
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    g = torch.Generator(device=dev).manual_seed(1)
    order = list(libs) + list(libs)[::-1]
    results = {}
    for b, s, h, d, causal, alibi in SHAPES:
        q, k, v, dout = (torch.randn(b, s, h, d, generator=g, device=dev).to(torch.bfloat16) for _ in range(4))
        slopes = _slopes(h, dev) if alibi else None
        out, lse = fa.flash_attention_fwd_lse(q, k, v, causal, slopes)
        pairs = s * (s + 1) // 2 if causal else s * s
        bound = 2 * 5 * b * h * pairs * d / BF16_FLOP_PER_S * 1e3

        def run():
            return fa.flash_attention_bwd(q, k, v, out, lse, dout, causal, slopes)

        times = {name: [] for name in libs}
        for name in order:
            cuda_build._loaded[fa._BWD_SOURCE] = libs[name]
            times[name].append((event_ms(run), timing.chain_ms([run] * 10, 5)))
        tag = f"[{b},{s},{h},{d}]{' causal' if causal else ''}{' ALiBi' if alibi else ''}"
        results[tag] = {name: min(x[1] for x in t) for name, t in times.items()}
        print(f"[time] {tag}, bound {bound:.4f} ms: " + "; ".join(
            f"{name} events {min(x[0] for x in t):.4f} ms, graph {min(x[1] for x in t):.4f} ms "
            f"({bound / min(x[1] for x in t):.1%} of the bound)" for name, t in times.items()), flush=True)
        for name, lib in libs.items():
            cuda_build._loaded[fa._BWD_SOURCE] = lib
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    run()
                torch.cuda.synchronize()
            split = [f"{KERNEL.search(e.key).group(0)} {e.self_device_time_total / e.count / 1e3:.4f} ms"
                     for e in prof.key_averages() if KERNEL.search(e.key)]
            print(f"[profile] {tag} {name}: " + ", ".join(split), flush=True)
    return results


def parse_variants(specs) -> dict[str, Path]:
    """NAME=DIR flags (DIR 'csrc': the package's own sources) as {name: dir}."""
    from supir_tpu_torch.ops import cuda_build

    variants = {}
    for spec in specs or ["csrc=csrc"]:
        name, _, src = spec.partition("=")
        variants[name] = cuda_build.CSRC if src == "csrc" else Path(src)
    return variants


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="K4 from several source trees, in turns (see the docstring)")
    ap.add_argument("--variant", action="append", default=[], metavar="NAME=DIR",
                    help="a csrc directory holding flash_attn_bwd.cu; 'csrc' is the package's own")
    ap.add_argument("--reps", type=int, default=30, help="calls per event timing")
    args = ap.parse_args(argv)
    dev = timing.require_cuda("flash_bwd_ab")
    variants = parse_variants(args.variant)
    print(f"flash_bwd_ab on {timing.card_line()}; torch {torch.__version__}", flush=True)
    libs = build(variants)
    check(libs, dev)
    results = bench(libs, dev, args.reps)
    if not all(math.isfinite(ms) for row in results.values() for ms in row.values()):
        raise SystemExit("flash_bwd_ab: a time is not finite")
    return results


if __name__ == "__main__":
    main()
