"""T1: the card's streaming ceiling for decode-GEMV access patterns, the
counterpart of the JAX package's `tools/stream_ceiling.py`, and where the
tensor-core GEMV body's gap to its bound comes from.

Ladder, all on uint8 [CIN/2, COUT] = [2560, 15360] weights (39.3 MB each,
the 13B qkv projection's paired bytes), L = 8 distinct copies (315 MB)
chained through one CUDA graph (timing.py):
  ring column sum T1a/T1b (csrc/colsum_tc.cu): the column sum on the
                  tensor-core GEMV body's weight stream (K6's plan at one
                  row over the same bytes: TMA ring, k-slice tiles,
                  slice-order combine) with no decode and no products, at
                  k-slices 1 (T1a), 2, 4, 8 and the plan's count, in turns;
                  then the plan's count in turns with
                  `torch.sum(q, 0, dtype=torch.int32)`, in place of the
                  TPU's sum_xla.
  ring vs K6      the ring column sum in turns with K6 at one row over the
                  same bytes on the same plan, at qkv ([2560,15360] bytes:
                  [1,5120] x [5120,15360]) and down ([6912,5120] bytes:
                  [1,13824] x [13824,5120]): the ring alone against the
                  ring with the decode and the products. Then the same pair
                  over [rows, 15360] bytes at each of SIZE_ROWS (9.8-157
                  MB), and a least-squares line through each one's times:
                  its fixed cost a launch (the start and end) and the rate
                  at which it streams the rest.
  copy            a device-to-device copy of each copy (read and write).
  bf16 GEMV       a chained bf16 `torch.matmul` of [1, CIN] x [CIN, COUT]
                  (cuBLAS, 157 MB a copy, 4 copies as the JAX tool), in
                  place of dot_bf16_xla.
  K7 (T1c)        K7's half-split int4 GEMV, [8, CIN] bf16 x [CIN/2, COUT],
                  on the tensor-core body (csrc/quant_gemv_tc.cu) at
                  k-slices 1, 2, 4, 8 and the plan's count in turns
                  (timing.slices_sweep), then the plan's count in turns with
                  the first design (K7's strip body at strip 128, for the
                  TPU's forced bouts) and tinygemm.
Each line gives ms per call and the read rate against the data-sheet 3.35
TB/s; the last line names the card's measured streaming ceiling: the highest
read rate any variant sustained, and which one.

Run on the card: python -m supir_tpu_torch.tools.stream_ceiling [--layers 8]
[--reps 20] [--slices 1,2,4,8]
"""

from __future__ import annotations

import argparse

import torch

from supir_tpu_torch.tools import timing

CIN, COUT, L = 5120, 15360, 8
DOWN = (6912, 5120)   # the 13B down projection's paired bytes, [13824 / 2, 5120]
SIZE_ROWS = (640, 1280, 5120, 10240)   # with qkv's 2560: [rows, COUT] bytes, 9.8-157 MB


def column_sums(qs, slices, reps: int) -> dict:
    """The ring column sum at each count of `slices` and the plan's own, in
    turns; then the plan's count in turns with torch.sum."""
    from supir_tpu_torch.ops import probes as P, quantize as Q

    rows, cout = qs[0].shape
    per, chain = qs[0].numel(), qs[0].numel() * len(qs)
    own = P.ring_plan(rows, cout, Q._sm_count(qs[0].device.index)).slices
    timer = lambda calls: timing.chain_ms(calls, reps)  # noqa: E731
    ring = {n: [lambda q=q: P.column_sum(q) for q in qs] if n == 1
            else [lambda q=q, n=n: P.column_sum_2d(q, n) for q in qs] for n in sorted(set(slices) | {own})}
    results = {}
    for n, r in timing.turns(ring, timer).items():
        tag = f"{' (T1a)' if n == 1 else ''}{' (plan)' if n == own else ''}"
        results[f"ring {n} slices"] = timing.report(f"ring column sum {n} k-slices{tag}", timing.mean(r), per, chain)
    others = {f"ring column sum, the plan's {own}": ring[own],
              "torch.sum(q, 0, int32)": [lambda q=q: torch.sum(q, 0, dtype=torch.int32) for q in qs]}
    for name, r in timing.turns(others, timer).items():
        results[name] = timing.report(name, timing.mean(r), per, chain, "(in turns)")
    return results


def ring_vs_k6(label: str, qs, reps: int, g) -> dict:
    """The ring column sum over `qs` (u8 [rows, cout] copies) in turns with
    K6 at one row reading the same bytes as paired int4 [2 rows, cout], on
    the same plan (tc_plan("paired", 1, 2 rows, cout)). Prints one line with
    both times; returns both reports."""
    from supir_tpu_torch.ops import probes as P, quantize as Q

    rows, cout = qs[0].shape
    per, chain = qs[0].numel(), qs[0].numel() * len(qs)
    x1 = torch.randn(1, 2 * rows, generator=g, device=qs[0].device).to(torch.bfloat16)
    scale = torch.rand(1, cout, generator=g, device=qs[0].device) * 0.01
    slices = P.ring_plan(rows, cout, Q._sm_count(qs[0].device.index)).slices
    variants = {"ring": [lambda q=q: P.column_sum_2d(q) for q in qs],
                "K6": [lambda q=q: Q.int4_paired_matmul(x1, q, scale) for q in qs]}
    found = {name: timing.report(f"{label} {name}", timing.mean(r), per, chain, "(in turns)")
             for name, r in timing.turns(variants, lambda calls: timing.chain_ms(calls, reps)).items()}
    ring, k6 = found["ring"], found["K6"]
    print(f"  ring alone vs K6 at {label} [{rows},{cout}] bytes, {slices} k-slices: ring {ring['ms']:.4f} ms "
          f"({ring['share']:.1%} of 3.35 TB/s), K6 {k6['ms']:.4f} ms ({k6['share']:.1%}): K6 takes "
          f"{k6['ms'] / ring['ms']:.2f}x the ring's time", flush=True)
    return {f"{label} {name}": r for name, r in found.items()}


def by_size(results: dict, layers: int, reps: int, g) -> dict:
    """ring_vs_k6 over u8 [rows, COUT] at each of SIZE_ROWS (at least
    `layers` copies, and enough to exceed 2.5x the L2), beside qkv's
    readings in `results`; then per variant a least-squares line ms = a +
    bytes / rate through the five sizes. Prints a and the rate; returns
    the readings."""
    found, points = {}, {"ring": [(CIN // 2 * COUT, results["qkv ring"]["ms"])],
                         "K6": [(CIN // 2 * COUT, results["qkv K6"]["ms"])]}
    for rows in SIZE_ROWS:
        per = rows * COUT
        n = max(layers, -(-int(2.5 * timing.L2_BYTES) // per))
        qs = [torch.randint(0, 256, (rows, COUT), dtype=torch.uint8, generator=g, device=g.device) for _ in range(n)]
        got = ring_vs_k6(f"[{rows},{COUT}]", qs, reps, g)
        for name in points:
            points[name].append((per, got[f"[{rows},{COUT}] {name}"]["ms"]))
        found.update(got)
        del qs
    for name, pts in points.items():
        xs, ys = [b for b, _ in pts], [ms for _, ms in pts]
        mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
        slope = sum((x - mx) * (y - my) for x, y in pts) / sum((x - mx) ** 2 for x in xs)   # ms a byte
        fixed = my - slope * mx
        print(f"  {name} by size ({len(pts)} sizes, {min(xs) / 1e6:.1f}-{max(xs) / 1e6:.1f} MB): {fixed * 1e3:.2f} us "
              f"a launch + the bytes at {1e-6 / slope:.1f} GB/s ({1e3 / slope / timing.HBM_BYTES_PER_S:.1%} of "
              f"3.35 TB/s)", flush=True)
    return found


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="T1: the card's streaming ceiling (see the module's docstring)")
    ap.add_argument("--layers", type=int, default=L, help="distinct weight copies per chain")
    ap.add_argument("--reps", type=int, default=20, help="graph replays timed per variant")
    ap.add_argument("--slices", default="1,2,4,8", help="k-slices per strip to sweep (the plan's own is added)")
    args = ap.parse_args(argv)
    dev = timing.require_cuda("stream_ceiling")
    slices = [int(n) for n in args.slices.split(",")]

    from supir_tpu_torch.ops import quantize as Q

    print(f"stream_ceiling on {timing.card_line()}; torch {torch.__version__}, L={args.layers}", flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    qs = [torch.randint(0, 256, (CIN // 2, COUT), dtype=torch.uint8, generator=g, device=dev)
          for _ in range(args.layers)]
    per = CIN // 2 * COUT
    chain = per * args.layers
    results = column_sums(qs, slices, args.reps)
    results.update(ring_vs_k6("qkv", qs, args.reps, g))
    down = [torch.randint(0, 256, DOWN, dtype=torch.uint8, generator=g, device=dev) for _ in range(args.layers)]
    results.update(ring_vs_k6("down", down, args.reps, g))
    del down
    results.update(by_size(results, args.layers, args.reps, g))

    def run(name, calls, read_bytes, chain_bytes=chain, note=""):
        results[name] = timing.report(name, timing.chain_ms(calls, args.reps), read_bytes, chain_bytes, note)

    dsts = [torch.empty_like(q) for q in qs]
    run("copy (read)", [lambda q=q, d=d: d.copy_(q) for q, d in zip(qs, dsts)], per,
        note="(reads and writes: twice the bytes moved)")
    del dsts

    ws = [torch.randn(CIN, COUT, generator=g, device=dev).to(torch.bfloat16) for _ in range(4)]
    x1 = torch.randn(1, CIN, generator=g, device=dev).to(torch.bfloat16)
    run("bf16 GEMV torch.matmul [1,5120]", [lambda w=w: torch.matmul(x1, w) for w in ws], CIN * COUT * 2,
        chain_bytes=CIN * COUT * 2 * len(ws))
    del ws

    x8 = torch.randn(8, CIN, generator=g, device=dev).to(torch.bfloat16)
    scale = torch.rand(1, COUT, generator=g, device=dev) * 0.01
    fn, _ = timing.tinygemm(Q.unpack_int4(qs[0]), scale)
    yard = [timing.tinygemm(Q.unpack_int4(q), scale)[1] for q in qs]
    extra = {"first design (K7's strip body, strip 128)": [lambda q=q: Q.int4_matmul(x8, q, scale, strip=128)
                                                           for q in qs],
             "tinygemm": [lambda w=w: fn(x8, *w) for w in yard]}
    found = timing.slices_sweep("T1c K7 int4 half-split [8,5120]x[5120,15360]", "half", qs, scale, x8, slices,
                                args.reps, extra)
    results.update({f"T1c {k}": v for k, v in found.items()})
    del yard

    best = max(results.values(), key=lambda r: r["gb_per_s"])
    print(f"streaming ceiling: {best['gb_per_s']:.1f} GB/s read ({best['share']:.1%} of 3.35 TB/s) by "
          f"{best['name']}", flush=True)
    results["ceiling"] = dict(best)
    return results


if __name__ == "__main__":
    main()
