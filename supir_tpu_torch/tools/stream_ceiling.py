"""T1: the card's streaming ceiling for decode-GEMV access patterns, the
counterpart of the JAX package's `tools/stream_ceiling.py`.

Ladder, all on uint8 [CIN/2, COUT] = [2560, 15360] weights (39.3 MB each),
L = 8 distinct copies (315 MB) chained through one CUDA graph (timing.py):
  column sum 1-D  T1a (csrc/probes.cu): one block per strip of columns down
                  all 2560 rows. Strips 512-15360 are the TPU's bouts
                  (1-30 blocks: a handful of the 132 SMs); 64-256 give
                  60-240 blocks.
  column sum 2-D  T1b: (brow, bout) blocks, the row blocks' partials added
                  by exact fp32 atomics; the TPU's four pairs (8-16 blocks)
                  and three card-sized ones.
  torch.sum       `torch.sum(q, 0, dtype=torch.int32)`, in place of the
                  TPU's sum_xla (the library's own stream rate).
  bf16 GEMV       a chained bf16 `torch.matmul` of [1, CIN] x [CIN, COUT]
                  (cuBLAS, 157 MB a copy, 4 copies as the JAX tool), in
                  place of dot_bf16_xla.
  copy            a device-to-device copy of each copy (read and write).
  K7 strips       T1c: K7's half-split int4 GEMV, [8, CIN] bf16 x [CIN/2,
                  COUT], at strips of 32 (the model paths') to 256 columns
                  per block (ops/quantize.py's `strip=`), for the TPU's
                  forced bouts 512-3840 (csrc/gemv_sweep.cu says why the
                  card's strip stops at 256).
Each line gives ms per call and the read rate against the data-sheet 3.35
TB/s; the last line names the card's measured streaming ceiling: the highest
read rate any variant sustained, and which one.

Run on the card: python -m supir_tpu_torch.tools.stream_ceiling [--layers 8]
[--reps 20]
"""

from __future__ import annotations

import argparse

import torch

from supir_tpu_torch.tools import timing

CIN, COUT, L = 5120, 15360, 8
SUM_STRIPS = (64, 128, 256, 512, 1024, 3840, 7680, 15360)
SUM2D_PAIRS = ((1280, 1920), (640, 3840), (1280, 3840), (2560, 1920),   # the TPU's
               (128, 1024), (256, 512), (512, 256))                        # card-sized
GEMV_STRIPS = (32, 64, 128, 256)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="T1: the card's streaming ceiling (see the module's docstring)")
    ap.add_argument("--layers", type=int, default=L, help="distinct weight copies per chain")
    ap.add_argument("--reps", type=int, default=20, help="graph replays timed per variant")
    args = ap.parse_args(argv)
    dev = timing.require_cuda("stream_ceiling")

    from supir_tpu_torch.ops import probes as P, quantize as Q

    print(f"stream_ceiling on {timing.card_line()}; torch {torch.__version__}, L={args.layers}", flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    qs = [torch.randint(0, 256, (CIN // 2, COUT), dtype=torch.uint8, generator=g, device=dev)
          for _ in range(args.layers)]
    per = CIN // 2 * COUT
    chain = per * args.layers
    results = {}

    def run(name, calls, read_bytes, chain_bytes=chain, note=""):
        results[name] = timing.report(name, timing.chain_ms(calls, args.reps), read_bytes, chain_bytes, note)

    for strip in SUM_STRIPS:
        run(f"column sum 1-D strip {strip}", [lambda q=q, s=strip: P.column_sum(q, s) for q in qs], per,
            note=f"[{-(-COUT // strip)} blocks]")
    for brow, bout in SUM2D_PAIRS:
        run(f"column sum 2-D {brow}x{bout}", [lambda q=q, r=brow, b=bout: P.column_sum_2d(q, r, b) for q in qs], per,
            note=f"[{-(-COUT // bout) * -(-(CIN // 2) // brow)} blocks]")
    run("torch.sum(q, 0, int32)", [lambda q=q: torch.sum(q, 0, dtype=torch.int32) for q in qs], per)

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
    for strip in GEMV_STRIPS:
        run(f"K7 int4 half-split [8,5120] strip {strip}", [lambda q=q, s=strip: Q.int4_matmul(x8, q, scale, strip=s)
                                                            for q in qs], per,
            note=f"[{-(-COUT // strip)} blocks]")

    best = max(results.values(), key=lambda r: r["gb_per_s"])
    print(f"streaming ceiling: {best['gb_per_s']:.1f} GB/s read ({best['share']:.1%} of 3.35 TB/s) by "
          f"{best['name']}", flush=True)
    results["ceiling"] = dict(best)
    return results


if __name__ == "__main__":
    main()
