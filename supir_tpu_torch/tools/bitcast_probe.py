"""T3: the nibble order the card's unpack gives, and a GEMV with one cast per
nibble pair, the counterpart of the JAX package's `tools/bitcast_probe.py`.

  probe_order  T3a's unpack kernel (csrc/nibble_order.cu) through each of
               the tensor-core body's int4 decodes (csrc/tc_decode.cuh:
               nib2, which K5-K7, K9, K11, T1c, T3b and T4b run; quad16,
               which K10, K5's act_int8 mode and T2 run) on the TPU probe's
               pattern (byte row i = nibbles 2i low, 2i+1 high), on all 256
               byte values, and on weights packed by
               ops/quantize.py:quantize_int4_paired. It prints the order and
               fails (non-zero exit) unless the order is the packer's: row 2i
               the low nibble, row 2i+1 the high one, sign-extended. A
               swapped order would leave every GEMV plausible but wrong.
  bench_gemv   T3b, the single-cast GEMV (bf16 x times paired int4, fp32
               sums) on the tensor-core body of csrc/quant_gemv_tc.cu (K6's
               instances, with their own decode: a permute, a lop3 and an
               hsub2 a nibble pair). At the four 13B decode shapes, 1 and 8
               rows, and k-slices per strip of --slices and the plan's own
               (the TPU probe's bouts were VMEM block widths; this body's
               geometry is its k-slices), in turns: which slice count wins
               and whether ops/gemv_plan.py:_choose_slices picked it; then,
               in turns with T3b at the plan's slices, tinygemm
               (torch._weight_int4pack_mm, the yardstick). Each variant is
               chained over L distinct weight copies (timing.py).

Run on the card: python -m supir_tpu_torch.tools.bitcast_probe [--layers 8]
[--reps 20] [--slices 1,2,4,8]
"""

from __future__ import annotations

import argparse

import torch

from supir_tpu_torch.tools import timing

D = 5120
SHAPES = {"qkv": (D, 3 * D), "gateup": (D, 2 * 13824), "down": (13824, D), "o": (D, D)}


def probe_order(dev) -> bool:
    """True when the card's unpack order equals quantize_int4_paired's
    through both of the body's decodes."""
    from supir_tpu_torch.ops import probes as P, quantize as Q

    rows, cols = 8, 128
    b = torch.zeros(rows, cols, dtype=torch.uint8)
    for i in range(rows):
        lo, hi = (2 * i) % 8, (2 * i + 1) % 8
        b[i, :] = (hi << 4) | lo
    every = torch.arange(256, dtype=torch.int32).to(torch.uint8).reshape(2, 128)
    # weights on the int4 grid with scale 1 (column absmax 7), through the packer
    w = torch.arange(16 * 128).reshape(16, 128).remainder(15).sub(7).float()
    w[0] = 7.0
    packed, scale = Q.quantize_int4_paired(w)
    ok = bool((scale == 1).all())
    idx = torch.arange(rows)
    for decode in P.DECODES:
        out = P.unpack_nibbles(b.to(dev), decode).cpu()[:, 0]
        print(f"unpack u8 -> s4 rows by the {decode} decode (column 0): {out.to(torch.int64).tolist()}", flush=True)
        low_first = (torch.equal(out[0::2], ((2 * idx) % 8).float())
                     and torch.equal(out[1::2], ((2 * idx + 1) % 8).float()))
        if low_first:
            print("ORDER: byte row i -> rows (2i = LOW nibble, 2i+1 = HIGH nibble)", flush=True)
        elif torch.equal(out[0::2], ((2 * idx + 1) % 8).float()):
            print("ORDER: byte row i -> rows (2i = HIGH nibble, 2i+1 = LOW)", flush=True)
        else:
            print(f"ORDER: something else: {out[:16].tolist()}", flush=True)
        bytes_ok = torch.equal(P.unpack_nibbles(every.to(dev), decode).cpu(), P.unpack_nibbles_plain(every))
        packer_ok = torch.equal(P.unpack_nibbles(packed.to(dev), decode).cpu(), w)
        print(f"{decode}: all 256 bytes match the plain unpack: {bytes_ok}; quantize_int4_paired's packing read "
              f"back: {packer_ok}", flush=True)
        ok = ok and low_first and bytes_ok and packer_ok
    return ok


def bench_gemv(dev, layers: int, reps: int, slices) -> dict:
    from supir_tpu_torch.ops import quantize as Q

    g = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for name, (cin, cout) in SHAPES.items():
        packed = [torch.randint(0, 256, (cin // 2, cout), dtype=torch.uint8, generator=g, device=dev)
                  for _ in range(layers)]
        scale = torch.rand(1, cout, generator=g, device=dev) * 0.01
        fn, _ = timing.tinygemm(Q.unpack_int4_paired(packed[0]), scale)
        yard = [timing.tinygemm(Q.unpack_int4_paired(q), scale)[1] for q in packed]
        for rows in (1, 8):
            x0 = torch.randn(rows, cin, generator=g, device=dev).to(torch.bfloat16)
            extra = {"tinygemm": [lambda w=w: fn(x0, *w) for w in yard]}
            found = timing.slices_sweep(f"{name:6s} [{rows},{cin}]x[{cin},{cout}]", "paired", packed, scale, x0,
                                        slices, reps, extra)
            results.update({f"{name} {rows} rows {k}": v for k, v in found.items()})
        del packed, yard
        torch.cuda.empty_cache()
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="T3: nibble order and the single-cast GEMV (see the docstring)")
    ap.add_argument("--layers", type=int, default=8, help="distinct weight copies per chain")
    ap.add_argument("--reps", type=int, default=20, help="graph replays timed per variant")
    ap.add_argument("--slices", default="1,2,4,8", help="k-slices per strip to sweep (the plan's own is added)")
    args = ap.parse_args(argv)
    dev = timing.require_cuda("bitcast_probe")
    print(f"bitcast_probe on {timing.card_line()}; torch {torch.__version__}", flush=True)
    if not probe_order(dev):
        raise SystemExit("bitcast_probe: the card's nibble order differs from quantize_int4_paired's packing")
    return bench_gemv(dev, args.layers, args.reps, [int(n) for n in args.slices.split(",")])


if __name__ == "__main__":
    main()
