"""T3: the nibble order the card's unpack gives, and a GEMV with one cast per
nibble pair, the counterpart of the JAX package's `tools/bitcast_probe.py`.

  probe_order  T3a's unpack kernel (csrc/probes.cu, through quant_gemv.cuh's
               nib, the conversion K5-K7, K9 and K11 use) on the TPU probe's
               pattern (byte row i = nibbles 2i low, 2i+1 high) and on all
               256 byte values, and on weights packed by
               ops/quantize.py:quantize_int4_paired. It prints the order and
               fails (non-zero exit) unless the order is the packer's: row 2i
               the low nibble, row 2i+1 the high one, sign-extended. A
               swapped order would leave every GEMV plausible but wrong.
  bench_gemv   T3b's single-cast GEMV (bf16 x [8, cin] x paired int4, one
               packed bf16 subtract per byte, fp32 sums) at the 13B decode
               shapes and strips of 32-256 columns per block, against K6
               (int4_paired_matmul on csrc/quant_gemv_tc.cu, in place of the
               "shiftpair" line of the TPU probe),
               chained over L distinct weight copies (timing.py). The TPU's
               bouts 256-2048 were VMEM block widths; the card's strip stops
               at 256 (csrc/gemv_sweep.cu).

Run on the card: python -m supir_tpu_torch.tools.bitcast_probe [--layers 8]
[--reps 20]
"""

from __future__ import annotations

import argparse

import torch

from supir_tpu_torch.tools import timing

D = 5120
SHAPES = {"qkv": (D, 3 * D), "gateup": (D, 2 * 13824), "down": (13824, D), "o": (D, D)}


def probe_order(dev) -> bool:
    """True when the card's unpack order equals quantize_int4_paired's."""
    from supir_tpu_torch.ops import probes as P, quantize as Q

    rows, cols = 8, 128
    b = torch.zeros(rows, cols, dtype=torch.uint8)
    for i in range(rows):
        lo, hi = (2 * i) % 8, (2 * i + 1) % 8
        b[i, :] = (hi << 4) | lo
    out = P.unpack_nibbles(b.to(dev)).cpu()[:, 0]
    print(f"unpack u8 -> s4 rows (column 0): {out.to(torch.int64).tolist()}", flush=True)
    idx = torch.arange(rows)
    low_first = torch.equal(out[0::2], ((2 * idx) % 8).float()) and torch.equal(out[1::2], ((2 * idx + 1) % 8).float())
    if low_first:
        print("ORDER: byte row i -> rows (2i = LOW nibble, 2i+1 = HIGH nibble)", flush=True)
    elif torch.equal(out[0::2], ((2 * idx + 1) % 8).float()):
        print("ORDER: byte row i -> rows (2i = HIGH nibble, 2i+1 = LOW)", flush=True)
    else:
        print(f"ORDER: something else: {out[:16].tolist()}", flush=True)

    every = torch.arange(256, dtype=torch.int32).to(torch.uint8).reshape(2, 128)
    got = P.unpack_nibbles(every.to(dev)).cpu()
    bytes_ok = torch.equal(got, P.unpack_nibbles_plain(every))
    # weights on the int4 grid with scale 1 (column absmax 7), through the packer
    w = torch.arange(16 * 128).reshape(16, 128).remainder(15).sub(7).float()
    w[0] = 7.0
    packed, scale = Q.quantize_int4_paired(w)
    packer_ok = bool((scale == 1).all()) and torch.equal(P.unpack_nibbles(packed.to(dev)).cpu(), w)
    print(f"all 256 bytes match the plain unpack: {bytes_ok}; quantize_int4_paired's packing read back: "
          f"{packer_ok}", flush=True)
    return low_first and bytes_ok and packer_ok


def bench_gemv(dev, layers: int, reps: int) -> dict:
    from supir_tpu_torch.ops import probes as P, quantize as Q

    g = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for name, (cin, cout) in SHAPES.items():
        packed = [torch.randint(0, 256, (cin // 2, cout), dtype=torch.uint8, generator=g, device=dev)
                  for _ in range(layers)]
        scale = torch.rand(1, cout, generator=g, device=dev) * 0.01
        x0 = torch.randn(8, cin, generator=g, device=dev).to(torch.bfloat16)
        per = cin * cout // 2
        for strip in Q.GEMV_STRIPS:
            key = f"{name} single-cast strip {strip}"
            ms = timing.chain_ms([lambda q=q, s=strip: P.int4_single_cast_matmul(x0, q, scale, s) for q in packed],
                                 reps)
            results[key] = timing.report(f"{name:6s} [8,{cin}]x[{cin},{cout}] single-cast strip {strip}", ms, per,
                                         per * layers, note=f"[{-(-cout // strip)} blocks]")
        ms = timing.chain_ms([lambda q=q: Q.int4_paired_matmul(x0, q, scale) for q in packed], reps)
        results[f"{name} K6"] = timing.report(f"{name:6s} [8,{cin}]x[{cin},{cout}] K6 (tensor-core body)", ms,
                                              per, per * layers)
        del packed
        torch.cuda.empty_cache()
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="T3: nibble order and the single-cast GEMV (see the docstring)")
    ap.add_argument("--layers", type=int, default=8, help="distinct weight copies per chain")
    ap.add_argument("--reps", type=int, default=20, help="graph replays timed per variant")
    args = ap.parse_args(argv)
    dev = timing.require_cuda("bitcast_probe")
    print(f"bitcast_probe on {timing.card_line()}; torch {torch.__version__}", flush=True)
    if not probe_order(dev):
        raise SystemExit("bitcast_probe: the card's nibble order differs from quantize_int4_paired's packing")
    return bench_gemv(dev, args.layers, args.reps)


if __name__ == "__main__":
    main()
