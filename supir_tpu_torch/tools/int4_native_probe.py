"""T4: the native int4 layout on the card, the counterpart of the JAX
package's `tools/int4_native_probe.py`.

  stage 1  the byte size of the port's native int4 buffer
           (ops/quantize.py:pack_int4_native, column pairs in uint8): a
           [4096, 4096] weight must take 8.4 MB, not 16.8. A host check: no
           kernel.
  stage 2  T4a's native cast (csrc/nibble_order.cu: column-pair-packed
           int4 [128, 128] -> bf16 x 2, each byte through nib2 of
           csrc/tc_decode.cuh, the decode of K11's native layout on the
           tensor-core body, then one packed doubling) against its plain
           version, bit for bit, on the TPU probe's values
           (arange % 7) and on every int4 value (-8..7): the probe's own
           values are never negative, so alone they cannot show a cast
           that drops the sign.
  stage 3  at down_proj's dims, [1, 13824] x [13824, 5120], chained over L
           distinct weight copies (timing.py; the TPU probe chained 8 calls
           on one 35.4 MB copy, which here would sit in the 50 MB L2): K7's
           half-split int4 ("packed-uint8") and the plain dequantize-and-
           matmul ("xla-int4-dot", no kernel); then, at 1 and 8 rows, T4b
           (the TPU probe's native_int4_matmul) on the tensor-core body of
           csrc/quant_gemv_tc.cu (K11's instances) at k-slices per strip of
           --slices and the plan's own, in turns (which slice count wins,
           and whether ops/gemv_plan.py:_choose_slices picked it), and in
           turns with T4b at the plan's slices the first design (K11's
           strip body at strip 256, int4_native_matmul(..., strip=256)) and
           tinygemm (torch._weight_int4pack_mm, the yardstick). ms per GEMV
           and GB/s.
It exits non-zero if stage 1 or 2 fails.

Run on the card: python -m supir_tpu_torch.tools.int4_native_probe
[--layers 8] [--reps 20] [--slices 1,2,4,8]
"""

from __future__ import annotations

import argparse

import torch

from supir_tpu_torch.tools import timing


def stage1_packing(dev) -> bool:
    from supir_tpu_torch.ops import quantize as Q

    packed = Q.pack_int4_native(torch.zeros(4096, 4096, dtype=torch.int8, device=dev))
    size = packed.numel() * packed.element_size()
    print(f"stage1: int4 4096x4096 (16.8M values) as column pairs: {size} bytes "
          f"({'packed' if size == 4096 * 4096 // 2 else 'NOT packed'})", flush=True)
    return size == 4096 * 4096 // 2


def stage2_cast(dev) -> bool:
    from supir_tpu_torch.ops import probes as P, quantize as Q

    ok = True
    arange = torch.arange(128 * 128, dtype=torch.int32).reshape(128, 128)
    for name, a in (("the TPU probe's values, 0..6", arange % 7), ("every int4 value, -8..7", arange % 16 - 8)):
        packed = Q.pack_int4_native(a.to(torch.int8)).to(dev)
        same = torch.equal(P.native_cast(packed).view(torch.int16), P.native_cast_plain(packed).view(torch.int16))
        print(f"stage2: native int4 block -> bf16 x 2 cast, {name}: {'OK' if same else 'MISMATCH'} (bit for bit)",
              flush=True)
        ok = ok and same
    return ok


def stage3_timing(dev, layers: int, reps: int, slices) -> dict:
    from supir_tpu_torch.ops import quantize as Q

    cin, cout = 13824, 5120
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(1, cin, generator=g, device=dev).to(torch.bfloat16)
    half, native = [], []
    for _ in range(layers):
        w = torch.randn(cin, cout, generator=g, device=dev) * 0.02
        half.append(Q.quantize_int4(w))
        native.append(Q.quantize_int4_native(w))
        del w
    per = cin * cout // 2
    results = {}
    for name, calls in (
        ("packed-uint8 (K7 half-split)", [lambda q=q, s=s: Q.int4_matmul(x, q, s) for q, s in half]),
        ("xla-int4-dot: plain (no kernel)", [lambda q=q, s=s: Q.int4_native_matmul_plain(x, q, s)
                                             for q, s in native[:4]]),
    ):
        ms = timing.chain_ms(calls, reps)
        results[name] = timing.report(f"stage3 {name}", ms, per, per * len(calls), note="per GEMV")
    del half
    # one scale for the copies, as the sweep takes it
    packed, scale = [q for q, _ in native], native[0][1]
    fn, _ = timing.tinygemm(Q.unpack_int4_native(packed[0]), scale)
    yard = [timing.tinygemm(Q.unpack_int4_native(q), scale)[1] for q in packed]
    for rows in (1, 8):
        xr = torch.randn(rows, cin, generator=g, device=dev).to(torch.bfloat16)
        extra = {"first design, K11 strip 256": [lambda q=q: Q.int4_native_matmul(xr, q, scale, strip=256)
                                                 for q in packed],
                 "tinygemm": [lambda w=w: fn(xr, *w) for w in yard]}
        found = timing.slices_sweep(f"stage3 T4b [{rows},{cin}]x[{cin},{cout}]", "native", packed, scale, xr, slices,
                                    reps, extra)
        results.update({f"{rows} rows {k}": v for k, v in found.items()})
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="T4: the native int4 layout (see the module's docstring)")
    ap.add_argument("--layers", type=int, default=8, help="distinct weight copies per chain")
    ap.add_argument("--reps", type=int, default=20, help="graph replays timed per variant")
    ap.add_argument("--slices", default="1,2,4,8", help="k-slices per strip to sweep (the plan's own is added)")
    args = ap.parse_args(argv)
    dev = timing.require_cuda("int4_native_probe")
    print(f"int4_native_probe on {timing.card_line()}; torch {torch.__version__}", flush=True)
    ok = stage1_packing(dev)
    ok = stage2_cast(dev) and ok
    results = stage3_timing(dev, args.layers, args.reps, [int(n) for n in args.slices.split(",")])
    if not ok:
        raise SystemExit("int4_native_probe: stage 1 or 2 failed")
    return results


if __name__ == "__main__":
    main()
