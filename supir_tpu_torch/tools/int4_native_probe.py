"""T4: the native int4 layout on the card, the counterpart of the JAX
package's `tools/int4_native_probe.py`.

  stage 1  the byte size of the port's native int4 buffer
           (ops/quantize.py:pack_int4_native, column pairs in uint8): a
           [4096, 4096] weight must take 8.4 MB, not 16.8. A host check: no
           kernel.
  stage 2  T4a's native cast (csrc/probes.cu: column-pair-packed int4
           [128, 128] -> bf16 x 2, one packed conversion per byte) against
           its plain version, bit for bit, on the TPU probe's values
           (arange % 7) and on every int4 value (-8..7): the probe's own
           values are never negative, so alone they cannot show a cast
           that drops the sign.
  stage 3  at down_proj's dims, [1, 13824] x [13824, 5120], chained over L
           distinct weight copies (timing.py; the TPU probe chained 8 calls
           on one 35.4 MB copy, which here would sit in the 50 MB L2): K7's
           half-split int4 ("packed-uint8"), K11 at strip 256 (the TPU
           probe's native_int4_matmul at bout 256, T4b) and at the default
           geometry (the model paths' tensor-core body, csrc/
           quant_gemv_tc.cu), and the plain dequantize-and-matmul
           ("xla-int4-dot", no kernel). ms per GEMV and GB/s.
It exits non-zero if stage 1 or 2 fails.

Run on the card: python -m supir_tpu_torch.tools.int4_native_probe
[--layers 8] [--reps 20]
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


def stage3_timing(dev, layers: int, reps: int) -> dict:
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
        ("native-int4 strip 256 (K11)", [lambda q=q, s=s: Q.int4_native_matmul(x, q, s, strip=256) for q, s in native]),
        ("native-int4 tensor-core body (K11)", [lambda q=q, s=s: Q.int4_native_matmul(x, q, s) for q, s in native]),
        ("xla-int4-dot: plain (no kernel)", [lambda q=q, s=s: Q.int4_native_matmul_plain(x, q, s)
                                             for q, s in native[:4]]),
    ):
        ms = timing.chain_ms(calls, reps)
        results[name] = timing.report(f"stage3 {name}", ms, per, per * len(calls), note="per GEMV")
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="T4: the native int4 layout (see the module's docstring)")
    ap.add_argument("--layers", type=int, default=8, help="distinct weight copies per chain")
    ap.add_argument("--reps", type=int, default=20, help="graph replays timed per variant")
    args = ap.parse_args(argv)
    dev = timing.require_cuda("int4_native_probe")
    print(f"int4_native_probe on {timing.card_line()}; torch {torch.__version__}", flush=True)
    ok = stage1_packing(dev)
    ok = stage2_cast(dev) and ok
    results = stage3_timing(dev, args.layers, args.reps)
    if not ok:
        raise SystemExit("int4_native_probe: stage 1 or 2 failed")
    return results


if __name__ == "__main__":
    main()
