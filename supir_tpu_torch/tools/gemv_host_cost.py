"""The host's cost of one decode-GEMV call, K5 (RMSNorm prologue, also in
its act_int8 mode), K7 (int8 and half-split int4), K10 (its wrapper with
the torch activation quantizer, and the kernel alone on int8 x) and K11
(native int4), and the card's time of K5 (both modes), K6, K7 (int8,
int4), K10 (the kernel alone, and the wrapper) and K11 over one 13B decode
layer, from several source trees on one card, in turns: the tool that
shows a change of the GEMV wrappers or kernels adds no host time per
launch and slows no other kernel.

Each variant is NAME=DIR, DIR the root of a source tree holding a
`supir_tpu_torch` package (`.` for this checkout; an older one unpacked
with `git archive` under the gitignored `build/`). Each variant runs in a
process of its own with DIR first on its path, so it imports its own
wrappers and builds its own kernels (into DIR/build/). A process warms the
wrapper up, then sums the host clock over `--calls` calls, each timed on
its own, with a synchronise every 10 calls (outside the timed spans) so
that the card's queue never fills and paces the host; rows 1, cin = cout =
512; it prints µs per call. Then the device time of one 13B layer's four
projections (qkv, o, gate-up, down) at 1 row, each chained through one CUDA
graph over weight copies that together exceed twice the L2 (timing.py),
K5 in each projection's form (RMSNorm, residual, RMSNorm, SiLU-GLU and
residual) in both modes; it prints ms per layer. The variants run in the order given,
then in reverse.

Run on the card: python -m supir_tpu_torch.tools.gemv_host_cost
--variant new=. --variant old=build/old [--calls 1000]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

WIDTH = 512  # cin = cout: the card's time per call stays well under the host's
# one 13B decode layer: projection, cin, cout, K5's prologue, K5's residual
LAYER = (("qkv", 5120, 15360, "norm", False), ("o", 5120, 5120, None, True),
         ("gateup", 5120, 27648, "norm", False), ("down", 13824, 5120, "siluglu", True))


def host_us(fn, calls: int, warmup: int = 100) -> float:
    """The host's microseconds per call of fn(): after `warmup` calls, the
    host clock summed over `calls` calls each timed on its own, with a
    synchronise every 10 calls outside the timed spans (the queue stays
    short: the card never paces the host)."""
    import torch

    for _ in range(warmup):
        fn()
    host = 0.0
    for i in range(calls):
        if i % 10 == 0:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host += time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / calls * 1e6


def child(calls: int) -> dict:
    """Time this tree's wrappers (run with the tree first on sys.path)."""
    import torch

    from supir_tpu_torch.ops import quantize as Q

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn(WIDTH, WIDTH, generator=g, device=dev) * WIDTH ** -0.5
    packed, scale = Q.quantize_int4_paired(w)
    q8, s8 = Q.quantize_int8(w, stochastic=False)
    q4, s4 = Q.quantize_int4(w)
    qn, sn = Q.quantize_int4_native(w)
    x = torch.randn(1, WIDTH, generator=g, device=dev).to(torch.bfloat16)
    xq, xs = Q.quantize_act_int8(x)
    gamma = 1.0 + 0.1 * torch.randn(WIDTH, generator=g, device=dev)
    calls_of = {"K5": lambda: Q.int4_paired_fused_matmul(x, packed, scale, gamma=gamma),
                "K5 act_int8": lambda: Q.int4_paired_fused_matmul(x, packed, scale, gamma=gamma, act_int8=True),
                "K7": lambda: Q.int8_matmul(x, q8, s8), "K7 int4": lambda: Q.int4_matmul(x, q4, s4),
                "K10": lambda: Q.int4_w4a8_matmul(x, packed, scale),
                "K10 kernel": lambda: Q._launch_w4a8(xq, xs, packed, scale),
                "K11": lambda: Q.int4_native_matmul(x, qn, sn)}
    out = {"package": str(Path(Q.__file__).resolve().parents[1])}
    for name, fn in calls_of.items():
        out[name] = host_us(fn, calls)
    out["device"] = layer_ms(dev)
    return out


def layer_ms(dev, reps: int = 20) -> dict:
    """Device ms of each GEMV over one 13B layer's four projections at 1 row."""
    import torch

    from supir_tpu_torch.ops import quantize as Q
    from supir_tpu_torch.tools import timing

    g = torch.Generator(device=dev).manual_seed(1)
    total = dict.fromkeys(("K5", "K5 act_int8", "K6", "K7", "K7 int4", "K10", "K10 wrapper", "K11"), 0.0)
    for _, cin, cout, prologue, with_residual in LAYER:
        w = torch.randn(cin, cout, generator=g, device=dev) * cin ** -0.5
        x = torch.randn(1, 2 * cin if prologue == "siluglu" else cin, generator=g, device=dev).to(torch.bfloat16)
        xg = x[:, :cin].contiguous()
        kw = dict(gamma=1.0 + 0.1 * torch.randn(cin, generator=g, device=dev) if prologue == "norm" else None,
                  siluglu=prologue == "siluglu",
                  residual=torch.randn(1, cout, generator=g, device=dev) if with_residual else None)
        paired = Q.quantize_int4_paired(w)
        xq, xs = Q.quantize_act_int8(xg)
        layouts = {"K5": (paired, lambda q, s: Q.int4_paired_fused_matmul(x, q, s, **kw)),
                   "K5 act_int8": (paired, lambda q, s: Q.int4_paired_fused_matmul(x, q, s, act_int8=True, **kw)),
                   "K6": (paired, lambda q, s: Q.int4_paired_matmul(xg, q, s)),
                   "K10": (paired, lambda q, s, xq=xq, xs=xs: Q._launch_w4a8(xq, xs, q, s)),
                   "K10 wrapper": (paired, lambda q, s: Q.int4_w4a8_matmul(xg, q, s)),
                   "K7": (Q.quantize_int8(w, stochastic=False), lambda q, s: Q.int8_matmul(xg, q, s)),
                   "K7 int4": (Q.quantize_int4(w), lambda q, s: Q.int4_matmul(xg, q, s)),
                   "K11": (Q.quantize_int4_native(w), lambda q, s: Q.int4_native_matmul(xg, q, s))}
        del w
        for name, ((q, s), fn) in layouts.items():
            copies = [(q, s)] + [(q.clone(), s) for _ in range(int(2 * timing.L2_BYTES // q.nbytes))]
            total[name] += timing.chain_ms([lambda c=c, fn=fn: fn(*c) for c in copies], reps)
            del copies
        torch.cuda.empty_cache()
    return total


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", required=True, help="NAME=DIR, DIR a source tree's root")
    ap.add_argument("--calls", type=int, default=1000)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.calls)), flush=True)
        return {}
    from supir_tpu_torch.tools import timing

    timing.require_cuda("gemv_host_cost")
    variants = dict(v.split("=", 1) for v in args.variant)
    results = {name: [] for name in variants}
    for name in list(variants) + list(reversed(variants)):
        root = Path(variants[name]).resolve()
        env = dict(os.environ, PYTHONPATH=str(root))
        # this file by path: the tree on PYTHONPATH supplies `supir_tpu_torch`
        # (an older tree need not hold this tool)
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child", "--variant", "x=.",
                               "--calls", str(args.calls)], cwd=root, env=env, capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"gemv_host_cost: variant {name} failed:\n{proc.stderr[-4000:]}")
        reading = json.loads(proc.stdout.strip().splitlines()[-1])
        results[name].append(reading)
        each = ", ".join(f"{k} {v:.2f} us" for k, v in reading.items() if k not in ("package", "device"))
        print(f"[host cost] {name} ({reading['package']}): {each} per call (host clock, {args.calls} calls, rows 1, "
              f"{WIDTH} x {WIDTH})", flush=True)
        each = ", ".join(f"{k} {v:.4f} ms" for k, v in reading["device"].items())
        print(f"[device] {name}: {each} over one 13B layer's four projections, 1 row (CUDA graph over weight "
              f"copies beyond twice the L2)", flush=True)
    print(f"[host cost] card: {timing.card_line()}", flush=True)
    return results


if __name__ == "__main__":
    main()
