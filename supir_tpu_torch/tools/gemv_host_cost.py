"""The host's cost of one decode-GEMV call, K5 (RMSNorm prologue) and K7
(int8), from several source trees on one card, in turns: the tool that
shows a change of the GEMV wrappers does not add host time per launch.

Each variant is NAME=DIR, DIR the root of a source tree holding a
`supir_tpu_torch` package (`.` for this checkout; an older one unpacked
with `git archive` under the gitignored `build/`). Each variant runs in a
process of its own with DIR first on its path, so it imports its own
wrappers and builds its own kernels (into DIR/build/). A process warms the
wrapper up, then sums the host clock over `--calls` calls, each timed on
its own, with a synchronise every 10 calls (outside the timed spans) so
that the card's queue never fills and paces the host; rows 1, cin = cout =
512; it prints µs per call. The variants run in the order given, then in
reverse.

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


def child(calls: int) -> dict:
    """Time this tree's wrappers (run with the tree first on sys.path)."""
    import torch

    from supir_tpu_torch.ops import quantize as Q

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn(WIDTH, WIDTH, generator=g, device=dev) * WIDTH ** -0.5
    packed, scale = Q.quantize_int4_paired(w)
    q8, s8 = Q.quantize_int8(w, stochastic=False)
    x = torch.randn(1, WIDTH, generator=g, device=dev).to(torch.bfloat16)
    gamma = 1.0 + 0.1 * torch.randn(WIDTH, generator=g, device=dev)
    calls_of = {"K5": lambda: Q.int4_paired_fused_matmul(x, packed, scale, gamma=gamma),
                "K7": lambda: Q.int8_matmul(x, q8, s8)}
    out = {"package": str(Path(Q.__file__).resolve().parents[1])}
    for name, fn in calls_of.items():
        for _ in range(100):
            fn()
        host = 0.0
        for i in range(calls):
            if i % 10 == 0:
                torch.cuda.synchronize()  # the queue stays short: the card never paces the host
            t0 = time.perf_counter()
            fn()
            host += time.perf_counter() - t0
        torch.cuda.synchronize()
        out[name] = host / calls * 1e6
    return out


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
        print(f"[host cost] {name} ({reading['package']}): K5 {reading['K5']:.2f} us, K7 {reading['K7']:.2f} us "
              f"per call (host clock, {args.calls} calls, rows 1, {WIDTH} x {WIDTH})", flush=True)
    print(f"[host cost] card: {timing.card_line()}", flush=True)
    return results


if __name__ == "__main__":
    main()
