"""Geometries and ablations of the two cluster reductions, K2
(`csrc/group_norm.cu`) and K8 (`csrc/quantize_int8.cu`), on one card: the
measurements behind `ops/groupnorm.py:gn_plan`'s and
`ops/quantize.py:int8_plan`'s choices.

K2: at each shape, every cluster size from 2 to 16 beside the plan's
choice and the Triton first design, each timed by CUDA-graph replay of 10
calls (`timing.chain_ms`) three ways: x hot (the same x every call), cold
(copies of x that together exceed twice the L2), and after its producer
(each call preceded by the residual add that writes x, as at the restore
path's GroupNorm sites, less the adds alone: x as L2 holds it there).
Then ablations of pass 2 (scratch copies of the source with pass 2
walking forwards, or its stores evict-first), timed the same way.

K8: at cin 5120 and 13824, the plan beside other geometries (ranks,
threads a CTA, columns a tile), then ablations: scratch copies of the
source, each with one stage taken out (the quantization, the cluster
exchange of the column maxima, the stores) or the division made fast,
built under `build/reduce_ab/`; each timed by CUDA events in stochastic
and nearest mode. An ablation computes wrong bytes by design; every full
variant is held to the first design's bytes.

Run on the card: python -m supir_tpu_torch.tools.reduce_ab [--k2] [--k8]
(both without a flag).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from supir_tpu_torch.ops import cuda_build, groupnorm as G, quantize as Q
from supir_tpu_torch.tools import timing

K2_SHAPES = ((2, 320, 128, 128), (2, 960, 128, 128), (2, 1280, 64, 64), (2, 640, 64, 64), (2, 1280, 32, 32),
             (2, 640, 32, 32), (1, 512, 128, 128), (1, 512, 256, 256), (1, 128, 1024, 1024))
K8_SHAPES = ((5120, 15360), (13824, 5120))
# (name, the source text, its replacement): the streaming pass of K2 changed
K2_ABLATIONS = (
    ("pass 2 forwards", "const int base = (blocks - 1 - i) * step;  // backwards: the last block first\n"
     "    if (i != 0 || neighbour) {", "const int base = i * step;\n    if (true) {"),
    ("stores evict-first", "if (v < nvec) out[v] = normalise<T>(buf[u], first + v * VEC, a, mean, sc, sh);",
     "if (v < nvec) __stcs(out + v, normalise<T>(buf[u], first + v * VEC, a, mean, sc, sh));"),
)
# (name, the source text, its replacement): one stage of K8 taken out
K8_ABLATIONS = (
    ("without the quantization", "const int steps = (nrows + rps - 1) / rps;", "const int steps = 0;"),
    ("without the cluster exchange", "    cluster.sync();\n    // every (rank", "    __syncthreads();\n    // every (rank"),
    ("without the stores", "if (live && (tid & 3) == 0) *reinterpret_cast", "if (live && (tid & 3) == 0 && e < 0) *reinterpret_cast"),
    ("with a fast division", "const float scaled = w / fmaxf(s, 1e-12f);",
     "const float scaled = __fdividef(w, fmaxf(s, 1e-12f));"),
)


def _gn_case(shape, g):
    c = shape[1]
    view = (1, c) + (1,) * (len(shape) - 2)
    x = (torch.randn(shape, generator=g, device="cuda").clamp(-3, 3) * (0.5 + torch.rand(c, generator=g, device="cuda")
         ).view(view) + (2 * torch.rand(c, generator=g, device="cuda") - 1).view(view)).to(torch.bfloat16)
    return x, 1 + 0.1 * torch.randn(c, generator=g, device="cuda"), 0.1 * torch.randn(c, generator=g, device="cuda")


def _gn_call(lib, x, w, b, plan: G.GnPlan) -> torch.Tensor:
    """One launch of K2's C entry point in `lib` (x 16-byte aligned)."""
    y = torch.empty_like(x)
    err = lib.supir_group_norm(x.data_ptr(), y.data_ptr(), w.data_ptr(), b.data_ptr(), 1, 0, 0, plan.slab, plan.hw,
                               *plan.hw_div, plan.cg, 32, plan.nslabs, 1e-5, 1, plan.ranks, plan.part, plan.smem,
                               0, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise SystemExit(f"reduce_ab: K2 launch failed: {err}")
    return y


def _times(run, x, copies, a, r, add_ms):
    """(hot, cold, after the producer) ms per call of run(x) by graph replay."""
    hot = timing.chain_ms([lambda: run(x)] * 10)
    cold = timing.chain_ms([lambda c=c: run(c) for c in copies] * max(1, 10 // len(copies)))
    situ = timing.chain_ms([lambda: run(torch.add(a, r))] * 10) - add_ms
    return f"hot {hot:.4f} ms, cold {cold:.4f} ms, after the add {situ:.4f} ms"


def k2() -> None:
    g = torch.Generator(device="cuda").manual_seed(0)
    G.build_triton()
    libs = _ablated_libraries("group_norm.cu", K2_ABLATIONS, G._library(), "supir_group_norm")
    for shape in K2_SHAPES:
        x, w, b = _gn_case(shape, g)
        ncopy = max(2, -(-2 * timing.L2_BYTES // (x.numel() * x.element_size())))
        copies = [x.clone() for _ in range(ncopy)]
        # the residual add that writes x at a GroupNorm site: x = a + r
        a = (x.float() * 0.75).to(x.dtype)
        r = (x.float() - a.float()).to(x.dtype)
        add_ms = timing.chain_ms([lambda: torch.add(a, r)] * 10)
        want = G.group_norm_plain(x.float(), w, b, 32, 1e-5, True)
        plan = G.plan_for(x)
        cands = [("plan", plan)]
        for ranks in (2, 4, 8, 16):
            if ranks != plan.ranks:
                cands.append((f"{ranks} CTAs a cluster", G.gn_plan(shape, x.dtype, ranks=ranks)))
        print(f"[k2] {list(shape)} bf16, bound {timing.bound_ms(2 * x.numel() * x.element_size()):.4f} ms; the plan: "
              f"{plan.ranks} CTAs a cluster; the add alone {add_ms:.4f} ms", flush=True)
        for name, p in cands:
            def run(xx, p=p):
                return G._launch(xx, w, b, 32, 1e-5, True, p)

            err = (run(x).float() - want).abs().max().item()
            print(f"  {name:22s} {G.clusters(p, x.dtype):4d} clusters placed: {_times(run, x, copies, a, r, add_ms)} "
                  f"(max_abs_err {err:.1e})", flush=True)
        for name, lib in libs.items():
            def run(xx, lib=lib):
                return _gn_call(lib, xx, w, b, plan)

            err = (run(x).float() - want).abs().max().item()
            print(f"  {name:22s}                     {_times(run, x, copies, a, r, add_ms)} "
                  f"(max_abs_err {err:.1e})", flush=True)

        def old(xx):
            return G.group_norm_triton(xx, w, b, 32, 1e-5, True)

        print(f"  {'Triton pair':22s}                     {_times(old, x, copies, a, r, add_ms)}", flush=True)
        del x, copies, want, a, r
        torch.cuda.empty_cache()


def _events_ms(fn, n: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _geometry(cin: int, cout: int, cols: int, ranks: int, threads: int) -> Q.Int8Plan:
    rows = -(-cin // ranks)
    nboxes = -(-rows // Q.Q8_BOX_ROWS)
    box_rows = Q._box_rows(rows, nboxes, cols)
    return Q.Int8Plan(cin, cout, cols, ranks, rows, box_rows, nboxes, threads,
                      Q.int8_smem(cols, box_rows, nboxes, threads))


def _ablated_libraries(source: str, ablations, like: ctypes.CDLL, entry: str) -> dict:
    """Build each ablation's scratch copy of csrc/`source` (one nvcc each,
    in parallel) and load it with the C interface of `like`'s `entry`."""
    src = (cuda_build.CSRC / source).read_text()
    out = cuda_build.BUILD_DIR.parent / "reduce_ab"
    out.mkdir(parents=True, exist_ok=True)
    stem = source.rsplit(".", 1)[0]

    def build(i):
        name, old, new = ablations[i]
        if old not in src:
            raise SystemExit(f"reduce_ab: the ablation {name!r} no longer matches csrc/{source}")
        path = out / f"{stem}_ablation{i}.cu"
        path.write_text(src.replace(old, new))
        lib = out / f"lib{stem}_ablation{i}.so"
        proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC), "-o",
                               str(lib), str(path)], capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"reduce_ab: nvcc failed on {path.name}:\n{proc.stderr[-3000:]}")
        return lib

    with ThreadPoolExecutor(len(ablations)) as pool:
        paths = list(pool.map(build, range(len(ablations))))
    libs = {}
    for (name, _, _), path in zip(ablations, paths):
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = getattr(like, entry).argtypes
        libs[name] = lib
    return libs


def _launch(lib, w, q, scale, plan: Q.Int8Plan, stochastic: bool) -> None:
    err = lib.supir_quantize_int8(w.data_ptr(), plan.cin, plan.cout, plan.cols, plan.ranks, plan.rows, plan.box_rows,
                                  plan.nboxes, plan.threads, 1, int(stochastic), q.data_ptr(), scale.data_ptr(),
                                  plan.smem, 0, torch.cuda.current_stream().cuda_stream, None)
    if err != 0:
        raise SystemExit(f"reduce_ab: K8 launch failed: {err}")


def k8() -> None:
    g = torch.Generator(device="cuda").manual_seed(0)
    libs = _ablated_libraries("quantize_int8.cu", K8_ABLATIONS, Q._quant_library(), "supir_quantize_int8")
    for cin, cout in K8_SHAPES:
        w = torch.randn(cin, cout, generator=g, device="cuda") * cin ** -0.5
        q = torch.empty(cin, cout, dtype=torch.int8, device="cuda")
        scale = torch.empty(1, cout, device="cuda")
        plan = Q.int8_plan(cin, cout)
        first = Q.quantize_int8_first_design(w, seed=1)[0]
        print(f"[k8] [{cin},{cout}] fp32, bound {timing.bound_ms(5 * cin * cout):.4f} ms; first design "
              f"{_events_ms(lambda: Q.quantize_int8_first_design(w, seed=1)):.4f} ms (stochastic)", flush=True)
        variants = [("plan", plan)] + [
            (f"{cols} columns, {ranks} ranks, {threads} threads", _geometry(cin, cout, cols, ranks, threads))
            for cols, ranks, threads in ((32, 8, 512), (32, 16, 256), (32, 16, 512), (16, 8, 256))]
        lib = Q._quant_library()
        for name, p in variants:
            if p.smem > Q.Q8_SMEM_MAX or (name != "plan" and dataclasses.astuple(p) == dataclasses.astuple(plan)):
                continue
            _launch(lib, w, q, scale, p, True)
            same = torch.equal(q, first)
            st = _events_ms(lambda p=p: _launch(lib, w, q, scale, p, True))
            ne = _events_ms(lambda p=p: _launch(lib, w, q, scale, p, False))
            print(f"  {name:32s} smem {p.smem:6d} B: stochastic {st:.4f} ms, nearest {ne:.4f} ms, the first design's "
                  f"bytes {same}", flush=True)
        for name, ablated in libs.items():
            st = _events_ms(lambda a=ablated: _launch(a, w, q, scale, plan, True))
            ne = _events_ms(lambda a=ablated: _launch(a, w, q, scale, plan, False))
            print(f"  {name:32s}            stochastic {st:.4f} ms, nearest {ne:.4f} ms", flush=True)
        del w, q, first
        torch.cuda.empty_cache()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k2", action="store_true", help="K2's geometries only")
    ap.add_argument("--k8", action="store_true", help="K8's geometries and ablations only")
    args = ap.parse_args(argv)
    timing.require_cuda("reduce_ab")
    cuda_build.build_all(G.SOURCES + (Q._QUANT_SOURCE,))
    print(f"[reduce_ab] card: {timing.card_line()}", flush=True)
    if args.k2 or not args.k8:
        k2()
    if args.k8 or not args.k2:
        k8()


if __name__ == "__main__":
    main()
