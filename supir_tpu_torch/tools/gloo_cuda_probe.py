"""What gloo does with CUDA tensors, and how fast it moves host bytes, on
this machine's PyTorch.

    python -m supir_tpu_torch.tools.gloo_cuda_probe [--mib 256] [--reps 4]

Two gloo ranks share card 0, the layout of chip_smoke.py's `[multi-device]`
on a one-card machine.

1. Each collective that `parallel/mesh.py` uses (all_reduce, broadcast,
   all_gather, a send/recv pair) runs once on CUDA tensors, each in a
   spawn of its own: handed a device pointer it does not take, gloo's TCP
   transport fails (writev: Bad address) or aborts the process, and a
   collective that fails cannot take the next one with it. A collective is "taken" when it returns the right
   result on both ranks.
2. Bandwidth between the two ranks on `--mib` MiB of fp32, `--reps`
   times each: gloo's all_gather and a send/recv pair on host tensors, and
   the port's `mesh.all_gather` (a send/recv exchange split over the
   mesh line's lanes) on host tensors and on a CUDA tensor (staged through
   pinned host memory); GB/s received by a rank.

Prints one JSON object {"cuda": {collective: verdict}, "gb_per_s": {...}}.
`parallel/mesh.py` stages what gloo's send/recv is handed on a card.
Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

COLLECTIVES = ("all_reduce", "broadcast", "all_gather", "send/recv")


def _init(rank: int, world: int, tmp: str):
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'store')}", rank=rank, world_size=world)


def _collective(name: str, rank: int, world: int, x: torch.Tensor) -> bool:
    if name == "all_reduce":
        y = x.clone()
        dist.all_reduce(y)
        return bool((y == sum(range(1, world + 1))).all())
    if name == "broadcast":
        y = x.clone()
        dist.broadcast(y, 0)
        return bool((y == 1).all())
    if name == "all_gather":
        ys = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(ys, x)
        return all(bool((y == r + 1).all()) for r, y in enumerate(ys))
    y = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, (rank + 1) % world), dist.P2POp(dist.irecv, y, (rank - 1) % world)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return bool((y == (rank - 1) % world + 1).all())


def _collective_rank(rank: int, world: int, tmp: str, name: str):
    _init(rank, world, tmp)
    x = torch.full((1024,), float(rank + 1), device="cuda:0")
    ok = _collective(name, rank, world, x)
    torch.cuda.synchronize()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(ok, f)
    dist.destroy_process_group()


def _bandwidth_rank(rank: int, world: int, tmp: str, mib: int, reps: int):
    from supir_tpu_torch.parallel.mesh import all_gather, make_mesh

    _init(rank, world, tmp)
    group = make_mesh((world,), ("model",)).get_group("model")
    x = torch.ones(mib * 2**18)
    nbytes = x.numel() * 4 * (world - 1)  # received by one rank
    ys = [torch.empty_like(x) for _ in range(world)]
    peer = 1 - rank

    def pair():
        for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer), dist.P2POp(dist.irecv, ys[peer], peer)]):
            work.wait()

    xc = x.to("cuda:0")
    runs = {"gloo all_gather (host)": lambda: dist.all_gather(ys, x), "send/recv pair (host)": pair,
            "mesh.all_gather (host, lanes)": lambda: all_gather(x, group),
            "mesh.all_gather (CUDA, staged, lanes)": lambda: all_gather(xc, group)}
    out = {}
    for name, run in runs.items():
        run()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        out[name] = nbytes * reps / (time.perf_counter() - t) / 1e9
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _spawn(fn, *args):
    """Two ranks of fn; their JSON results, or the error that stopped them."""
    with tempfile.TemporaryDirectory() as tmp:
        try:
            mp.start_processes(fn, args=(2, tmp) + args, nprocs=2, join=True, start_method="spawn")
        except mp.ProcessExitedException as e:
            return f"the process died ({str(e).splitlines()[0][:100]})"
        except mp.ProcessRaisedException as e:
            return f"raised ({str(e).strip().splitlines()[-1][:100]})"
        out = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                out.append(json.load(f))
        return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mib", type=int, default=256)
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 1
    cuda = {}
    for name in COLLECTIVES:
        got = _spawn(_collective_rank, name)
        cuda[name] = got if isinstance(got, str) else ("taken" if all(got) else "wrong result")
    bw = _spawn(_bandwidth_rank, args.mib, args.reps)
    rates = bw if isinstance(bw, str) else {k: round(min(r[k] for r in bw), 3) for k in bw[0]}
    print(json.dumps({"cuda": cuda, "gb_per_s": rates, "mib": args.mib, "reps": args.reps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
