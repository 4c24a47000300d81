"""Device meshes and the collectives that run over their axes
(counterpart of supir_tpu/parallel/mesh.py).

Axis convention, as in the JAX package:
  data  - batch / CFG-duplicate data parallelism
  tile  - the tiles of the tiled VAE and the windows of tiled diffusion
  model - parameter sharding (parallel/sharding.py)
  seq   - the sequence of ring attention (parallel/ring_attention.py)

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over ranks of the
default process group, one process per rank (SPMD): every rank builds the
same meshes, in the same order, and runs the same code. The caller starts
the group and chooses its backend: NCCL with one rank per card, gloo for
the CPU and for ranks that share one card (NCCL refuses two ranks on one
device). `make_mesh(devices=[ranks])` builds a mesh over a subset of the
ranks (the engine and the captioner on disjoint ranks); a rank outside it
has no coordinate there (`in_mesh`).

gloo takes CUDA tensors in `all_reduce`, `broadcast` and `all_gather`;
handed a CUDA tensor, its send and receive fail in their TCP transport
(`tools/gloo_cuda_probe.py` asks the installed PyTorch). Its all-gather
moves fewer bytes a second between two processes of one host than a
send/recv pair does (0.47-0.82 against 0.81-1.34 GB/s on an H100
machine's host, PERF.md §5), so on gloo the port's all-gather is a
send/recv exchange between every pair of ranks, its bytes split over
LANES gloo groups that `make_mesh` opens beside each mesh line. The
helpers below (`all_gather`, `all_reduce_`, `ring_shift`, and the
trainers' `all_reduce_mean_` and its bucketed form
`all_reduce_mean_bucket`) are the port's one place that knows this: on a gloo group they stage a CUDA tensor bound
for send/recv through pinned host memory (PyTorch's caching host
allocator keeps the pinned blocks), and on NCCL or on the CPU they hand
the tensor over as it is. The compute stays on the card.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

LANES = 4                   # gloo groups that one exchange's bytes are split over
LANE_MIN_BYTES = 1 << 20    # the least bytes a lane carries
_LANES: dict = {}           # the global ranks of a mesh line -> its lanes (gloo groups over those ranks)


def make_mesh(axis_sizes: Optional[Tuple[int, ...]] = None, axis_names: Sequence[str] = ("data", "model"),
              devices: Optional[Sequence[int]] = None) -> DeviceMesh:
    """A mesh over `devices` (ranks of the default group, all of them by
    default) laid out row-major as `axis_sizes`; None puts every rank on
    the first axis. Its device type is "cuda" on an NCCL group (one rank
    per card) and "cpu" on gloo. Every rank must call it."""
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    if axis_sizes is None:
        axis_sizes = (len(ranks),) + (1,) * (len(axis_names) - 1)
    need = int(np.prod(axis_sizes))
    if need > len(ranks):
        raise ValueError(f"axis sizes {axis_sizes} need {need} devices, have {len(ranks)}")
    layout = torch.tensor(ranks[:need], dtype=torch.int64).reshape(tuple(axis_sizes))
    mesh = DeviceMesh("cuda" if dist.get_backend() == "nccl" else "cpu", layout, mesh_dim_names=tuple(axis_names))
    if dist.get_backend() == "gloo":
        for dim in range(layout.dim()):
            for line in layout.movedim(dim, -1).reshape(-1, layout.shape[dim]).tolist():
                if len(line) > 1 and tuple(line) not in _LANES:
                    _LANES[tuple(line)] = [dist.new_group(line, backend="gloo") for _ in range(LANES)]
    return mesh


def data_tile_model_mesh(dp: int, tile: int, model: int) -> DeviceMesh:
    return make_mesh((dp, tile, model), ("data", "tile", "model"))


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    """The size of `axis` in `mesh`; 1 where there is no mesh or no such axis."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def in_mesh(mesh: DeviceMesh) -> bool:
    """Whether this rank is one of the mesh's ranks."""
    return mesh.get_coordinate() is not None


def axis_group(mesh: DeviceMesh, axis: str):
    """(process group of this rank's line along `axis`, its size, this rank's index on it)."""
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), dist.get_rank(group)


def _staged(x: torch.Tensor, group) -> bool:
    """Whether x goes to gloo's send/recv, which takes no CUDA tensor."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _host(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return h.copy_(x)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's x (all of one shape) concatenated along `dim`, in the
    group's rank order: a tensor of its own, not a view."""
    n = dist.get_world_size(group)
    src = x.contiguous()
    staged = _staged(src, group)
    if staged:
        src = _host(src)
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype, device=src.device,
                      pin_memory=staged)
    parts = list(out.chunk(n))
    if dist.get_backend(group) == "gloo":
        _exchange(src, parts, group)
    else:
        dist.all_gather(parts, src, group=group)
    if staged:
        out = out.to(x.device)
    return torch.cat(out.chunk(n), dim=dim) if dim else out


def _send_recv(pairs, group) -> None:
    """For each (send tensor, peer it goes to, receive tensor, peer it
    comes from), peers by their index in `group`. On gloo the bytes are
    split over the lanes of the group's ranks, each lane a gloo group of
    its own with its own TCP connections: one connection moves 0.8 GB/s
    between two processes of the H100's host, and lanes add up
    (`tools/gloo_cuda_probe.py`)."""
    lanes = _LANES.get(tuple(dist.get_process_group_ranks(group)), [group])
    k = max(1, min(len(lanes), max(t.numel() * t.element_size() for t, _, _, _ in pairs) // LANE_MIN_BYTES))
    works = []
    for send, to, recv, frm in pairs:
        to, frm = dist.get_global_rank(group, to), dist.get_global_rank(group, frm)
        for lane, a, b in zip(lanes[:k], send.reshape(-1).chunk(k), recv.reshape(-1).chunk(k)):
            works += [dist.isend(a, to, group=lane), dist.irecv(b, frm, group=lane)]
    for work in works:
        work.wait()


def _exchange(src: torch.Tensor, parts, group) -> None:
    """parts[i] <- rank i's src, by one send and one receive between this
    rank and every other rank of the group."""
    r = dist.get_rank(group)
    parts[r].copy_(src)
    _send_recv([(src, peer, parts[peer], peer) for peer in range(dist.get_world_size(group)) if peer != r], group)


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum x over the group, in place (gloo takes CUDA tensors here)."""
    dist.all_reduce(x, group=group)
    return x


def all_reduce_mean_(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of x over the group, in place: a summed all-reduce divided
    by the group's size (gloo takes CUDA tensors here)."""
    dist.all_reduce(x, group=group)
    return x.div_(dist.get_world_size(group))


def all_reduce_mean_bucket(tensors, group) -> None:
    """`all_reduce_mean_` of every tensor of a bucket, in one collective a
    dtype: the tensors laid end to end, reduced, and copied back."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        all_reduce_mean_(flat, group)
        at = 0
        for t in ts:
            t.copy_(flat[at:at + t.numel()].view_as(t))
            at += t.numel()


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """x sent to the next rank of the group; the previous rank's x
    returned (JAX's ppermute j -> j + 1)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    src = x.contiguous()
    staged = _staged(src, group)
    if staged:
        src = _host(src)
    buf = torch.empty(src.shape, dtype=src.dtype, device=src.device, pin_memory=staged)
    if dist.get_backend(group) == "gloo":
        _send_recv([(src, (r + 1) % n, buf, (r - 1) % n)], group)
    else:
        ops = [dist.P2POp(dist.isend, src, dist.get_global_rank(group, (r + 1) % n), group),
               dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, (r - 1) % n), group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return buf.to(x.device) if staged else buf
