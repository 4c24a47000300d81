"""Sharding rules: FSDP parameter sharding for inference, and the batch
split of data parallelism (counterpart of supir_tpu/parallel/sharding.py).

The rule is the JAX package's `_fsdp_spec` (:28-45): each tensor's largest
axis whose size is at least 2n and divisible by n, n the 'model' axis's
size, is split over that axis (ties go to the lowest index); a tensor with
no such axis stays whole on every rank. `fsdp_param_shardings` applies it
to every tensor of a module's state dict: parameters and persistent
buffers alike, so the captioner's quantized weight packs (buffers) shard
as the JAX agent's `params` tree shards them.

`shard_module` makes it real, as ZeRO-3 does for inference: each rank keeps
only its shard of every tensor the rule splits, and the full tensor exists
only while it is in use. Each such tensor becomes a `torch.nn.utils.
parametrize` parametrization whose value comes from an all-gather of the
shards over the 'model' group (`mesh.all_gather`, staged through host
memory on gloo). The tree is cut into gathering units, the largest
subtrees holding at most UNIT_BYTES of such tensors (a UNet block, a Llama
layer, the VAE, an embedding table): the first read of a tensor of a unit
gathers the whole unit in one collective, later reads take the gathered
tensors, and a unit is freed when a third one is gathered (CACHED_UNITS).
Gathering on read, not around a module's forward, keeps every caller
right: the fused-glue Llama block reads its projections' packs,
`fused_pair_decode_step` reads two layers at once, the LM head is read by
its parent, the engine calls the VAE through methods that are not its
forward, the staged tiled VAE calls a block's parts one by one. One
collective a unit and not one a tensor: two ranks that share one card pay
a context switch for every copy between host and card (PERF.md §5).
FSDP2's `fully_shard` would not do: it shards parameters only, not the
captioner's quantized packs, which are buffers. Ranks must read in the
same order, as SPMD code does. The module's state-dict keys change
(`parametrizations.<name>.original`), so a sharded module loads no state
dict; shard after loading the weights.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.nn.utils import parametrize

from supir_tpu_torch.parallel.mesh import all_gather, axis_group, axis_size

Spec = Tuple[Optional[str], ...]  # per dimension: the mesh axis it is split over, or None


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A tensor's layout over a mesh (JAX's NamedSharding): dimension i is
    split over the mesh axis spec[i], or whole where spec[i] is None (or
    past the spec's end)."""

    mesh: object
    spec: Spec

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the full tensor x."""
        for dim, axis in enumerate(self.spec):
            if axis is not None:
                n = axis_size(self.mesh, axis)
                x = x.chunk(n, dim)[self.mesh.get_local_rank(axis)]
        return x

    def local_nbytes(self, shape, itemsize: int) -> int:
        """Bytes of one rank's block of a tensor of `shape`."""
        n = 1
        for dim, axis in enumerate(self.spec):
            n *= 1 if axis is None else axis_size(self.mesh, axis)
        numel = 1
        for d in shape:
            numel *= d
        return numel // n * itemsize


def replicated(mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharding(mesh, ndim: int, axis: str = "data") -> Sharding:
    """Split the leading (batch) dim over `axis`, the rest whole."""
    return Sharding(mesh, (axis,) + (None,) * (ndim - 1))


def fsdp_spec(shape, model_size: int) -> Spec:
    """The largest axis of `shape` at least 2 * model_size long and
    divisible by model_size, over 'model'; () (whole) where none is, or
    model_size <= 1. Small tensors (biases, norm scales) stay whole:
    splitting them costs more in collective latency than it saves."""
    if model_size <= 1 or not shape:
        return ()
    for d in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[d] >= 2 * model_size and shape[d] % model_size == 0:
            return tuple("model" if i == d else None for i in range(len(shape)))
    return ()


def fsdp_param_shardings(module: nn.Module, mesh) -> Dict[str, Sharding]:
    """A Sharding for every tensor of module's state dict, by its key."""
    n = axis_size(mesh, "model")
    return {k: Sharding(mesh, fsdp_spec(tuple(v.shape), n)) for k, v in module.state_dict(keep_vars=True).items()}


UNIT_BYTES = 1 << 30  # the largest gathering unit, in full bytes of its sharded tensors
CACHED_UNITS = 2      # units kept gathered: the one being read and the one before it


class _Gathered(nn.Module):
    """The full tensor from this rank's shard: its unit's all-gather over
    the 'model' group, a tensor of its own carrying the shard's
    requires_grad flag, as the unsharded tensor did: PyTorch's matmul
    picks its kernel by that flag (it folds a strided 3-D input against a
    weight that requires grad, and sums in another order when it does
    not, or when the weight is a view), and a sharded module computes what
    the unsharded one does, bit for bit. No gradient reaches the shard."""

    def __init__(self, dim: int, unit: "_Unit"):
        super().__init__()
        self.dim = dim
        self.unit = unit

    def forward(self, shard: torch.Tensor) -> torch.Tensor:
        return self.unit.full(self)


class _Unit:
    """A subtree whose sharded tensors are gathered together: one
    all-gather of all their shards' bytes (each 16-byte aligned), each full
    tensor then cut out of it and laid together along its split dim. The
    `cache` of the tree keeps the last CACHED_UNITS units gathered."""

    def __init__(self, group, cache: "collections.OrderedDict"):
        self.group = group
        self.cache = cache
        self.members = []  # [(_Gathered, its shard)]

    def full(self, g: _Gathered) -> torch.Tensor:
        got = self.cache.get(self)
        if got is None:
            got = self.cache[self] = self._gather()
            while len(self.cache) > CACHED_UNITS:
                self.cache.popitem(last=False)
        else:
            self.cache.move_to_end(self)
        return got[g]

    def _gather(self) -> dict:
        pieces, spans, at = [], [], 0
        for _, shard in self.members:
            b = shard.detach().reshape(-1).view(torch.uint8)
            pad = -b.numel() % 16
            spans.append((at, b.numel()))
            pieces.append(torch.cat([b, b.new_zeros(pad)]) if pad else b)
            at += b.numel() + pad
        flat = torch.cat(pieces) if len(pieces) > 1 else pieces[0]
        n = dist.get_world_size(self.group)
        every = all_gather(flat, self.group).view(n, flat.numel())
        out = {}
        for (g, shard), (off, nb) in zip(self.members, spans):
            parts = [every[r, off:off + nb].view(shard.dtype).view(shard.shape) for r in range(n)]
            out[g] = torch.cat(parts, dim=g.dim).requires_grad_(shard.requires_grad)
        return out


def _units(module: nn.Module, sizes: Dict[int, int], limit: int) -> Dict[int, nn.Module]:
    """{id(owner): the unit module} for every owner of a sharded tensor:
    the largest subtree holding it with at most `limit` full bytes of
    sharded tensors, or the owner itself."""
    def subtree(m):
        return sizes.get(id(m), 0) + sum(subtree(c) for name, c in m.named_children() if name != "parametrizations")

    out = {}

    def walk(m, unit):
        if unit is None and subtree(m) <= limit:
            unit = m
        if id(m) in sizes:
            out[id(m)] = unit if unit is not None else m
        for name, child in m.named_children():
            if name != "parametrizations":
                walk(child, unit)

    walk(module, None)
    return out


def _owner(module: nn.Module, key: str):
    *path, name = key.split(".")
    for p in path:
        module = getattr(module, p)
    return module, name


@torch.no_grad()
def shard_module(module: nn.Module, mesh, axis: str = "model") -> nn.Module:
    """Keep only this rank's shard of every tensor of `module` that
    `fsdp_spec` splits over `axis`; each read of such a tensor gathers it.
    Every rank of the mesh calls it on the same module, in the same state."""
    n = axis_size(mesh, axis)
    if n <= 1:
        return module
    group, _, rank = axis_group(mesh, axis)
    plan = []
    for key, tensor in module.state_dict(keep_vars=True).items():
        spec = fsdp_spec(tuple(tensor.shape), n)
        if spec:
            plan.append((key, tensor, spec.index("model")))
    sizes: Dict[int, int] = {}
    for key, tensor, _ in plan:
        owner = _owner(module, key)[0]
        sizes[id(owner)] = sizes.get(id(owner), 0) + tensor.numel() * tensor.element_size()
    unit_of = _units(module, sizes, UNIT_BYTES)
    cache: collections.OrderedDict = collections.OrderedDict()
    units: Dict[int, _Unit] = {}
    for key, tensor, dim in plan:
        owner, name = _owner(module, key)
        shard = tensor.detach().chunk(n, dim)[rank].clone()
        if name in owner._parameters:
            owner._parameters[name] = nn.Parameter(shard, requires_grad=tensor.requires_grad)
        else:
            owner._buffers[name] = shard
        unit = units.setdefault(id(unit_of[id(owner)]), _Unit(group, cache))
        gathered = _Gathered(dim, unit)
        parametrize.register_parametrization(owner, name, gathered, unsafe=True)
        unit.members.append((gathered, owner.parametrizations[name].original))
    return module
