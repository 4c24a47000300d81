"""The captioner's training sampler (counterpart of
supir_tpu/captioner/data.py).

Behavioural contract: `llava/train/llava_trainer.py:33-130`, the
LengthGroupedSampler with modality grouping: multimodal and text-only
samples are shuffled apart, cut into megabatches sorted by length, and each
megabatch is split into world-size chunks of near-equal total length, so
every data-parallel rank gets a balanced batch. The draws are the JAX
module's, `np.random.default_rng(seed)` in the same order, so both packages
give the same lists. `rank_batches` takes its rank from the default
`torch.distributed` process group where one is initialised (JAX asks
`jax.process_index()`), else 0.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def split_to_even_chunks(indices: Sequence[int], lengths: Sequence[int], num_chunks: int):
    """Greedy balance of `indices` into `num_chunks` lists of near-equal
    total length (llava_trainer.py:33-55); a count that does not divide
    evenly deals them round-robin."""
    if len(indices) % num_chunks != 0:
        return [list(indices[i::num_chunks]) for i in range(num_chunks)]
    num_per = len(indices) // num_chunks
    chunks = [[] for _ in range(num_chunks)]
    loads = [0] * num_chunks
    for idx in indices:
        slot = int(np.argmin([l if len(c) < num_per else np.inf for l, c in zip(loads, chunks)]))
        chunks[slot].append(idx)
        loads[slot] += lengths[idx]
    return chunks


def length_grouped_indices(lengths: Sequence[int], batch_size: int, world_size: int, seed: int = 0,
                           group_by_modality: bool = True) -> List[int]:
    """Indices grouped by modality and length into world-even megabatches
    (llava_trainer.py:58-95). Multimodal samples carry positive lengths,
    text-only ones negative (the reference's convention)."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths)
    mega = batch_size * world_size

    def group(idx):
        idx = idx[rng.permutation(len(idx))]
        megabatches = [idx[i: i + mega] for i in range(0, len(idx), mega)]
        megabatches = [sorted(m.tolist(), key=lambda i: abs(int(lengths[i])), reverse=True) for m in megabatches]
        return [split_to_even_chunks(m, np.abs(lengths).tolist(), world_size) for m in megabatches]

    if group_by_modality and (lengths > 0).any() and (lengths < 0).any():
        batches = group(np.nonzero(lengths > 0)[0]) + group(np.nonzero(lengths < 0)[0])
    else:
        batches = group(np.arange(len(lengths)))

    out: List[int] = []
    for bi in rng.permutation(len(batches)):
        for chunk in batches[bi]:
            out.extend(chunk)
    return out


def default_rank() -> int:
    """The rank of this process in the default torch.distributed group, 0
    without one."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def rank_batches(lengths: Sequence[int], batch_size: int, world_size: int, rank: Optional[int] = None,
                 seed: int = 0) -> List[List[int]]:
    """The batches of index lists that `rank` (default: `default_rank()`)
    takes, one per whole megabatch of `batch_size * world_size` indices."""
    if rank is None:
        rank = default_rank()
    idx = length_grouped_indices(lengths, batch_size, world_size, seed)
    mega = batch_size * world_size
    return [idx[i: i + mega][rank * batch_size: (rank + 1) * batch_size]
            for i in range(0, len(idx) - mega + 1, mega)]
