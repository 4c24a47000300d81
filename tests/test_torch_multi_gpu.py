"""The multi-device path on the card (`gpu`): ring attention on K3 blocks
and a sharded tiny restore, in two ranks spawned by tests/torch_ranks.py.

On one card the two ranks share it over gloo, whose all-gather and
point-to-point operations go through host memory (parallel/mesh.py); the
`multi_gpu` cases run NCCL with one rank per card and skip below two
cards. No JAX here: the card's machine has none.

Bounds: the ring against attention_plain in fp32 at K1's rel-L2 1e-2, two
K3 launches per rank (one block each); the sharded restore against the
same rank's unsharded run bit for bit (the gathered weights are the same
bits, and the kernels run on the same shapes).

    python -m pytest --noconftest tests/test_torch_multi_gpu.py -m gpu -q
"""

import numpy as np
import pytest
import torch

import torch_ranks
from torch_parity import one_torch_thread  # noqa: F401

RING_SHAPE = (2, 4096, 10, 64)  # two K3 blocks of [2, 2048, 10, 64] a rank
RING_BOUND = 1e-2
BACKENDS = {"one_card": "gloo", "multi_gpu": "nccl"}


def _needs(backend: str):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ring's blocks run on K3, which has no CPU mode")
    if backend == "nccl" and torch.cuda.device_count() < 2:
        pytest.skip("multi_gpu: NCCL with one rank per card needs two cards")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(BACKENDS))
def test_ring_on_k3_blocks_matches_plain(case, tmp_path):
    backend = BACKENDS[case]
    _needs(backend)
    for rank in torch_ranks.spawn(2, tmp_path, backend=backend, card_ring=dict(shape=RING_SHAPE, seed=3)).join():
        got = rank["card_ring"]
        assert got["rel"] <= RING_BOUND, got["rel"]
        assert got["launches"] == 2
        assert got["fp32"].startswith("TypeError") and "bf16" in got["fp32"]
        assert got["grad"].startswith("RuntimeError") and "no autograd rule" in got["grad"]


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(BACKENDS))
def test_sharded_tiny_restore_equals_one_rank_on_the_card(case, tmp_path):
    backend = BACKENDS[case]
    _needs(backend)
    ranks = torch_ranks.spawn(2, tmp_path, backend=backend, card_restore=dict(seed=5, steps=2)).join()
    for rank in ranks:
        got = rank["card_restore"]
        assert torch.isfinite(got["split"]).all()
        np.testing.assert_array_equal(got["split"].numpy(), got["one"].numpy())
    np.testing.assert_array_equal(ranks[0]["card_restore"]["split"].numpy(), ranks[1]["card_restore"]["split"].numpy())
