"""The flash-attention forward's TMA plans (`ops/flash_attention.py:tma_plan`),
on the CPU: how q, k and v of every layout the port passes (contiguous, views
of one packed qkv tensor, multiquery k/v expanded over heads with stride 0)
become tensor maps, and what TMA cannot take is refused in Python before a
launch. The kernel that reads the maps runs only on the card
(tests/test_torch_ops.py, `gpu`)."""

import re
from pathlib import Path

import pytest
import torch

from supir_tpu_torch.ops import flash_attention as fa
from supir_tpu_torch.ops.flash_attention import BLOCK_M, BLOCK_N, PLAN_LEN, SLAB, tma_plan
from torch_parity import one_torch_thread  # noqa: F401

BF16 = 2  # bytes


@pytest.mark.parametrize("d", [64, 128])
def test_contiguous_plan(d):
    x = torch.empty(2, 1000, 3, d, dtype=torch.bfloat16)
    plan = tma_plan(x, BLOCK_M)
    assert plan.dims == (d, 1000, 3, 2)
    assert plan.strides == (3 * d * BF16, d * BF16, 1000 * 3 * d * BF16)
    assert plan.box == (SLAB, BLOCK_M, 1, 1)
    assert (plan.seq, plan.head, plan.batch) == (1, 2, 3)


@pytest.mark.parametrize("d", [64, 128])
def test_box_and_slabs_per_head_dim(d):
    # one 128-byte swizzle slab per copy: 64 columns at either head dim, so
    # D = 128 takes two copies a tile
    plan = tma_plan(torch.empty(1, 300, 2, d, dtype=torch.bfloat16), BLOCK_N)
    assert plan.box[0] * BF16 == 128
    assert plan.dims[0] // plan.box[0] == d // SLAB
    assert plan.box[1] == BLOCK_N


@pytest.mark.parametrize("d", [64, 128])
def test_packed_qkv_views(d):
    b, s, h = 2, 300, 4
    qkv = torch.empty(b, s, 3, h, d, dtype=torch.bfloat16)
    row = 3 * h * d * BF16
    for i, x in enumerate(qkv.unbind(2)):
        plan = tma_plan(x, BLOCK_M)
        assert x.data_ptr() - qkv.data_ptr() == i * h * d * BF16
        assert plan.dims == (d, s, h, b)
        assert plan.strides == (row, d * BF16, s * row)
        assert (plan.seq, plan.head, plan.batch) == (1, 2, 3)


def test_expanded_head_axis_is_dropped():
    # MPT's multiquery k/v: one head expanded over H with stride 0
    k = torch.empty(2, 500, 1, 128, dtype=torch.bfloat16).expand(2, 500, 8, 128)
    assert k.stride(2) == 0
    plan = tma_plan(k, BLOCK_N)
    assert plan.dims == (128, 500, 2)
    assert plan.strides == (128 * BF16, 500 * 128 * BF16)
    assert plan.box == (SLAB, BLOCK_N, 1)
    assert (plan.seq, plan.head, plan.batch) == (1, -1, 2)
    assert 0 not in plan.strides


def test_extent_one_axes_are_dropped():
    # batch 1 and the expanded head: only (D, seq) is left, a rank-2 map
    k = torch.empty(1, 500, 1, 64, dtype=torch.bfloat16).expand(1, 500, 8, 64)
    plan = tma_plan(k, BLOCK_N)
    assert plan.dims == (64, 500) and plan.strides == (64 * BF16,)
    assert (plan.seq, plan.head, plan.batch) == (1, -1, -1)


def test_packed_layout_matches_the_c_side():
    plan = tma_plan(torch.empty(1, 300, 1, 64, dtype=torch.bfloat16).expand(1, 300, 4, 64), BLOCK_N)
    packed = plan.packed()
    assert len(packed) == PLAN_LEN
    # rank, dims[4], strides[3], box[4], then the seq, head and batch positions
    assert packed == [2, 64, 300, 0, 0, 128, 0, 0, SLAB, BLOCK_N, 0, 0, 1, -1, -1]


def test_tile_constants_match_the_kernel_source():
    # the forward's source and the header it shares with the backward
    csrc = Path(fa.__file__).resolve().parents[1] / "csrc"
    src = (csrc / fa._FWD_SOURCE).read_text() + (csrc / "flash_attn_tma.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("BM"), const("BN"), const("SLAB"), const("PLAN_LEN")) == (BLOCK_M, BLOCK_N, SLAB, PLAN_LEN)


def test_refuses_a_two_byte_offset_view():
    flat = torch.empty(300 * 2 * 64 + 8, dtype=torch.bfloat16)
    x = flat[1:1 + 300 * 2 * 64].view(1, 300, 2, 64)
    assert x.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16-byte aligned"):
        tma_plan(x, BLOCK_M)


@pytest.mark.parametrize("pad", [4, 68])
def test_refuses_a_stride_not_a_multiple_of_16_bytes(pad):
    # the head stride is 64 + pad elements: 136 or 264 bytes
    x = torch.empty(2, 300, 2, 64 + pad, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        tma_plan(x, BLOCK_M)


def test_refuses_a_strided_head_dim():
    x = torch.empty(1, 300, 2, 128, dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="contiguous D"):
        tma_plan(x, BLOCK_M)
