"""The flash-attention backward's TMA plans and launch layout on the CPU
(`ops/flash_attention.py`): q, k, v and dout become tensor maps at the
backward's box rows for every layout the port passes (contiguous, views of
one packed qkv tensor, multiquery k/v expanded over heads, the contiguous
copy of a transposed gradient), the four plans pack as the C entry point
reads them, and the Python constants agree with the kernel source. The
kernels themselves run only on the card (tests/test_torch_ops.py, `gpu`)."""

import re
from pathlib import Path

import pytest
import torch

from supir_tpu_torch.ops import flash_attention as fa
from supir_tpu_torch.ops.flash_attention import BWD_BLOCK, BWD_BOX, PLAN_LEN, SLAB, bwd_rows, tma_plan
from torch_parity import one_torch_thread  # noqa: F401

BF16 = 2  # bytes
CSRC = Path(fa.__file__).resolve().parents[1] / "csrc"


def _source() -> str:
    return (CSRC / fa._BWD_SOURCE).read_text()


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("name", ["q", "k", "v", "dout"])
def test_contiguous_operands_plan_at_the_box_rows(name, d):
    n = 1000 if name in ("q", "dout") else 1500  # queries S, keys T
    plan = tma_plan(torch.empty(2, n, 3, d, dtype=torch.bfloat16), BWD_BOX)
    assert plan.dims == (d, n, 3, 2)
    assert plan.strides == (3 * d * BF16, d * BF16, n * 3 * d * BF16)
    assert plan.box == (SLAB, BWD_BOX, 1, 1)
    assert (plan.seq, plan.head, plan.batch) == (1, 2, 3)


@pytest.mark.parametrize("d", [64, 128])
def test_head_packed_views_plan_in_place(d):
    b, s, h = 2, 300, 4
    qkv = torch.empty(b, s, 3, h, d, dtype=torch.bfloat16)
    row = 3 * h * d * BF16
    for x in qkv.unbind(2):
        plan = tma_plan(x, BWD_BOX)
        assert plan.dims == (d, s, h, b) and plan.strides == (row, d * BF16, s * row)
        assert plan.box == (SLAB, BWD_BOX, 1, 1)


def test_expanded_multiquery_kv_drop_the_head_axis():
    k = torch.empty(2, 1100, 1, 128, dtype=torch.bfloat16).expand(2, 1100, 8, 128)
    plan = tma_plan(k, BWD_BOX)
    assert plan.dims == (128, 1100, 2) and plan.strides == (128 * BF16, 1100 * 128 * BF16)
    assert plan.box == (SLAB, BWD_BOX, 1)
    assert (plan.seq, plan.head, plan.batch) == (1, -1, 2)
    # dK and dV are then written per head into contiguous outputs
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    assert dk.shape == k.shape and dk.is_contiguous()


def test_contiguous_copy_of_a_transposed_gradient():
    # FlashAttention's backward passes dout.contiguous(); autograd may hand
    # it a gradient laid out [B, H, S, D] and transposed back
    grad = torch.empty(2, 4, 700, 64, dtype=torch.bfloat16).transpose(1, 2)
    assert not grad.is_contiguous()
    dout = grad.contiguous()
    plan = tma_plan(dout, BWD_BOX)
    assert plan.dims == (64, 700, 4, 2)
    assert plan.strides == (4 * 64 * BF16, 64 * BF16, 700 * 4 * 64 * BF16)
    # the transposed view itself has a head dim of stride 1 but a seq stride
    # of 64 elements and a head stride of 700 * 64: TMA takes it as well
    view = tma_plan(grad, BWD_BOX)
    assert view.dims == (64, 700, 4, 2) and view.strides == (64 * BF16, 700 * 64 * BF16, 4 * 700 * 64 * BF16)


def test_four_plans_pack_as_the_c_side_reads_them():
    q = torch.empty(1, 300, 4, 64, dtype=torch.bfloat16)
    k = torch.empty(1, 500, 1, 64, dtype=torch.bfloat16).expand(1, 500, 4, 64)
    plans = [tma_plan(x, BWD_BOX) for x in (q, k, k, q)]
    packed = fa._packed_plans(*plans)
    assert len(packed) == 4 * PLAN_LEN
    for i, plan in enumerate(plans):
        assert list(packed[i * PLAN_LEN:(i + 1) * PLAN_LEN]) == plan.packed()
    # k: rank 2 (batch 1 and the expanded head dropped), box (SLAB, BWD_BOX)
    assert list(packed[PLAN_LEN:2 * PLAN_LEN]) == [2, 64, 500, 0, 0, 128, 0, 0, SLAB, BWD_BOX, 0, 0, 1, -1, -1]
    assert fa._packed_plans(*plans) is packed  # cached by layout


def test_tile_constants_match_the_kernel_source():
    src = _source()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("BLOCK"), const("BOX")) == (BWD_BLOCK, BWD_BOX)
    # the dQ kernel's key tiles: 128 at D = 64, 64 at D = 128, whole boxes
    keys = re.search(r"KEYS = D == 64 \? (\d+) : (\d+);", src)
    assert keys and (int(keys.group(1)), int(keys.group(2))) == (2 * BWD_BOX, BWD_BOX)
    header = (CSRC / "flash_attn_tma.cuh").read_text()
    assert int(re.search(r"constexpr int SLAB = (\d+);", header).group(1)) == SLAB
    assert '#include "flash_attn_tma.cuh"' in src


@pytest.mark.parametrize("s,want", [(1, 128), (127, 128), (128, 128), (129, 256), (1100, 1152), (4096, 4096)])
def test_scratch_rows_pad_to_whole_blocks(s, want):
    # the lse/delta scratch: every block's rows and every 64-row slice in range
    assert bwd_rows(s) == want
    assert bwd_rows(s) % BWD_BLOCK == 0 and bwd_rows(s) % BWD_BOX == 0


def test_entry_point_takes_what_the_wrapper_passes():
    # the C signature: 11 pointers, B H S T D causal, the plans, the strides,
    # scale and stream; the wrapper passes 15 strides (out, dout, dq, dk, dv)
    sig = re.search(r'extern "C" int supir_flash_attn_bwd_bf16\((.*?)\)\s*\{', _source(), re.S).group(1)
    params = [p.strip() for p in sig.split(",")]
    assert len(params) == 11 + 6 + 2 + 2
    assert params[17].endswith("plans") and params[18].endswith("strides")
    assert "15 element strides" in _source()
    assert "nvcuda" not in _source() and "wgmma.mma_async" in (CSRC / "flash_attn_tma.cuh").read_text()


def test_ab_tool_exits_without_a_card(monkeypatch):
    from supir_tpu_torch.tools import flash_bwd_ab

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        flash_bwd_ab.main(["--reps", "1"])
    assert "no CUDA device" in str(exc.value.code)
