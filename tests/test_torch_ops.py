"""supir_tpu_torch kernels (K1 flash attention, K2 GroupNorm+SiLU) against
the JAX package's Pallas kernels, run in interpret mode on the CPU.

On the CPU each wrapper returns its plain PyTorch version, so these tests
hold the plain versions to the Pallas kernels at atol 2e-5 (fp32, the bound
of tests/test_flash_attention.py and tests/test_groupnorm_kernel.py), and
check that a CPU tensor never reaches a kernel. The kernels themselves are
held to their plain versions on the card by the tests marked `gpu`. JAX is
imported inside the parity tests only, so the `gpu` tests also run on a
machine without it: python -m pytest --noconftest tests/test_torch_ops.py -m gpu
"""

import numpy as np
import pytest
import torch

from supir_tpu_torch.ops import attention as attn_ops
from supir_tpu_torch.ops.flash_attention import attention_plain, flash_attention
from supir_tpu_torch.ops.groupnorm import group_norm, group_norm_plain


def _qkv(seed, b, s, t, h, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, t, h, d), (b, t, h, d)))


@pytest.mark.parametrize("s,t,bq,bkv", [
    (256, 256, 128, 128),   # packed kernel, two kv blocks (online softmax)
    (128, 128, 128, 128),   # packed single-block kernel (closed form)
    (300, 300, 128, 128),   # ragged: the last kv block is masked
])
def test_flash_plain_matches_pallas(s, t, bq, bkv):
    import jax.numpy as jnp

    from supir_tpu.ops.flash_attention import flash_attention as jax_flash_attention

    q, k, v = _qkv(0, 2, s, t, 4, 64)
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               bq=bq, bkv=bkv, interpret=True)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("shape,silu,eps", [
    ((2, 8, 8, 64), True, 1e-5),
    ((2, 8, 8, 64), False, 1e-5),
    ((1, 7, 9, 96), True, 1e-6),
    ((1, 16, 16, 32), False, 1e-6),
])
def test_group_norm_plain_matches_pallas(shape, silu, eps):
    import jax.numpy as jnp

    from supir_tpu.ops.groupnorm import group_norm_silu

    rng = np.random.default_rng(1)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    c = shape[-1]
    gamma = rng.standard_normal(c).astype(np.float32)
    beta = rng.standard_normal(c).astype(np.float32)
    want = group_norm_silu(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), groups=32,
                           eps=eps, apply_silu=silu, block_rows=64, interpret=True)
    x_nchw = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))
    got = group_norm(x_nchw, torch.from_numpy(gamma), torch.from_numpy(beta), 32, eps, silu)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), np.asarray(want), atol=2e-5)


def test_routing_follows_the_jax_auto_mode():
    assert attn_ops.flash_eligible(4096, 4096, 64)
    assert attn_ops.flash_eligible(1024, 1024, 128)
    assert not attn_ops.flash_eligible(4096, 77, 64)       # text cross-attention
    assert not attn_ops.flash_eligible(16384, 16384, 512)  # VAE mid-block head
    assert not attn_ops.flash_eligible(1023, 4096, 64)


def test_cpu_tensors_never_reach_a_kernel():
    flash_attention.launches = 0
    group_norm.launches = 0
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 1, 1024, 1024, 2, 64))
    out = attn_ops.attention(q, k, v)
    torch.testing.assert_close(out, attention_plain(q, k, v), rtol=0, atol=0)
    x = torch.randn(1, 64, 4, 4)
    w, b = torch.ones(64), torch.zeros(64)
    torch.testing.assert_close(group_norm(x, w, b, 32, 1e-5, True),
                               group_norm_plain(x, w, b, 32, 1e-5, True), rtol=0, atol=0)
    assert flash_attention.launches == 0
    assert group_norm.launches == 0


def test_group_norm_plain_keeps_dtype():
    x = torch.randn(2, 64, 4, 4).to(torch.bfloat16)
    y = group_norm_plain(x, torch.ones(64), torch.zeros(64), 32, 1e-5, True)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape


# ----------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,t,h,d", [
    (2, 4096, 4096, 10, 64),
    (2, 1024, 1024, 20, 64),
    (1, 1100, 1100, 4, 64),
    (1, 1024, 2000, 2, 128),
])
def test_flash_kernel_matches_plain(cuda, b, s, t, h, d):
    # the outputs are small (max below 1), so the bound is relative: bf16
    # rounding of P and of the output gives a few 1e-3, keys past T joining
    # the softmax (the control below) about 3e-2 at T=1100
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(b, n, h, d, generator=g, device=cuda).to(torch.bfloat16)
               for n in (s, t, t))
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = attention_plain(q.float(), k.float(), v.float())
    assert (got.float() - want).abs().max().item() <= 2e-2
    assert _rel_l2(got, want) <= 1e-2
    if t % 64:
        pad = (0, 0, 0, 0, 0, 64 - t % 64)
        unmasked = flash_attention(q, torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad))
        assert _rel_l2(unmasked, want) > 1e-2


def _rel_l2(got, want):
    return ((got.float() - want).norm() / want.norm()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("shape,eps,silu", [
    ((2, 320, 128, 128), 1e-5, True),
    ((1, 128, 256, 256), 1e-6, True),
    ((2, 1280, 32, 32), 1e-5, False),
])
def test_group_norm_kernel_matches_plain(cuda, shape, eps, silu):
    # bf16 in and out; the plain version on the same values in fp32 is the
    # reference, so the bound covers the kernel's one output rounding
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)
    w = 1.0 + 0.1 * torch.randn(shape[1], generator=g, device=cuda)
    b = 0.1 * torch.randn(shape[1], generator=g, device=cuda)
    got = group_norm(x, w, b, 32, eps, silu)
    want = group_norm_plain(x.float(), w, b, 32, eps, silu)
    assert got.dtype == x.dtype
    assert (got.float() - want).abs().max().item() <= 3e-2


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.randn(1, 1024, 2, 64, device=cuda)  # fp32
    with pytest.raises(TypeError):
        flash_attention(q, q, q)
    x = torch.randn(1, 64, 8, 8, device=cuda).transpose(2, 3)
    with pytest.raises(ValueError):
        group_norm(x, torch.ones(64, device=cuda), torch.zeros(64, device=cuda))
