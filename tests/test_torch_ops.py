"""supir_tpu_torch kernels (K1 flash attention, K2 GroupNorm+SiLU, K3 the
forward with logsumexp, K4 the backward, and the ALiBi variants of K3 and
K4) against the JAX package's Pallas kernels, run in interpret mode on the
CPU.

On the CPU each wrapper returns its plain PyTorch version, so these tests
hold the plain versions to the Pallas kernels at atol 2e-5 (fp32, the bound
of tests/test_flash_attention.py and tests/test_groupnorm_kernel.py), and
check that a CPU tensor never reaches a kernel, that a kernel wrapper
refuses an input that asks for a gradient, and that the sites route by
grad mode: `FlashAttention` (K3/K4) and the plain GroupNorm where something
is differentiated, K1 and K2 elsewhere. The kernels themselves are
held to their plain versions on the card by the tests marked `gpu`. JAX is
imported inside the parity tests only, so the `gpu` tests also run on a
machine without it: python -m pytest --noconftest tests/test_torch_ops.py -m gpu
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from supir_tpu_torch.models import layers
from supir_tpu_torch.ops import attention as attn_ops
from supir_tpu_torch.ops.flash_attention import (
    FlashAttention,
    alibi_bias,
    attention_bwd_plain,
    attention_fwd_lse_plain,
    attention_plain,
    flash_attention,
    flash_attention_bwd,
    flash_attention_fwd_lse,
)
from supir_tpu_torch.ops.groupnorm import group_norm, group_norm_plain
from torch_parity import one_torch_thread  # noqa: F401


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


@pytest.mark.parametrize("s", [256, 300])
def test_flash_plain_causal_matches_pallas(s):
    """K1's causal mask (the `causal` flag of the packed kernels): query i
    sees keys 0..i."""
    import jax.numpy as jnp

    from supir_tpu.ops.flash_attention import flash_attention as jax_flash_attention

    q, k, v = _qkv(3, 1, s, s, 2, 64)
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                               bq=128, bkv=128, interpret=True)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


# the cases of tests/test_flash_attention_bwd.py: block-aligned, causal,
# ragged causal (padded rows and columns must not leak), cross with q != t
LSE_CASES = [(128, 128, False), (128, 128, True), (100, 100, True), (96, 200, False)]


def _qkvg(seed, s, t, h=2, d=64, b=2):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, t, h, d), (b, t, h, d), (b, s, h, d)))


def _jax_fwd_lse(q, k, v, causal):
    """JAX's forward rule (_flash_fwd_lse, interpret mode): out [B,S,H,D] and
    lse [B,H,S], read from its lane-broadcast [B*H, S_pad, 128] layout."""
    import jax.numpy as jnp

    from supir_tpu.ops.flash_attention import _flash_fwd_lse

    b, s, h, _ = q.shape
    out, lse = _flash_fwd_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, None, 64, 64, True)
    return out, lse, np.asarray(lse)[:, :s, 0].reshape(b, h, s)


@pytest.mark.parametrize("s,t,causal", LSE_CASES)
def test_fwd_lse_plain_matches_pallas(s, t, causal):
    """K3's plain version against _flash_fwd_lse: the output, and the
    natural-log logsumexp of the scaled scores."""
    q, k, v, _ = _qkvg(5, s, t)
    want_out, _, want_lse = _jax_fwd_lse(q, k, v, causal)
    out, lse = flash_attention_fwd_lse(*map(torch.from_numpy, (q, k, v)), causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=2e-5)


# the backward's tile edges on the CPU: one short of, one past and past two
# 64-row tiles, S != T both ways, causal
BWD_EDGE_CASES = [(63, 65, False), (65, 129, False), (129, 63, False), (129, 129, True), (65, 65, True)]


@pytest.mark.parametrize("s,t,causal", LSE_CASES + BWD_EDGE_CASES)
def test_bwd_plain_matches_pallas(s, t, causal):
    """K4's plain version against _flash_bwd on the same residuals, and the
    port's FlashAttention gradients against jax.grad through flash_attention."""
    import jax
    import jax.numpy as jnp

    from supir_tpu.ops.flash_attention import _flash_bwd
    from supir_tpu.ops.flash_attention import flash_attention as jax_flash_attention

    q, k, v, g = _qkvg(6, s, t)
    out, lse_lanes, lse = _jax_fwd_lse(q, k, v, causal)
    want = _flash_bwd(*map(jnp.asarray, (q, k, v)), out, lse_lanes, jnp.asarray(g), causal, None, 64, 64, True)
    got = flash_attention_bwd(*map(torch.from_numpy, (q, k, v, np.array(out), lse, g)), causal)
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-5, err_msg=f"d{name}")

    want = jax.grad(lambda *a: jnp.sum(jax_flash_attention(*a, causal=causal, bq=64, bkv=64, interpret=True) * g),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (FlashAttention.apply(qt, kt, vt, causal) * torch.from_numpy(g)).sum().backward()
    for name, a, w in zip("qkv", (qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-5, err_msg=f"d{name} via autograd")


def _slopes(h):
    """MPT's slopes for h heads (bias_max 8), as numpy fp32."""
    return (1.0 / 2.0 ** (np.arange(1, h + 1, dtype=np.float32) * 8.0 / h)).astype(np.float32)


# ALiBi: causal and not, block-aligned and ragged T (the bias offset uses the
# unpadded key length), cross with S != T
ALIBI_CASES = [(128, 128, True), (100, 100, True), (128, 128, False), (96, 200, False)]


@pytest.mark.parametrize("s,t,causal", ALIBI_CASES)
def test_alibi_fwd_lse_plain_matches_pallas(s, t, causal):
    """K3 ALiBi's plain version against the Pallas kernel with its `alibi`
    operand: the output of the primal (_flash_primal's unpacked branch) and
    of the forward rule, and the lse of the biased scores."""
    import jax.numpy as jnp

    from supir_tpu.ops.flash_attention import _flash_fwd_lse
    from supir_tpu.ops.flash_attention import flash_attention as jax_flash_attention

    q, k, v, _ = _qkvg(11, s, t, h=4)
    slopes = _slopes(4)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    primal = jax_flash_attention(jq, jk, jv, causal=causal, alibi_slopes=slopes, bq=64, bkv=64, interpret=True)
    want_out, lse_lanes = _flash_fwd_lse(jq, jk, jv, causal, tuple(float(x) for x in slopes), 64, 64, True)
    want_lse = np.asarray(lse_lanes)[:, :s, 0].reshape(2, 4, s)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = flash_attention_fwd_lse(tq, tk, tv, causal, alibi_slopes=torch.from_numpy(slopes))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=2e-5)
    got = flash_attention(tq, tk, tv, causal, alibi_slopes=slopes)
    np.testing.assert_allclose(got.numpy(), np.asarray(primal), atol=2e-5)


@pytest.mark.parametrize("s,t,causal", ALIBI_CASES + BWD_EDGE_CASES)
def test_alibi_bwd_plain_matches_pallas(s, t, causal):
    """K4 ALiBi's plain version against _flash_bwd with the slopes, on the
    same residuals; FlashAttention's ALiBi gradients against jax.vjp of
    flash_attention (its custom VJP)."""
    import jax
    import jax.numpy as jnp

    from supir_tpu.ops.flash_attention import _flash_bwd, _flash_fwd_lse
    from supir_tpu.ops.flash_attention import flash_attention as jax_flash_attention

    q, k, v, g = _qkvg(12, s, t, h=4)
    slopes = _slopes(4)
    st = tuple(float(x) for x in slopes)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out, lse_lanes = _flash_fwd_lse(jq, jk, jv, causal, st, 64, 64, True)
    lse = np.asarray(lse_lanes)[:, :s, 0].reshape(2, 4, s)
    want = _flash_bwd(jq, jk, jv, out, lse_lanes, jnp.asarray(g), causal, st, 64, 64, True)
    got = flash_attention_bwd(*map(torch.from_numpy, (q, k, v, np.array(out), lse, g)), causal,
                              alibi_slopes=slopes)
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=2e-5, err_msg=f"d{name}")

    _, vjp = jax.vjp(lambda *a: jax_flash_attention(*a, causal=causal, alibi_slopes=slopes, bq=64, bkv=64,
                                                    interpret=True), jq, jk, jv)
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (FlashAttention.apply(*leaves, causal, torch.from_numpy(slopes)) * torch.from_numpy(g)).sum().backward()
    for name, a, w in zip("qkv", leaves, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), atol=2e-5, err_msg=f"d{name} via autograd")


def test_alibi_flash_attention_function_gradcheck():
    """FlashAttention with ALiBi: its backward is the derivative of its
    forward (float64, ragged)."""
    rng = np.random.default_rng(13)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 9, 2, 4))).requires_grad_() for _ in range(3))
    slopes = torch.tensor([0.5, 0.0625], dtype=torch.float64)
    assert torch.autograd.gradcheck(lambda *a: FlashAttention.apply(*a, True, slopes), (q, k, v))


@pytest.mark.parametrize("s,causal,route", [
    (1024, True, "flash"),   # flash-eligible: K3 ALiBi (K1's wrapper) / FlashAttention
    (1024, False, "flash"),
    (77, True, "xla"),       # short: the materialised column bias
    (40, False, "xla"),
])
def test_attention_alibi_matches_dot_product_attention(s, causal, route):
    """attention(..., alibi_slopes=) against JAX's dot_product_attention on
    the route the port takes: the Pallas kernel for a flash-eligible site,
    the XLA form with the materialised bias otherwise; forward and, through
    autograd, the gradients."""
    import jax
    import jax.numpy as jnp

    from supir_tpu.ops.attention import dot_product_attention

    assert attn_ops.flash_eligible(s, s, 64) == (route == "flash")
    q, k, v, g = _qkvg(14, s, s, h=2, b=1)
    slopes = _slopes(2)

    def jax_fn(*a):
        return dot_product_attention(*a, causal=causal, alibi_slopes=slopes, impl=route)

    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want, vjp = jax.vjp(jax_fn, jq, jk, jv)
    want_grads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = attn_ops.attention(*leaves, causal=causal, alibi_slopes=slopes)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=2e-5)
    for name, a, w in zip("qkv", leaves, want_grads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), atol=2e-5, err_msg=f"d{name}")
    with torch.no_grad():
        again = attn_ops.attention(*map(torch.from_numpy, (q, k, v)), causal=causal, alibi_slopes=slopes)
    np.testing.assert_allclose(again.numpy(), np.asarray(want), atol=2e-5)


def test_attention_alibi_with_bias_adds_the_column_bias():
    """A biased call with slopes takes the plain route with bias + the
    [1, H, 1, T] column bias, as JAX's XLA route adds them (:119-124)."""
    import jax.numpy as jnp

    from supir_tpu.ops.attention import dot_product_attention

    q, k, v, _ = _qkvg(15, 24, 24, h=2, b=1)
    bias = np.random.default_rng(16).standard_normal((1, 2, 24, 24)).astype(np.float32)
    slopes = _slopes(2)
    want = dot_product_attention(*map(jnp.asarray, (q, k, v)), bias=jnp.asarray(bias), alibi_slopes=slopes,
                                 impl="xla")
    got = attn_ops.attention(*map(torch.from_numpy, (q, k, v)), bias=torch.from_numpy(bias), alibi_slopes=slopes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    col = alibi_bias(slopes, 24)
    assert col.shape == (1, 2, 1, 24) and float(col[0, 0, 0, -1]) == 0.0
    np.testing.assert_allclose(col[0, :, 0, 0].numpy(), -23 * slopes, rtol=1e-6)


def test_attention_plain_promotes_like_xla():
    """bf16 weights against fp32 values (a bf16 query over an fp32 cache):
    the plain form promotes them as jnp.einsum does in `_xla_attention`,
    where torch's einsum would refuse the mix."""
    import jax.numpy as jnp

    from supir_tpu.ops.attention import _xla_attention

    q, k, v, _ = _qkvg(18, 3, 20, h=2, b=1)
    bias = np.random.default_rng(19).standard_normal((1, 2, 3, 20)).astype(np.float32)
    want = _xla_attention(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k), jnp.asarray(v), bias=jnp.asarray(bias))
    got = attention_plain(torch.from_numpy(q).bfloat16(), torch.from_numpy(k), torch.from_numpy(v),
                          bias=torch.from_numpy(bias))
    assert str(want.dtype) == "float32" and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)  # the same roundings on both sides


def test_attention_routes_alibi(monkeypatch):
    """An ALiBi site at 1024 tokens or more goes to the kernel with its
    slopes (K3 ALiBi without grad, FlashAttention with); a biased or short
    one never does."""
    calls = []

    def k1(q, k, v, causal=False, alibi_slopes=None):
        calls.append(("K1", alibi_slopes is not None))
        return attention_plain(q, k, v, causal, alibi_slopes=alibi_slopes)

    class Recorded(FlashAttention):
        @staticmethod
        def forward(ctx, q, k, v, causal=False, alibi_slopes=None):
            calls.append(("FlashAttention", alibi_slopes is not None))
            return FlashAttention.forward(ctx, q, k, v, causal, alibi_slopes)

    monkeypatch.setattr(attn_ops, "flash_attention", k1)
    monkeypatch.setattr(attn_ops, "FlashAttention", Recorded)
    q, k, v = (torch.from_numpy(a) for a in _qkv(17, 1, 1024, 1024, 2, 64))
    slopes = _slopes(2)
    attn_ops.attention(q, k, v, causal=True, alibi_slopes=slopes)
    attn_ops.attention(q.requires_grad_(), k, v, causal=True, alibi_slopes=slopes).sum().backward()
    attn_ops.attention(q, k, v, bias=torch.zeros(1, 2, 1024, 1024), alibi_slopes=slopes)
    attn_ops.attention(q[:, :100], k[:, :100], v[:, :100], causal=True, alibi_slopes=slopes)
    assert calls == [("K1", True), ("FlashAttention", True)]


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_function_gradcheck(causal):
    """FlashAttention's backward (K4's plain arithmetic) is the derivative
    of its forward: gradcheck in float64, ragged sizes."""
    rng = np.random.default_rng(7)
    s, t = (9, 9) if causal else (7, 11)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, n, 2, 4))).requires_grad_() for n in (s, t, t))
    assert torch.autograd.gradcheck(lambda *a: FlashAttention.apply(*a, causal), (q, k, v))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_function_matches_plain_autograd(causal):
    q, k, v, g = (torch.from_numpy(a) for a in _qkvg(8, 64, 64, h=3, d=32))
    grads = []
    for fn in (lambda *a: FlashAttention.apply(*a, causal), lambda *a: attention_plain(*a, causal=causal)):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*leaves)
        (out * g).sum().backward()
        grads.append([out.detach()] + [x.grad for x in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4", "K3-alibi", "K4-alibi"])
def test_kernel_wrappers_refuse_to_drop_gradients(kernel):
    """Off the CPU a wrapper checks grad mode before anything else: handed a
    tensor that requires grad it raises (a kernel's result has no autograd
    history), so no gradient is dropped without a word. Meta tensors stand
    in for the card here: they take the same branch, and without the guard
    they reach the device check, a ValueError."""
    meta = dict(device="meta")
    q = torch.empty(1, 1024, 2, 64, **meta)
    lse = torch.empty(1, 2, 1024, **meta)
    x, w = torch.empty(1, 64, 8, 8, **meta), torch.empty(64, **meta)
    slopes = torch.ones(2, **meta)
    calls = {
        "K1": lambda a: flash_attention(a, q, q),
        "K3": lambda a: flash_attention_fwd_lse(a, q, q),
        "K4": lambda a: flash_attention_bwd(a, q, q, q, lse, q),
        "K2": lambda a: group_norm(x, a, w),
        "K3-alibi": lambda a: flash_attention_fwd_lse(a, q, q, True, slopes),
        "K4-alibi": lambda a: flash_attention_bwd(a, q, q, q, lse, q, True, slopes),
    }
    leaf = (w if kernel == "K2" else q).clone().requires_grad_()
    with pytest.raises(RuntimeError, match="gradient"):
        calls[kernel](leaf)
    with torch.no_grad(), pytest.raises(ValueError, match="CPU or CUDA"):
        calls[kernel](leaf)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        calls[kernel](leaf.detach())


def test_group_norm_sites_route_by_grad(monkeypatch):
    """GroupNorm32: the plain, differentiable form where x or the affine
    parameters require grad under grad mode (counted), K2 everywhere else."""
    kernel_calls = []
    monkeypatch.setattr(layers, "group_norm", lambda *a: kernel_calls.append(1) or group_norm_plain(*a))
    norm = layers.GroupNorm32(64, fuse_silu=True)
    x = torch.randn(1, 64, 4, 4)
    before = layers.GroupNorm32.plain_sites
    y = norm(x)  # the affine parameters require grad
    assert y.requires_grad and kernel_calls == [] and layers.GroupNorm32.plain_sites == before + 1
    y.sum().backward()
    assert norm.weight.grad is not None
    with torch.no_grad():
        norm(x)
    norm.requires_grad_(False)
    norm(x)  # frozen parameters, input without grad: nothing to differentiate
    assert kernel_calls == [1, 1]
    norm(x.requires_grad_())
    assert kernel_calls == [1, 1] and layers.GroupNorm32.plain_sites == before + 2


def test_attention_sites_route_by_grad(monkeypatch):
    """A flash-eligible site whose inputs require grad goes to FlashAttention
    (K3/K4); without grad, to K1; an ineligible one to the plain form."""
    routes = []
    monkeypatch.setattr(attn_ops, "flash_attention", lambda q, k, v, causal=False, alibi_slopes=None:
                        routes.append("K1") or attention_plain(q, k, v, causal))

    class Recorded(FlashAttention):
        @staticmethod
        def forward(ctx, q, k, v, causal=False, alibi_slopes=None):
            routes.append("FlashAttention")
            return FlashAttention.forward(ctx, q, k, v, causal, alibi_slopes)

    monkeypatch.setattr(attn_ops, "FlashAttention", Recorded)
    q, k, v = (torch.from_numpy(a) for a in _qkv(9, 1, 1024, 1024, 1, 64))
    attn_ops.attention(q, k, v)
    out = attn_ops.attention(q.requires_grad_(), k, v)
    out.sum().backward()
    assert q.grad is not None and routes == ["K1", "FlashAttention"]
    with torch.no_grad():
        attn_ops.attention(q, k, v)
    attn_ops.attention(q, k[:, :77], v[:, :77])  # text cross-attention: plain
    assert routes == ["K1", "FlashAttention", "K1"]


def test_attention_routes_bias_and_causal(monkeypatch):
    """As supir_tpu/ops/attention.py routes them: causal self-attention at
    1024 tokens or more goes to K1; a biased call never does."""
    calls = []
    monkeypatch.setattr(attn_ops, "flash_attention",
                        lambda q, k, v, causal=False, alibi_slopes=None: calls.append(causal)
                        or attention_plain(q, k, v, causal))
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 1, 1024, 1024, 1, 64))
    attn_ops.attention(q, k, v, causal=True)
    bias = torch.zeros(1, 1, 1024, 1024)
    torch.testing.assert_close(attn_ops.attention(q, k, v, bias=bias), attention_plain(q, k, v))
    attn_ops.attention(q[:, :1], k, v, causal=True)  # one decode query: plain form
    assert calls == [True]


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
    slopes = torch.tensor([0.25, 0.0625])
    out = attn_ops.attention(q, k, v, causal=True, alibi_slopes=slopes)
    torch.testing.assert_close(out, attention_plain(q, k, v, True, alibi_slopes=slopes), rtol=0, atol=0)
    x = torch.randn(1, 64, 4, 4)
    w, b = torch.ones(64), torch.zeros(64)
    torch.testing.assert_close(group_norm(x, w, b, 32, 1e-5, True),
                               group_norm_plain(x, w, b, 32, 1e-5, True), rtol=0, atol=0)
    assert flash_attention.launches == 0 and flash_attention.alibi_launches == 0
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


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,d", [(1, 1100, 8, 128), (1, 2048, 4, 64)])
def test_flash_kernel_causal_matches_plain(cuda, b, s, h, d):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=cuda).to(torch.bfloat16) for _ in range(3))
    got = flash_attention(q, k, v, causal=True)
    want = attention_plain(q.float(), k.float(), v.float(), causal=True)
    assert _rel_l2(got, want) <= 1e-2
    assert _rel_l2(flash_attention(q, k, v), want) > 1e-2  # the mask removed


def _rel_l2(got, want):
    return ((got.float() - want).norm() / want.norm()).item()


def _forward_inputs(cuda, seed, b, s, t, h, d, layout):
    """q [B,S,H,D], k/v [B,T,H,D] in bf16: contiguous, non-contiguous views
    of one packed [B,S,3,H,D] tensor (S == T), or multiquery k/v expanded
    over heads with head stride 0."""
    g = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=cuda).to(torch.bfloat16)

    if layout == "packed":
        return randn(b, s, 3, h, d).unbind(2)
    q = randn(b, s, h, d)
    if layout == "mqa":
        return (q, *(randn(b, t, 1, d).expand(b, t, h, d) for _ in range(2)))
    return q, randn(b, t, h, d), randn(b, t, h, d)


def _slopes_for(h, device):
    ceil = 2 ** math.ceil(math.log2(h))
    slopes = 1.0 / 2.0 ** (torch.arange(1, ceil + 1, dtype=torch.float32, device=device) * 8.0 / ceil)
    return slopes if ceil == h else torch.cat([slopes[1::2], slopes[::2]])[:h]


# the forward's tile edges: 128-row query blocks, 128-key tiles, the causal
# diagonal cutting a block inside its second 64-row half (1088 = 8.5 x 128,
# 1100), cross attention, strided and multiquery inputs, and B*H = 400
FORWARD_EDGES = [
    (1, 1100, 1100, 4, 64, False, "contiguous"),
    (1, 1088, 1088, 4, 128, False, "contiguous"),
    (2, 1000, 1500, 3, 64, False, "contiguous"),
    (2, 1000, 1500, 3, 128, False, "contiguous"),
    (1, 1088, 1088, 4, 64, True, "contiguous"),
    (1, 1100, 1100, 4, 128, True, "contiguous"),
    (2, 1100, 1100, 4, 64, False, "packed"),
    (1, 1088, 1088, 4, 128, True, "packed"),
    (1, 1100, 1100, 8, 128, True, "mqa"),
    (2, 1000, 1000, 4, 64, False, "mqa"),
    (10, 256, 256, 40, 128, False, "contiguous"),
    (10, 300, 300, 40, 64, True, "contiguous"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,t,h,d,causal,layout", FORWARD_EDGES)
def test_flash_forward_tile_edges(cuda, b, s, t, h, d, causal, layout):
    """K1 and K3, with and without ALiBi, against the fp32 plain version at
    the tile edges (out rel-L2 1e-2, lse max abs 1e-3); K1 and K3 are one
    kernel, so their outputs are bit-identical."""
    q, k, v = _forward_inputs(cuda, 4, b, s, t, h, d, layout)
    for slopes in (None, _slopes_for(h, cuda)):
        before = (flash_attention.launches, flash_attention.alibi_launches)
        primal = flash_attention(q, k, v, causal, slopes)
        out, lse = flash_attention_fwd_lse(q, k, v, causal, slopes)
        torch.cuda.synchronize()
        assert (flash_attention.launches, flash_attention.alibi_launches) == (
            before[0] + (slopes is None), before[1] + (slopes is not None))
        want_out, want_lse = attention_fwd_lse_plain(q.float(), k.float(), v.float(), causal, slopes)
        assert _rel_l2(out, want_out) <= 1e-2, slopes is not None
        assert (lse - want_lse).abs().max().item() <= 1e-3, slopes is not None
        assert torch.equal(primal, out)


@pytest.mark.gpu
@pytest.mark.parametrize("s,d,causal", [(1100, 64, False), (1088, 128, True), (1100, 128, True)])
def test_flash_forward_planted_faults(cuda, s, d, causal):
    """Each planted fault breaks the bound the sound kernel keeps: keys
    past T unmasked (k/v zero-padded to the 128-key tile), exp2 without
    log2(e), the causal mask removed, the lse in log2 units, and k/v
    shifted by one key (a tile-offset error in the TMA coordinates)."""
    q, k, v = _forward_inputs(cuda, 5, 1, s, s, 4, d, "contiguous")
    want, want_lse = attention_fwd_lse_plain(q.float(), k.float(), v.float(), causal)
    out, lse = flash_attention_fwd_lse(q, k, v, causal)
    assert _rel_l2(out, want) <= 1e-2 and (lse - want_lse).abs().max().item() <= 1e-3
    pad = (0, 0, 0, 0, 0, -s % 128)
    if not causal:  # padding would change T and so the causal diagonal
        assert _rel_l2(flash_attention(q, F.pad(k, pad), F.pad(v, pad)), want) > 1e-2
    assert _rel_l2(flash_attention((q.float() * math.log(2)).to(q.dtype), k, v, causal), want) > 1e-2
    if causal:
        assert _rel_l2(flash_attention(q, k, v), want) > 1e-2
    assert (lse * LOG2E - want_lse).abs().max().item() > 1e-3
    shift = (0, 0, 0, 0, 0, 1)
    assert _rel_l2(flash_attention(q, F.pad(k[:, 1:], shift), F.pad(v[:, 1:], shift), causal), want) > 1e-2


# the backward's tile edges: the forward's, plus a ragged block whose second
# 64-row box lies wholly past S = T (1030) and short, unaligned S != T
BACKWARD_EDGES = FORWARD_EDGES + [
    (1, 1030, 1030, 4, 128, True, "contiguous"),
    (2, 65, 129, 2, 64, False, "contiguous"),
]


def _backward_case(cuda, b, s, t, h, d, causal, layout, slopes, seed=6):
    """Inputs, K3's residuals and the fp32 plain gradients for one case."""
    q, k, v = _forward_inputs(cuda, seed, b, s, t, h, d, layout)
    g = torch.Generator(device=cuda).manual_seed(seed + 1)
    dout = torch.randn(b, s, h, d, generator=g, device=cuda).to(torch.bfloat16)
    out, lse = flash_attention_fwd_lse(q, k, v, causal, slopes)
    want = attention_bwd_plain(q.float(), k.float(), v.float(), out.float(), lse, dout.float(), causal, slopes)
    return q, k, v, dout, out, lse, want


def _worst(got, want):
    return max(_rel_l2(a, w) for a, w in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,t,h,d,causal,layout", BACKWARD_EDGES)
def test_flash_backward_tile_edges(cuda, b, s, t, h, d, causal, layout):
    """K4 and K4 ALiBi against the fp32 plain version on K3's residuals at
    the tile edges: every gradient within rel-L2 2e-2, two runs
    bit-identical, one launch counted per call."""
    for slopes in (None, _slopes_for(h, cuda)):
        q, k, v, dout, out, lse, want = _backward_case(cuda, b, s, t, h, d, causal, layout, slopes)
        before = (flash_attention_bwd.launches, flash_attention_bwd.alibi_launches)
        got = flash_attention_bwd(q, k, v, out, lse, dout, causal, slopes)
        again = flash_attention_bwd(q, k, v, out, lse, dout, causal, slopes)
        torch.cuda.synchronize()
        assert (flash_attention_bwd.launches, flash_attention_bwd.alibi_launches) == (
            before[0] + 2 * (slopes is None), before[1] + 2 * (slopes is not None))
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            assert a.dtype == torch.bfloat16 and a.shape == w.shape, name
            assert _rel_l2(a, w) <= 2e-2, (name, slopes is not None, _rel_l2(a, w))
        assert all(torch.equal(a, a2) for a, a2 in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("s,d,causal", [(1100, 64, False), (1088, 128, True), (1100, 128, True)])
def test_flash_backward_planted_faults(cuda, s, d, causal):
    """Each planted fault breaks K4's 2e-2 bound, emulated on the inputs of
    the sound kernel: the lse in log2 units, delta dropped (a zero out gives
    delta 0), dK without its scale, dO shifted by one query row and k/v
    shifted by one key (tile-offset errors in the TMA coordinates); with
    ALiBi also the bias left out of the recomputed scores."""
    for slopes in (None, _slopes_for(4, cuda)):
        q, k, v, dout, out, lse, want = _backward_case(cuda, 1, s, s, 4, d, causal, "contiguous", slopes, seed=8)
        got = flash_attention_bwd(q, k, v, out, lse, dout, causal, slopes)
        assert _worst(got, want) <= 2e-2
        shift = (0, 0, 0, 0, 0, 1)
        faults = {
            "lse in log2 units": flash_attention_bwd(q, k, v, out, lse * LOG2E, dout, causal, slopes),
            "delta dropped": flash_attention_bwd(q, k, v, torch.zeros_like(out), lse, dout, causal, slopes),
            "dK without scale": (got[0], got[1] * d ** 0.5, got[2]),
            "dO shifted by one query": flash_attention_bwd(q, k, v, out, lse, F.pad(dout[:, 1:], shift), causal,
                                                           slopes),
            "k/v shifted by one key": flash_attention_bwd(q, F.pad(k[:, 1:], shift), F.pad(v[:, 1:], shift), out,
                                                          lse, dout, causal, slopes),
        }
        if slopes is not None:
            faults["bias left out"] = flash_attention_bwd(q, k, v, out, lse, dout, causal)
        for name, bad in faults.items():
            assert not _worst(bad, want) <= 2e-2, (name, slopes is not None)  # NaN breaks it too


def _gn_card_case(cuda, shape, dtype, seed=0):
    """x with its own mean and scale per channel (so that statistics taken
    over the wrong elements show), and the affine, on the card."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    c = shape[1]
    view = (1, c) + (1,) * (len(shape) - 2)
    scale = 0.5 + torch.rand(c, generator=g, device=cuda)
    shift = 2.0 * torch.rand(c, generator=g, device=cuda) - 1.0
    # clamped at 3 sigma: the outputs stay under 8, where a bf16 rounding
    # stays under the bound
    x = (torch.randn(shape, generator=g, device=cuda).clamp(-3, 3) * scale.view(view) + shift.view(view)).to(dtype)
    w = 1.0 + 0.1 * torch.randn(c, generator=g, device=cuda)
    b = 0.1 * torch.randn(c, generator=g, device=cuda)
    return x, w, b


@pytest.mark.gpu
@pytest.mark.parametrize("shape,eps,silu,dtype", [
    ((2, 320, 128, 128), 1e-5, True, torch.bfloat16),
    ((1, 128, 256, 256), 1e-6, True, torch.bfloat16),
    ((2, 1280, 32, 32), 1e-5, False, torch.bfloat16),
    ((1, 64, 1024, 1024), 1e-6, True, torch.bfloat16),   # 4 MB slabs
    ((1, 96, 7, 9), 1e-6, True, torch.bfloat16),         # 189-element slabs: ragged heads and tails
    ((3, 96, 7, 9), 1e-5, False, torch.float32),
    ((2, 320, 64, 64), 1e-5, True, torch.float16),
])
def test_group_norm_kernel_matches_plain(cuda, shape, eps, silu, dtype):
    # the plain version on the same values in fp32 is the reference, so the
    # bound covers the kernel's one output rounding; one launch a call, and
    # two runs give the same bits (a fixed reduction order, no atomics)
    x, w, b = _gn_card_case(cuda, shape, dtype)
    before = group_norm.launches
    got = group_norm(x, w, b, 32, eps, silu)
    torch.cuda.synchronize()
    assert group_norm.launches == before + 1
    want = group_norm_plain(x.float(), w, b, 32, eps, silu)
    assert got.dtype == x.dtype
    assert (got.float() - want).abs().max().item() <= 3e-2
    assert torch.equal(got, group_norm(x, w, b, 32, eps, silu))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_group_norm_kernel_takes_an_unaligned_x(cuda, dtype):
    """x at an offset that is not a multiple of 16 bytes: every slab's head
    and tail go through plain loads, and y is placed at x's offset."""
    x, w, b = _gn_card_case(cuda, (2, 64, 9, 7), dtype, seed=3)
    flat = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
    shifted = flat[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    got = group_norm(shifted, w, b, 32, 1e-5, True)
    want = group_norm_plain(x.float(), w, b, 32, 1e-5, True)
    assert (got.float() - want).abs().max().item() <= 3e-2


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 320, 128, 128), (1, 64, 1024, 1024)])
def test_group_norm_planted_faults_break_the_bound(cuda, shape):
    """Each planted fault of csrc/group_norm.cu breaks K2's 3e-2 bound: one
    rank's partials left out, each CTA on its own part's statistics, the
    affine one channel off, and pass 2 reading the next group."""
    from supir_tpu_torch.ops import groupnorm as G

    x, w, b = _gn_card_case(cuda, shape, torch.bfloat16, seed=1)
    plan = G.plan_for(x)
    want = group_norm_plain(x.float(), w, b, 32, 1e-5, True)
    for fault in (G.FAULT_DROP_RANK, G.FAULT_OWN_SLICE, G.FAULT_AFFINE_SHIFT, G.FAULT_NEIGHBOUR_GROUP):
        bad = G._launch(x, w, b, 32, 1e-5, True, plan, fault=fault)
        assert not (bad.float() - want).abs().max().item() <= 3e-2, fault


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,t,h,d,causal", [
    (1, 4096, 4096, 10, 64, False),
    (1, 1024, 1024, 20, 64, False),
    (1, 1100, 1100, 4, 64, True),
    (2, 1000, 1500, 3, 128, False),
])
def test_flash_lse_and_backward_kernels_match_plain(cuda, b, s, t, h, d, causal):
    """K3 and K4 against their fp32 plain versions (bounds: out and each
    gradient rel-L2 1e-2 / 2e-2, lse max abs 1e-3), deterministic, and a
    planted fault (lse in log2 units) outside the gradients' bound."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(b, n, h, d, generator=g, device=cuda).to(torch.bfloat16) for n in (s, t, t))
    dout = torch.randn(b, s, h, d, generator=g, device=cuda).to(torch.bfloat16)
    out, lse = flash_attention_fwd_lse(q, k, v, causal)
    want_out, want_lse = attention_fwd_lse_plain(q.float(), k.float(), v.float(), causal)
    assert _rel_l2(out, want_out) <= 1e-2
    assert (lse - want_lse).abs().max().item() <= 1e-3
    got = flash_attention_bwd(q, k, v, out, lse, dout, causal)
    want = attention_bwd_plain(q.float(), k.float(), v.float(), out.float(), want_lse, dout.float(), causal)
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16 and _rel_l2(a, w) <= 2e-2
    again = flash_attention_bwd(q, k, v, out, lse, dout, causal)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
    bad = flash_attention_bwd(q, k, v, out, lse * 1.4426950408889634, dout, causal)
    assert _rel_l2(bad[0], want[0]) > 2e-2


LOG2E = 1.4426950408889634


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,t,h,d,causal,mqa", [
    (1, 2048, 2048, 32, 128, True, False),   # the MPT-7B prefill
    (1, 1024, 1024, 8, 64, False, False),
    (1, 1100, 1100, 6, 64, True, False),     # ragged T, 6 heads (interleaved slopes)
    (2, 1000, 1500, 4, 128, False, False),   # cross, S != T
    (1, 1024, 1024, 8, 64, True, True),      # multiquery: k, v expanded, head stride 0
])
def test_alibi_kernels_match_plain(cuda, b, s, t, h, d, causal, mqa):
    """K3 ALiBi and K4 ALiBi against their fp32 plain versions (K3's and
    K4's bounds: out rel-L2 1e-2, lse max abs 1e-3, each gradient rel-L2
    2e-2), deterministic, with the planted faults of each: the bias in
    scaled instead of raw units and the slopes reversed break O; the offset
    -(T - 1) dropped keeps O and breaks the lse; K4 without the bias breaks
    the gradients."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(b, s, h, d, generator=g, device=cuda).to(torch.bfloat16)
    if mqa:
        k, v = (torch.randn(b, t, 1, d, generator=g, device=cuda).to(torch.bfloat16).expand(b, t, h, d)
                for _ in range(2))
    else:
        k, v = (torch.randn(b, t, h, d, generator=g, device=cuda).to(torch.bfloat16) for _ in range(2))
    dout = torch.randn(b, s, h, d, generator=g, device=cuda).to(torch.bfloat16)
    ceil = 2 ** math.ceil(math.log2(h))
    slopes = 1.0 / 2.0 ** (torch.arange(1, ceil + 1, dtype=torch.float32, device=cuda) * 8.0 / ceil)
    if ceil != h:
        slopes = torch.cat([slopes[1::2], slopes[::2]])[:h]
    before = (flash_attention_fwd_lse.alibi_launches, flash_attention_bwd.alibi_launches,
              flash_attention_fwd_lse.launches)
    out, lse = flash_attention_fwd_lse(q, k, v, causal, slopes)
    want_out, want_lse = attention_fwd_lse_plain(q.float(), k.float(), v.float(), causal, slopes)
    assert _rel_l2(out, want_out) <= 1e-2
    assert (lse - want_lse).abs().max().item() <= 1e-3
    primal = flash_attention(q, k, v, causal, slopes)
    assert torch.equal(primal, out)
    got = flash_attention_bwd(q, k, v, out, lse, dout, causal, slopes)
    want = attention_bwd_plain(q.float(), k.float(), v.float(), out.float(), want_lse, dout.float(), causal, slopes)
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16 and _rel_l2(a, w) <= 2e-2
    assert all(torch.equal(a, a2) for a, a2 in zip(got, flash_attention_bwd(q, k, v, out, lse, dout, causal,
                                                                             slopes)))
    torch.cuda.synchronize()
    assert (flash_attention_fwd_lse.alibi_launches, flash_attention_bwd.alibi_launches,
            flash_attention_fwd_lse.launches) == (before[0] + 1, before[1] + 2, before[2])

    scaled_units, _ = flash_attention_fwd_lse(q, k, v, causal, slopes * d ** -0.5)
    assert _rel_l2(scaled_units, want_out) > 1e-2
    reversed_, _ = flash_attention_fwd_lse(q, k, v, causal, slopes.flip(0))
    assert _rel_l2(reversed_, want_out) > 1e-2
    # the offset dropped adds slope_h * (T - 1) to every row's lse, O unchanged
    no_offset = lse + (slopes * (t - 1))[None, :, None]
    assert (no_offset - want_lse).abs().max().item() > 1e-3
    bad = flash_attention_bwd(q, k, v, out, lse, dout, causal)  # bias left out of the recomputed scores
    assert not max(_rel_l2(a, w) for a, w in zip(bad, want)) <= 2e-2  # NaN (exp overflow) breaks it too


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.randn(1, 1024, 2, 64, device=cuda)
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())  # K1 takes bf16 or fp32; attention() widens fp16
    with pytest.raises(TypeError):
        flash_attention_fwd_lse(q.half(), q.half(), q.half())  # K3 takes bf16 or fp32
    x = torch.randn(1, 64, 8, 8, device=cuda).transpose(2, 3)
    with pytest.raises(ValueError):
        group_norm(x, torch.ones(64, device=cuda), torch.zeros(64, device=cuda))
    qb = q.to(torch.bfloat16).requires_grad_()
    with pytest.raises(RuntimeError, match="gradient"):
        flash_attention(qb, qb, qb)
    w = torch.ones(64, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="gradient"):
        group_norm(x.contiguous(), w, torch.zeros(64, device=cuda))
