"""MPT decoder for the captioner's llava-mpt family (counterpart of
supir_tpu/captioner/mpt.py).

Behavioral contract, as the JAX module states it: the reference's
`llava/model/language_model/mpt/` MPTModel with ALiBi positional bias,
pre-LN blocks without biases, optional multiquery attention and
low-precision LayerNorm; prefix-LM mode; a static-shape KV cache for
greedy or sampled decode (`mpt_generate`).

Module and parameter names are the reference's HF ones
(`transformer.wte.weight`, `transformer.blocks.{i}.norm_1.weight`,
`.attn.Wqkv.weight`, `.attn.out_proj.weight`, `.norm_2.*`,
`.ffn.up_proj.weight`, `.ffn.down_proj.weight`, `transformer.norm_f.*`), so a
real checkpoint loads with `strict=True` (`utils/weights.py:convert_mpt_state_dict`
fills the LayerNorm biases the no_bias family strips).

Attention routes as the JAX block routes it (mpt.py:146-179):
  no cache          causal with `alibi_slopes`: K3 ALiBi at >= 1024 tokens
                    (`FlashAttention`, K3 with lse and K4 ALiBi, under
                    grad), else the plain form with the column bias
  cache, index 0    the prefill fast path (`cache_index` the Python int 0):
                    the same causal ALiBi call over the fresh keys, read
                    back from the cache and cast to q's dtype (exact: they
                    came from it), so an fp32 cache still reaches the kernel
  cache, index > 0  decode: valid mask plus the [1, H, 1, L] column bias over
                    the whole cache, plain form
  prefix-LM         the full [B, H, S, S] bias of `prefix_lm_bias`, plain form
The kernels run in the model's dtype, as the TPU kernels run in the
inputs' dtype: a bf16 model on K3 ALiBi and K4 ALiBi, an fp32 one (the
default here, as `MPTBlock` and `MPTForCausalLM` default to fp32 in the
JAX module, mpt.py:113, :195) on K3 ALiBi fp32 and K4 ALiBi fp32; an
fp16 model is widened to fp32 for the kernel and rounded back once
(`ops/attention.py:kernel_dtypes`).
The KV cache is updated in place (JAX returns a new one) and returned for
the same call form. Multiquery broadcasts k and v to every head with
`expand` (head stride 0), which the kernels read as they are.

dtype: the projections and the embedding are held in the model's dtype and
compute in it, as flax's Dense and Embed cast to theirs; the LayerNorms keep
fp32 parameters and statistics and return the compute dtype. The tied head
multiplies in the model's dtype, so a bf16 model gives bf16 logits, as
`Embed.attend` promotes both operands to the module's dtype (mpt.py:252).
The JAX module keeps fp32 parameters under a bf16 compute dtype; a bf16
port model holds bf16 parameters.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from supir_tpu_torch.ops.attention import attention
from supir_tpu_torch.ops.flash_attention import alibi_bias
from supir_tpu_torch.utils.device import resolve_device

Cache = Tuple[torch.Tensor, torch.Tensor]
LN_EPS = 1e-6  # flax.linen.LayerNorm's default (torch's is 1e-5)


@dataclasses.dataclass(frozen=True)
class MPTConfig:
    """Field names and defaults are those of supir_tpu/captioner/mpt.py:31-53
    (MPT-7B)."""

    vocab_size: int = 50432
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    multiquery: bool = False
    alibi_bias_max: float = 8.0
    max_seq_len: int = 2048
    prefix_lm: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return 1 if self.multiquery else self.n_heads

    def tiny(self) -> "MPTConfig":
        return dataclasses.replace(self, vocab_size=128, d_model=64, n_layers=2, n_heads=4, max_seq_len=64)


def alibi_slopes(n_heads: int, bias_max: float = 8.0) -> np.ndarray:
    """[H] ALiBi slopes, MPT convention: 1/2^(i*bias_max/ceil_pow2(H)); when
    H is not a power of two the odd slopes are interleaved (mpt.py:55-64)."""
    ceil_p2 = 2 ** math.ceil(math.log2(n_heads))
    m = np.arange(1, ceil_p2 + 1, dtype=np.float32) * bias_max / ceil_p2
    slopes = 1.0 / (2.0**m)
    if ceil_p2 != n_heads:
        slopes = np.concatenate([slopes[1::2], slopes[::2]])[:n_heads]
    return slopes.astype(np.float32)


def build_alibi_bias(n_heads: int, seq_len: int, bias_max: float = 8.0) -> np.ndarray:
    """[1, H, 1, S] ALiBi slopes * distance (mpt.py:67-71)."""
    dist = np.arange(1 - seq_len, 1, dtype=np.float32)[None, None, None, :]
    slopes = alibi_slopes(n_heads, bias_max)
    return (dist * slopes[None, :, None, None]).astype(np.float32)


def build_alibi_bias_full(n_heads: int, seq_len: int, bias_max: float = 8.0) -> np.ndarray:
    """[1, H, S, S] symmetric -|i - j| * slope, the prefix-LM form (mpt.py:74-83)."""
    pos = np.arange(seq_len, dtype=np.float32)
    dist = -np.abs(pos[None, :] - pos[:, None])[None, None]
    slopes = alibi_slopes(n_heads, bias_max)
    return (dist * slopes[None, :, None, None]).astype(np.float32)


def prefix_lm_bias(cfg: MPTConfig, prefix_mask: torch.Tensor) -> torch.Tensor:
    """[B, H, S, S] fp32 additive bias for prefix-LM mode: the full ALiBi,
    and -1e30 where a key is neither causal to the query nor in the prefix
    (mpt.py:86-95)."""
    b, s = prefix_mask.shape
    dev = prefix_mask.device
    alibi = torch.from_numpy(build_alibi_bias_full(cfg.n_heads, s, cfg.alibi_bias_max)).to(dev)
    causal = torch.ones(s, s, dtype=torch.bool, device=dev).tril()[None, None]
    prefix = prefix_mask.bool()[:, None, None, :]
    return torch.where(causal | prefix, alibi, torch.tensor(-1e30, device=dev))


class LPLayerNorm(nn.Module):
    """Low-precision LayerNorm (mpt.py:98-108): fp32 parameters and
    statistics on x in fp32, eps 1e-6; the result in `dtype`."""

    def __init__(self, dim: int, device=None, dtype=torch.float32):
        super().__init__()
        self.out_dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), x.shape[-1:], self.weight, self.bias, LN_EPS).to(self.out_dtype)


class MPTAttention(nn.Module):
    def __init__(self, cfg: MPTConfig, device=None, dtype=torch.float32):
        super().__init__()
        qkv_dim = cfg.d_model + 2 * cfg.kv_heads * cfg.head_dim
        self.Wqkv = nn.Linear(cfg.d_model, qkv_dim, bias=False, device=device, dtype=dtype)
        self.out_proj = nn.Linear(cfg.d_model, cfg.d_model, bias=False, device=device, dtype=dtype)


class MPTMLP(nn.Module):
    def __init__(self, cfg: MPTConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.up_proj = nn.Linear(cfg.d_model, 4 * cfg.d_model, bias=False, device=device, dtype=dtype)
        self.down_proj = nn.Linear(4 * cfg.d_model, cfg.d_model, bias=False, device=device, dtype=dtype)


class MPTBlock(nn.Module):
    """Pre-LN block (mpt.py:111-187): fused Wqkv, ALiBi attention, exact-erf
    GELU MLP, no biases."""

    def __init__(self, cfg: MPTConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.norm_1 = LPLayerNorm(cfg.d_model, device, dtype)
        self.attn = MPTAttention(cfg, device, dtype)
        self.norm_2 = LPLayerNorm(cfg.d_model, device, dtype)
        self.ffn = MPTMLP(cfg, device, dtype)

    def _attend(self, q, k, v, slopes, alibi_bias, cache, cache_index, attn_bias):
        c = self.cfg
        b, s = q.shape[:2]
        full = (b, -1, c.n_heads, c.head_dim)
        if cache is None:
            if attn_bias is not None:  # prefix-LM: the bias carries ALiBi and the mask
                return attention(q, k.expand(full), v.expand(full), bias=attn_bias), None
            return attention(q, k.expand(full), v.expand(full), causal=True, alibi_slopes=slopes), None
        ck, cv = cache
        i = int(cache_index)
        ck[:, i:i + s] = k.to(ck.dtype)
        cv[:, i:i + s] = v.to(cv.dtype)
        if isinstance(cache_index, int) and cache_index == 0:
            # prefill fast path: nothing precedes these s tokens, and the column
            # bias is shift-invariant under softmax, so causal ALiBi over the
            # fresh keys is exact; they are read back from the cache as JAX
            # reads them, in q's dtype for the kernel
            kf, vf = (t[:, :s].to(q.dtype).expand(full) for t in (ck, cv))
            return attention(q, kf, vf, causal=True, alibi_slopes=slopes), cache
        length = ck.shape[1]
        col = torch.arange(length, device=q.device)[None, None, None, :]
        row = torch.arange(s, device=q.device)[None, None, :, None] + i
        valid = (col < i + s) & (col <= row)
        bias = torch.where(valid, 0.0, -1e30) + alibi_bias
        return attention(q, ck.expand(full), cv.expand(full), bias=bias), cache

    def forward(self, x: torch.Tensor, slopes: torch.Tensor, alibi_bias: Optional[torch.Tensor] = None,
                cache: Optional[Cache] = None, cache_index=None, attn_bias: Optional[torch.Tensor] = None):
        """x [B, S, d_model]; `slopes` [H] fp32; `alibi_bias` [1, H, 1, L] the
        column bias over a cache of length L (decode only); `attn_bias`
        [B|1, H, S, S] the prefix-LM bias (no cache). Returns (x, cache)."""
        c = self.cfg
        b, s, _ = x.shape
        hd, kvh = c.head_dim, c.kv_heads
        qkv = self.attn.Wqkv(self.norm_1(x))
        q = qkv[..., :c.d_model].reshape(b, s, c.n_heads, hd)
        k = qkv[..., c.d_model:c.d_model + kvh * hd].reshape(b, s, kvh, hd)
        v = qkv[..., c.d_model + kvh * hd:].reshape(b, s, kvh, hd)
        out, new_cache = self._attend(q, k, v, slopes, alibi_bias, cache, cache_index, attn_bias)
        x = x + self.attn.out_proj(out.reshape(b, s, c.d_model).to(self.dtype))
        h = F.gelu(self.ffn.up_proj(self.norm_2(x)))  # exact erf, as the reference's GELU(approximate='none')
        return x + self.ffn.down_proj(h), new_cache


class MPTModel(nn.Module):
    def __init__(self, cfg: MPTConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.wte = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device, dtype=dtype)
        self.blocks = nn.ModuleList(MPTBlock(cfg, device, dtype) for _ in range(cfg.n_layers))
        self.norm_f = LPLayerNorm(cfg.d_model, device, dtype)


class MPTForCausalLM(nn.Module):
    """Tied-embedding MPT causal LM (mpt.py:190-275) with a static-shape KV
    cache for decode."""

    def __init__(self, cfg: MPTConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.transformer = MPTModel(cfg, device, dtype)
        self._slopes: dict = {}

    @property
    def device(self) -> torch.device:
        return self.transformer.wte.weight.device

    def slopes(self, device) -> torch.Tensor:
        """The [H] fp32 ALiBi slopes on `device`, made once per device."""
        device = torch.device(device)
        if device not in self._slopes:
            c = self.cfg
            self._slopes[device] = torch.from_numpy(alibi_slopes(c.n_heads, c.alibi_bias_max)).to(device)
        return self._slopes[device]

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.transformer.wte(ids)

    def forward_embeds(self, x: torch.Tensor, caches: Optional[List[Cache]] = None, cache_index=None,
                       prefix_mask: Optional[torch.Tensor] = None):
        """Embeddings [B, S, d_model] in, (logits [B, S, vocab], caches or
        None) out. `prefix_mask` [B, S] (prefix-LM mode, cfg.prefix_lm): 1
        marks the bidirectional prefix; it requires caches=None, and a
        prefix-LM model requires it (mpt.py:212-245)."""
        c = self.cfg
        blocks = self.transformer.blocks
        slopes = self.slopes(x.device)
        if prefix_mask is not None:
            if not c.prefix_lm:
                raise ValueError("prefix_mask requires MPTConfig.prefix_lm=True")
            if caches is not None:
                raise ValueError("prefix-LM mode does not support the KV cache path")
            bias = prefix_lm_bias(c, prefix_mask)
            for blk in blocks:
                x, _ = blk(x, slopes, attn_bias=bias)
            return self._logits(x), None
        if c.prefix_lm:
            raise ValueError(
                "prefix_mask is required when MPT is configured with prefix_lm=True (and the KV-cache path "
                "does not support prefix-LM; re-prefill instead)")
        alibi = None if caches is None else alibi_bias(slopes, caches[0][0].shape[1])
        new_caches = []
        for i, blk in enumerate(blocks):
            x, nc = blk(x, slopes, alibi, None if caches is None else caches[i], cache_index)
            new_caches.append(nc)
        return self._logits(x), (new_caches if caches is not None else None)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """The tied head in the model's dtype (flax's Embed.attend)."""
        x = self.transformer.norm_f(x)
        return F.linear(x.to(self.dtype), self.transformer.wte.weight.to(self.dtype))

    def forward(self, ids: torch.Tensor, caches: Optional[List[Cache]] = None, cache_index=None,
                prefix_mask: Optional[torch.Tensor] = None):
        """logits, or (logits, caches) when `caches` is given."""
        logits, new_caches = self.forward_embeds(self.embed(ids), caches, cache_index, prefix_mask)
        if caches is None:
            return logits
        return logits, new_caches

    def init_cache(self, batch: int, length: int, dtype=torch.float32) -> List[Cache]:
        """Zeroed (k, v) pairs of [B, L, kv_heads, head_dim] per layer, fp32
        by default as in the JAX module (mpt.py:263-274)."""
        c = self.cfg
        shape = (batch, length, c.kv_heads, c.head_dim)
        return [(torch.zeros(shape, dtype=dtype, device=self.device),
                 torch.zeros(shape, dtype=dtype, device=self.device)) for _ in range(c.n_layers)]


# --------------------------------------------------------------- init fns
#
# The reference's from-scratch init schemes (param_init_fns.py,
# MODEL_INIT_REGISTRY), as the JAX module implements them (mpt.py:278-397),
# in numpy: the same seed gives the same arrays, bit for bit. The tree has
# the JAX module's shape; utils/weights.py:mpt_state_dict_from_jax carries
# it into the port's state dict.


def _init_linear(rng: np.random.Generator, fan_in: int, fan_out: int, name: str, d_model: int,
                 init_std=None, init_gain: float = 0.0) -> np.ndarray:
    """One [fan_in, fan_out] kernel under the named scheme (torch fan
    conventions: fan_in = in features)."""
    shape = (fan_in, fan_out)
    if name == "default_":
        bound = 1.0 / math.sqrt(fan_in)
        return rng.uniform(-bound, bound, shape).astype(np.float32)
    if name == "baseline_":
        if init_std is None:
            raise ValueError("init_config['init_std'] must be set for baseline_ init")
        return rng.normal(0.0, init_std, shape).astype(np.float32)
    if name in ("small_init_", "neox_init_"):
        std = math.sqrt(2.0 / (5.0 * d_model))
        return rng.normal(0.0, std, shape).astype(np.float32)
    if name == "kaiming_uniform_":
        gain = math.sqrt(2.0 / (1.0 + init_gain**2))
        bound = math.sqrt(3.0) * gain / math.sqrt(fan_in)
        return rng.uniform(-bound, bound, shape).astype(np.float32)
    if name == "kaiming_normal_":
        gain = math.sqrt(2.0 / (1.0 + init_gain**2))
        return rng.normal(0.0, gain / math.sqrt(fan_in), shape).astype(np.float32)
    if name == "xavier_uniform_":
        bound = init_gain * math.sqrt(6.0 / (fan_in + fan_out))
        return rng.uniform(-bound, bound, shape).astype(np.float32)
    if name == "xavier_normal_":
        std = init_gain * math.sqrt(2.0 / (fan_in + fan_out))
        return rng.normal(0.0, std, shape).astype(np.float32)
    raise KeyError(f"unknown init scheme {name!r}")


MODEL_INIT_REGISTRY = (
    "default_", "baseline_", "kaiming_uniform_", "kaiming_normal_",
    "neox_init_", "small_init_", "xavier_uniform_", "xavier_normal_",
)


def residual_divisor(cfg: MPTConfig, name: str, init_div_is_residual=True) -> float:
    """What the residual projections (out_proj, down_proj) are divided by
    (mpt.py:333-344)."""
    if name == "neox_init_":
        return cfg.n_layers / math.sqrt(10.0)
    if name == "default_" or init_div_is_residual is False:
        return 1.0
    if init_div_is_residual is True:
        return math.sqrt(2.0 * cfg.n_layers)
    return float(init_div_is_residual)


def init_mpt_params(cfg: MPTConfig, seed: int = 0, name: str = "kaiming_normal_", init_std: Optional[float] = None,
                    emb_init_std: Optional[float] = None, init_div_is_residual=True, init_gain: float = 0.0):
    """An MPTForCausalLM parameter tree of the JAX module's shape, numpy fp32
    leaves, under a named init scheme (mpt.py:314-397)."""
    if name not in MODEL_INIT_REGISTRY:
        raise KeyError(f"unknown init scheme {name!r}; registry: {MODEL_INIT_REGISTRY}")
    rng = np.random.default_rng(seed)
    c = cfg
    div = residual_divisor(c, name, init_div_is_residual)

    def lin(fan_in, fan_out, residual=False, fused_splits=None):
        if fused_splits:
            # fused_init_helper_: each split initialized independently
            parts, prev = [], 0
            for e in list(fused_splits) + [fan_out]:
                parts.append(_init_linear(rng, fan_in, e - prev, name, c.d_model, init_std, init_gain))
                prev = e
            w = np.concatenate(parts, axis=1)
        else:
            w = _init_linear(rng, fan_in, fan_out, name, c.d_model, init_std, init_gain)
        if residual and div != 1.0:
            w = w / div
        return {"Dense_0": {"kernel": w}}

    def norm():
        return {"ln": {"scale": np.ones((c.d_model,), np.float32), "bias": np.zeros((c.d_model,), np.float32)}}

    if emb_init_std is not None:
        emb = rng.normal(0.0, emb_init_std, (c.vocab_size, c.d_model))
    elif name == "default_":
        emb = rng.normal(0.0, 1.0, (c.vocab_size, c.d_model))
    else:
        emb = _init_linear(rng, c.d_model, c.vocab_size, name, c.d_model, init_std, init_gain).T
    params = {"wte": {"embedding": np.asarray(emb, np.float32)}}
    qkv_out = c.d_model + 2 * c.kv_heads * c.head_dim
    for i in range(c.n_layers):
        params[f"block_{i}"] = {
            "norm_1": norm(),
            "Wqkv": lin(c.d_model, qkv_out, fused_splits=(c.d_model, c.d_model + c.kv_heads * c.head_dim)),
            "out_proj": lin(c.d_model, c.d_model, residual=True),
            "norm_2": norm(),
            "up_proj": lin(c.d_model, 4 * c.d_model),
            "down_proj": lin(4 * c.d_model, c.d_model, residual=True),
        }
    params["norm_f"] = norm()
    return params


@torch.no_grad()
def init_random_(model: MPTForCausalLM, generator: torch.Generator) -> None:
    """Fill `model` in place on its device from `generator`, with the
    distributions of `init_mpt_params`' default scheme (kaiming_normal_,
    gain sqrt(2), each fused Wqkv split drawn apart, the residual
    projections divided by sqrt(2 * n_layers)); LayerNorms to ones and
    zeros. For runs at full width, where numpy on the host would be slow."""
    c = model.cfg
    div = residual_divisor(c, "kaiming_normal_")

    def normal_(w: torch.Tensor, fan_in: int, scale: float = 1.0):
        tmp = torch.empty(w.shape, dtype=torch.float32, device=w.device)
        w.copy_(tmp.normal_(0.0, math.sqrt(2.0) / math.sqrt(fan_in) / scale, generator=generator))

    normal_(model.transformer.wte.weight, c.d_model)
    for blk in model.transformer.blocks:
        wqkv = blk.attn.Wqkv.weight  # [out, in]: q, k, v rows
        normal_(wqkv[:c.d_model], c.d_model)
        normal_(wqkv[c.d_model:], c.d_model)
        normal_(blk.attn.out_proj.weight, c.d_model, div)
        normal_(blk.ffn.up_proj.weight, c.d_model)
        normal_(blk.ffn.down_proj.weight, 4 * c.d_model, div)
    for m in model.modules():
        if isinstance(m, LPLayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()


def create_mpt(cfg: Optional[MPTConfig] = None, device="cuda", dtype: torch.dtype = torch.bfloat16, seed: int = 0,
               state_dict=None) -> MPTForCausalLM:
    """An MPTForCausalLM on `device` (the card unless the caller names the
    CPU), MPT-7B by default, its projections and embedding in `dtype`.
    state_dict: weights under the HF keys (e.g. from
    utils/weights.mpt_state_dict_from_jax or convert_mpt_state_dict), loaded
    with strict=True; None draws random weights on the device from `seed`
    (`init_random_`)."""
    device = resolve_device(device)
    cfg = cfg or MPTConfig()
    with torch.device("meta"):
        model = MPTForCausalLM(cfg, dtype=dtype)
    model = model.to_empty(device=device)
    if state_dict is None:
        init_random_(model, torch.Generator(device=device).manual_seed(seed))
    else:
        model.load_state_dict(state_dict, strict=True)
    return model.eval()


@torch.no_grad()
def mpt_generate(model: MPTForCausalLM, ids: torch.Tensor, max_new_tokens: int = 64, cache_len: Optional[int] = None,
                 temperature: float = 0.0, eos_id: int = 0, seed: int = 0) -> torch.Tensor:
    """Autoregressive decode with the static KV cache (mpt.py:400-452):
    prefill, then one token per step; greedy when temperature == 0, else a
    draw from softmax(logits / temperature) with a torch generator seeded by
    `seed` (its stream is not jax.random's). Stops early once every row has
    produced `eos_id`. Returns the new tokens [B, n] (int64, CPU)."""
    b, plen = ids.shape
    cache_len = cache_len or (plen + max_new_tokens)
    assert plen + max_new_tokens <= cache_len
    caches = model.init_cache(b, cache_len)
    generator = torch.Generator(device=ids.device).manual_seed(seed)

    def pick(logits):
        if temperature > 0.0:
            probs = torch.softmax(logits.float() / max(temperature, 1e-4), dim=-1)
            return torch.multinomial(probs, 1, generator=generator)[:, 0]
        return logits.argmax(-1)

    logits, caches = model(ids, caches=caches, cache_index=0)
    tok = logits[:, -1].argmax(-1)
    outs = [tok.cpu()]
    done = outs[0] == eos_id
    for i in range(max_new_tokens - 1):
        logits, caches = model(tok[:, None], caches=caches, cache_index=plen + i)
        tok = pick(logits[:, -1])
        outs.append(tok.cpu())
        done |= outs[-1] == eos_id
        if bool(done.all()):
            break
    return torch.stack(outs, dim=1)
