"""Llama decoder (Vicuna-13B class) for the captioner (counterpart of
supir_tpu/captioner/llama.py): RMSNorm, rotary embeddings, SwiGLU MLP,
pre-norm blocks and a static-length KV cache.

Weight and execution modes, as the JAX package's LlamaConfig flags select
them:
  fp                  nn.Linear projections (no kernel)
  quantize_int4       Int4PairedLinear (paired int4, K6), or with
                      fused_qkv + fused_glue the block's glue folded into
                      K5 (`ops/quantize.py:int4_paired_fused_matmul`): four
                      launches per layer per decoded token (llama.py:486-541)
    + act_int8        W4A8: Int4PairedLinear through K10, or the fused glue
                      through K5's act_int8 mode; the same `qp` weights
    + int4_native     Int4NativeLinear, {qn, scale} with qn column-pair
                      packed (K11); never fused glue (llama.py:475-478)
    + fused_pairs     decode through fused_pair_decode_step: two K9
                      launches per layer (prefill keeps the block modules)
  quantize_int8       Int8Linear (K7), weights quantized at load by K8
  int4_paired=False   Int4Linear, the half-split layout (K7, bits=4)
  head_int8           lm_head as Int8Linear (K7 in decode, K8 at load)
Module and parameter names are HF's (`model.layers.{i}.self_attn.q_proj`,
`input_layernorm`, `post_attention_layernorm`, `mlp.gate_proj`, ...); the
merged projections are `self_attn.qkv_proj` and `mlp.gateup_proj`, holding
{qp | q4 | qn | q, scale} buffers in the JAX layout ([in/2, out], [in, out]
or, for qn, [in, out/2]).

The KV cache is updated in place (JAX returns a new cache); decode attends
over the cache's first cache_index + s positions, which is what the JAX
bias mask over the whole cache leaves (llama.py:437-450). A cache is a
(k, v) pair of [B, L, KV, D] tensors, or with int8 entries the 4-tuple
(kq, ks, vq, vs) of int8 [B, L, KV, D] values and fp32 [B, KV, L] scales
(llama.py:397-451, 610-629).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from supir_tpu_torch.ops import quantize as Q
from supir_tpu_torch.ops.attention import attention

Cache = Tuple[torch.Tensor, ...]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Field names and defaults are those of supir_tpu/captioner/llama.py:32-96."""

    vocab_size: int = 32000
    dim: int = 5120          # 13B
    layers: int = 40
    heads: int = 40
    kv_heads: int = 40       # MHA for llama-1/2 13B
    hidden_dim: int = 13824
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    quantize_int8: bool = False
    quantize_int4: bool = False
    fused_qkv: bool = False
    int4_native: bool = False
    int4_paired: bool = True
    act_int8: bool = False
    fused_glue: bool = True
    head_int8: bool = False
    fused_pairs: bool = False

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    def tiny(self) -> "LlamaConfig":
        return dataclasses.replace(
            self, vocab_size=256, dim=64, layers=2, heads=4, kv_heads=4,
            hidden_dim=128, max_seq_len=128,
        )

    @property
    def use_fused_glue(self) -> bool:
        return (self.quantize_int4 and self.int4_paired and not self.int4_native and self.fused_glue
                and self.fused_qkv)


def _check_config(cfg: LlamaConfig) -> None:
    if cfg.quantize_int4 and cfg.quantize_int8:
        raise ValueError("quantize_int4 and quantize_int8 are exclusive")


class RMSNorm(nn.Module):
    """fp32 statistics and an fp32 weight; the output in `dtype`."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.out_dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + self.eps)
        return (xf * self.weight).to(self.out_dtype)


def rotary_cos_sin(positions: torch.Tensor, head_dim: int, theta: float = 10000.0):
    """positions [B, S] -> fp32 cos, sin [B, S, head_dim // 2]."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    inv = torch.from_numpy(inv.astype(np.float32)).to(positions.device)
    ang = positions.float()[..., None] * inv[None, None]
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D]; rotate-half (HF Llama)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class _QuantLinear(nn.Module):
    """A projection whose weights are quantized buffers in the JAX layout."""

    def __init__(self, cin: int, cout: int, names: Tuple[str, str], shape, qdtype, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cin, self.cout, self.dtype = cin, cout, dtype
        self.qname = names[0]
        self.register_buffer(names[0], torch.zeros(shape, dtype=qdtype, device=device))
        self.register_buffer("scale", torch.ones(1, cout, dtype=torch.float32, device=device))

    def matmul(self, x2d: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        y = self.matmul(x.reshape(-1, self.cin).to(self.dtype).contiguous())
        return y.reshape(*lead, self.cout).to(self.dtype)


class Int4PairedLinear(_QuantLinear):
    """{'qp', 'scale'}: adjacent-pair int4 (llama.py:150-176) -> K6, or
    with act_int8 (W4A8) -> K10 on the same weights."""

    def __init__(self, cin, cout, device=None, dtype=torch.float32, act_int8: bool = False):
        super().__init__(cin, cout, ("qp", "scale"), (cin // 2, cout), torch.uint8, device, dtype)
        self.act_int8 = act_int8

    def matmul(self, x2d):
        mm = Q.int4_w4a8_matmul if self.act_int8 else Q.int4_paired_matmul
        return mm(x2d, self.qp, self.scale)


class Int4NativeLinear(_QuantLinear):
    """{'qn', 'scale'}: the JAX package's jnp.int4 weights (llama.py:179-201),
    stored as column pairs in uint8 [in, out/2] -> K11."""

    def __init__(self, cin, cout, device=None, dtype=torch.float32):
        super().__init__(cin, cout, ("qn", "scale"), (cin, cout // 2), torch.uint8, device, dtype)

    def matmul(self, x2d):
        return Q.int4_native_matmul(x2d, self.qn, self.scale)


class Int4Linear(_QuantLinear):
    """{'q4', 'scale'}: half-split int4 (llama.py:127-147) -> K7 bits=4."""

    def __init__(self, cin, cout, device=None, dtype=torch.float32):
        super().__init__(cin, cout, ("q4", "scale"), (cin // 2, cout), torch.uint8, device, dtype)

    def matmul(self, x2d):
        return Q.int4_matmul(x2d, self.q4, self.scale)


class Int8Linear(_QuantLinear):
    """{'q', 'scale'}: per-output-channel int8 (llama.py:204-225) -> K7 bits=8."""

    def __init__(self, cin, cout, device=None, dtype=torch.float32):
        super().__init__(cin, cout, ("q", "scale"), (cin, cout), torch.int8, device, dtype)

    def matmul(self, x2d):
        return Q.int8_matmul(x2d, self.q, self.scale)


def _linear(cfg: LlamaConfig, cin: int, cout: int, device, dtype) -> nn.Module:
    if cfg.quantize_int4:
        if cfg.int4_native:
            return Int4NativeLinear(cin, cout, device=device, dtype=dtype)
        if cfg.int4_paired:
            return Int4PairedLinear(cin, cout, device=device, dtype=dtype, act_int8=cfg.act_int8)
        return Int4Linear(cin, cout, device=device, dtype=dtype)
    if cfg.quantize_int8:
        return Int8Linear(cin, cout, device=device, dtype=dtype)
    return nn.Linear(cin, cout, bias=False, device=device, dtype=dtype)


def _quant_kv(x: torch.Tensor):
    """[B, S, H, D] -> (int8 [B, S, H, D], fp32 scale [B, S, H, 1]):
    per-(position, head) symmetric int8 for the KV cache (llama.py:227-238)."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def _int8_kv_attention(q, kq, ks, vq, vs, mask=None):
    """Attention over an int8 KV cache in the scales-factored form of
    llama.py:270-309: the per-(position, head) scales come out of both dots
    exactly, scores = (q . kq) * ks and out = (p * vs) @ vq, so no
    dequantized K or V is formed beside the products. q [B, s, H, D] in the
    compute dtype; kq, vq int8 [B, L, H, D]; ks, vs fp32 [B, H, L]; mask
    None or a boolean [s, L] of the positions each query sees. The dots are
    fp32 products of q's values and the integers (preferred_element_type
    float32 in JAX). Returns [B, s, H, D] in q's dtype."""
    # the factored einsums pair query head h with cache head h; a GQA cache
    # would need its scales and planes broadcast over the query groups first
    assert q.shape[2] == kq.shape[2], (
        f"int8-KV factorized attention requires kv_heads == heads (got {kq.shape[2]} kv heads, "
        f"{q.shape[2]} query heads); use the bf16 KV path for GQA configs")
    dt = q.dtype
    with torch.autocast(q.device.type, enabled=False):
        scores = torch.einsum("bshd,blhd->bhsl", q.float(), kq.to(dt).float())
        scores = scores * ks[:, :, None, :]
        scores = scores * (1.0 / math.sqrt(q.shape[-1]))
        if mask is not None:
            scores = scores.masked_fill(~mask, -1e30)
        p = torch.softmax(scores, dim=-1)
        p = p * vs[:, :, None, :]
        out = torch.einsum("bhsl,blhd->bshd", p.to(dt).float(), vq.to(dt).float())
    return out.to(dt)


def update_cache_attend(q, k, v, cache: Cache, cache_index: int, s: int) -> torch.Tensor:
    """Write k/v [B, s, KV, D] at cache_index of the cache (in place) and
    attend. Prefill (cache_index 0) attends causally over the fresh k/v,
    which K1 serves at 1024 tokens or more; decode attends over the cache's
    first cache_index + s positions in the plain form. An int8 cache
    (4-tuple) stores k/v quantized per (position, head), and decode attends
    over it in the factored form (llama.py:397-451)."""
    n = cache_index + s
    if len(cache) == 4:
        kq, ks, vq, vs = cache
        for plane, scales, new in ((kq, ks, k), (vq, vs, v)):
            nq, ns = _quant_kv(new)
            plane[:, cache_index: n] = nq
            scales[:, :, cache_index: n] = ns[..., 0].transpose(1, 2)
        if cache_index == 0:
            return attention(q, k, v, causal=True)
        mask = None
        if s > 1:  # query i (at cache_index + i) sees positions up to cache_index + i
            mask = torch.arange(n, device=q.device)[None, :] <= torch.arange(s, device=q.device)[:, None] + cache_index
        return _int8_kv_attention(q, kq[:, :n], ks[:, :, :n], vq[:, :n], vs[:, :, :n], mask)
    ck, cv = cache
    ck[:, cache_index: n] = k.to(ck.dtype)
    cv[:, cache_index: n] = v.to(cv.dtype)
    if cache_index == 0:
        return attention(q, k, v, causal=True)
    # a cache narrower than q (bf16 under fp32 compute) is read in q's dtype,
    # as JAX's einsum promotes it
    return attention(q, ck[:, :n].to(q.dtype), cv[:, :n].to(q.dtype), causal=True)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, dtype=torch.float32):
        super().__init__()
        _check_config(cfg)
        self.cfg, self.dtype = cfg, dtype
        c, hd = cfg, cfg.head_dim
        lin = lambda cin, cout: _linear(cfg, cin, cout, device, dtype)  # noqa: E731
        self.input_layernorm = RMSNorm(c.dim, c.rms_eps, device=device, dtype=dtype)
        self.post_attention_layernorm = RMSNorm(c.dim, c.rms_eps, device=device, dtype=dtype)
        self.self_attn = nn.Module()
        self.mlp = nn.Module()
        if c.fused_qkv:
            self.self_attn.qkv_proj = lin(c.dim, hd * (c.heads + 2 * c.kv_heads))
            self.mlp.gateup_proj = lin(c.dim, 2 * c.hidden_dim)
        else:
            self.self_attn.q_proj = lin(c.dim, c.heads * hd)
            self.self_attn.k_proj = lin(c.dim, c.kv_heads * hd)
            self.self_attn.v_proj = lin(c.dim, c.kv_heads * hd)
            self.mlp.gate_proj = lin(c.dim, c.hidden_dim)
            self.mlp.up_proj = lin(c.dim, c.hidden_dim)
        self.self_attn.o_proj = lin(c.heads * hd, c.dim)
        self.mlp.down_proj = lin(c.hidden_dim, c.dim)

    def forward(self, x, cos, sin, cache: Optional[Cache] = None, cache_index: Optional[int] = None):
        c, hd, dt = self.cfg, self.cfg.head_dim, self.dtype
        b, s, _ = x.shape
        attn, mlp = self.self_attn, self.mlp
        fused = c.use_fused_glue
        if fused:
            # the glue of llama.py:486-541: each projection one K5 launch, the
            # residual stream fp32 between them
            x2 = x.reshape(b * s, c.dim)
            qkv = Q.int4_paired_fused_matmul(
                x2.to(dt).contiguous(), attn.qkv_proj.qp, attn.qkv_proj.scale,
                gamma=self.input_layernorm.weight, eps=c.rms_eps, act_int8=c.act_int8,
            ).reshape(b, s, -1).to(dt)
        else:
            h = self.input_layernorm(x)
            qkv = attn.qkv_proj(h) if c.fused_qkv else None
        if qkv is not None:
            q = qkv[..., : c.heads * hd]
            k = qkv[..., c.heads * hd: hd * (c.heads + c.kv_heads)]
            v = qkv[..., hd * (c.heads + c.kv_heads):]
        else:
            q, k, v = attn.q_proj(h), attn.k_proj(h), attn.v_proj(h)
        q = apply_rotary(q.reshape(b, s, c.heads, hd), cos, sin)
        k = apply_rotary(k.reshape(b, s, c.kv_heads, hd), cos, sin)
        v = v.reshape(b, s, c.kv_heads, hd)
        if cache is not None:
            out = update_cache_attend(q, k, v, cache, cache_index, s)
        else:
            out = attention(q, k, v, causal=True)
        out = out.reshape(b, s, c.heads * hd)

        if fused:
            xr = Q.int4_paired_fused_matmul(
                out.reshape(b * s, -1).to(dt).contiguous(), attn.o_proj.qp, attn.o_proj.scale,
                residual=x2, act_int8=c.act_int8,
            )
            gu = Q.int4_paired_fused_matmul(
                xr.to(dt), mlp.gateup_proj.qp, mlp.gateup_proj.scale,
                gamma=self.post_attention_layernorm.weight, eps=c.rms_eps, act_int8=c.act_int8,
            )
            xr = Q.int4_paired_fused_matmul(
                gu.to(dt), mlp.down_proj.qp, mlp.down_proj.scale, siluglu=True, residual=xr,
                act_int8=c.act_int8,
            )
            return xr.reshape(b, s, c.dim).to(dt)

        x = x + attn.o_proj(out)
        h = self.post_attention_layernorm(x)
        if c.fused_qkv:
            gu = mlp.gateup_proj(h)
            gate, up = gu[..., : c.hidden_dim], gu[..., c.hidden_dim:]
        else:
            gate, up = mlp.gate_proj(h), mlp.up_proj(h)
        return x + mlp.down_proj(F.silu(gate) * up)


class LlamaModel(nn.Module):
    """Embeddings in, hidden states out: LLaVA splices projected image
    patches into the token embeddings, so the caller passes embeddings."""

    def __init__(self, cfg: LlamaConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.dim, device=device, dtype=dtype)
        self.layers = nn.ModuleList(LlamaBlock(cfg, device, dtype) for _ in range(cfg.layers))
        self.norm = RMSNorm(cfg.dim, cfg.rms_eps, device=device, dtype=dtype)

    def forward(self, embeds, positions, caches: Optional[List[Cache]] = None, cache_index=None):
        c = self.cfg
        cos, sin = rotary_cos_sin(positions, c.head_dim, c.rope_theta)
        cos, sin = cos.to(self.dtype), sin.to(self.dtype)
        x = embeds.to(self.dtype)
        for i, layer in enumerate(self.layers):
            x = layer(x, cos, sin, None if caches is None else caches[i], cache_index)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.model = LlamaModel(cfg, device, dtype)
        if cfg.head_int8:
            self.lm_head = Int8Linear(cfg.dim, cfg.vocab_size, device=device, dtype=dtype)
        else:
            self.lm_head = nn.Linear(cfg.dim, cfg.vocab_size, bias=False, device=device, dtype=dtype)

    @property
    def device(self) -> torch.device:
        # the stored tensor, not `embed_tokens.weight`: a sharded model
        # (parallel/sharding.py) gathers that on every read
        return next(self.parameters()).device

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.model.embed_tokens(ids).to(self.dtype)

    def forward(self, embeds, positions, caches: Optional[List[Cache]] = None, cache_index=None):
        """-> fp32 logits [B, S, vocab]. The caches are updated in place."""
        x = self.model(embeds, positions, caches, cache_index)
        if self.cfg.head_int8:  # K7 in decode; logits in x's dtype, as Int8Dense's
            return self.lm_head(x).float()
        return F.linear(x, self.lm_head.weight.to(x.dtype)).float()

    def forward_ids(self, ids, positions, caches=None, cache_index=None):
        return self(self.embed(ids), positions, caches, cache_index)

    def init_cache(self, batch: int, length: int, dtype=None) -> List[Cache]:
        """Per layer (k, v) of `dtype` [B, L, KV, D], or for torch.int8 the
        4-tuple (kq, ks, vq, vs) with fp32 scales [B, KV, L]."""
        c = self.cfg
        dtype = dtype or self.dtype
        shape = (batch, length, c.kv_heads, c.head_dim)
        zeros = lambda shape_, dt: torch.zeros(shape_, dtype=dt, device=self.device)  # noqa: E731
        if dtype == torch.int8:
            scales = (batch, c.kv_heads, length)
            return [(zeros(shape, dtype), zeros(scales, torch.float32), zeros(shape, dtype),
                     zeros(scales, torch.float32)) for _ in range(c.layers)]
        return [(zeros(shape, dtype), zeros(shape, dtype)) for _ in range(c.layers)]


def fused_pair_decode_step(model: LlamaForCausalLM, emb, positions, caches: List[Cache],
                           cache_index: int) -> torch.Tensor:
    """The decode step under LlamaConfig.fused_pairs (llama.py:632-709): per
    layer, [o_proj + residual -> post-attention norm -> gate-up] and
    [SiLU-GLU + down_proj + residual -> the next layer's input norm -> its
    qkv] each run as one K9 launch; layer 0's qkv and the last layer's down
    are K5 launches. Two launches per layer instead of fused glue's four.
    The residual stream stays fp32 between launches. act_int8 is ignored
    here, as the JAX function ignores it. emb [B, s, dim] -> fp32 logits
    [B, s, vocab]; the caches are updated in place."""
    c = model.cfg
    hd, dt = c.head_dim, model.dtype
    layers = model.model.layers
    b, s, _ = emb.shape
    cos, sin = rotary_cos_sin(positions, hd, c.rope_theta)
    cos, sin = cos.to(dt), sin.to(dt)

    x2 = emb.reshape(b * s, c.dim).float()
    l0 = layers[0]
    qkv = Q.int4_paired_fused_matmul(x2.to(dt), l0.self_attn.qkv_proj.qp, l0.self_attn.qkv_proj.scale,
                                     gamma=l0.input_layernorm.weight, eps=c.rms_eps)
    for i, layer in enumerate(layers):
        attn, mlp = layer.self_attn, layer.mlp
        qkv3 = qkv.reshape(b, s, -1).to(dt)
        q = apply_rotary(qkv3[..., : c.heads * hd].reshape(b, s, c.heads, hd), cos, sin)
        k = apply_rotary(qkv3[..., c.heads * hd: hd * (c.heads + c.kv_heads)].reshape(b, s, c.kv_heads, hd),
                         cos, sin)
        v = qkv3[..., hd * (c.heads + c.kv_heads):].reshape(b, s, c.kv_heads, hd)
        out = update_cache_attend(q, k, v, caches[i], cache_index, s)
        out2 = out.reshape(b * s, c.heads * hd).to(dt).contiguous()
        xr, gu = Q.int4_paired_fused_pair(
            out2, attn.o_proj.qp, attn.o_proj.scale, x2, layer.post_attention_layernorm.weight,
            mlp.gateup_proj.qp, mlp.gateup_proj.scale, siluglu1=False, eps=c.rms_eps)
        if i + 1 < len(layers):
            nxt = layers[i + 1]
            x2, qkv = Q.int4_paired_fused_pair(
                gu.to(dt), mlp.down_proj.qp, mlp.down_proj.scale, xr, nxt.input_layernorm.weight,
                nxt.self_attn.qkv_proj.qp, nxt.self_attn.qkv_proj.scale, siluglu1=True, eps=c.rms_eps)
        else:
            x2 = Q.int4_paired_fused_matmul(gu.to(dt), mlp.down_proj.qp, mlp.down_proj.scale, siluglu=True,
                                            residual=xr)

    xf = x2 * torch.rsqrt((x2 * x2).mean(-1, keepdim=True) + c.rms_eps)
    xf = (xf * model.model.norm.weight.float()).to(dt)
    if c.head_int8:
        logits = Q.int8_matmul(xf, model.lm_head.q, model.lm_head.scale)
    else:
        # fp32 sums in x's dtype; on the card the product is rounded to bf16
        # where JAX keeps it fp32 (preferred_element_type)
        logits = F.linear(xf, model.lm_head.weight.to(dt))
    return logits.reshape(b, s, -1).float()


# ------------------------------------------------------------ quantization

_QKV = ("q_proj", "k_proj", "v_proj")
_GATEUP = ("gate_proj", "up_proj")


def quantize_projection(w_in_out: torch.Tensor, bits: int, paired: bool = True, seed: int = 0,
                        stochastic: bool = True, native: bool = False) -> Dict[str, torch.Tensor]:
    """One fp32 kernel [in, out] -> its quantized buffers, named as the
    quantized modules name them."""
    if bits == 8:
        q, scale = Q.quantize_int8(w_in_out.float().contiguous(), seed=seed, stochastic=stochastic)
        return {"q": q, "scale": scale}
    if native:
        qn, scale = Q.quantize_int4_native(w_in_out.float())
        return {"qn": qn, "scale": scale}
    if paired:
        qp, scale = Q.quantize_int4_paired(w_in_out.float())
        return {"qp": qp, "scale": scale}
    q4, scale = Q.quantize_int4(w_in_out.float())
    return {"q4": q4, "scale": scale}


def quantize_llama_state_dict(sd: Mapping[str, torch.Tensor], cfg: LlamaConfig, bits: int,
                              fuse: bool = True, paired: bool = True, seed: int = 0,
                              stochastic: bool = True, native: bool = False,
                              head_int8: bool = False) -> Dict[str, torch.Tensor]:
    """fp Llama weights under HF keys -> the quantized layout
    (quantize_llama_params, llama.py:315-394): every block projection becomes
    {q | qp | q4 | qn, scale}; with `fuse`, q|k|v and gate|up are
    concatenated along the output axis first (per-output-channel scales make
    that equal to quantizing them apart); `native` stores int4 as qn (K11's
    column pairs). lm_head is cast to bf16, or with `head_int8` quantized
    per output channel to {q, scale} (LlamaConfig.head_int8). K8 quantizes
    the int8 projections and head, stochastically unless `stochastic` is
    False, with the seed advanced per projection. Other keys pass through."""
    if bits not in (4, 8, None):
        raise ValueError(f"bits must be 4, 8 or None, got {bits}")
    out: Dict[str, torch.Tensor] = {}
    done = set()
    n = 0

    def put(prefix: str, names, module_name: str):
        nonlocal n
        kernels = [sd[f"{prefix}.{p}.weight"].float().t() for p in names]
        w = torch.cat(kernels, dim=1) if len(kernels) > 1 else kernels[0]
        for k, v in quantize_projection(w, bits, paired, seed + n, stochastic, native).items():
            out[f"{prefix}.{module_name}.{k}"] = v
        done.update(f"{prefix}.{p}.weight" for p in names)
        n += 1

    for i in range(cfg.layers if bits is not None else 0):
        lt = f"model.layers.{i}"
        if fuse:
            put(f"{lt}.self_attn", _QKV, "qkv_proj")
            put(f"{lt}.mlp", _GATEUP, "gateup_proj")
        else:
            for p in _QKV:
                put(f"{lt}.self_attn", (p,), p)
            for p in _GATEUP:
                put(f"{lt}.mlp", (p,), p)
        put(f"{lt}.self_attn", ("o_proj",), "o_proj")
        put(f"{lt}.mlp", ("down_proj",), "down_proj")
    if head_int8:
        w = sd["lm_head.weight"].float().t().contiguous()
        q, scale = Q.quantize_int8(w, seed=seed + n, stochastic=stochastic)
        out["lm_head.q"], out["lm_head.scale"] = q, scale
        done.add("lm_head.weight")
    for k, v in sd.items():
        if k in done:
            continue
        out[k] = v.to(torch.bfloat16) if k == "lm_head.weight" else v
    return out
