"""Llama decoder (Vicuna-13B class) for the captioner (counterpart of
supir_tpu/captioner/llama.py): RMSNorm, rotary embeddings, SwiGLU MLP,
pre-norm blocks and a static-length bf16 KV cache.

Weight modes, as the JAX package's LlamaConfig flags select them:
  fp                  nn.Linear projections (no kernel)
  quantize_int4       Int4PairedLinear (paired int4, K6), or with
                      fused_qkv + fused_glue the block's glue folded into
                      K5 (`ops/quantize.py:int4_paired_fused_matmul`): four
                      launches per layer per decoded token (llama.py:486-541)
  quantize_int8       Int8Linear (K7), weights quantized at load by K8
  int4_paired=False   Int4Linear, the half-split layout (K7, bits=4)
Module and parameter names are HF's (`model.layers.{i}.self_attn.q_proj`,
`input_layernorm`, `post_attention_layernorm`, `mlp.gate_proj`, ...); the
merged projections are `self_attn.qkv_proj` and `mlp.gateup_proj`, holding
{qp | q4 | q, scale} buffers in the JAX layout ([in/2, out] or [in, out]).

The KV cache is updated in place (JAX returns a new cache); decode attends
over the cache's first cache_index + s positions, which is what the JAX
bias mask over the whole cache leaves (llama.py:437-450). W4A8 (act_int8),
fused_pairs, int4_native, head_int8 and the int8 KV cache are not ported
and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from supir_tpu_torch.ops import quantize as Q
from supir_tpu_torch.ops.attention import attention

Cache = Tuple[torch.Tensor, torch.Tensor]


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
        return self.quantize_int4 and self.int4_paired and self.fused_glue and self.fused_qkv


def _check_ported(cfg: LlamaConfig) -> None:
    missing = [f for f in ("int4_native", "act_int8", "head_int8", "fused_pairs") if getattr(cfg, f)]
    if missing:
        raise NotImplementedError(f"LlamaConfig options not ported yet: {missing}")
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
    """{'qp', 'scale'}: adjacent-pair int4 (llama.py:150-176) -> K6."""

    def __init__(self, cin, cout, device=None, dtype=torch.float32):
        super().__init__(cin, cout, ("qp", "scale"), (cin // 2, cout), torch.uint8, device, dtype)

    def matmul(self, x2d):
        return Q.int4_paired_matmul(x2d, self.qp, self.scale)


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
        cls = Int4PairedLinear if cfg.int4_paired else Int4Linear
        return cls(cin, cout, device=device, dtype=dtype)
    if cfg.quantize_int8:
        return Int8Linear(cin, cout, device=device, dtype=dtype)
    return nn.Linear(cin, cout, bias=False, device=device, dtype=dtype)


def update_cache_attend(q, k, v, cache: Cache, cache_index: int, s: int) -> torch.Tensor:
    """Write k/v [B, s, KV, D] at cache_index of the cache (in place) and
    attend. Prefill (cache_index 0) attends causally over the fresh k/v,
    which K1 serves at 1024 tokens or more; decode attends over the cache's
    first cache_index + s positions in the plain form."""
    ck, cv = cache
    ck[:, cache_index: cache_index + s] = k.to(ck.dtype)
    cv[:, cache_index: cache_index + s] = v.to(cv.dtype)
    if cache_index == 0:
        return attention(q, k, v, causal=True)
    n = cache_index + s
    return attention(q, ck[:, :n], cv[:, :n], causal=True)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, dtype=torch.float32):
        super().__init__()
        _check_ported(cfg)
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
                gamma=self.input_layernorm.weight, eps=c.rms_eps,
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
                residual=x2,
            )
            gu = Q.int4_paired_fused_matmul(
                xr.to(dt), mlp.gateup_proj.qp, mlp.gateup_proj.scale,
                gamma=self.post_attention_layernorm.weight, eps=c.rms_eps,
            )
            xr = Q.int4_paired_fused_matmul(
                gu.to(dt), mlp.down_proj.qp, mlp.down_proj.scale, siluglu=True, residual=xr,
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
        self.lm_head = nn.Linear(cfg.dim, cfg.vocab_size, bias=False, device=device, dtype=dtype)

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.model.embed_tokens(ids).to(self.dtype)

    def forward(self, embeds, positions, caches: Optional[List[Cache]] = None, cache_index=None):
        """-> fp32 logits [B, S, vocab]. The caches are updated in place."""
        x = self.model(embeds, positions, caches, cache_index)
        return F.linear(x, self.lm_head.weight.to(x.dtype)).float()

    def forward_ids(self, ids, positions, caches=None, cache_index=None):
        return self(self.embed(ids), positions, caches, cache_index)

    def init_cache(self, batch: int, length: int, dtype=None) -> List[Cache]:
        c = self.cfg
        dtype = dtype or self.dtype
        device = self.lm_head.weight.device
        shape = (batch, length, c.kv_heads, c.head_dim)
        return [(torch.zeros(shape, dtype=dtype, device=device),
                 torch.zeros(shape, dtype=dtype, device=device)) for _ in range(c.layers)]


# ------------------------------------------------------------ quantization

_QKV = ("q_proj", "k_proj", "v_proj")
_GATEUP = ("gate_proj", "up_proj")


def quantize_projection(w_in_out: torch.Tensor, bits: int, paired: bool = True, seed: int = 0,
                        stochastic: bool = True) -> Dict[str, torch.Tensor]:
    """One fp32 kernel [in, out] -> its quantized buffers, named as the
    quantized modules name them."""
    if bits == 8:
        q, scale = Q.quantize_int8(w_in_out.float().contiguous(), seed=seed, stochastic=stochastic)
        return {"q": q, "scale": scale}
    if paired:
        qp, scale = Q.quantize_int4_paired(w_in_out.float())
        return {"qp": qp, "scale": scale}
    q4, scale = Q.quantize_int4(w_in_out.float())
    return {"q4": q4, "scale": scale}


def quantize_llama_state_dict(sd: Mapping[str, torch.Tensor], cfg: LlamaConfig, bits: int,
                              fuse: bool = True, paired: bool = True, seed: int = 0,
                              stochastic: bool = True) -> Dict[str, torch.Tensor]:
    """fp Llama weights under HF keys -> the quantized layout
    (quantize_llama_params, llama.py:315-394): every block projection becomes
    {q | qp | q4, scale}; with `fuse`, q|k|v and gate|up are concatenated
    along the output axis first (per-output-channel scales make that equal
    to quantizing them apart); lm_head is cast to bf16. K8 quantizes the
    int8 projections, stochastically unless `stochastic` is False, with the
    seed advanced per projection. Other keys pass through."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    out: Dict[str, torch.Tensor] = {}
    done = set()
    n = 0

    def put(prefix: str, names, module_name: str):
        nonlocal n
        kernels = [sd[f"{prefix}.{p}.weight"].float().t() for p in names]
        w = torch.cat(kernels, dim=1) if len(kernels) > 1 else kernels[0]
        for k, v in quantize_projection(w, bits, paired, seed + n, stochastic).items():
            out[f"{prefix}.{module_name}.{k}"] = v
        done.update(f"{prefix}.{p}.weight" for p in names)
        n += 1

    for i in range(cfg.layers):
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
    for k, v in sd.items():
        if k in done:
            continue
        out[k] = v.to(torch.bfloat16) if k == "lm_head.weight" else v
    return out
