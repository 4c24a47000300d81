"""The captioner's remaining weight and execution modes in the port
(supir_tpu_torch.captioner) against the JAX package's on the CPU, at tiny
widths and fp32: native int4 (K11's layout), W4A8 (act_int8, K10 and K5's
act_int8 mode), the int8 lm_head, the int8 KV cache, fused_pairs (K9) and
the text-only `chat`, with the memory-lean mode of the JAX package's
end-to-end bench (int4, fused pairs, int8 KV cache, int8 head) as the slice.

Weights: the JAX agent's own parameter shapes with every leaf random from a
numpy seed (tests/test_torch_captioner.py's `_random_like`), bridged by
`captioner_state_dict_from_jax`, then quantized on each side by its own
package (bit for bit the same values, checked here) or, for the bridge
test, quantized by JAX and carried across. Tolerances, each with its reason:
- `_quant_kv`: bit for bit (int8 values and scales);
- the int8 KV attention: 1e-5 (fp32 softmax and sums in another order);
- logits of the tiny Llama stack in each mode: atol 1e-4 + rtol 1e-4, fp32
  summation order over widths of 64-256. In the W4A8 modes float order
  before an activation quantizer could flip one rounding (1/127 of one
  activation, O(1e-2) in a logit), so each W4A8 site is also held on
  injected inputs at 1e-5; at stack level the readings over five input
  seeds were at most 1.7e-6 (no flip at these widths), under the same 1e-4;
- fused_pair_decode_step: logits 1e-4 and the int8 caches bit for bit
  (scales 1e-6) after a prefill and four decode steps;
- the slice, tiny greedy gen_image_caption in the lean mode, and `chat`:
  the same token stream, token for token.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supir_tpu.captioner import agent as JA
from supir_tpu.captioner import llama as JL
from supir_tpu.ops import quantize as JQ
from supir_tpu_torch.captioner import agent as TA
from supir_tpu_torch.captioner import chat as TChat
from supir_tpu_torch.captioner import llama as TL
from supir_tpu_torch.ops import quantize as Q
from supir_tpu_torch.utils import weights as W
from tests.test_torch_captioner import _ids, _image, _port_cfg, _random_like

ATOL = RTOL = 1e-4
INT4 = dict(quantize_int4=True, fused_qkv=True)
MODES = {  # name -> (LlamaConfig flags, kv_dtype)
    "int4_native": (dict(INT4, int4_native=True), "float32"),
    "w4a8_unfused": (dict(INT4, act_int8=True, fused_glue=False), "float32"),
    "w4a8_fused": (dict(INT4, act_int8=True), "float32"),
    "head_int8": (dict(INT4, head_int8=True), "float32"),
    "lean": (dict(INT4, fused_pairs=True, head_int8=True), "int8"),
}


@pytest.fixture(scope="module")
def tiny():
    jcfg = JA.CaptionerConfig.tiny()
    shapes = JA.CaptionerAgent.create_random(jcfg, seed=0).params
    params = _random_like(shapes, seed=1)
    return jcfg, params, W.captioner_state_dict_from_jax(params, jcfg)


def _jax_cfg_params(tiny, mode):
    jcfg, params, _ = tiny
    flags, kv = MODES[mode]
    cfg = dataclasses.replace(jcfg, kv_dtype=kv, llama=dataclasses.replace(jcfg.llama, **flags))
    qllama, _ = JL.quantize_llama_params(params["llama"], bits=4, fuse=True, native=cfg.llama.int4_native,
                                         head_int8=cfg.llama.head_int8)
    return cfg, jax.tree_util.tree_map(jnp.asarray, dict(params, llama=qllama))


def _jax_agent(tiny, mode):
    return JA.CaptionerAgent(*_jax_cfg_params(tiny, mode))


def _port(tiny, mode, state_dict=None):
    cfg, _ = _jax_cfg_params(tiny, mode)
    return TA.create_captioner(_port_cfg(cfg), "cpu", state_dict=tiny[2] if state_dict is None else state_dict,
                               stochastic=False)


@pytest.fixture(scope="module")
def lean(tiny):
    return _port(tiny, "lean"), _jax_agent(tiny, "lean")


# ------------------------------------------------------------ int8 KV cache


def test_quant_kv_is_bit_exact():
    x = np.random.default_rng(30).standard_normal((2, 5, 4, 16)).astype(np.float32)
    x[0, 1, 2] = 0.0  # the 1e-8 floor
    wq, ws = JL._quant_kv(jnp.asarray(x))
    gq, gs = TL._quant_kv(torch.from_numpy(x))
    assert gq.dtype == torch.int8 and gs.shape == (2, 5, 4, 1)
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


@pytest.mark.parametrize("s,cache_index", [(1, 6), (3, 4)])
def test_int8_kv_attention_matches_jax(s, cache_index):
    """The factored int8 attention over the cache's first cache_index + s
    positions against the JAX function's bias mask over the whole cache."""
    rng = np.random.default_rng(31)
    b, length, h, d = 2, 9, 4, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    kq, ks = JL._quant_kv(jnp.asarray(rng.standard_normal((b, length, h, d)).astype(np.float32)))
    vq, vs = JL._quant_kv(jnp.asarray(rng.standard_normal((b, length, h, d)).astype(np.float32)))
    ks, vs = jnp.transpose(ks[..., 0], (0, 2, 1)), jnp.transpose(vs[..., 0], (0, 2, 1))
    col = jnp.arange(length)[None, None, None, :]
    row = jnp.arange(s)[None, None, :, None] + cache_index
    bias = jnp.where(col < cache_index + s, 0.0, -1e30) + jnp.where(col <= row, 0.0, -1e30)
    want = JL._int8_kv_attention(jnp.asarray(q), kq, ks, vq, vs, bias)
    n = cache_index + s
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    mask = torch.arange(n)[None, :] <= torch.arange(s)[:, None] + cache_index if s > 1 else None
    got = TL._int8_kv_attention(t(q), t(kq)[:, :n], t(ks)[:, :, :n], t(vq)[:, :n], t(vs)[:, :, :n], mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    with pytest.raises(AssertionError):  # the factored form needs kv_heads == heads
        TL._int8_kv_attention(t(q), t(kq)[:, :n, :2], t(ks)[:, :2, :n], t(vq)[:, :n, :2], t(vs)[:, :2, :n])


def test_int8_kv_cached_decode_matches_jax(tiny):
    """Prefill 6 into an int8 cache, decode 4 one at a time: each step's
    logits within 1e-4 of the JAX module path's on its int8 cache, and the
    caches' int8 planes bit for bit (scales 1e-6)."""
    agent, jagent = _port(tiny, "head_int8"), _jax_agent(tiny, "head_int8")
    ids = _ids(32, 2, 10, tiny[0].llama.vocab_size)
    pos = np.broadcast_to(np.arange(10), (2, 10))
    jcaches = jagent.llama.init_cache(2, 16, dtype=jnp.int8)
    caches = agent.model.init_cache(2, 16, dtype=torch.int8)
    assert len(caches[0]) == 4 and caches[0][0].dtype == torch.int8 and caches[0][1].shape == (2, 4, 16)
    p = {"params": jagent.params["llama"]}
    for lo, hi in ((0, 6), (6, 7), (7, 8), (8, 9), (9, 10)):
        want, jcaches = jagent.llama.apply(p, jnp.asarray(ids[:, lo:hi]), jnp.asarray(pos[:, lo:hi]),
                                           jcaches, lo, method=jagent.llama.forward_ids)
        with torch.no_grad():
            got = agent.model.forward_ids(torch.from_numpy(ids[:, lo:hi]), torch.from_numpy(pos[:, lo:hi].copy()),
                                          caches, cache_index=lo)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL, err_msg=f"at {lo}")
    for (kq, ks, vq, vs), jc in zip(caches, jcaches):
        np.testing.assert_array_equal(kq.numpy(), np.asarray(jc[0]))
        np.testing.assert_array_equal(vq.numpy(), np.asarray(jc[2]))
        np.testing.assert_allclose(ks.numpy(), np.asarray(jc[1]), rtol=1e-6, atol=0)
        np.testing.assert_allclose(vs.numpy(), np.asarray(jc[3]), rtol=1e-6, atol=0)


def test_bf16_kv_cache_under_fp32_compute_matches_jax(tiny):
    """An fp32 model decoding from a bf16 KV cache reads the cache in fp32,
    as JAX's einsum promotes it (the port's decode refused the mixed dtypes
    before): prefill 6, decode 4, logits within 1e-4 of the JAX module
    path's on its own bf16 cache."""
    agent, jagent = _port(tiny, "int4_native"), _jax_agent(tiny, "int4_native")
    ids = _ids(36, 2, 10, tiny[0].llama.vocab_size)
    pos = np.broadcast_to(np.arange(10), (2, 10))
    jcaches = jagent.llama.init_cache(2, 16, dtype=jnp.bfloat16)
    caches = agent.model.init_cache(2, 16, dtype=torch.bfloat16)
    p = {"params": jagent.params["llama"]}
    for lo, hi in ((0, 6), (6, 7), (7, 8), (8, 9), (9, 10)):
        want, jcaches = jagent.llama.apply(p, jnp.asarray(ids[:, lo:hi]), jnp.asarray(pos[:, lo:hi]),
                                           jcaches, lo, method=jagent.llama.forward_ids)
        with torch.no_grad():
            got = agent.model.forward_ids(torch.from_numpy(ids[:, lo:hi]), torch.from_numpy(pos[:, lo:hi].copy()),
                                          caches, cache_index=lo)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL, err_msg=f"at {lo}")


# ------------------------------------------------------------- weight modes


def test_quantized_state_dicts_equal_jax(tiny):
    """Native int4 (values and scales bit for bit, column pairs) and the int8
    head (nearest, bit for bit) against quantize_llama_params; the bridge
    carries the JAX-quantized trees into state dicts that load strictly and
    equal the port's own quantization."""
    jcfg, params, sd = tiny
    for mode in ("int4_native", "lean"):
        cfg, jparams = _jax_cfg_params(tiny, mode)
        pcfg = _port_cfg(cfg).llama
        qt = TL.quantize_llama_state_dict(sd, pcfg, 4, stochastic=False, native=pcfg.int4_native,
                                          head_int8=pcfg.head_int8)
        bridged = W.captioner_state_dict_from_jax(jparams, cfg)
        port = _port(tiny, mode, state_dict=bridged).model.state_dict()
        qname = "qn" if pcfg.int4_native else "qp"
        for i in range(jcfg.llama.layers):
            for jname, tname in (("qkv_proj", "self_attn.qkv_proj"), ("down_proj", "mlp.down_proj")):
                leaf = jparams["llama"]["model"][f"layer_{i}"][jname]
                key = f"model.layers.{i}.{tname}"
                values = Q.unpack_int4_native(qt[f"{key}.qn"]) if qname == "qn" else Q.unpack_int4_paired(qt[f"{key}.qp"])
                want = leaf["qn"] if qname == "qn" else JQ.unpack_int4_paired(leaf["qp"])
                np.testing.assert_array_equal(values.numpy(), np.asarray(want).astype(np.int8))
                np.testing.assert_array_equal(qt[f"{key}.scale"].numpy(), np.asarray(leaf["scale"]))
                for k in (qname, "scale"):
                    assert torch.equal(bridged[f"{key}.{k}"], qt[f"{key}.{k}"])
                    assert torch.equal(port[f"{key}.{k}"], qt[f"{key}.{k}"])
        if pcfg.head_int8:
            head = jparams["llama"]["lm_head"]
            np.testing.assert_array_equal(qt["lm_head.q"].numpy(), np.asarray(head["q"]))
            np.testing.assert_array_equal(qt["lm_head.scale"].numpy(), np.asarray(head["scale"]))
            assert torch.equal(bridged["lm_head.q"], qt["lm_head.q"]) and "lm_head.weight" not in bridged


@pytest.mark.parametrize("mode", ["int4_native", "head_int8", "w4a8_unfused", "w4a8_fused"])
def test_llama_stack_modes_match_jax(tiny, mode):
    """Full-sequence logits through the stack in each weight mode."""
    agent, jagent = _port(tiny, mode), _jax_agent(tiny, mode)
    ids = _ids(33, 2, 11, tiny[0].llama.vocab_size)
    pos = np.broadcast_to(np.arange(11), (2, 11))
    want, _ = jagent.llama.apply({"params": jagent.params["llama"]}, jnp.asarray(ids), jnp.asarray(pos),
                                 method=jagent.llama.forward_ids)
    with torch.no_grad():
        got = agent.model.forward_ids(torch.from_numpy(ids), torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_w4a8_modules_match_jax_on_injected_inputs(tiny):
    """Each W4A8 site on the same input: Int4PairedLinear(act_int8) against
    Int4PairedDense(act_int8), and one fused-glue LlamaBlock against the JAX
    block (its four quantizers inside), 1e-5."""
    rng = np.random.default_rng(34)
    w = (rng.standard_normal((64, 96)) / 8).astype(np.float32)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    qp, scale = JQ.quantize_int4_paired(jnp.asarray(w))
    want = JL.Int4PairedDense(96, act_int8=True).apply({"params": {"qp": qp, "scale": scale}}, jnp.asarray(x))
    lin = TL.Int4PairedLinear(64, 96, act_int8=True)
    lin.qp.copy_(torch.from_numpy(np.array(qp)))
    lin.scale.copy_(torch.from_numpy(np.array(scale)))
    np.testing.assert_allclose(lin(torch.from_numpy(x)).detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)

    agent, jagent = _port(tiny, "w4a8_fused"), _jax_agent(tiny, "w4a8_fused")
    cfg = jagent.cfg.llama
    h = rng.standard_normal((2, 7, cfg.dim)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7), (2, 7))
    cos, sin = JL.rotary_cos_sin(jnp.asarray(pos), cfg.head_dim, cfg.rope_theta)
    want, _ = JL.LlamaBlock(cfg).apply({"params": jagent.params["llama"]["model"]["layer_1"]}, jnp.asarray(h),
                                       cos, sin)
    tcos, tsin = TL.rotary_cos_sin(torch.from_numpy(pos.copy()), cfg.head_dim, cfg.rope_theta)
    with torch.no_grad():
        got = agent.model.model.layers[1](torch.from_numpy(h), tcos, tsin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_fused_pair_decode_step_matches_jax(lean, tiny):
    """fused_pair_decode_step after a module-path prefill into int8 caches:
    four decode steps, logits and caches against JAX's function."""
    agent, jagent = lean
    model, jllama = agent.model, jagent.llama
    p = {"params": jagent.params["llama"]}
    ids = _ids(35, 2, 10, tiny[0].llama.vocab_size)
    pos = np.broadcast_to(np.arange(10), (2, 10))
    jcaches = jllama.init_cache(2, 16, dtype=jnp.int8)
    caches = model.init_cache(2, 16, dtype=torch.int8)
    _, jcaches = jllama.apply(p, jnp.asarray(ids[:, :6]), jnp.asarray(pos[:, :6]), jcaches, 0,
                              method=jllama.forward_ids)
    with torch.no_grad():
        model.forward_ids(torch.from_numpy(ids[:, :6]), torch.from_numpy(pos[:, :6].copy()), caches, cache_index=0)
        for i in range(6, 10):
            emb = jllama.apply(p, jnp.asarray(ids[:, i:i + 1]), method=jllama.embed)
            want, jcaches = JL.fused_pair_decode_step(jagent.cfg.llama, jagent.params["llama"], emb,
                                                      jnp.asarray(pos[:, i:i + 1]), jcaches, i,
                                                      compute_dtype=jnp.float32)
            got = TL.fused_pair_decode_step(model, model.embed(torch.from_numpy(ids[:, i:i + 1])),
                                            torch.from_numpy(pos[:, i:i + 1].copy()), caches, i)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL, err_msg=f"step {i}")
    for (kq, ks, vq, vs), jc in zip(caches, jcaches):
        np.testing.assert_array_equal(kq.numpy(), np.asarray(jc[0]))
        np.testing.assert_array_equal(vq.numpy(), np.asarray(jc[2]))
        np.testing.assert_allclose(ks.numpy(), np.asarray(jc[1]), rtol=1e-6, atol=0)
        np.testing.assert_allclose(vs.numpy(), np.asarray(jc[3]), rtol=1e-6, atol=0)


# -------------------------------------------------------------------- slice


def test_gen_image_caption_lean_matches_jax(lean):
    """The slice: tiny greedy gen_image_caption in the memory-lean mode (int4
    fused pairs, int8 KV cache, int8 head) gives the JAX agent's token stream
    token for token, and the same captions."""
    agent, jagent = lean
    img = _image()
    seqs, stop_at, _ = agent.generate([img], temperature=0.0)
    tok, plen, caches, stopper, _ = jagent._prefill_images([img], None, "vicuna_v1")
    want_seqs, want_stop = jagent._decode_tokens(tok, plen, caches, 0, 0.0, 0.7, 2, stopper)
    assert seqs.shape[1] == agent.cfg.max_new_tokens
    np.testing.assert_array_equal(seqs, np.asarray(want_seqs))
    np.testing.assert_array_equal(stop_at, np.asarray(want_stop))
    assert agent.gen_image_caption([img], temperature=0.0) == jagent.gen_image_caption([img], temperature=0.0)


def test_chat_matches_jax(lean):
    """A text-only turn: the same reply as the JAX agent's chat, greedy."""
    agent, jagent = lean
    for text in ("What is in a photograph of a lake?", "Hi"):
        assert agent.chat(text, temperature=0.0) == jagent.chat(text, temperature=0.0)


def test_chat_cli_runs_on_the_cpu(capsys, tmp_path):
    TChat.main(["--tiny-random", "--device", "cpu", "--query", "Hello", "--temperature", "0"])
    text = capsys.readouterr().out
    assert text.endswith("\n") and len(text.splitlines()) == 1
    from PIL import Image

    path = tmp_path / "img.png"
    Image.fromarray(_image()).save(path)
    TChat.main(["--tiny-random", "--device", "cpu", "--image", str(path), "--query", "What is this?"])
    assert len(capsys.readouterr().out.splitlines()) == 1
    with pytest.raises(SystemExit):
        TChat.main(["--device", "cpu", "--query", "Hello"])
