"""The port's captioner (supir_tpu_torch.captioner, models/clip.py) against
the JAX package's on the CPU, at tiny widths and fp32.

Weights: the JAX agent's own parameter shapes, every leaf random from a
numpy seed (norm scales 1 + 0.1 N, kernels N / sqrt(fan_in), the rest 0.1 N),
bridged by `captioner_state_dict_from_jax` and, in the quantized modes,
quantized on each side by its own package (bit for bit the same, checked
here). Tolerances, each with its reason:
- modules (CLIP block, vision tower, RMSNorm, rotary, projector, logits of
  the Llama stack in every weight mode): atol 1e-4 + rtol 1e-4, fp32
  summation order over widths of 64-256 (readings are ~1e-6);
- preprocess_images: atol 1e-4 on CLIP-normalised pixels, the resize built
  from the same separable weights as jax.image.resize;
- the slice, tiny greedy gen_image_caption in int4 fused mode: the same
  token stream, token for token, and prefill logits within PREFILL_ATOL;
- the sampling filter: the renormalised top-p distribution in descending
  order, atol 1e-6, before the draw (the two packages' RNGs differ).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supir_tpu.captioner import agent as JA
from supir_tpu.captioner import convert as JConv
from supir_tpu.captioner import llama as JL
from supir_tpu.captioner import vision as JV
from supir_tpu_torch.captioner import agent as TA
from supir_tpu_torch.captioner import llama as TL
from supir_tpu_torch.captioner import vision as TV
from supir_tpu_torch.models import clip as TC
from supir_tpu_torch.utils import ckpt_rules as R
from supir_tpu_torch.utils import weights as W

ATOL = RTOL = 1e-4
PREFILL_ATOL = 1e-4
MODES = {  # name -> (bits, fused_glue)
    "fp": (None, True),
    "int4_fused": (4, True),
    "int4_unfused": (4, False),
    "int8": (8, True),
}


def _random_like(tree, seed):
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = np.shape(leaf)
        if name == "kernel":
            v = rng.standard_normal(shape) * float(np.prod(shape[:-1])) ** -0.5
        elif name in ("scale", "weight"):
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _port_cfg(jcfg) -> TA.CaptionerConfig:
    d = dataclasses.asdict(jcfg)
    return TA.CaptionerConfig(vision=TV.CLIPVisionConfig(**d.pop("vision")),
                              llama=TL.LlamaConfig(**d.pop("llama")), **d)


def _jax_mode(jcfg, params, bits, fused_glue):
    """(cfg, params) of the JAX agent in a weight mode, as its create_default
    quantizes them (agent.py:191-206)."""
    if bits is None:
        return jcfg, params
    qllama, _ = JL.quantize_llama_params(params["llama"], bits=bits, fuse=True)
    llama = dataclasses.replace(jcfg.llama, quantize_int4=bits == 4, quantize_int8=bits == 8,
                                fused_qkv=True, fused_glue=fused_glue)
    return dataclasses.replace(jcfg, llama=llama), dict(params, llama=qllama)


@pytest.fixture(scope="module")
def tiny():
    jcfg = JA.CaptionerConfig.tiny()
    shapes = JA.CaptionerAgent.create_random(jcfg, seed=0).params
    params = _random_like(shapes, seed=1)
    return jcfg, params, W.captioner_state_dict_from_jax(params, jcfg)


def _port(tiny, mode):
    jcfg, _, sd = tiny
    bits, fused_glue = MODES[mode]
    return TA.create_captioner(_port_cfg(jcfg), "cpu", bits=bits, fused_glue=fused_glue,
                               state_dict=sd, stochastic=False)


def _jax_agent(tiny, mode):
    jcfg, params, _ = tiny
    cfg, p = _jax_mode(jcfg, params, *MODES[mode])
    return JA.CaptionerAgent(cfg, jax.tree_util.tree_map(jnp.asarray, p))


def _image(seed=2, h=80, w=56):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


# --------------------------------------------------------------- rule tables


def test_captioner_rule_tables_equal_jax_at_full_width():
    cfg = JA.CaptionerConfig()
    assert R.llama_rules(cfg.llama) == JConv.llama_rules(cfg.llama)
    assert R.vision_rules(cfg.vision) == JConv.vision_rules(cfg.vision)
    assert R.projector_rules() == JConv.projector_rules()


def test_captioner_bridge_covers_full_width():
    """At LLaVA-1.5-13B width the unquantized port model has exactly the keys
    and shapes the JAX agent's trees bridge to (meta device, eval_shape)."""
    jcfg = JA.CaptionerConfig()

    def init():
        return JA.CaptionerAgent.create_random(jcfg, seed=0).params

    shapes = jax.eval_shape(init)
    with torch.device("meta"):
        model = TA.LlavaForCausalLM(_port_cfg(jcfg))
    port = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    bridged = {}
    for branch, rules in W.captioner_rules(jcfg).items():
        for tkey, fpath, kind in rules:
            leaf = shapes[branch]
            for p in fpath:
                leaf = leaf[p]
            shape = leaf.shape
            if kind == "linear":
                shape = shape[::-1]
            elif kind == "conv":
                shape = (shape[3], shape[2], shape[0], shape[1])
            bridged[tkey] = tuple(shape)
    assert port == bridged


@pytest.mark.parametrize("bits", [4, 8])
def test_quantized_state_dict_equals_jax(tiny, bits):
    """Port quantization of the bridged weights == quantize_llama_params
    (bits, fuse=True) bit for bit; int8 in nearest mode (JAX off the TPU)."""
    jcfg, params, sd = tiny
    qj, _ = JL.quantize_llama_params(params["llama"], bits=bits, fuse=True)
    qt = TL.quantize_llama_state_dict(sd, _port_cfg(jcfg).llama, bits, stochastic=False)
    qname = "qp" if bits == 4 else "q"
    for i in range(jcfg.llama.layers):
        for jname, tname in (("qkv_proj", "self_attn.qkv_proj"), ("o_proj", "self_attn.o_proj"),
                             ("gateup_proj", "mlp.gateup_proj"), ("down_proj", "mlp.down_proj")):
            leaf = qj["model"][f"layer_{i}"][jname]
            for jk, tk in ((qname, qname), ("scale", "scale")):
                np.testing.assert_array_equal(qt[f"model.layers.{i}.{tname}.{tk}"].numpy(), np.asarray(leaf[jk]))
    head = np.asarray(qj["lm_head"]["Dense_0"]["kernel"].astype(jnp.float32)).T
    np.testing.assert_array_equal(qt["lm_head.weight"].float().numpy(), head)


# ------------------------------------------------------------------ modules


def test_clip_block_matches_jax():
    from supir_tpu.models.clip import CLIPBlock, CLIPTextConfig

    cfg = CLIPTextConfig().tiny()
    x = np.random.default_rng(3).standard_normal((2, 17, cfg.width)).astype(np.float32)
    block = CLIPBlock(cfg)
    params = _random_like(block.init(jax.random.PRNGKey(0), jnp.asarray(x), None)["params"], seed=4)
    want = block.apply({"params": params}, jnp.asarray(x), None)
    # the block's rules are the vision tower's layer 0 with that prefix cut
    prefix = "model.vision_tower.vision_tower.vision_model.encoder.layers.0."
    rules = [(k[len(prefix):], fp[1:], kind) for k, fp, kind in R.vision_rules(dataclasses.replace(
        TV.CLIPVisionConfig(), layers=1)) if k.startswith(prefix)]
    port = TC.CLIPBlock(TC.CLIPTextConfig(width=cfg.width, heads=cfg.heads))
    port.load_state_dict(W.state_dict_from_rules(params, rules), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_vision_tower_and_projector_match_jax(tiny):
    jcfg, params, _ = tiny
    agent = _port(tiny, "fp")
    jagent = _jax_agent(tiny, "fp")
    s = jcfg.vision.image_size
    pixels = np.random.default_rng(5).standard_normal((2, s, s, 3)).astype(np.float32)
    want = jagent.vision.apply({"params": jagent.params["vision"]}, jnp.asarray(pixels))
    with torch.no_grad():
        got = agent.model.vision(torch.from_numpy(pixels))
    assert len(got) == len(want) == jcfg.vision.layers + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)
    feats = JV.select_patch_features(want, jcfg.mm_hidden_layer)
    want_proj = jagent.projector.apply({"params": jagent.params["projector"]}, feats)
    with torch.no_grad():
        got_proj = agent.model.model.mm_projector(TV.select_patch_features(got, jcfg.mm_hidden_layer))
    np.testing.assert_allclose(got_proj.numpy(), np.asarray(want_proj), atol=ATOL, rtol=RTOL)


def test_preprocess_images_matches_jax():
    """expand2square with the CLIP mean, then the antialiased Keys-cubic
    downscale of jax.image.resize: 1024x768 -> 336 needs both."""
    imgs = [_image(6, 1024, 768), _image(7, 300, 400), _image(8, 336, 336)]
    for img in imgs:
        want = JV.preprocess_images([img], 336)
        got = TV.preprocess_images([img], 336)
        assert got.shape == (1, 336, 336, 3) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_rmsnorm_and_rotary_match_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]])
    cos, sin = JL.rotary_cos_sin(jnp.asarray(pos), 16, 10000.0)
    tcos, tsin = TL.rotary_cos_sin(torch.from_numpy(pos), 16, 10000.0)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(cos), atol=1e-6)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(sin), atol=1e-6)
    want = JL.apply_rotary(jnp.asarray(x), cos, sin)
    got = TL.apply_rotary(torch.from_numpy(x), tcos, tsin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    h = rng.standard_normal((3, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    want = JL.RMSNorm(1e-6).apply({"params": {"weight": jnp.asarray(w)}}, jnp.asarray(h))
    norm = TL.RMSNorm(64, 1e-6)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(w))
        got = norm(torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_prompts_and_stopper_match_jax():
    """Every template's one-shot prompt, and KeywordStopper's cut points,
    equal the JAX package's (captioner/conversation.py)."""
    from supir_tpu.captioner import conversation as JCv
    from supir_tpu_torch.captioner import conversation as TCv

    assert sorted(TCv.conv_templates) == sorted(JCv.conv_templates)
    for mode in JCv.conv_templates:
        assert TCv.build_prompt(mode, "What is this?") == JCv.build_prompt(mode, "What is this?"), mode
        assert TCv.conv_templates[mode].stop_str == JCv.conv_templates[mode].stop_str, mode
    enc = {"</s>": [1, 7, 8], "###": [9]}
    decode = lambda ids: "".join(chr(65 + i % 26) for i in ids)  # noqa: E731
    for kws in (["</s>"], ["###", "</s>"]):
        stoppers = [m.KeywordStopper(kws, lambda k: enc[k], decode, bos_id=1) for m in (TCv, JCv)]
        for ids, start in (([3, 7, 8, 4], 0), ([3, 9, 7, 8], 2), ([5, 6], 0), ([7, 8], 1)):
            assert stoppers[0].find_stop(ids, start) == stoppers[1].find_stop(ids, start), (kws, ids, start)


def _ids(seed, b, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, n))


@pytest.mark.parametrize("mode", list(MODES))
def test_llama_stack_matches_jax(tiny, mode):
    """Full-sequence logits through every LlamaBlock of the stack, each
    weight mode: fp (nn.Linear), int4 fused glue (K5's plain version), int4
    unfused (K6's), int8 (K7's)."""
    agent, jagent = _port(tiny, mode), _jax_agent(tiny, mode)
    ids = _ids(10, 2, 11, tiny[0].llama.vocab_size)
    pos = np.broadcast_to(np.arange(11), (2, 11))
    want, _ = jagent.llama.apply({"params": jagent.params["llama"]}, jnp.asarray(ids), jnp.asarray(pos),
                                 method=jagent.llama.forward_ids)
    with torch.no_grad():
        got = agent.model.forward_ids(torch.from_numpy(ids), torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("mode", list(MODES))
def test_kv_cached_decode_matches_full_forward(tiny, mode):
    """Prefill 6 into the cache, decode 4 one at a time == the full forward
    (tests/test_captioner.py:18-45 for the JAX package)."""
    agent = _port(tiny, mode)
    model = agent.model
    ids = torch.from_numpy(_ids(11, 2, 10, tiny[0].llama.vocab_size))
    pos = torch.arange(10)[None].expand(2, -1)
    with torch.no_grad():
        full = model.forward_ids(ids, pos)
        caches = model.init_cache(2, 16)
        lg = model.forward_ids(ids[:, :6], pos[:, :6], caches, cache_index=0)
        torch.testing.assert_close(lg[:, -1], full[:, 5], atol=2e-4, rtol=0)
        for i in range(6, 10):
            lg = model.forward_ids(ids[:, i:i + 1], pos[:, i:i + 1], caches, cache_index=i)
            torch.testing.assert_close(lg[:, 0], full[:, i], atol=2e-4, rtol=0, msg=f"step {i}")


def test_sampling_filter_matches_jax(tiny, monkeypatch):
    """The JAX decode step's own top-p filter (agent.py:432-442), run without
    jit with its draw intercepted, against the port's top_p_filter on the same
    step's logits: the renormalised distribution in descending order."""
    jagent, agent = _jax_agent(tiny, "fp"), _port(tiny, "fp")
    img = _image()
    tok, plen, caches, _, _ = jagent._prefill_images([img], None, "vicuna_v1")
    seen = []

    def categorical(key, logits):
        seen.append(np.exp(np.asarray(logits)))
        return jnp.argmax(logits, axis=-1)

    monkeypatch.setattr(jax.random, "categorical", categorical)
    temperature, top_p = 0.7, 0.9
    with jax.disable_jit():
        _, decode_step, _ = jagent._prefill_decode
        decode_step(jagent.params, tok[:, None], jnp.full((1,), plen), caches, jax.random.PRNGKey(0),
                    jnp.float32(temperature), jnp.float32(top_p))
    want = seen[0]
    want = np.where(want > 1e-19, want, 0.0)  # the draw's log clamps zeros to 1e-20
    ttok, tplen, tcaches, _, _ = agent._prefill_images([img], None, "vicuna_v1")
    assert int(ttok[0]) == int(tok[0]) and tplen == plen
    logits = agent._step(ttok, tplen, tcaches)
    sort_idx, got = TA.top_p_filter(logits, temperature, top_p)
    kept = int((want > 0).sum())
    assert 1 < kept < want.shape[-1] and int((got > 0).sum()) == kept
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert int(sort_idx[0, 0]) == int(logits.argmax())


# -------------------------------------------------------------------- slice


def test_gen_image_caption_int4_matches_jax(tiny):
    """The slice: tiny greedy gen_image_caption in int4 fused mode gives the
    JAX agent's token stream token for token, its prefill logits agree within
    PREFILL_ATOL, and so do the captions."""
    agent, jagent = _port(tiny, "int4_fused"), _jax_agent(tiny, "int4_fused")
    img = _image()
    seqs, stop_at, stop_str = agent.generate([img], temperature=0.0)
    tok, plen, caches, stopper, jstop_str = jagent._prefill_images([img], None, "vicuna_v1")
    want_seqs, want_stop = jagent._decode_tokens(tok, plen, caches, 0, 0.0, 0.7, 2, stopper)
    assert seqs.shape[1] == agent.cfg.max_new_tokens
    np.testing.assert_array_equal(seqs, np.asarray(want_seqs))
    np.testing.assert_array_equal(stop_at, np.asarray(want_stop))
    assert agent.gen_image_caption([img], temperature=0.0) == jagent.gen_image_caption([img], temperature=0.0)

    # prefill logits: the embeddings each agent builds, through its stack
    pre, post = JA.vicuna_v1_prompt(JA.DEFAULT_QUESTION).split("<image>")
    img_emb = jagent._encode_image([img])
    emb = lambda ids: jagent._embed_jit(jagent.params, jnp.asarray(ids, jnp.int32)[None])  # noqa: E731
    embeds = jnp.concatenate([emb(jagent._tokenize(pre)), img_emb, emb(jagent._tokenize(post))], axis=1)
    positions = jnp.arange(embeds.shape[1])[None]
    want, _ = jagent.llama.apply({"params": jagent.params["llama"]}, embeds, positions)
    tembeds = torch.cat([agent._embed(agent._tokenize(pre), 1), agent._encode_image([img]),
                         agent._embed(agent._tokenize(post), 1)], dim=1)
    with torch.no_grad():
        got = agent.model(tembeds, torch.arange(tembeds.shape[1])[None])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PREFILL_ATOL, rtol=0)


def test_stream_yields_the_caption(tiny):
    agent = _port(tiny, "int4_fused")
    img = _image()
    *_, last = agent.gen_image_caption_stream([img], temperature=0.0)
    assert last == agent.gen_image_caption([img], temperature=0.0)


# --------------------------------------------------------- entry points


def test_create_captioner_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TA.create_captioner(TA.CaptionerConfig.tiny())


def test_unported_llama_options_raise():
    """Every LlamaConfig option of the JAX captioner builds in the port now
    (each module the flag selects, and a decode step through it); int4
    together with int8 still raises."""
    base = dataclasses.replace(TA.CaptionerConfig.tiny().llama, quantize_int4=True, fused_qkv=True)
    for flag, module in (("int4_native", TL.Int4NativeLinear), ("act_int8", TL.Int4PairedLinear),
                         ("head_int8", TL.Int8Linear), ("fused_pairs", TL.Int4PairedLinear)):
        cfg = dataclasses.replace(base, **{flag: True}, fused_glue=flag != "act_int8")
        model = TL.LlamaForCausalLM(cfg)
        assert isinstance(model.lm_head if flag == "head_int8" else model.model.layers[0].self_attn.o_proj, module)
        with torch.no_grad():
            caches = model.init_cache(1, 8, dtype=torch.int8)
            model.forward_ids(torch.zeros(1, 2, dtype=torch.long), torch.arange(2)[None], caches, cache_index=0)
            if flag == "fused_pairs":
                logits = TL.fused_pair_decode_step(model, model.embed(torch.zeros(1, 1, dtype=torch.long)),
                                                   torch.full((1, 1), 2), caches, 2)
                assert logits.shape == (1, 1, cfg.vocab_size) and torch.isfinite(logits).all()
    assert TL.LlamaForCausalLM(dataclasses.replace(base, act_int8=True)).model.layers[0].self_attn.o_proj.act_int8
    with pytest.raises(ValueError):
        TL.LlamaBlock(dataclasses.replace(base, quantize_int8=True))
