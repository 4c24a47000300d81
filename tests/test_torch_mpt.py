"""The port's MPT (supir_tpu_torch.captioner.mpt), its weights, preprocess
and causal-LM loss against the JAX package's on the CPU, at tiny widths and
fp32.

Weights: `init_mpt_params` (numpy; held bit for bit to the JAX function in
every scheme here), with every LayerNorm scale and bias made random too
(1 + 0.1 N, 0.1 N), bridged by `mpt_state_dict_from_jax`. Tolerances, each
with its reason:
- slopes, biases, init trees, rule tables, the weight bridge, preprocess:
  exact (the same numpy arithmetic, or integers);
- logits of the tiny model (no cache, multiquery, six heads, prefill and
  cached decode, prefix-LM): atol 1e-4 + rtol 1e-4, fp32 summation order
  over widths of 16-256 (readings are ~1e-6); the same with JAX's Pallas
  ALiBi kernel in interpret mode (SUPIR_ATTN_IMPL=flash);
- greedy `mpt_generate`: token for token;
- the causal-LM loss relative 1e-4 and every parameter gradient atol/rtol
  2e-3 (the train step's bounds), on the plain route and with every
  attention site forced through `FlashAttention`.
The kernels (K3 and K4 ALiBi) are held to these plain versions on the card
by tests/test_torch_ops.py's `gpu` tests and chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supir_tpu.captioner import convert as JConv
from supir_tpu.captioner import mpt as JM
from supir_tpu.captioner import preprocess as JP
from supir_tpu.captioner import train as JT
from supir_tpu_torch.captioner import mpt as TM
from supir_tpu_torch.captioner import preprocess as TP
from supir_tpu_torch.captioner import train as TT
from supir_tpu_torch.ops import attention as attn_ops
from supir_tpu_torch.ops.flash_attention import FlashAttention, alibi_bias
from supir_tpu_torch.utils import ckpt_rules as R
from supir_tpu_torch.utils import weights as W

TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=2e-3, rtol=2e-3)
TINY = TM.MPTConfig().tiny()
CONFIGS = {
    "mha": TINY,
    "mqa": dataclasses.replace(TINY, multiquery=True),
    "heads6": dataclasses.replace(TINY, d_model=96, n_heads=6),  # interleaved slopes
}


def _jax_cfg(cfg):
    return JM.MPTConfig(**dataclasses.asdict(cfg))


def _tree(cfg, seed=0):
    """init_mpt_params with random LayerNorm scales and biases."""
    tree = TM.init_mpt_params(cfg, seed)
    rng = np.random.default_rng(seed + 100)
    for name, node in tree.items():
        for ln in ([node["norm_1"], node["norm_2"]] if name.startswith("block_") else
                   [node] if name == "norm_f" else []):
            ln["ln"]["scale"] = (1 + 0.1 * rng.standard_normal(cfg.d_model)).astype(np.float32)
            ln["ln"]["bias"] = (0.1 * rng.standard_normal(cfg.d_model)).astype(np.float32)
    return tree


def _pair(cfg, seed=0):
    """(JAX module, its params, port model) with the same weights."""
    tree = _tree(cfg, seed)
    model = TM.create_mpt(cfg, device="cpu", dtype=torch.float32, state_dict=W.mpt_state_dict_from_jax(tree, cfg))
    return JM.MPTForCausalLM(_jax_cfg(cfg)), jax.tree_util.tree_map(jnp.asarray, tree), model


def _ids(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _close(got, want, **tol):
    if torch.is_tensor(want):
        want = want.detach().numpy()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


# ------------------------------------------------------------ slopes, biases


@pytest.mark.parametrize("heads", [4, 6, 32])
def test_alibi_slopes_and_biases_equal_jax(heads):
    np.testing.assert_array_equal(TM.alibi_slopes(heads), JM.alibi_slopes(heads))
    np.testing.assert_array_equal(TM.alibi_slopes(heads, 16.0), JM.alibi_slopes(heads, 16.0))
    np.testing.assert_array_equal(TM.build_alibi_bias(heads, 37), JM.build_alibi_bias(heads, 37))
    # the decode path's device-built bias is the same column bias
    slopes = torch.from_numpy(TM.alibi_slopes(heads))
    np.testing.assert_array_equal(alibi_bias(slopes, 37).numpy(), JM.build_alibi_bias(heads, 37))
    np.testing.assert_array_equal(TM.build_alibi_bias_full(heads, 19), JM.build_alibi_bias_full(heads, 19))
    mask = np.zeros((2, 11), np.int32)
    mask[0, :4] = 1
    cfg = dataclasses.replace(TINY, d_model=16 * heads, n_heads=heads)
    want = JM.prefix_lm_bias(_jax_cfg(cfg), jnp.asarray(mask))
    np.testing.assert_array_equal(TM.prefix_lm_bias(cfg, torch.from_numpy(mask)).numpy(), np.asarray(want))


@pytest.mark.parametrize("name", TM.MODEL_INIT_REGISTRY)
def test_init_mpt_params_equal_jax(name):
    """Every registry scheme, the same arrays bit for bit (multiquery, so the
    fused Wqkv's splits differ in width)."""
    cfg = dataclasses.replace(TINY, multiquery=True)
    kw = dict(init_std=0.02) if name == "baseline_" else {}
    if name.startswith("xavier"):
        kw["init_gain"] = 1.0
    want = JM.init_mpt_params(_jax_cfg(cfg), seed=3, name=name, **kw)
    got = TM.init_mpt_params(cfg, seed=3, name=name, **kw)
    flat_w, flat_g = jax.tree_util.tree_leaves_with_path(want), jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert g.dtype == np.float32, path
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(path))


def test_init_options_equal_jax():
    """emb_init_std and the residual divisor's other forms."""
    for kw in (dict(emb_init_std=0.5), dict(init_div_is_residual=False), dict(init_div_is_residual=3.0)):
        want = JM.init_mpt_params(_jax_cfg(TINY), seed=4, **kw)
        got = TM.init_mpt_params(TINY, seed=4, **kw)
        for w, g in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)):
            np.testing.assert_array_equal(g, np.asarray(w))
    with pytest.raises(KeyError):
        TM.init_mpt_params(TINY, name="nope_")
    with pytest.raises(ValueError):
        TM.init_mpt_params(TINY, name="baseline_")


# -------------------------------------------------------------- the model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lp_layernorm_matches_flax(dtype):
    """LPLayerNorm: fp32 statistics with flax's eps 1e-6 (torch's default
    1e-5 would show at this input's variance, ~1e-6), fp32 parameters, the
    result in the compute dtype."""
    rng = np.random.default_rng(23)
    # zero mean: flax computes the variance as E[x^2] - E[x]^2, which a mean
    # far from 0 at this scale would cancel away
    x = (1e-3 * rng.standard_normal((2, 5, 32))).astype(np.float32)
    scale, bias = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32), rng.standard_normal(32).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = JM.LPLayerNorm(dtype=jdt).apply({"params": {"ln": {"scale": scale, "bias": bias}}},
                                           jnp.asarray(x).astype(jdt))
    norm = TM.LPLayerNorm(32, dtype=tdt)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
    got = norm(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and str(want.dtype) == dtype
    tol = TOL if dtype == "float32" else dict(atol=2e-2, rtol=1e-2)  # one bf16 rounding of the output
    _close(got.float(), np.asarray(want, np.float32), **tol)


def test_bf16_model_gives_bf16_logits_as_jax():
    """A bf16 model's tied head multiplies in bf16, so its logits are bf16
    (flax's Embed.attend promotes both operands to the module's dtype);
    the values agree with JAX's bf16 module within bf16 roundings."""
    cfg = TINY
    tree = _tree(cfg, seed=24)
    ids = _ids(cfg, (1, 10), seed=25)
    want = JM.MPTForCausalLM(_jax_cfg(cfg), dtype=jnp.bfloat16).apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, tree)}, jnp.asarray(ids))
    model = TM.create_mpt(cfg, device="cpu", dtype=torch.bfloat16, state_dict=W.mpt_state_dict_from_jax(tree, cfg))
    got = model(torch.from_numpy(ids).long())
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16

    def rel(got, want):
        want = np.asarray(want, np.float32)
        return np.linalg.norm(got.float().detach().numpy() - want) / np.linalg.norm(want)

    assert rel(got, want) < 2e-2
    # cached decode of a bf16 model over the default fp32 cache: bf16 weights
    # meet fp32 values, which the plain route promotes as jnp.einsum does
    jm = JM.MPTForCausalLM(_jax_cfg(cfg), dtype=jnp.bfloat16)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jc, tc = jm.init_cache(1, 12), model.init_cache(1, 12)
    _, jc = jm.apply({"params": jp}, jnp.asarray(ids[:, :8]), caches=jc, cache_index=0)
    _, tc = model(torch.from_numpy(ids[:, :8]).long(), caches=tc, cache_index=0)
    want, _ = jm.apply({"params": jp}, jnp.asarray(ids[:, 8:9]), caches=jc, cache_index=8)
    got, _ = model(torch.from_numpy(ids[:, 8:9]).long(), caches=tc, cache_index=8)
    assert got.dtype == torch.bfloat16 and rel(got, want) < 2e-2



@pytest.mark.parametrize("label", CONFIGS)
def test_forward_matches_jax(label):
    """No cache: logits [B, S, V], and the embedding's forward_embeds."""
    cfg = CONFIGS[label]
    jm, jp, tm = _pair(cfg)
    ids = _ids(cfg, (2, 12))
    want = jm.apply({"params": jp}, jnp.asarray(ids))
    got = tm(torch.from_numpy(ids).long())
    assert got.shape == (2, 12, cfg.vocab_size) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("label", ["mha", "mqa"])
def test_forward_matches_jax_pallas_alibi(label, monkeypatch):
    """The JAX side on its Pallas ALiBi kernel (interpret mode) instead of
    XLA: the no-cache forward and the prefill fast path."""
    monkeypatch.setenv("SUPIR_ATTN_IMPL", "flash")
    cfg = CONFIGS[label]
    jm, jp, tm = _pair(cfg, seed=5)
    ids = _ids(cfg, (2, 12), seed=6)
    _close(tm(torch.from_numpy(ids).long()), jm.apply({"params": jp}, jnp.asarray(ids)))
    want, _ = jm.apply({"params": jp}, jnp.asarray(ids), caches=jm.init_cache(2, 16), cache_index=0)
    got, _ = tm(torch.from_numpy(ids).long(), caches=tm.init_cache(2, 16), cache_index=0)
    _close(got, want)


@pytest.mark.parametrize("label", ["mha", "mqa"])
def test_cached_decode_matches_jax(label):
    """Prefill into the fp32 cache (the fast path, cache_index the int 0),
    then cached decode one token at a time (valid mask + column bias over
    the whole cache): logits of every call and the caches after."""
    cfg = CONFIGS[label]
    jm, jp, tm = _pair(cfg, seed=7)
    ids = _ids(cfg, (2, 10), seed=8)
    plen = 6
    jc, tc = jm.init_cache(2, 16), tm.init_cache(2, 16)
    want, jc = jm.apply({"params": jp}, jnp.asarray(ids[:, :plen]), caches=jc, cache_index=0)
    got, tc = tm(torch.from_numpy(ids[:, :plen]).long(), caches=tc, cache_index=0)
    _close(got, want)
    for i in range(plen, 10):
        want, jc = jm.apply({"params": jp}, jnp.asarray(ids[:, i:i + 1]), caches=jc, cache_index=i)
        got, tc = tm(torch.from_numpy(ids[:, i:i + 1]).long(), caches=tc, cache_index=i)
        _close(got, want)
    for (jk, jv), (tk, tv) in zip(jc, tc):
        _close(tk, jk)
        _close(tv, jv)
    # the cached run is the teacher-forced forward
    _close(got[:, -1], tm(torch.from_numpy(ids).long())[:, -1])


def test_prefix_lm_matches_jax():
    """Prefix-LM: the full symmetric ALiBi inside the prefix, causal after."""
    cfg = dataclasses.replace(TINY, prefix_lm=True)
    jm, jp, tm = _pair(cfg, seed=9)
    ids = _ids(cfg, (2, 12), seed=10)
    mask = np.zeros((2, 12), np.int32)
    mask[0, :5] = 1
    mask[1, :12] = 1
    want = jm.apply({"params": jp}, jnp.asarray(ids), prefix_mask=jnp.asarray(mask))
    got = tm(torch.from_numpy(ids).long(), prefix_mask=torch.from_numpy(mask))
    _close(got, want)


def test_prefix_lm_errors_match_jax():
    """The three refusals of mpt.py:221-245, on both sides."""
    ids = _ids(TINY, (1, 6), seed=11)
    mask = np.ones((1, 6), np.int32)
    plain = _pair(TINY)
    prefix = _pair(dataclasses.replace(TINY, prefix_lm=True))
    cases = [
        (plain, dict(prefix_mask=mask), "requires MPTConfig.prefix_lm"),
        (prefix, dict(prefix_mask=mask, caches=True), "does not support the KV cache"),
        (prefix, dict(), "prefix_mask is required"),
    ]
    for (jm, jp, tm), kw, msg in cases:
        jkw, tkw = {}, {}
        if "prefix_mask" in kw:
            jkw["prefix_mask"], tkw["prefix_mask"] = jnp.asarray(mask), torch.from_numpy(mask)
        if "caches" in kw:
            jkw.update(caches=jm.init_cache(1, 8), cache_index=0)
            tkw.update(caches=tm.init_cache(1, 8), cache_index=0)
        with pytest.raises(ValueError, match=msg):
            jm.apply({"params": jp}, jnp.asarray(ids), **jkw)
        with pytest.raises(ValueError, match=msg):
            tm(torch.from_numpy(ids).long(), **tkw)


@pytest.mark.parametrize("label", ["mha", "mqa"])
def test_generate_greedy_matches_jax(label):
    """Greedy mpt_generate, token for token, and the early stop at eos."""
    cfg = CONFIGS[label]
    jm, jp, tm = _pair(cfg, seed=12)
    ids = _ids(cfg, (2, 8), seed=13)
    want = JM.mpt_generate(jm, jp, jnp.asarray(ids), max_new_tokens=12, eos_id=-1)
    got = TM.mpt_generate(tm, torch.from_numpy(ids).long(), max_new_tokens=12, eos_id=-1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (2, 12)
    eos = int(want[0, 3])
    want = JM.mpt_generate(jm, jp, jnp.asarray(ids[:1]), max_new_tokens=12, eos_id=eos)
    got = TM.mpt_generate(tm, torch.from_numpy(ids[:1]).long(), max_new_tokens=12, eos_id=eos)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape[1] <= 4


def test_generate_samples_at_temperature():
    """Sampling draws from a torch generator (not jax.random's stream):
    valid ids, the same seed the same tokens; the first token is greedy."""
    _, _, tm = _pair(TINY, seed=14)
    ids = torch.from_numpy(_ids(TINY, (2, 5), seed=15)).long()
    a = TM.mpt_generate(tm, ids, max_new_tokens=8, temperature=1.0, eos_id=-1, seed=3)
    b = TM.mpt_generate(tm, ids, max_new_tokens=8, temperature=1.0, eos_id=-1, seed=3)
    greedy = TM.mpt_generate(tm, ids, max_new_tokens=8, eos_id=-1)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert a.shape == (2, 8) and int(a.min()) >= 0 and int(a.max()) < TINY.vocab_size
    torch.testing.assert_close(a[:, 0], greedy[:, 0], rtol=0, atol=0)


# ---------------------------------------------------------------- gradient


@pytest.mark.parametrize("route", ["plain", "flash"])
@pytest.mark.parametrize("label", ["mha", "mqa"])
def test_causal_lm_gradients_match_jax(label, route, monkeypatch):
    """causal_lm_loss of the tiny model and every parameter's gradient
    against jax.value_and_grad. "flash": every attention site of the port
    goes through FlashAttention (its backward is K4's plain arithmetic) and
    the JAX side through its Pallas kernels' custom VJP."""
    cfg = CONFIGS[label]
    jm, jp, tm = _pair(cfg, seed=16)
    ids = _ids(cfg, (2, 12), seed=17)
    labels = ids.astype(np.int64)
    labels[:, :4] = TT.IGNORE_INDEX
    labels[1, 9] = TT.IGNORE_INDEX
    sites = []
    if route == "flash":
        monkeypatch.setenv("SUPIR_ATTN_IMPL", "flash")
        monkeypatch.setattr(attn_ops, "flash_eligible", lambda s, t, d: True)

        class Counted(FlashAttention):
            @staticmethod
            def forward(ctx, *args):
                sites.append(args[4] is not None)
                return FlashAttention.forward(ctx, *args)

        monkeypatch.setattr(attn_ops, "FlashAttention", Counted)

    def jax_loss(p):
        return JT.causal_lm_loss(jm.apply({"params": p}, jnp.asarray(ids)), jnp.asarray(labels))

    want_loss, want_grads = jax.value_and_grad(jax_loss)(jp)
    loss = TT.causal_lm_loss(tm(torch.from_numpy(ids).long()), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    assert sites == ([True] * cfg.n_layers if route == "flash" else [])
    want = W.mpt_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, want_grads), cfg)
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, **GRAD_TOL)


def test_causal_lm_loss_matches_jax():
    rng = np.random.default_rng(18)
    logits = rng.standard_normal((2, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 7))
    labels[0, :3] = TT.IGNORE_INDEX
    want = JT.causal_lm_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = TT.causal_lm_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    none = np.full((1, 4), TT.IGNORE_INDEX)
    assert TT.causal_lm_loss(torch.from_numpy(logits[:1, :4]), torch.from_numpy(none)).item() == 0.0
    assert TT.IGNORE_INDEX == JT.IGNORE_INDEX == -100


# ----------------------------------------------------------------- weights


def test_mpt_rules_equal_jax_at_full_width():
    cfg = TM.MPTConfig()
    assert R.mpt_rules(cfg) == JConv.mpt_rules(_jax_cfg(cfg))


def test_jax_tree_bridge_round_trips():
    """JAX tree -> the port's state dict (which loads strictly) -> JAX's own
    converter gives the tree back, bit for bit."""
    cfg = CONFIGS["mqa"]
    tree = _tree(cfg, seed=19)
    sd = W.mpt_state_dict_from_jax(tree, cfg)
    TM.MPTForCausalLM(cfg).load_state_dict(sd, strict=True)
    back, report = JConv.convert_mpt_state_dict({k: v.numpy() for k, v in sd.items()}, _jax_cfg(cfg))
    assert not report.missing and not report.unused
    flat_t, flat_b = jax.tree_util.tree_leaves_with_path(tree), jax.tree_util.tree_leaves_with_path(back)
    assert sorted(str(p) for p, _ in flat_t) == sorted(str(p) for p, _ in flat_b)
    back_by_path = {str(p): v for p, v in flat_b}
    for path, v in flat_t:
        np.testing.assert_array_equal(np.asarray(back_by_path[str(path)]), v, err_msg=str(path))


def test_no_bias_state_dict_loader_matches_jax():
    """A no_bias checkpoint (LayerNorm biases stripped, mpt-7b's family):
    zeros filled in, and what is missing or unused reported as JAX reports
    it; the filled state dict loads strictly and runs."""
    cfg = TINY
    sd = W.mpt_state_dict_from_jax(_tree(cfg, seed=20), cfg)
    no_bias = {k: v for k, v in sd.items() if not (k.endswith(".bias") and "norm" in k)}
    assert len(no_bias) == len(sd) - (2 * cfg.n_layers + 1)
    conv, report = W.convert_mpt_state_dict(no_bias, cfg)
    want, want_report = JConv.convert_mpt_state_dict({k: v.numpy() for k, v in no_bias.items()}, _jax_cfg(cfg))
    assert report.summary() == want_report.summary() and report.missing == [] and report.unused == []
    model = TM.create_mpt(cfg, device="cpu", dtype=torch.float32, state_dict=conv)
    assert float(model.transformer.blocks[1].norm_2.bias.detach().abs().sum()) == 0.0
    ids = _ids(cfg, (1, 6), seed=21)
    _close(model(torch.from_numpy(ids).long()),
           JM.MPTForCausalLM(_jax_cfg(cfg)).apply({"params": jax.tree_util.tree_map(jnp.asarray, want)},
                                                  jnp.asarray(ids)))

    broken = dict(no_bias, **{"transformer.blocks.0.attn.rotary.weight": torch.zeros(3)})
    del broken["transformer.blocks.1.ffn.up_proj.weight"]
    _, report = W.convert_mpt_state_dict(broken, cfg)
    _, want_report = JConv.convert_mpt_state_dict({k: v.numpy() for k, v in broken.items()}, _jax_cfg(cfg))
    assert report.missing == want_report.missing == [
        "transformer.blocks.1.ffn.up_proj.weight -> block_1/up_proj/Dense_0/kernel"]
    assert report.unused == want_report.unused == ["transformer.blocks.0.attn.rotary.weight"]
    assert report.filled == want_report.filled


# -------------------------------------------------------------- preprocess


CONV = [
    {"from": "human", "value": "<image>\nDescribe this image and its style."},
    {"from": "gpt", "value": "A watercolor harbor scene with tall ships."},
    {"from": "human", "value": "What colors dominate ?"},
    {"from": "gpt", "value": "Teal and amber, with muted grays."},
]
TEXT_CONV = [{"from": t["from"], "value": t["value"].replace("<image>\n", "")} for t in CONV]
PLAIN = [{"from": "human", "value": "<image>"}, {"from": "gpt", "value": "a harbor at dusk"}]


def _same(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert [list(x) for x in got[key]] == [list(x) for x in want[key]], key


@pytest.mark.parametrize("fn,sources,kw,bos", [
    ("preprocess_mpt", [CONV, TEXT_CONV], {}, False),
    ("preprocess_v1", [CONV], dict(has_image=True), True),
    ("preprocess_v1", [TEXT_CONV], {}, True),
    ("preprocess_plain", [PLAIN], {}, True),
    ("preprocess_llama_2", [CONV], dict(has_image=True), True),
    ("preprocess_v0", [TEXT_CONV], {}, True),
])
def test_preprocess_equals_jax(fn, sources, kw, bos):
    """The label maskers on the byte tokenizer: input_ids and labels equal.
    The round-length arithmetic of the v1 and llama-2 maskers assumes a
    SentencePiece tokenizer, so there the byte tokenizer's labels come out
    wholly masked on both sides; MPT's (no bos) and plain's keep the
    answers."""
    tok = TP.ByteTokenizer(bos=bos)
    want = getattr(JP, fn)(sources, tok, **kw)
    got = getattr(TP, fn)(sources, tok, **kw)
    _same(got, want)
    if fn in ("preprocess_mpt", "preprocess_plain"):
        for labels in got["labels"]:
            assert any(x != TP.IGNORE_INDEX for x in labels) and TP.IGNORE_INDEX in labels


def test_dataset_and_collate_equal_jax():
    """normalize_multimodal, the lazy dataset (one image record, one text
    record) and the static-shape collator."""
    rng = np.random.default_rng(22)
    image = rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
    records = [{"conversations": CONV, "image": "a.png"}, {"conversations": TEXT_CONV}]
    tok = TP.ByteTokenizer(bos=False)
    kw = dict(template_name="mpt", image_loader=lambda path: image, image_size=28)
    want_ds, got_ds = JP.LazyCaptionDataset(records, tok, **kw), TP.LazyCaptionDataset(records, tok, **kw)
    assert got_ds.lengths == want_ds.lengths and got_ds.modality_lengths == want_ds.modality_lengths
    items = [(got_ds[i], want_ds[i]) for i in range(2)]
    for got, want in items:
        np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
        np.testing.assert_array_equal(got["labels"], want["labels"])
        np.testing.assert_allclose(got["image"], want["image"], atol=1e-4)
    got = TP.collate([g for g, _ in items], pad_id=0, max_len=400)
    want = JP.collate([w for _, w in items], pad_id=0, max_len=400)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-4, err_msg=key)
