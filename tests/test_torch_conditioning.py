"""The port's SDXL text conditioning against the JAX package: the tokenizer,
both CLIP text towers, the conditioner and the engine's prepare_condition
family, at tiny widths in fp32 on the CPU, weights crossed by the bridge.

Bounds: token ids exact; tower states, conditioner outputs and
prepare_condition 1e-4 max abs (observed below 2e-6 on outputs of unit
scale: fp32 summation order differs between the packages); the ucg
dropout's all-0 and all-1 rates exact. At full width the conditioner's
keys and shapes are the reference manifest's, on the meta device.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supir_tpu.engine import factory as JF
from supir_tpu.engine.supir import SUPIREngine as JaxEngine
from supir_tpu.models import clip as JClip
from supir_tpu.models import embedders as JE
from supir_tpu.utils import ckpt as JC
from supir_tpu.utils import tokenizer as JT
from supir_tpu_torch import config as TCfg
from supir_tpu_torch.engine.factory import create_engine, tiny_test_config
from supir_tpu_torch.engine.supir import SUPIRModel
from supir_tpu_torch.models import embedders as TE
from supir_tpu_torch.models.clip import CLIPTextModel
from supir_tpu_torch.utils import ckpt_rules as R
from supir_tpu_torch.utils import tokenizer as TT
from supir_tpu_torch.utils import weights as W
from tests import torch_parity as P
from torch_parity import one_torch_thread  # noqa: F401

ATOL = 1e-4
ROOT = Path(__file__).resolve().parents[1]
PROMPTS = {
    "empty": [""],
    "over_long": ["a restored photo " * 40],
    "punctuated": ["Cinematic, High Contrast; 32k -- ultra-HD!? (skin pore detailing) ok.", "two  spaces\tand tab"],
}


@pytest.fixture(scope="module")
def engines():
    """A JAX engine of tiny_test_config holding random conditioner weights
    (prepare_condition reads no other branch), and the port's engine with
    the same conditioner weights."""
    cfg, cond = JF.tiny_test_config()
    tok, size = jnp.zeros((1, 77), jnp.int32), jnp.zeros((1, 2))
    shapes = jax.eval_shape(lambda: JE.Conditioner(cond).init(jax.random.PRNGKey(0), tok, tok, size, size, size))
    params = {"conditioner": P.random_params(shapes["params"], seed=11)}
    jengine = JaxEngine(cfg, jax.tree_util.tree_map(jnp.asarray, params), cond_cfg=cond)
    tcfg, tcond = tiny_test_config()
    tengine = create_engine(tcfg, "cpu", cond_cfg=tcond)
    sd = W.state_dict_from_rules(params["conditioner"], W.conditioner_rules(tcond))
    tengine.model.conditioner.load_state_dict(P.sub_state_dict(sd, "conditioner"), strict=True)
    return jengine, tengine, params


def _ids(texts=("a cat on a sofa", "", "x " * 90)):
    return TT.tokenize(list(texts))


# ------------------------------------------------------------------ tokenizer


@pytest.mark.parametrize("case", sorted(PROMPTS))
def test_tokenize_equals_jax(case):
    texts = PROMPTS[case]
    got = TT.tokenize(texts)
    want = JT.tokenize(texts)
    assert got.dtype == np.int32 and got.shape == (len(texts), TT.CONTEXT)
    np.testing.assert_array_equal(got, want)
    assert TT.tokenizer_available() == JT.tokenizer_available()
    assert (got[:, 0] == TT.BOS).all() and (got[:, -1] == TT.EOS).all()


# ------------------------------------------------------------------ configs


def test_text_configs_equal_jax():
    """The port's copies of CLIPTextConfig and ConditionerConfig: the same
    fields and defaults, tiny and the two towers, and tiny_test_config."""
    for name, jcls in (("CLIPTextConfig", JClip.CLIPTextConfig), ("ConditionerConfig", JE.ConditionerConfig)):
        tcls = getattr(TCfg, name)
        assert [f.name for f in dataclasses.fields(tcls)] == [f.name for f in dataclasses.fields(jcls)]
        assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls())
        assert dataclasses.asdict(tcls().tiny()) == dataclasses.asdict(jcls().tiny())
    assert dataclasses.asdict(TCfg.CLIPTextConfig.vit_bigg()) == dataclasses.asdict(JClip.CLIPTextConfig.vit_bigg())
    (cfg, cond), (jcfg, jcond) = tiny_test_config(), JF.tiny_test_config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(cond) == dataclasses.asdict(jcond)
    assert (cond.context_dim, cond.adm_dim) == (cfg.unet.context_dim, cfg.unet.adm_in_channels)
    assert (TCfg.ConditionerConfig().context_dim, TCfg.ConditionerConfig().adm_dim) == (2048, 2816)


# ------------------------------------------------------------------ towers

LAYOUTS = {  # layout -> (JAX config, rules, prefix of the tower's keys)
    "hf": (JClip.CLIPTextConfig.vit_l().tiny(), R.clip_l_rules,
           "conditioner.embedders.0.transformer.text_model", "clip_l"),
    "openclip": (dataclasses.replace(JClip.CLIPTextConfig.vit_bigg().tiny(), layers=3), R.clip_bigg_rules,
                 "conditioner.embedders.1.model", "clip_bigg"),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_clip_text_model_matches_jax(layout):
    """hidden (every layer), final and pooled at 1e-4 in both key layouts;
    the rows' end-of-text tokens sit at different positions (the pooled
    row reads argmax(ids)), one of them the last."""
    jcfg, rules, prefix, branch = LAYOUTS[layout]
    ids = _ids()
    assert len({int(i) for i in ids.argmax(-1)}) == 3 and ids.argmax(-1).max() == TT.CONTEXT - 1
    jmodel = JClip.CLIPTextModel(jcfg)
    params = P.random_params(jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids))),
                             seed=5)["params"]
    want = jmodel.apply({"params": jax.tree_util.tree_map(jnp.asarray, params)}, jnp.asarray(ids))

    sd = W.state_dict_from_rules({branch: params}, rules(jcfg.layers))
    tcfg = TCfg.CLIPTextConfig(**dataclasses.asdict(jcfg))
    with torch.device("meta"):
        model = CLIPTextModel(tcfg, layout)
    model = model.to_empty(device="cpu")
    model.load_state_dict(P.sub_state_dict(sd, prefix), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long())
    assert len(got["hidden"]) == jcfg.layers + 1
    for i, (g, w) in enumerate(zip(got["hidden"], want["hidden"])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0, err_msg=f"hidden[{i}]")
    np.testing.assert_allclose(got["final"].numpy(), np.asarray(want["final"]), atol=ATOL, rtol=0)
    assert ("pooled" in got) == (layout == "openclip") == ("pooled" in want)
    if layout == "openclip":
        np.testing.assert_allclose(got["pooled"].numpy(), np.asarray(want["pooled"]), atol=ATOL, rtol=0)
        # the pooled row is the final state at each row's end-of-text token
        rows = np.asarray(want["final"])[np.arange(3), ids.argmax(-1)] @ params["text_projection"]
        np.testing.assert_allclose(got["pooled"].numpy(), rows, atol=ATOL, rtol=0)


# ------------------------------------------------------------------ conditioner


def test_concat_timestep_embed_matches_jax():
    v = np.random.default_rng(3).uniform(0, 2048, (3, 2)).astype(np.float32)
    got = TE.concat_timestep_embed(torch.from_numpy(v), 256)
    want = JE.concat_timestep_embed(jnp.asarray(v), 256)
    assert got.shape == (3, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _conditioner_inputs(n=3):
    rng = np.random.default_rng(4)
    ids = _ids()[:n]
    return ids, ids[::-1].copy(), [rng.uniform(0, 1500, (n, 2)).astype(np.float32) for _ in range(3)]


def test_conditioner_matches_jax(engines):
    jengine, tengine, params = engines
    tl, tg, sizes = _conditioner_inputs()
    want = jengine.conditioner.apply({"params": jax.tree_util.tree_map(jnp.asarray, params["conditioner"])},
                                     jnp.asarray(tl), jnp.asarray(tg), *map(jnp.asarray, sizes))
    with torch.no_grad():
        got = tengine.model.conditioner(torch.from_numpy(tl).long(), torch.from_numpy(tg).long(),
                                        *map(torch.from_numpy, sizes))
    cond = tengine.cond_cfg
    assert got["crossattn"].shape == (3, 77, cond.context_dim) and got["vector"].shape == (3, cond.adm_dim)
    for k in ("crossattn", "vector"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("rate", [0.0, 1.0])
def test_conditioner_ucg_rates(engines, rate):
    """All rates 0 leave the outputs as they are, bit for bit; all rates 1
    zero them, in both packages."""
    jengine, tengine, params = engines
    tl, tg, sizes = _conditioner_inputs()
    args = [torch.from_numpy(tl).long(), torch.from_numpy(tg).long(), *map(torch.from_numpy, sizes)]
    rates = (rate,) * 5
    with torch.no_grad():
        plain = tengine.model.conditioner(*args)
        got = tengine.model.conditioner(*args, ucg_generator=torch.Generator().manual_seed(0), ucg_rates=rates)
    want = jengine.conditioner.apply({"params": jax.tree_util.tree_map(jnp.asarray, params["conditioner"])},
                                     jnp.asarray(tl), jnp.asarray(tg), *map(jnp.asarray, sizes),
                                     ucg_rng=jax.random.PRNGKey(0), ucg_rates=rates)
    for k in ("crossattn", "vector"):
        expect = plain[k] if rate == 0.0 else torch.zeros_like(plain[k])
        torch.testing.assert_close(got[k], expect, rtol=0, atol=0)
        if rate == 1.0:
            assert not np.asarray(want[k]).any()


# ------------------------------------------------------------------ engine


def _tokens():
    pos = TT.tokenize(["a cat, sharp", "a dog"])
    neg = TT.tokenize(["blurry", "blurry"])
    return pos, pos[::-1].copy(), neg, neg


def test_prepare_condition_matches_jax(engines):
    jengine, tengine, _ = engines
    z = np.random.default_rng(6).standard_normal((2, 8, 8, 4)).astype(np.float32)
    toks = _tokens()
    jc, juc = jengine.prepare_condition(jnp.asarray(z), *map(jnp.asarray, toks))
    c, uc = tengine.prepare_condition(z, *toks)
    for got, want in ((c, jc), (uc, juc)):
        assert set(got) == set(want) == {"crossattn", "vector", "control"}
        for k in ("crossattn", "vector"):
            assert got[k].dtype == torch.float32
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=0, err_msg=k)
        np.testing.assert_array_equal(got["control"].numpy(), z)


def test_prepare_condition_cached(engines, monkeypatch):
    """The same conditioning as prepare_condition, the towers run once for a
    repeated token set (a new latent rides along), the JAX engine's SHA-1
    key, and the oldest entry evicted past COND_CACHE_SIZE."""
    _, tengine, _ = engines
    z = np.random.default_rng(7).standard_normal((2, 8, 8, 4)).astype(np.float32)
    toks = _tokens()
    runs = []
    forward = tengine.model.conditioner.forward
    monkeypatch.setattr(tengine.model.conditioner, "forward", lambda *a, **k: runs.append(1) or forward(*a, **k))
    monkeypatch.setattr(tengine, "_cond_cache", {})
    want_c, want_uc = tengine.prepare_condition(z, *toks)
    assert len(runs) == 2
    c, uc = tengine.prepare_condition_cached(z, *toks)
    c2, _ = tengine.prepare_condition_cached(z + 1, *toks)
    assert len(runs) == 4  # one run each for c and uc, then none
    for k in ("crossattn", "vector"):
        torch.testing.assert_close(c[k], want_c[k], rtol=0, atol=0)
        torch.testing.assert_close(uc[k], want_uc[k], rtol=0, atol=0)
        torch.testing.assert_close(c2[k], want_c[k], rtol=0, atol=0)
    np.testing.assert_array_equal(c2["control"].numpy(), z + 1)

    import hashlib

    key = hashlib.sha1(b"".join(np.asarray(t).tobytes() for t in toks)).hexdigest()
    assert list(tengine._cond_cache) == [key]
    assert tengine.condition_key(*(torch.from_numpy(t).long() for t in toks)) == key

    monkeypatch.setattr(type(tengine), "COND_CACHE_SIZE", 2)
    for i in range(2):
        other = TT.tokenize([f"prompt {i}"] * 2)
        tengine.prepare_condition_cached(z, other, other, toks[2], toks[3])
    assert len(tengine._cond_cache) == 2 and key not in tengine._cond_cache


def test_prepare_condition_tiled_matches_jax(engines):
    jengine, tengine, _ = engines
    z = np.random.default_rng(8).standard_normal((1, 8, 8, 4)).astype(np.float32)
    tiles = TT.tokenize(["tile one", "tile two, sky", "tile three"])
    neg = TT.tokenize(["blurry"])
    jc, juc = jengine.prepare_condition_tiled(jnp.asarray(z), jnp.asarray(tiles), jnp.asarray(tiles),
                                              jnp.asarray(neg), jnp.asarray(neg))
    c, uc = tengine.prepare_condition_tiled(z, tiles, tiles, neg, neg)
    assert c["crossattn_tiles"].shape == (3, 1, 77, tengine.cond_cfg.context_dim)
    for got, want in ((c, jc), (uc, juc)):
        assert set(got) == set(want)
        for k in set(got) - {"control"}:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=0, err_msg=k)
    with pytest.raises(ValueError, match="batch 1"):
        tengine.prepare_condition_tiled(np.concatenate([z, z]), tiles, tiles, neg, neg)


def test_engine_without_conditioner_refuses():
    cfg, _ = tiny_test_config()
    engine = create_engine(cfg, "cpu")
    with pytest.raises(ValueError, match="no conditioner"):
        engine.prepare_condition(np.zeros((1, 8, 8, 4), np.float32), *_tokens()[:1] * 4)


def test_random_init_keeps_restore_weights():
    """The conditioner draws after the restore modules: adding it leaves
    their random weights as they were, and its own draws are finite and
    not all zero."""
    cfg, cond = tiny_test_config()
    plain = create_engine(cfg, "cpu", seed=3).model.state_dict()
    full = create_engine(cfg, "cpu", seed=3, cond_cfg=cond).model.state_dict()
    for k, v in plain.items():
        torch.testing.assert_close(full[k], v, rtol=0, atol=0)
    extra = {k: v for k, v in full.items() if k.startswith("conditioner.")}
    assert len(extra) == len(W.conditioner_rules(cond))
    for k in ("conditioner.embedders.1.model.text_projection", "conditioner.embedders.1.model.positional_embedding",
              "conditioner.embedders.1.model.transformer.resblocks.0.attn.in_proj_weight",
              "conditioner.embedders.0.transformer.text_model.embeddings.token_embedding.weight"):
        assert torch.isfinite(extra[k]).all() and extra[k].abs().max() > 0, k


# ------------------------------------------------------------------ full width


def test_conditioner_keys_equal_reference_manifest():
    """At full width the conditioner's keys and shapes are the reference's
    `clip_l` (196) and `clip_bigg` (389) groups; the rule tables are the
    JAX package's; and a reference-keyed state dict of the whole model
    (restore and conditioner groups) loads strictly, all on the meta
    device."""
    manifest = json.loads((ROOT / "supir_tpu/data/ref_key_manifests.json").read_text())
    cond = TCfg.ConditionerConfig()
    with torch.device("meta"):
        model = SUPIRModel(TCfg.SUPIRConfig(), cond_cfg=cond)
    port = {k: list(v.shape) for k, v in model.state_dict().items() if k.startswith("conditioner.")}
    want = dict(manifest["clip_l"], **manifest["clip_bigg"])
    assert (len(manifest["clip_l"]), len(manifest["clip_bigg"])) == (196, 389)
    assert port == want

    assert W.conditioner_rules(cond) == JC.clip_l_rules() + JC.clip_bigg_rules()
    groups = ("unet", "control", "vae", "clip_l", "clip_bigg")
    sd = {k: torch.empty(shape, device="meta") for g in groups for k, shape in manifest[g].items()}
    assert len(sd) == len(model.state_dict())
    model.load_state_dict(sd, strict=True)
