"""The port's captioner training (supir_tpu_torch/captioner/train.py and
data.py) against the JAX package's (supir_tpu/captioner/train.py and
data.py) on the CPU: the length-grouped sampler list for list, LoRA's
sites and merge, and one feature-level and one token-level step of the
trainer in every mode from the same weights (the tiny LLaVA, unquantized
fp32), with the selective saves.

Tolerances: the loss 1e-5 relative; each trainable leaf's one-step change
2e-3 relative L2 (the gradient bound of PERF.md section 2: Adam divides by
the gradient's own scale, so the change carries the gradient's relative
error); frozen leaves bit-identical; merge_lora 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from torch_parity import one_torch_thread, tiny_captioner_pair  # noqa: F401

from supir_tpu.captioner import data as JD
from supir_tpu.captioner import train as JT
from supir_tpu.parallel.mesh import make_mesh
from supir_tpu_torch.captioner import data as TD
from supir_tpu_torch.captioner import train as TT
from supir_tpu_torch.captioner.agent import create_captioner
from supir_tpu_torch.captioner.preprocess import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from supir_tpu_torch.utils import ckpt_rules as C
from supir_tpu_torch.utils.checkpoint import load_params
from supir_tpu_torch.utils.weights import (
    captioner_state_dict_from_jax,
    lora_state_dict_from_jax,
    state_dict_from_rules,
)

LR = 1e-3
RANK, ALPHA = 4, 8.0
LOSS_RTOL = 1e-5
CHANGE_REL = 2e-3
DECAY_ONLY = 1e-6  # largest change of a leaf that the weight decay alone moves (|p| < 1 here)


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# ------------------------------------------------------------------ data


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(1, 400), min_size=1, max_size=60), st.integers(1, 5), st.integers(1, 4),
       st.integers(0, 2**31), st.sampled_from(["mixed", "images", "text"]))
def test_sampler_lists_equal_jax(lengths, batch_size, world_size, seed, modality):
    rng = np.random.default_rng(seed)
    if modality == "mixed":
        lengths = [n if rng.random() < 0.5 else -n for n in lengths]
    elif modality == "text":
        lengths = [-n for n in lengths]
    assert TD.length_grouped_indices(lengths, batch_size, world_size, seed) == \
        JD.length_grouped_indices(lengths, batch_size, world_size, seed)
    assert TD.length_grouped_indices(lengths, batch_size, world_size, seed, group_by_modality=False) == \
        JD.length_grouped_indices(lengths, batch_size, world_size, seed, group_by_modality=False)
    idx = list(range(len(lengths)))
    assert TD.split_to_even_chunks(idx, np.abs(lengths).tolist(), world_size) == \
        JD.split_to_even_chunks(idx, np.abs(lengths).tolist(), world_size)
    for rank in range(world_size):
        assert TD.rank_batches(lengths, batch_size, world_size, rank, seed) == \
            JD.rank_batches(lengths, batch_size, world_size, rank, seed)


def test_rank_batches_takes_the_process_group_rank(monkeypatch, tmp_path):
    import torch.distributed as dist

    lengths = [5, -3, 8, 2, -7, 4, 9, -1, 6, 3, -2, 7]
    assert not dist.is_initialized()
    assert TD.default_rank() == 0
    assert TD.rank_batches(lengths, 2, 2, seed=3) == JD.rank_batches(lengths, 2, 2, 0, seed=3)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0, world_size=1)
    try:
        assert TD.default_rank() == dist.get_rank() == 0
        assert TD.rank_batches(lengths, 2, 1, seed=3) == JD.rank_batches(lengths, 2, 1, 0, seed=3)
        # the group's rank is the one taken: rank 1 of a two-rank layout
        monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
        assert TD.rank_batches(lengths, 2, 2, seed=3) == JD.rank_batches(lengths, 2, 2, 1, seed=3)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def pair():
    """(JAX agent, its numpy params): the tiny LLaVA, unquantized fp32."""
    jagent, _ = tiny_captioner_pair(seed=7, quantized=False)
    return jagent, jax.tree_util.tree_map(np.asarray, jagent.params)


def _port_agent(jagent, params_np):
    from supir_tpu_torch.captioner.agent import CaptionerConfig
    from supir_tpu_torch.captioner.llama import LlamaConfig
    from supir_tpu_torch.captioner.vision import CLIPVisionConfig

    d = dataclasses.asdict(jagent.cfg)
    cfg = CaptionerConfig(vision=CLIPVisionConfig(**d.pop("vision")), llama=LlamaConfig(**d.pop("llama")), **d)
    return create_captioner(cfg, "cpu", state_dict=captioner_state_dict_from_jax(params_np, jagent.cfg))


def _feature_batch(cfg, seed=0, b=2):
    rng = np.random.default_rng(seed)
    p, dim = cfg.vision.num_patches, cfg.llama.dim
    labels = rng.integers(0, cfg.llama.vocab_size, (b, 3 + p + 5))
    labels[:, : 3 + p] = IGNORE_INDEX
    return {"image_feats": rng.standard_normal((b, p, cfg.vision.width)).astype(np.float32),
            "pre_embeds": (0.02 * rng.standard_normal((b, 3, dim))).astype(np.float32),
            "post_embeds": (0.02 * rng.standard_normal((b, 5, dim))).astype(np.float32),
            "labels": labels.astype(np.int32)}


def _token_batch(cfg, seed=1, t=14):
    """Three rows: the image marker first, mid-row, and none; the first
    tokens and the marker masked, the last two rows padded."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, cfg.llama.vocab_size, (3, t))
    ids[0, 0] = IMAGE_TOKEN_INDEX
    ids[1, 6] = IMAGE_TOKEN_INDEX
    labels = ids.copy()
    labels[:, :3] = IGNORE_INDEX
    labels[ids == IMAGE_TOKEN_INDEX] = IGNORE_INDEX
    ids[1:, t - 2:] = 0
    labels[1:, t - 2:] = IGNORE_INDEX
    size = cfg.vision.image_size
    return {"input_ids": ids.astype(np.int32), "labels": labels.astype(np.int32),
            "images": rng.standard_normal((3, size, size, 3)).astype(np.float32)}


def _llama_sd(llama_np, cfg):
    return state_dict_from_rules(llama_np, C.llama_rules(cfg.llama))


# ------------------------------------------------------------------ LoRA


def test_init_lora_sites_shapes_and_scale(pair):
    jagent, params_np = pair
    jl = jax.tree_util.tree_map(np.asarray, JT.init_lora(params_np["llama"], rank=RANK, rng=jax.random.PRNGKey(3)))
    want = lora_state_dict_from_jax(jl, jagent.cfg.llama.layers)
    agent = _port_agent(jagent, params_np)
    got = TT.init_lora(agent.model, RANK, torch.Generator().manual_seed(0))
    assert len(got) == 2 * len(TT.LORA_TARGETS) * jagent.cfg.llama.layers
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape) for k, v in want.items()}
    assert all(v.dtype == torch.float32 for v in got.values())
    assert all(not v.any() for k, v in got.items() if k.endswith("lora_b"))
    a = torch.cat([v.flatten() for k, v in got.items() if k.endswith("lora_a")])
    assert abs(float(a.std()) * RANK - 1.0) < 0.05 and abs(float(a.mean())) * RANK < 0.05


def test_merge_lora_equals_jax(pair):
    jagent, params_np = pair
    rng = np.random.default_rng(4)
    jl = JT.init_lora(params_np["llama"], rank=RANK, rng=jax.random.PRNGKey(3))
    jl = jax.tree_util.tree_map(lambda v: (0.1 * rng.standard_normal(v.shape)).astype(np.float32), jl)
    want = _llama_sd(jax.tree_util.tree_map(np.asarray, JT.merge_lora(params_np["llama"], jl, ALPHA, RANK)),
                     jagent.cfg)
    base = _llama_sd(params_np["llama"], jagent.cfg)
    got = TT.merge_lora(base, lora_state_dict_from_jax(jl, jagent.cfg.llama.layers), ALPHA, RANK)
    assert set(got) == set(want)
    merged = [k for k in want if not torch.equal(want[k], base[k])]
    assert len(merged) == len(TT.LORA_TARGETS) * jagent.cfg.llama.layers
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-6, err_msg=k)


def test_merged_lora_linear_gradients_match_autograd():
    """MergedLoRALinear against autograd through the merged kernel kept."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 12, generator=g, requires_grad=True)
    w = torch.randn(7, 12, generator=g)
    a = torch.randn(12, 3, generator=g, requires_grad=True)
    b = torch.randn(3, 7, generator=g, requires_grad=True)
    dy = torch.randn(2, 5, 7, generator=g)
    got = torch.autograd.grad(TT.MergedLoRALinear.apply(x, w, a, b, 0.5), (x, a, b), dy)
    want = torch.autograd.grad(torch.nn.functional.linear(x, TT.merged_weight(w, a, b, 0.5)), (x, a, b), dy)
    for gv, wv in zip(got, want):
        torch.testing.assert_close(gv, wv, rtol=1e-6, atol=1e-6)


def test_splice_image_static_shapes():
    tok = torch.arange(3 * 5, dtype=torch.float32).reshape(3, 5, 1)
    img = -torch.arange(1, 3 * 3 + 1, dtype=torch.float32).reshape(3, 3, 1)
    ids = torch.tensor([[IMAGE_TOKEN_INDEX, 2, 3, 4, 5], [2, 3, IMAGE_TOKEN_INDEX, 4, 5], [2, 3, 4, 5, 6]])
    labels = torch.where(ids == IMAGE_TOKEN_INDEX, IGNORE_INDEX, ids + 10)
    emb, lab = TT.splice_image(tok, img, ids, labels)
    assert emb.shape == (3, 7, 1) and lab.shape == (3, 7)
    assert emb[0, :, 0].tolist() == [-1, -2, -3, 1, 2, 3, 4]
    assert emb[1, :, 0].tolist() == [5, 6, -4, -5, -6, 8, 9]
    assert emb[2, :, 0].tolist() == [10, 11, 12, 13, 14, 14, 14]
    assert lab[0].tolist() == [IGNORE_INDEX] * 3 + [12, 13, 14, 15]
    assert lab[1].tolist() == [12, 13] + [IGNORE_INDEX] * 3 + [14, 15]
    assert lab[2].tolist() == [12, 13, 14, 15, 16] + [IGNORE_INDEX] * 2


# ----------------------------------------------------------------- trainer


def _jax_step(jagent, params_np, mode, step_name, batch):
    trainer = JT.CaptionerTrainer(jagent, make_mesh((1, 1)), learning_rate=LR, mode=mode, lora_rank=RANK,
                                  lora_alpha=ALPHA)
    state = trainer.init_state(jax.tree_util.tree_map(jnp.array, params_np), rng=jax.random.PRNGKey(11))
    before = jax.tree_util.tree_map(np.asarray, state["params"])
    after, loss = getattr(trainer, step_name)(state, batch)
    return before, jax.tree_util.tree_map(np.asarray, after["params"]), float(loss)


def _bridged(tree, jagent):
    sd = captioner_state_dict_from_jax(tree, jagent.cfg)
    if "lora" in tree:
        sd.update(lora_state_dict_from_jax(tree["lora"], jagent.cfg.llama.layers))
    return sd


def _check_changes(got, trainable, want_before, want_after):
    """Each trainable leaf's one-step change against JAX's at CHANGE_REL."""
    assert trainable <= set(want_after)
    for k in trainable:
        change, want = got[k].detach() - want_before[k], want_after[k] - want_before[k]
        assert float(want.abs().max()) > 0 and float(change.abs().max()) > 0, k
        if float(want.abs().max()) < DECAY_ONLY:
            # no gradient reaches the leaf (the token table of the feature-level
            # step): its change is the weight decay alone, lr * 1e-4 * p, at
            # the leaf's last bits; both updates land within two ulps
            np.testing.assert_allclose(got[k].detach().numpy(), want_after[k].numpy(), rtol=2.5e-7, err_msg=k)
            continue
        assert rel_l2(change, want) <= CHANGE_REL, (k, rel_l2(change, want))


@pytest.mark.parametrize("step_name", ["train_step", "train_step_tokens"])
@pytest.mark.parametrize("mode", TT.MODES)
def test_trainer_step_matches_jax(pair, mode, step_name, tmp_path):
    jagent, params_np = pair
    batch = (_feature_batch if step_name == "train_step" else _token_batch)(jagent.cfg)
    jbefore, jafter, jloss = _jax_step(jagent, params_np, mode, step_name, batch)
    want_before, want_after = _bridged(jbefore, jagent), _bridged(jafter, jagent)

    agent = _port_agent(jagent, params_np)
    trainer = TT.CaptionerTrainer(agent, learning_rate=LR, mode=mode, lora_rank=RANK, lora_alpha=ALPHA)
    lora = lora_state_dict_from_jax(jbefore["lora"], jagent.cfg.llama.layers) if mode == "lora" else None
    trainer.init_state(lora=lora)
    trainable = set(trainer.params)
    frozen = {k: p.detach().clone() for k, p in agent.model.named_parameters() if k not in trainable}
    assert len(frozen) + len(trainable) - len(trainer.lora) == len(list(agent.model.parameters()))
    loss = float(getattr(trainer, step_name)(batch))

    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    got = {**dict(agent.model.named_parameters()), **trainer.lora}
    _check_changes(got, trainable, want_before, want_after)
    for k, v in frozen.items():
        assert torch.equal(got[k], v), k
        assert torch.equal(v, want_after[k]), k  # JAX left it too
    assert trainer.step == 1 and len(trainer.state()["exp_avg"]) == len(trainable)

    trainer.save_projector_only(str(tmp_path / "projector.safetensors"))
    saved = load_params(str(tmp_path / "projector.safetensors"))
    assert set(saved) == {k for k in trainable if k.startswith(TT.PROJECTOR)}
    assert all(torch.equal(saved[k], got[k].detach()) for k in saved)
    if mode == "lora":
        trainer.save_lora_only(str(tmp_path / "lora.safetensors"))
        saved = load_params(str(tmp_path / "lora.safetensors"))
        assert set(saved) == trainable
        assert all(torch.equal(saved[k], got[k].detach()) for k in saved)


def test_trainer_refuses_unknown_mode(pair):
    jagent, params_np = pair
    with pytest.raises(ValueError, match="mode"):
        TT.CaptionerTrainer(_port_agent(jagent, params_np), mode="adapter")


def test_sharded_trainer_step_matches_jax(pair, tmp_path):
    """CaptionerTrainer after `shard_state` over two gloo ranks' 'model'
    axis (lora mode: the frozen base, the projector and the adapters
    sharded), the feature-level step against JAX's as the one-process test
    holds it: the loss and each trainable leaf's change."""
    import torch_ranks

    jagent, params_np = pair
    batch = _feature_batch(jagent.cfg)
    jbefore, jafter, jloss = _jax_step(jagent, params_np, "lora", "train_step", batch)
    want_before, want_after = _bridged(jbefore, jagent), _bridged(jafter, jagent)
    cfg = _port_agent(jagent, params_np).cfg
    ranks = torch_ranks.spawn(2, tmp_path, captioner_sharded_step=dict(
        cfg=cfg, state_dict=captioner_state_dict_from_jax(params_np, jagent.cfg),
        lora=lora_state_dict_from_jax(jbefore["lora"], jagent.cfg.llama.layers), batch=batch, lr=LR, mode="lora",
        rank_lora=RANK, alpha=ALPHA)).join()
    for rank in ranks:
        got = rank["captioner_sharded_step"]
        assert got["sharded"]
        np.testing.assert_allclose(got["loss"], jloss, rtol=LOSS_RTOL)
        _check_changes(got["params"], set(got["trainable"]), want_before, want_after)

