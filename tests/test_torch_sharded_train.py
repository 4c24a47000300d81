"""The trainers over a mesh (supir_tpu_torch/engine/training.py,
engine/ae_training.py, captioner/train.py with parallel/sharding.py's
gradient path), four gloo ranks on the CPU, each sharded step held to the
same rank's one-process step on the same state and draws:

- SUPIRTrainer on tiny_test_config at 64^2 (8x8 latents), batch 4, on a
  (2, 2) ('data', 'model') mesh (the multi-chip drill's rule at four
  devices) and a (1, 2) mesh. At dp = 1 the shards' gradients are slices
  of the one-process gradients, so the loss, the moments, the updated
  parameters and the EMA are equal bit for bit; at dp = 2 each rank takes
  half the batch and the gradients are averaged over 'data', so the loss
  is held within 1e-6 and the first moments within 1e-5 relative L2 (fp32
  sums in another order) over the whole tree: several leaves have no true
  gradient at these widths (a bias before a GroupNorm), and their moments
  are round-off in both runs. Both are also held to the JAX trainer's step on
  one CPU device (the gradients, read from the first moments, at 2e-3):
  JAX's shardings change placement, not arithmetic.
- AETrainer(mesh=) (branch "all", disc_start 0, tiny VAE at 32^2) and
  CaptionerTrainer.shard_state (the tiny LLaVA, lora and full modes, two
  feature-level steps) on (1, 2) meshes, bit for bit against one process.
  Their sharded steps are held to the JAX trainers' steps on two ranks in
  tests/test_torch_ae_training.py and tests/test_torch_captioner_train.py
  (`test_sharded_trainer_step_matches_jax`), where the JAX side is built.

The spawn starts before the JAX side is computed, so the two overlap.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from supir_tpu.diffusion import loss as jax_loss
from supir_tpu.diffusion.sigma_sampling import discrete_sampling as jax_discrete_sampling
from supir_tpu.engine.supir import SUPIREngine as JaxEngine
from supir_tpu_torch.captioner.agent import CaptionerConfig
from supir_tpu_torch.config import VAEConfig
from supir_tpu_torch.engine.factory import tiny_test_config
from supir_tpu_torch.utils import weights as W
from tests import torch_parity as P
from torch_parity import one_torch_thread  # noqa: F401

BATCH = 4       # two a rank at dp = 2
LR = 1e-3
LOSS_BOUND = 1e-6     # dp = 2 against one process, relative
MOMENT_BOUND = 1e-5   # dp = 2 first moments against one process, relative L2
JAX_TOL = dict(atol=2e-3, rtol=2e-3)  # the gradients against JAX's


def _rel(got, want) -> float:
    got, want = (np.asarray(x, np.float64) for x in (got, want))
    n = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / n) if n else float(np.linalg.norm(got))


def _inputs(cfg):
    rng = np.random.default_rng(3)
    z = rng.standard_normal((BATCH, 8, 8, 4)).astype(np.float32)
    cond = {"crossattn": rng.standard_normal((BATCH, 77, cfg.unet.context_dim)).astype(np.float32),
            "vector": rng.standard_normal((BATCH, cfg.unet.adm_in_channels)).astype(np.float32),
            "control": rng.standard_normal((BATCH, 8, 8, 4)).astype(np.float32)}
    return z, cond


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results, the JAX step's loss and gradients under the
    port's keys)."""
    jcfg = P.tiny_cfg()
    params = P.tiny_params(jcfg, seed=11)
    z, cond = _inputs(jcfg)
    key = jax.random.PRNGKey(5)
    k_sigma, k_noise = jax.random.split(key)
    sigma, _ = jax_discrete_sampling(k_sigma, BATCH)
    noise = np.asarray(jax.random.normal(k_noise, z.shape, jnp.float32))
    sigma = np.asarray(sigma)
    state_dict = {k: v.numpy() for k, v in W.state_dict_from_jax(params, jcfg).items()}
    cfg, _ = tiny_test_config()

    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    target = np.clip(x + 0.1 * rng.standard_normal(x.shape), -1, 1).astype(np.float32)
    ccfg = CaptionerConfig.tiny()
    p, dim = ccfg.vision.num_patches, ccfg.llama.dim
    labels = rng.integers(0, ccfg.llama.vocab_size, (2, 3 + p + 5))
    labels[:, :3 + p] = -100
    batch = {"image_feats": rng.standard_normal((2, p, ccfg.vision.width)).astype(np.float32),
             "pre_embeds": (0.02 * rng.standard_normal((2, 3, dim))).astype(np.float32),
             "post_embeds": (0.02 * rng.standard_normal((2, 5, dim))).astype(np.float32),
             "labels": labels.astype(np.int64)}
    spawned = torch_ranks.spawn(4, tmp_path_factory.mktemp("sharded_train"), sharded_train=dict(
        supir=dict(state_dict=state_dict, cfg=cfg, z=z, cond=cond, sigma=sigma, noise=noise, lr=LR),
        ae=dict(cfg=VAEConfig().tiny(), seed=4, x=x, target=target, lr=2e-4),
        cap=dict(cfg=dataclasses.replace(ccfg, compute_dtype="float32"), seed=6, batch=batch, lr=5e-3)))

    # the JAX trainer's loss_fn (supir_tpu/engine/training.py:101-109) on one device
    engine = JaxEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, params))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    trainable = {"control": jp["control"], "unet": jp["unet"]}
    frozen = {k: v for k, v in jp.items() if k not in trainable}
    jcond = jax.tree_util.tree_map(jnp.asarray, cond)

    def loss_fn(tr):
        ps = {**frozen, **tr}

        def denoise_fn(noised, s, c):
            return engine.denoiser(lambda *a: engine._network(ps, *a), noised, s, c, 1.0)

        return jax_loss.diffusion_loss(denoise_fn, jnp.asarray(z), jcond, key, weighting="eps")

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(trainable)
    tables = W.supir_rules(jcfg)
    bridged = W._bridge(jax.tree_util.tree_map(np.asarray, grads), {k: tables[k] for k in ("control", "unet")})
    return spawned.join(timeout=600.0), float(loss), {k: v.numpy() for k, v in bridged.items()}


def _supir(runs, label):
    ranks = runs[0]
    return [r["sharded_train"][label] for r in ranks if label in r["sharded_train"]]


def test_supir_dp1_equals_one_process_bit_for_bit(runs):
    got = _supir(runs, "supir_12")
    assert len(got) == 2
    for r in got:
        one, split = r["one"], r["split"]
        assert torch.equal(one["loss"], split["loss"])
        for tree in ("exp_avg", "exp_avg_sq", "params", "ema"):
            assert one[tree].keys() == split[tree].keys()
            for k in one[tree]:
                assert torch.equal(one[tree][k], split[tree][k]), (tree, k)
        # the rule split the large tensors: some shard is half its tensor
        assert any(split["held"][k] != tuple(one["params"][k].shape) for k in one["params"])


def test_supir_dp2_matches_one_process(runs):
    got = _supir(runs, "supir_22")
    assert len(got) == 4
    for r in got:
        one, split = r["one"], r["split"]
        assert abs(float(split["loss"]) - float(one["loss"])) <= LOSS_BOUND * abs(float(one["loss"]))
        keys = sorted(one["exp_avg"])
        flat = [torch.cat([t[k].reshape(-1) for k in keys]) for t in (split["exp_avg"], one["exp_avg"])]
        assert _rel(*flat) <= MOMENT_BOUND
    # every rank holds the same full state after the step
    first = got[0]["split"]
    for r in got[1:]:
        assert all(torch.equal(first["exp_avg"][k], r["split"]["exp_avg"][k]) for k in first["exp_avg"])


@pytest.mark.parametrize("label", ["supir_12", "supir_22"])
def test_sharded_supir_step_matches_jax(runs, label):
    _, loss, grads = runs
    r = _supir(runs, label)[0]["split"]
    np.testing.assert_allclose(float(r["loss"]), loss, rtol=1e-4)
    trained = {k for k, g in grads.items() if np.any(g)}
    assert set(r["exp_avg"]) == trained
    for k in trained:  # Adam's first moment after one step is (1 - b1) g
        np.testing.assert_allclose(r["exp_avg"][k].numpy() / 0.1, grads[k], err_msg=k, **JAX_TOL)


def test_ae_trainer_over_a_mesh_equals_one_process(runs):
    got = [r["sharded_train"]["ae_12"] for r in runs[0] if "ae_12" in r["sharded_train"]]
    assert len(got) == 2
    for r in got:
        one, split = r["one"], r["split"]
        assert split["sharded"] and not one["sharded"]
        for k in one["metrics"]:
            assert torch.equal(one["metrics"][k], split["metrics"][k]), k
        for tree in ("opt_g", "opt_d", "gen", "disc"):
            for k in one[tree]:
                assert torch.equal(one[tree][k], split[tree][k]), (tree, k)


@pytest.mark.parametrize("mode", ["lora", "full"])
def test_captioner_shard_state_equals_one_process(runs, mode):
    got = [r["sharded_train"]["cap_12"][mode] for r in runs[0] if "cap_12" in r["sharded_train"]]
    assert len(got) == 2
    for r in got:
        one, split = r["one"], r["split"]
        assert split["sharded"]
        assert all(torch.equal(a, b) for a, b in zip(one["losses"], split["losses"]))
        for tree in ("exp_avg", "lora", "params"):
            assert one[tree].keys() == split[tree].keys()
            for k in one[tree]:
                assert torch.equal(one[tree][k], split[tree][k]), (tree, k)
        assert any(split["held"][k] != tuple(one["exp_avg"][k].shape) for k in one["exp_avg"])


# ------------------------------------------------- the trainers' precision


def _recorder(monkeypatch, module):
    """Record the autocast each train_autocast call of `module` picks for a
    card, from the compute dtype the trainer hands it."""
    from supir_tpu_torch.engine.training import autocast_dtype, train_autocast

    picked = []

    def recording(device, compute_dtype):
        picked.append(autocast_dtype(torch.device("cuda"), compute_dtype))
        return train_autocast(device, compute_dtype)

    monkeypatch.setattr(module, "train_autocast", recording)
    return picked


@pytest.mark.parametrize("dtype,want", [("fp32", None), ("bf16", torch.bfloat16)])
def test_trainers_compute_in_their_models_dtype(monkeypatch, dtype, want):
    """An fp32 model trains with no autocast on the card, a bf16 one under
    bf16 autocast over fp32 parameters, for each trainer: the SUPIR
    trainer from the config's diffusion_dtype, the AE trainer from the
    autoencoder's dtype, the captioner trainer from the agent's
    compute_dtype. Checked on the CPU: each step's train_autocast calls
    are recorded with the autocast they would take on a card."""
    from supir_tpu_torch.captioner import train as cap_train
    from supir_tpu_torch.captioner.agent import create_captioner
    from supir_tpu_torch.engine import ae_training, training
    from supir_tpu_torch.engine.factory import create_ae_trainer, create_trainer
    from supir_tpu_torch.engine.training import autocast_dtype

    assert autocast_dtype(torch.device("cpu"), torch.bfloat16) is None  # the CPU runs fp32
    cfg, _ = tiny_test_config()
    trainer = create_trainer(dataclasses.replace(cfg, diffusion_dtype=dtype), "cpu", seed=1)
    picked = _recorder(monkeypatch, training)
    z, cond = _inputs(cfg)
    trainer.loss_and_grads(z[:1], {k: v[:1] for k, v in cond.items()}, torch.Generator().manual_seed(0))
    assert picked == [want] and all(p.dtype == torch.float32 for p in trainer.params.values())

    ae = create_ae_trainer(VAEConfig().tiny(), "cpu", ae_dtype=dtype, loss_cfg=_ae_loss())
    picked = _recorder(monkeypatch, ae_training)
    x = np.zeros((1, 32, 32, 3), np.float32)
    ae.train_step(x, x, torch.Generator().manual_seed(0))
    assert picked and set(picked) == {want}

    ccfg = dataclasses.replace(CaptionerConfig.tiny(), compute_dtype={"fp32": "float32", "bf16": "bfloat16"}[dtype])
    agent = create_captioner(ccfg, "cpu", stochastic=False)
    cap = cap_train.CaptionerTrainer(agent, mode="projector")
    cap.init_state()
    picked = _recorder(monkeypatch, cap_train)
    p, dim = ccfg.vision.num_patches, ccfg.llama.dim
    cap.train_step({"image_feats": np.zeros((1, p, ccfg.vision.width), np.float32),
                    "pre_embeds": np.zeros((1, 2, dim), np.float32), "post_embeds": np.zeros((1, 2, dim), np.float32),
                    "labels": np.full((1, 4 + p), 1, np.int64)})
    assert picked == [want]


def _ae_loss():
    from supir_tpu_torch.diffusion.ae_losses import AELossConfig

    return AELossConfig(disc_start=0)
