"""The port's trainer (supir_tpu_torch/engine/training.py) against the JAX
trainer (supir_tpu/engine/training.py), CPU, fp32, tiny widths.

One step of the control-path fine-tune: the same random weights (every leaf)
go to both packages through the weight bridge, z and cond come from numpy,
and the JAX side draws sigma and the noise exactly as its `diffusion_loss`
does (`jax.random.split` -> `discrete_sampling` / `jax.random.normal`);
the port is handed those draws. Bounds: loss relative 1e-4; gradients,
updated parameters and EMA atol/rtol 2e-3, the torch-golden bound of
tests/test_ref_golden_vae.py (observed: gradients within 1.5e-7). The step
also runs with every attention site forced through `FlashAttention`, whose
CPU forward and backward are K3's and K4's plain versions.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supir_tpu.diffusion import loss as jax_loss
from supir_tpu.diffusion import lr_schedulers as jax_lr
from supir_tpu.diffusion import scaling as jax_scaling
from supir_tpu.diffusion.discretization import legacy_ddpm_sigma_table as jax_sigma_table
from supir_tpu.diffusion.sigma_sampling import discrete_sampling as jax_discrete_sampling
from supir_tpu.engine.supir import SUPIREngine as JaxEngine
from supir_tpu.engine.training import SUPIRTrainer as JaxTrainer
from supir_tpu_torch.diffusion import lr_schedulers as lr
from supir_tpu_torch.diffusion import scaling
from supir_tpu_torch.diffusion.loss import diffusion_loss
from supir_tpu_torch.diffusion.sigma_sampling import discrete_sampling, edm_sampling
from supir_tpu_torch.engine.factory import create_trainer
from supir_tpu_torch.ops import attention as attn_ops
from supir_tpu_torch.ops import flash_attention as flash_ops
from supir_tpu_torch.utils import weights as W
from tests import torch_parity as P
from torch_parity import one_torch_thread  # noqa: F401

TOL = dict(atol=2e-3, rtol=2e-3)
LR = 1e-3
BATCH = 2


def _trainable_tables(cfg):
    tables = W.supir_rules(cfg)
    return {k: tables[k] for k in ("control", "unet")}


def _bridge(tree, cfg):
    """A JAX {'control', 'unet'} tree -> numpy arrays under the torch keys."""
    return {k: v.numpy() for k, v in W._bridge(jax.tree_util.tree_map(np.asarray, tree),
                                                _trainable_tables(cfg)).items()}


@pytest.fixture(scope="module")
def jax_side():
    """Inputs, the JAX draws, and the JAX trainer's loss and gradients."""
    cfg = P.tiny_cfg()
    params = P.tiny_params(cfg, seed=11)
    engine = JaxEngine(cfg, jax.tree_util.tree_map(jnp.asarray, params))
    rng = np.random.default_rng(3)
    z = rng.standard_normal((BATCH, 8, 8, 4)).astype(np.float32)
    cond = {"crossattn": rng.standard_normal((BATCH, 77, cfg.unet.context_dim)).astype(np.float32),
            "vector": rng.standard_normal((BATCH, cfg.unet.adm_in_channels)).astype(np.float32),
            "control": rng.standard_normal((BATCH, 8, 8, 4)).astype(np.float32)}
    key = jax.random.PRNGKey(5)
    k_sigma, k_noise = jax.random.split(key)  # as diffusion_loss splits its key
    sigma, _ = jax_discrete_sampling(k_sigma, BATCH)
    noise = jax.random.normal(k_noise, z.shape, jnp.float32)

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    trainable = {"control": jp["control"], "unet": jp["unet"]}
    frozen = {k: v for k, v in jp.items() if k not in trainable}
    jcond = jax.tree_util.tree_map(jnp.asarray, cond)

    def loss_fn(trainable):  # the JAX trainer's loss_fn (engine/training.py:101-109)
        ps = {**frozen, **trainable}

        def denoise_fn(noised, s, c):
            return engine.denoiser(functools.partial(engine._network, ps), noised, s, c, 1.0)

        return jax_loss.diffusion_loss(denoise_fn, jnp.asarray(z), jcond, key, weighting="eps")

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(trainable)
    return dict(cfg=cfg, params=params, engine=engine, z=z, cond=cond, sigma=np.asarray(sigma),
                noise=np.asarray(noise), loss=float(loss), grads=grads, trainable=trainable)


def _jax_update(side, weight_decay):
    """One update through the JAX trainer's own tx and EMA (no mesh):
    (new trainable params, new EMA), bridged to the torch keys."""
    trainer = JaxTrainer(side["engine"], None, learning_rate=LR, weight_decay=weight_decay)
    state = trainer.init_state(side["engine"].params)
    trainable = side["trainable"]
    updates, _ = trainer.tx.update(side["grads"], state["opt"], trainable)
    new = jax.tree_util.tree_map(lambda p, u: p + u, trainable, updates)
    ema = trainer.ema.update(state["ema"], new, state["step"])
    cfg = side["cfg"]
    return _bridge(new, cfg), _bridge(ema, cfg)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
@pytest.mark.parametrize("sites", ["dispatch", "all_flash"])
def test_train_step_matches_jax(jax_side, monkeypatch, weight_decay, sites):
    side = jax_side
    cfg = side["cfg"]
    calls = {"fwd": 0, "bwd": 0}
    if sites == "all_flash":
        # the tiny heads are 16 wide, outside HEAD_DIMS: accept every site so
        # that each attention that trains goes through FlashAttention
        monkeypatch.setattr(attn_ops, "flash_eligible", lambda s, t, d: True)
        for name, key in (("flash_attention_fwd_lse", "fwd"), ("flash_attention_bwd", "bwd")):
            fn = getattr(flash_ops, name)

            def counted(*a, _fn=fn, _key=key, **k):
                calls[_key] += 1
                return _fn(*a, **k)

            monkeypatch.setattr(flash_ops, name, counted)
    trainer = create_trainer(cfg, "cpu", state_dict=W.state_dict_from_jax(side["params"], cfg),
                             learning_rate=LR, weight_decay=weight_decay)
    before = {k: p.detach().clone() for k, p in trainer.trainable_of().items()}

    loss = trainer.loss_and_grads(side["z"], side["cond"], sigma=side["sigma"], noise=side["noise"])
    np.testing.assert_allclose(float(loss), side["loss"], rtol=1e-4)
    want = _bridge(side["grads"], cfg)
    zero = {k for k, g in want.items() if not np.any(g)}
    assert zero == set(trainer.stopped) and zero
    assert set(trainer.params) == set(want) - zero
    for k, p in trainer.params.items():
        np.testing.assert_allclose(p.grad.numpy(), want[k], err_msg=k, **TOL)
    if sites == "all_flash":
        # every trainable transformer site runs K3 twice under remat, K4 once
        assert calls["fwd"] > calls["bwd"] > 0

    trainer.apply_gradients()
    new, ema = _jax_update(side, weight_decay)
    for k, p in trainer.trainable_of().items():
        np.testing.assert_allclose(p.detach().numpy(), new[k], err_msg=k, **TOL)
    assert set(trainer.ema_params) == (set(new) if weight_decay else set(trainer.params))
    for k, e in trainer.ema_params.items():
        np.testing.assert_allclose(e.numpy(), ema[k], err_msg=k, **TOL)
    # the stop-gradient leaves: unchanged without weight decay; with it, they
    # move by optax's decay, -lr * wd * p, to within one fp32 ulp of p
    for k in trainer.stopped:
        old = before[k].numpy()
        moved = trainer.stopped[k].detach().numpy() - old
        if weight_decay:
            assert (np.abs(moved - (new[k] - old)) <= np.spacing(np.abs(old))).all(), k
            assert np.abs(moved).max() > 0
        else:
            assert torch.equal(trainer.stopped[k], before[k])
    assert trainer.step == 1


def test_remat_changes_no_gradient(jax_side):
    """Recomputing ResBlocks and SpatialTransformers in the backward pass
    gives the same loss and gradients as keeping their activations."""
    side = jax_side
    sd = W.state_dict_from_jax(side["params"], side["cfg"])
    grads = []
    for remat in (False, True):
        trainer = create_trainer(side["cfg"], "cpu", state_dict=sd, remat=remat)
        loss = trainer.loss_and_grads(side["z"], side["cond"], sigma=side["sigma"], noise=side["noise"])
        grads.append((loss, {k: p.grad for k, p in trainer.params.items()}))
    (l0, g0), (l1, g1) = grads
    torch.testing.assert_close(l1, l0, rtol=0, atol=0)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=1e-7, msg=k)


def _to_flax(kind, t: torch.Tensor) -> np.ndarray:
    """The bridge's transform, inverted: torch layout back to flax's."""
    a = t.detach().numpy()
    if kind == "linear":
        return a.T
    if kind == "conv":
        return np.transpose(a, (2, 3, 1, 0))
    return a


def test_train_state_from_jax_round_trips(jax_side):
    """A JAX init_state with random moments and EMA -> train_state_from_jax
    -> the port trainer -> back through the rules: every leaf as it was.
    What the port does not keep of the stop-gradient leaves is what any JAX
    state at weight decay 0 holds for them: zero moments, and an EMA equal
    to the leaf."""
    side = jax_side
    cfg = side["cfg"]
    trainer_j = JaxTrainer(side["engine"], None)
    state = trainer_j.init_state(side["engine"].params)
    rng = np.random.default_rng(9)
    stopped_paths = set()
    for branch, rules in _trainable_tables(cfg).items():
        for tkey, fpath, _ in rules:
            if tkey.startswith(("model.diffusion_model.input_blocks.", "model.diffusion_model.time_embed.",
                                "model.diffusion_model.label_emb.")):
                stopped_paths.add((branch,) + tuple(fpath))

    def fill(scale):
        """Random leaves, the stop-gradient ones left as they are."""
        def leaf(path, x):
            if tuple(p.key for p in path) in stopped_paths:
                return np.asarray(x)
            return (scale * rng.random(x.shape)).astype(np.float32)
        return leaf

    adam = state["opt"][0]
    mu = jax.tree_util.tree_map_with_path(fill(1.0), adam.mu)
    nu = jax.tree_util.tree_map_with_path(fill(1e-3), adam.nu)
    state = dict(state, opt=(adam._replace(count=jnp.asarray(7), mu=mu, nu=nu),) + tuple(state["opt"][1:]),
                 ema=jax.tree_util.tree_map_with_path(fill(1.0), state["ema"]), step=jnp.asarray(7))

    trainer = create_trainer(cfg, "cpu", state_dict=W.state_dict_from_jax(side["params"], cfg))
    trainer.load_state(W.train_state_from_jax(state, cfg))
    got = trainer.state()
    assert got["step"] == 7
    assert all(int(s["step"]) == 7 for s in trainer.optimizer.state.values())
    tables = W.supir_rules(cfg)
    checked = 0
    for name, tree, branches in (("params", state["params"], ("unet", "control", "vae")),
                                 ("exp_avg", mu, ("unet", "control")), ("exp_avg_sq", nu, ("unet", "control")),
                                 ("ema", state["ema"], ("unet", "control"))):
        for branch in branches:
            for tkey, fpath, kind in tables[branch]:
                leaf = np.asarray(W._leaf(tree[branch], fpath))
                if tkey not in got[name]:
                    assert tkey in trainer.stopped and name != "params", tkey
                    kept = np.asarray(W._leaf(state["params"][branch], fpath)) if name == "ema" else 0.0
                    np.testing.assert_array_equal(leaf, kept + np.zeros_like(leaf), err_msg=f"{name} {tkey}")
                    continue
                np.testing.assert_array_equal(_to_flax(kind, got[name][tkey]), leaf, err_msg=f"{name} {tkey}")
                checked += 1
    assert checked > 3 * len(trainer.params)


# --------------------------------------------------------- the small modules


@pytest.mark.parametrize("name,args", [
    ("lambda_warmup_cosine", (10, 0.1, 1.0, 0.01, 100)),
    ("lambda_warmup_cosine2", ([10, 5], [0.1, 0.2], [1.0, 0.8], [0.01, 0.05], [60, 40])),
    ("lambda_linear", ([10, 5], [0.1, 0.2], [1.0, 0.8], [0.01, 0.05], [60, 40])),
])
def test_lr_schedulers_equal_jax(name, args):
    """Steps 0, 1, inside the warm-up, its end, mid-decay, a cycle boundary
    and past the end."""
    got, want = getattr(lr, name)(*args), getattr(jax_lr, name)(*args)
    for step in (0, 1, 5, 10, 35, 60, 61, 80, 100, 150):
        assert float(got(step)) == float(want(step)), step


@pytest.mark.parametrize("weighting", ["unit", "eps", "edm", "v"])
@pytest.mark.parametrize("loss_type", ["l2", "l1"])
def test_diffusion_loss_matches_jax(weighting, loss_type):
    """The loss with the JAX draws injected, on a fixed denoiser; the
    weightings are jax's (scaling.py:38-51)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 4, 4, 4)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    k_sigma, k_noise = jax.random.split(key)
    sigma, _ = jax_discrete_sampling(k_sigma, 3)
    noise = jax.random.normal(k_noise, x.shape, jnp.float32)
    want = jax_loss.diffusion_loss(lambda n, s, c: 0.7 * n + c, jnp.asarray(x), 0.25, key,
                                   weighting=weighting, loss_type=loss_type)
    got = diffusion_loss(lambda n, s, c: 0.7 * n + c, torch.from_numpy(x), 0.25, weighting=weighting,
                         loss_type=loss_type, sigma=torch.from_numpy(np.asarray(sigma)),
                         noise=torch.from_numpy(np.asarray(noise)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    s = np.asarray(sigma)
    np.testing.assert_allclose(scaling.WEIGHTINGS[weighting](torch.from_numpy(s)).numpy(),
                               np.asarray(jax_loss.WEIGHTINGS[weighting](jnp.asarray(s))), rtol=1e-6)
    assert jax_loss.WEIGHTINGS[weighting] is getattr(jax_scaling, f"{weighting}_weighting")


def test_sigma_samplers_draw_from_the_generator():
    sigma, idx = discrete_sampling(torch.Generator().manual_seed(0), 64)
    assert idx.min() >= 0 and idx.max() < 1000 and sigma.dtype == torch.float32
    np.testing.assert_array_equal(sigma.numpy(), jax_sigma_table(1000)[idx.numpy()])
    again, _ = discrete_sampling(torch.Generator().manual_seed(0), 64)
    assert torch.equal(sigma, again)
    e = edm_sampling(torch.Generator().manual_seed(1), 4096)
    assert (e > 0).all() and abs(float(e.log().mean()) + 1.2) < 0.1 and abs(float(e.log().std()) - 1.2) < 0.1


def test_create_trainer_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_trainer(P.tiny_cfg())
