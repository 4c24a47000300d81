"""The port's autoencoder GAN training (supir_tpu_torch/diffusion/ae_losses.py
and engine/ae_training.py) against the JAX package's on the CPU: the
discriminator and the five loss functions, and two steps of the trainer in
both branches, with the adversarial term live from step 0 and gated at
step 0 (disc_start 1), from the same weights and JAX's own posterior draws.

The tiny SDXL VAE (VAEConfig().tiny()) at 32^2, every leaf random. The port
draws its two unit-normal draws per step through
`engine/ae_training.py:unit_normal`; the tests replace it with JAX's draws,
as the sampler tests inject JAX's increments. The second step starts from
JAX's state after the first, carried by `ae_train_state_from_jax`, Adam
moments included.

Tolerances: the discriminator 1e-5, the losses 1e-6; the metrics 1e-4
relative, d_weight (a ratio of two gradient norms) 1e-3; each updated leaf
2e-3 relative L2 (PERF.md section 2's gradient bound), and moved where JAX
moved it; a leaf JAX leaves alone bit-identical. Gradients are held
through the generator's Adam moments (2e-3) and the discriminator's
gradients on the same images (1e-5).

Two limits of the comparison, both of JAX's own making:
- The change of a leaf is not held to a bound: Adam divides it by the
  gradient's magnitude, and at these widths several leaves have no true
  gradient (a bias before a GroupNorm of one channel per group, the
  attention's key bias), so both packages move them by round-off divided by
  eps. Their moments must stay at round-off in both (below ROUNDOFF times
  the largest moment of the tree).
- The discriminator's maps are 4x4 and 3x3 here, and an activation within
  ~1e-6 of a LeakyReLU kink flips its slope under round-off; one flip moves
  the gradients before it by ~1e-2, in JAX alone as much as between the
  packages. So a gradient may match, within the stated bound, either JAX's
  result or JAX's result on images moved by PERTURB (relative, either
  sign): the other side of such a kink. Away from a kink the two are the
  same to ~1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import nchw, one_torch_thread, random_params  # noqa: F401

from supir_tpu.config import VAEConfig as JVAEConfig
from supir_tpu.diffusion import ae_losses as JL
from supir_tpu.engine.ae_training import AETrainer as JAETrainer
from supir_tpu.models.vae import AutoencoderKL as JAutoencoderKL
from supir_tpu_torch.config import VAEConfig
from supir_tpu_torch.diffusion import ae_losses as TL
from supir_tpu_torch.engine import ae_training as TA
from supir_tpu_torch.engine.factory import create_ae_trainer
from supir_tpu_torch.utils.weights import ae_train_state_from_jax, discriminator_state_dict_from_jax

SIZE = 32
LR = 2e-4
METRIC_RTOL = 1e-4
D_WEIGHT_RTOL = 1e-3
LEAF_REL = 2e-3
ROUNDOFF = 1e-6
DISC_GRAD_REL = 1e-5  # the discriminator's gradients on the same images (observed ~1e-6)
PERTURB = 1e-6


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def trees():
    """(JAX VAE module, generator params, discriminator params), numpy leaves."""
    model = JAutoencoderKL(JVAEConfig().tiny())
    x = jnp.zeros((1, SIZE, SIZE, 3))
    gen = random_params(jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x))["params"], seed=30)
    disc = random_params(jax.eval_shape(lambda: JL.NLayerDiscriminator().init(jax.random.PRNGKey(0), x))["params"],
                         seed=31)
    return model, gen, disc


def _images(seed, n=2):
    rng = np.random.default_rng(seed)
    hq = np.clip(rng.normal(0, 0.4, (n, SIZE, SIZE, 3)), -1, 1).astype(np.float32)
    lq = np.clip(hq + 0.1 * rng.standard_normal(hq.shape), -1, 1).astype(np.float32)
    return lq, hq


# ------------------------------------------------------------------ losses


def test_discriminator_matches_jax(trees):
    _, _, disc = trees
    x = np.random.default_rng(0).uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    want = np.asarray(JL.NLayerDiscriminator().apply({"params": disc}, x))
    tdisc = TL.NLayerDiscriminator()
    tdisc.load_state_dict(discriminator_state_dict_from_jax(disc), strict=True)
    with torch.no_grad():
        got = tdisc(torch.from_numpy(nchw(x))).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, SIZE // 8 - 2, SIZE // 8 - 2, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_loss_functions_match_jax():
    rng = np.random.default_rng(1)
    real, fake = (rng.normal(0, 1.5, (2, 6, 6, 1)).astype(np.float32) for _ in range(2))
    mean, logvar = rng.normal(0, 1, (2, 4, 4, 4)).astype(np.float32), rng.normal(0, 0.5, (2, 4, 4, 4)).astype(np.float32)
    recon, target = (rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32) for _ in range(2))
    perceptual = rng.uniform(0, 1, (2,)).astype(np.float32)
    t = torch.from_numpy

    def close(got, want):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)

    close(TL.hinge_d_loss(t(real), t(fake)), JL.hinge_d_loss(real, fake))
    close(TL.vanilla_g_loss(t(fake)), JL.vanilla_g_loss(fake))
    close(TL.kl_regularizer(t(nchw(mean)), t(nchw(logvar))), JL.kl_regularizer(mean, logvar))
    cfg, jcfg = TL.AELossConfig(disc_start=5), JL.AELossConfig(disc_start=5)
    for step, p in ((0, None), (0, perceptual), (5, None), (5, perceptual)):
        got, gparts = TL.generator_loss(t(recon), t(target), t(nchw(mean)), t(nchw(logvar)), t(fake), step, cfg,
                                        None if p is None else t(p))
        want, wparts = JL.generator_loss(recon, target, mean, logvar, fake, step, jcfg, p)
        close(got, want)
        for k in ("rec", "kl", "g"):
            close(gparts[k], wparts[k])
        close(TL.discriminator_loss(t(real), t(fake), step, cfg), JL.discriminator_loss(real, fake, step, jcfg))


# ----------------------------------------------------------------- trainer


def _jax_draws(rng, latent_shape):
    """The step's two draws (generator phase, discriminator phase), as
    JAX's step splits its key, NCHW for the port."""
    rng_s, rng_d = jax.random.split(rng)
    return [nchw(np.asarray(jax.random.normal(k, latent_shape, jnp.float32))) for k in (rng_s, rng_d)]


def _check_leaves(label, got_after, want_before, want_after):
    for k, w_after in want_after.items():
        got = got_after[k].detach()
        if torch.equal(w_after, want_before[k]):  # JAX left the leaf as it was
            assert torch.equal(got, w_after), (label, k)
        else:
            assert not torch.equal(got, want_before[k]), (label, k)
            assert rel_l2(got, w_after) <= LEAF_REL, (label, k, rel_l2(got, w_after))


def _perturbed(images, sign):
    rng = np.random.default_rng(50)
    return [(a * (1 + sign * PERTURB * rng.standard_normal(a.shape))).astype(np.float32) for a in images]


def _check_close(label, got, want, bound, others):
    """Each leaf within `bound` of JAX's result, or of one of JAX's results
    on images moved by PERTURB (`others`: the other side of a kink that
    round-off crosses); where JAX's is at round-off (below ROUNDOFF times
    the tree's largest), the port's too."""
    norm = lambda v: float(np.linalg.norm(np.asarray(v, np.float64)))  # noqa: E731
    floor = ROUNDOFF * max(norm(v) for v in want.values())
    assert set(got) == set(want), label
    for k, v in want.items():
        if norm(v) > floor:
            err = min(rel_l2(got[k], w[k]) for w in [want, *others])
            assert err <= bound, (label, k, rel_l2(got[k], v), err)
        else:
            assert norm(got[k]) <= floor, (label, k, norm(got[k]))


GEN_METRICS = ("loss_g", "rec", "kl", "g_adv", "d_weight")
DISC_METRICS = ("loss_d", "logits_real", "logits_fake")


def _check_metrics(label, got, want, names):
    for k in names:
        rtol = D_WEIGHT_RTOL if k == "d_weight" else METRIC_RTOL
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol, atol=1e-7, err_msg=f"{label} {k}")


@functools.partial(jax.jit, static_argnums=(0, 4))
def _jax_recon(model, gen, x, rng, use_dn):
    """JAX's discriminator-phase reconstruction: the branch's encoder, the
    second draw of `rng`, the decoder (NHWC)."""
    from supir_tpu.models.vae import DiagonalGaussian

    moments = model.apply({"params": gen}, x, use_denoise_encoder=use_dn, method=model.moments)
    z = DiagonalGaussian(moments).sample(jax.random.split(rng)[1])
    return model.apply({"params": gen}, z, method=model.decode)


@functools.partial(jax.jit, static_argnums=(4,))
def _jax_disc_value_and_grad(disc, real, fake, step, disc_start):
    d = JL.NLayerDiscriminator()

    def loss(params):
        lr_, lf = d.apply({"params": params}, real), d.apply({"params": params}, fake)
        return JL.discriminator_loss(lr_, lf, step, JL.AELossConfig(disc_start=disc_start)), (jnp.mean(lr_),
                                                                                             jnp.mean(lf))

    return jax.value_and_grad(loss, has_aux=True)(disc)


def _jax_disc_phase(disc, real, fake, step, cfg):
    """JAX's discriminator loss, mean logits and gradients at `disc` on
    the given images (NHWC)."""
    (value, (mr, mf)), grads = _jax_disc_value_and_grad(disc, real, fake, step, cfg.disc_start)
    metrics = {"loss_d": float(value), "logits_real": float(mr), "logits_fake": float(mf)}
    return metrics, discriminator_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads))


@pytest.mark.parametrize("disc_start", [0, 1])
@pytest.mark.parametrize("branch", TA.BRANCHES)
def test_trainer_two_steps_match_jax(trees, monkeypatch, branch, disc_start):
    """The generator phase against JAX's step: its metrics, the updated
    generator and its Adam moments. The discriminator phase against JAX's
    discriminator loss on the port's own reconstruction (loss, mean
    logits, gradients), since that reconstruction by the updated generator
    carries the update's round-off; the reconstruction itself and the
    updated discriminator against JAX's step's."""
    model, gen, disc = trees
    cfg = JVAEConfig().tiny()
    jcfg = JL.AELossConfig(disc_start=disc_start)
    # the perceptual term with the gated runs: both packages' callables on NHWC
    jperc = (lambda a, b: jnp.mean(jnp.square(a - b), axis=(1, 2, 3))) if disc_start else None
    tperc = (lambda a, b: ((a - b) ** 2).mean(dim=(1, 2, 3))) if disc_start else None
    jtrainer = JAETrainer(model, jcfg, learning_rate=LR, train_branch=branch, perceptual_fn=jperc)
    copy = lambda tree: jax.tree_util.tree_map(jnp.array, tree)  # noqa: E731  (train_step donates its state)
    state = {"gen": copy(gen), "disc": copy(disc), "opt_g": jtrainer.opt_g.init(jtrainer._trainable(copy(gen))),
             "opt_d": jtrainer.opt_d.init(copy(disc)), "step": jnp.zeros((), jnp.int32)}
    lq, hq = _images(2)
    x = lq if branch == "denoise_encoder" else hq
    keys = [jax.random.PRNGKey(40), jax.random.PRNGKey(41)]
    jax_states, jax_metrics, moved = [jax.tree_util.tree_map(np.asarray, state)], [], []
    for key in keys:
        # the same step on images moved by PERTURB: the other side of a kink
        moved.append([jax.tree_util.tree_map(np.asarray, jtrainer.train_step(
            copy(jax_states[-1]), *_perturbed((x, hq), sign), key)[0]) for sign in (1, -1)])
        state, m = jtrainer.train_step(state, x, hq, key)
        jax_states.append(jax.tree_util.tree_map(np.asarray, state))
        jax_metrics.append({k: float(v) for k, v in m.items()})
    bridged = [ae_train_state_from_jax(s, VAEConfig().tiny()) for s in jax_states]

    latent = (2, SIZE // 8, SIZE // 8, cfg.embed_dim)
    draws = [d for key in keys for d in _jax_draws(key, latent)]

    def injected(shape, generator, device):
        noise = torch.from_numpy(draws.pop(0))
        assert tuple(noise.shape) == tuple(shape)
        return noise.to(device)

    monkeypatch.setattr(TA, "unit_normal", injected)
    trainer = create_ae_trainer(VAEConfig().tiny(), "cpu", state_dict=bridged[0]["gen"],
                                loss_cfg=TL.AELossConfig(disc_start=disc_start), learning_rate=LR,
                                train_branch=branch, perceptual_fn=tperc)
    trainer.load_state(bridged[0])

    # the generator phase leaves the discriminator's gradients alone
    generator_phase, recon, d_step = trainer._generator_phase, trainer._recon, trainer.opt_d.step
    recons, d_grads = [], []

    def watched(*args):
        out = generator_phase(*args)
        assert all(p.grad is None and not p.requires_grad for p in trainer.disc.parameters())
        return out

    def recording_recon(*args):
        out = recon(*args)
        recons.append(out[0].detach().permute(0, 2, 3, 1).numpy())
        return out

    def recording_step(*args, **kw):
        d_grads.append({k: p.grad.detach().clone() for k, p in trainer.disc.named_parameters()})
        return d_step(*args, **kw)

    monkeypatch.setattr(trainer, "_generator_phase", watched)
    monkeypatch.setattr(trainer, "_recon", recording_recon)
    monkeypatch.setattr(trainer.opt_d, "step", recording_step)
    frozen = {k: p.detach().clone() for k, p in trainer.model.named_parameters() if k not in trainer.params}
    assert bool(frozen) == (branch == "denoise_encoder")

    for i in range(2):
        if i:  # the second step from JAX's state after the first, Adam moments included
            trainer.load_state(bridged[1])
        metrics = trainer.train_step(x, hq)
        label = f"{branch} disc_start={disc_start} step {i + 1}"
        assert set(metrics) == set(TA.METRICS)
        _check_metrics(label, metrics, jax_metrics[i], GEN_METRICS)
        got = trainer.state()
        _check_leaves(label + " gen", got["gen"], bridged[i]["gen"], bridged[i + 1]["gen"])
        for m in ("exp_avg", "exp_avg_sq"):
            want = bridged[i + 1]["opt_g"][m]
            others = [ae_train_state_from_jax(o, VAEConfig().tiny())["opt_g"][m] for o in moved[i]]
            _check_close(f"{label} opt_g {m}", got["opt_g"][m], want, LEAF_REL, others)

        fake = recons[-1]
        use_dn = branch == "denoise_encoder"
        want = {"recon": np.asarray(_jax_recon(model, jax_states[i + 1]["gen"], x, keys[i], use_dn))}
        others = [{"recon": np.asarray(_jax_recon(model, o["gen"], x, keys[i], use_dn))} for o in moved[i]]
        _check_close(label, {"recon": fake}, want, LEAF_REL, others)
        want, want_grads = _jax_disc_phase(jax_states[i]["disc"], hq, fake, i, jcfg)
        _check_metrics(label, metrics, want, DISC_METRICS)
        if not disc_start or i:
            others = [_jax_disc_phase(jax_states[i]["disc"], *_perturbed((hq, fake), sign), i, jcfg)[1]
                      for sign in (1, -1)]
            _check_close(label + " disc gradients", d_grads[-1], want_grads, DISC_GRAD_REL, others)
        else:  # gated: a zero loss
            assert not any(g.any() for g in d_grads[-1].values()), label
        _check_leaves(label + " disc", got["disc"], bridged[i]["disc"], bridged[i + 1]["disc"])
    assert not draws and trainer.step == 2
    for k, v in frozen.items():
        assert torch.equal(dict(trainer.model.named_parameters())[k], v), k
    if branch == "denoise_encoder":
        assert float(metrics["d_weight"]) == 1.0
    else:
        assert 0.0 <= float(metrics["d_weight"]) <= 1e4
    if disc_start:
        assert jax_metrics[0]["loss_d"] == 0.0 and jax_metrics[1]["loss_d"] > 0.0


def test_trainer_refuses_unknown_branch():
    with pytest.raises(ValueError, match="train_branch"):
        create_ae_trainer(VAEConfig().tiny(), "cpu", train_branch="decoder")


def test_sharded_trainer_step_matches_jax(trees, tmp_path):
    """AETrainer with its state sharded over two gloo ranks' 'model' axis
    (`mesh=`, `shard_state`), branch "all" at disc_start 0, against JAX's
    first step as the one-process test holds it: the generator's metrics,
    its updated leaves and its Adam moments (2e-3, or the other side of a
    kink)."""
    import torch_ranks

    model, gen, disc = trees
    jtrainer = JAETrainer(model, JL.AELossConfig(disc_start=0), learning_rate=LR, train_branch="all")
    copy = lambda tree: jax.tree_util.tree_map(jnp.array, tree)  # noqa: E731
    state = {"gen": copy(gen), "disc": copy(disc), "opt_g": jtrainer.opt_g.init(copy(gen)),
             "opt_d": jtrainer.opt_d.init(copy(disc)), "step": jnp.zeros((), jnp.int32)}
    before = jax.tree_util.tree_map(np.asarray, state)
    _, hq = _images(2)
    key = jax.random.PRNGKey(40)
    moved = [jax.tree_util.tree_map(np.asarray, jtrainer.train_step(copy(before), *_perturbed((hq, hq), sign),
                                                                        key)[0]) for sign in (1, -1)]
    after, metrics = jtrainer.train_step(state, hq, hq, key)
    bridged = [ae_train_state_from_jax(jax.tree_util.tree_map(np.asarray, s), VAEConfig().tiny())
               for s in (before, after)]
    draws = _jax_draws(key, (2, SIZE // 8, SIZE // 8, JVAEConfig().tiny().embed_dim))
    ranks = torch_ranks.spawn(2, tmp_path, ae_sharded_step=dict(
        cfg=VAEConfig().tiny(), state=bridged[0], x=hq, target=hq, draws=draws, lr=LR, branch="all")).join()
    for r, rank in enumerate(ranks):
        got, label = rank["ae_sharded_step"], f"sharded rank {r}"
        assert got["sharded"] and got["draws_left"] == 0
        _check_metrics(label, got["metrics"], {k: float(v) for k, v in metrics.items()}, GEN_METRICS)
        _check_leaves(label + " gen", got["gen"], bridged[0]["gen"], bridged[1]["gen"])
        for m in ("exp_avg", "exp_avg_sq"):
            others = [ae_train_state_from_jax(o, VAEConfig().tiny())["opt_g"][m] for o in moved]
            _check_close(f"{label} opt_g {m}", got["opt_g"][m], bridged[1]["opt_g"][m], LEAF_REL, others)

