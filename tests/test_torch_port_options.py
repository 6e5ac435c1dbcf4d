"""The other Dreamer model options against the JAX package (CPU, float32).

Per module (rtol/atol 1e-5): ``CategoricalSupport``, the reward squashing
functions, the dense image encoder and the vecobs encoder, the categorical
image decoder, the categorical reward head, the vecobs head and
``extra_metrics``; the noise of each kind. Then two ``TrainStep`` steps each
(metrics rtol 1e-4, parameters atol 1e-5 / rtol 1e-4) for the auxiliary critic, IWAE, a
minigrid-like dense/categorical-image config with ``reward_input``, a
vecobs-only config and the categorical reward head; those also prove
``convert.py`` both ways on each config's new subtrees (the port loads the
JAX tree strictly, and its updated parameters go back into the JAX tree).
Helpers: ``tests/test_torch_port_train_step.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydreamer_tpu.models import decoders as jdec
from pydreamer_tpu.models import distributions as jdist
from pydreamer_tpu.models import encoders as jenc
from pydreamer_tpu.models import functions as jfn
from pydreamer_tpu_torch.convert import jax_to_state_dict
from pydreamer_tpu_torch.models import decoders, distributions, encoders, functions
from pydreamer_tpu_torch.models.dreamer import Dreamer
from pydreamer_tpu_torch.models.noise import NOISE_KINDS, GeneratorNoise
from tests.test_torch_port_train_step import _batch, _close, _conf, run_two_steps

RTOL = ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _load(module, flax_params):
    module.load_state_dict(jax_to_state_dict(flax_params))
    return module


def _minigrid_conf(**overrides):
    """The `minigrid` preset's observation and model options on the tiny config."""
    return _conf(image_size=7, image_channels=12, image_categorical=True, action_dim=7,
                 reward_input=True, image_encoder="dense", image_encoder_layers=3,
                 image_decoder="dense", image_decoder_layers=2, image_decoder_min_prob=0.01,
                 imag_horizon=1, **overrides)


# -- functions and CategoricalSupport ------------------------------------------

def test_reward_squashing():
    x = np.random.RandomState(20).randn(6, 5).astype(np.float32) * 3
    _close(functions.symlog(_t(x)), jfn.symlog(jnp.asarray(x)), RTOL, ATOL, "symlog")
    _close(functions.symexp(_t(x)), jfn.symexp(jnp.asarray(x)), RTOL, ATOL, "symexp")
    for mode in (None, "tanh", "log1p", "symlog"):
        xm = np.abs(x) if mode == "log1p" else x
        _close(functions.clip_rewards(_t(xm), mode), jfn.clip_rewards(jnp.asarray(xm), mode),
               RTOL, ATOL, str(mode))
        np.testing.assert_array_equal(functions.clip_rewards_np(xm, mode),
                                      jfn.clip_rewards_np(xm, mode))
    with pytest.raises(ValueError):
        functions.clip_rewards(_t(x), "clip")


def test_categorical_support():
    """log_prob (nearest bucket, first on a tie), entropy, mean and a sample
    from the same gumbel noise as jax.random.categorical."""
    rng = np.random.RandomState(21)
    logits = rng.randn(4, 6, 5).astype(np.float32)
    support = np.array([-10.0, -1.0, 0.0, 1.0, 10.0], np.float32)
    target = np.concatenate([rng.randn(4, 5) * 4, np.full((4, 1), 0.5)], 1).astype(np.float32)
    key = jax.random.PRNGKey(22)
    jd = jdist.CategoricalSupport(jnp.asarray(logits), jnp.asarray(support))
    td = distributions.CategoricalSupport(_t(logits), _t(support))
    np.testing.assert_array_equal(
        distributions.support_to_categorical(_t(target), _t(support)).numpy(),
        jdist.support_to_categorical(jnp.asarray(target), jnp.asarray(support)))
    _close(td.log_prob(_t(target)), jd.log_prob(jnp.asarray(target)), RTOL, ATOL, "log_prob")
    _close(td.entropy(), jd.entropy(), RTOL, ATOL, "entropy")
    _close(td.mean, jd.mean, RTOL, ATOL, "mean")
    gumbel = jax.random.gumbel(key, logits.shape)
    _close(td.sample_noise(_t(gumbel)), jd.sample(key), RTOL, ATOL, "sample")


# -- encoders and decoders -----------------------------------------------------

def test_dense_and_vecobs_encoders():
    """MultiEncoder with the dense image encoder (reward/terminal planes on a
    7x7x12 image) and the vecobs MLP, embeddings concatenated."""
    rng = np.random.RandomState(23)
    T, B = 3, 2
    obs = dict(image=np.eye(12, dtype=np.float32)[rng.randint(0, 12, (T, B, 7, 7))],
               vecobs=rng.randn(T, B, 5).astype(np.float32),
               reward=rng.randn(T, B).astype(np.float32),
               terminal=(rng.rand(T, B) < 0.5).astype(np.float32))
    kw = dict(image_encoder="dense", image_size=7, image_channels=12, cnn_depth=4,
              image_encoder_layers=3, vecobs_size=5, reward_input=True)
    je = jenc.MultiEncoder(**kw)
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}
    params = je.init(jax.random.PRNGKey(24), jobs)
    te = _load(encoders.MultiEncoder(**kw), params)
    got = te({k: _t(v) for k, v in obs.items()})
    assert tuple(got.shape) == (T, B, 512) and te.out_dim == 512
    _close(got, je.apply(params, jobs), RTOL, ATOL, "embed")


def test_cat_image_decoder():
    """Logits, the min_prob-mixed cross-entropy over (H,W) for int and one-hot
    targets, and the I-axis log-space aggregation (I=2)."""
    rng = np.random.RandomState(25)
    feats = rng.randn(3, 2, 2, 24).astype(np.float32)
    target = rng.randint(0, 12, (3, 2, 7, 7))
    jd = jdec.CatImageDecoder(24, (7, 7, 12), hidden_layers=2, min_prob=0.01)
    params = jd.init(jax.random.PRNGKey(26), jnp.asarray(feats))
    td = _load(decoders.CatImageDecoder(24, (7, 7, 12), hidden_layers=2, min_prob=0.01), params)
    for tgt in (target, np.eye(12, dtype=np.float32)[target]):
        want = jd.apply(params, jnp.asarray(feats), jnp.asarray(tgt),
                        method=jdec.CatImageDecoder.training_step)
        got = td.training_step(_t(feats), torch.from_numpy(tgt))
        for g, w, name in zip(got, want, ("loss_tbi", "loss_tb", "logits")):
            _close(g, w, RTOL, ATOL, name)


@pytest.mark.parametrize("variant", ["categorical_reward_vecobs", "dense_image_signed_reward"])
def test_multi_decoder_heads_and_extra_metrics(variant):
    """MultiDecoder's loss, metrics and tensors with extra_metrics: the
    per-bucket reward losses of the categorical head (support -1, 0, 1) with
    the vecobs head, or the per-sign ones with the dense image decoder."""
    rng = np.random.RandomState(27)
    T, B, I, F = 4, 3, 2, 24
    kw = dict(features_dim=F, image_size=7, image_channels=12, cnn_depth=4,
              image_decoder_layers=1, image_decoder_min_prob=0.0, reward_decoder_layers=2,
              terminal_decoder_layers=1)
    obs = dict(reward=np.round(rng.randn(T, B), 1).astype(np.float32),
               terminal=(rng.rand(T, B) < 0.3).astype(np.float32))
    if variant == "categorical_reward_vecobs":
        kw.update(image_decoder=None, reward_decoder_categorical=(-1.0, 0.0, 1.0), vecobs_size=5)
        obs["vecobs"] = rng.randn(T, B, 5).astype(np.float32)
    else:
        kw.update(image_decoder="dense", reward_decoder_categorical=None, vecobs_size=0)
        obs["image"] = rng.randint(0, 12, (T, B, 7, 7))
    feats = rng.randn(T, B, I, F).astype(np.float32)
    jd = jdec.MultiDecoder(**kw)
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}
    params = jd.init(jax.random.PRNGKey(28), jnp.asarray(feats), jobs)
    td = _load(decoders.MultiDecoder(**kw), params)
    wloss, wmets, wtens = jd.apply(params, jnp.asarray(feats), jobs, True)
    gloss, gmets, gtens = td(_t(feats), {k: torch.from_numpy(v) for k, v in obs.items()},
                             extra_metrics=True)
    _close(gloss, wloss, RTOL, ATOL, "loss_reconstr")
    assert set(gmets) == set(wmets) and set(gtens) == set(wtens)
    for name in wmets:
        _close(gmets[name], wmets[name], RTOL, ATOL, name)
    for name in wtens:
        _close(gtens[name], wtens[name], RTOL, ATOL, name)
    rwant, twant = jd.apply(params, jnp.asarray(feats), method=jdec.MultiDecoder.reward_terminal)
    rgot, tgot = td.reward_terminal(_t(feats))
    _close(rgot, rwant, RTOL, ATOL, "reward mean")
    _close(tgot, twant, RTOL, ATOL, "terminal mean")


# -- two TrainStep steps per option ---------------------------------------------

@pytest.mark.parametrize("case", ["aux_critic", "iwae2", "minigrid", "vecobs", "reward_categorical"])
def test_two_steps_match_jax(case):
    conf = {
        "aux_critic": lambda: _conf(aux_critic=True, target_interval_aux=1, aux_critic_weight=0.5),
        # IWAE weighs the samples by softmax(-loss) over I. With the 64x64
        # image term each sample's loss is in the hundreds, and float32 sums
        # in another order move it by ~1e-4: enough to move the gradients by
        # ~2e-4 of their size and step 2's metrics past 1e-4 whatever the
        # code. Without the image term the losses are small and the bound's
        # code (sampled KL, the I axis in every head) is held to the stated
        # tolerances.
        "iwae2": lambda: _conf(iwae_samples=2, image_encoder=None, image_decoder=None,
                               vecobs_size=4),
        "minigrid": _minigrid_conf,
        "vecobs": lambda: _conf(image_encoder=None, image_decoder=None, vecobs_size=4,
                                action_dim=2),
        "reward_categorical": lambda: _conf(reward_decoder_categorical=(-1.0, 0.0, 0.5, 1.0)),
    }[case]()
    model = run_two_steps(conf, _batch(conf, signed=True))
    if case == "aux_critic":
        # The target copy ran before each update: it holds the critic as it
        # was before step 2's update, so the two now differ.
        aux = model.wm.ac_aux
        assert not any(p.requires_grad for p in aux.critic_target.parameters())
        assert any(not torch.equal(p, q) for p, q in zip(aux.critic.parameters(),
                                                         aux.critic_target.parameters()))


# -- the noise of each kind ------------------------------------------------------

def test_generator_noise_kinds_and_gaussian_latents():
    """A fault the port had: GeneratorNoise drew gumbel noise for every latent,
    so gaussian latents (stoch_discrete: 0) sampled mean + std * gumbel. Each
    draw now names its kind: standard normal, standard gumbel or uniform
    [0, 1), and a gaussian-latent Dreamer asks for normal latent noise."""
    draws = {kind: GeneratorNoise("cpu", seed=35).draw("x", (200_000,), kind)
             for kind in NOISE_KINDS}
    assert abs(draws["normal"].mean()) < 0.01 and abs(draws["normal"].std() - 1) < 0.01
    assert abs(draws["gumbel"].mean() - 0.5772) < 0.01                 # Euler's constant
    assert abs(draws["gumbel"].std() - np.pi / np.sqrt(6)) < 0.01
    assert 0 <= draws["uniform"].min() and draws["uniform"].max() < 1

    asked = {}

    class Recorder(GeneratorNoise):
        def draw(self, name, shape, kind, t=None):
            asked.setdefault(name, set()).add(kind)
            return super().draw(name, shape, kind, t)

    conf = _conf(stoch_discrete=0, actor_dist="trunc_normal", actor_grad="dynamics")
    model = Dreamer(conf, device="cpu")
    obs = {k: torch.from_numpy(v) for k, v in _batch(conf).items()}
    with torch.no_grad():
        model.training_step(obs, model.init_state(conf.batch_size), Recorder("cpu"))
    assert asked == {"posterior_z": {"normal"}, "dream_action": {"uniform"}, "dream_z": {"normal"}}
