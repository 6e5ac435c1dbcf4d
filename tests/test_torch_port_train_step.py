"""The port's slice as a whole: two TrainStep steps against the JAX package.

Same tiny flagship config (``__graft_entry__._make_conf(tiny=True)``, float32)
with ``gru_type: gru_layernorm_dv2`` and ``target_interval: 1`` so the
critic-target copy runs, same weights (the port's seeded init carried into
JAX's tree and back through ``convert.py``), same batch,
and the noise JAX draws from its keys replayed into the port:
``fold_in(key, step)`` -> ``split(3)`` -> (k_wm, k_dream, k_dream_log);
``split(k_wm)`` -> (k_rssm, k_pred): the posterior noise (T,B*I,S,K) and the
``do_image_pred`` prior sample (T,B,I,S,K); with ``dream_rng: threefry``,
``split(k_dream, H)`` -> per step ``split`` -> (k_act, k_prior) -> the action
noise (M,A) and the prior noise (M,S,K); the same from ``k_dream_log`` over
T-1 steps at M=B for ``do_dream_tensors``. Latent noise is gumbel (discrete)
or normal (``rssm.draw_z_noise``); action noise is gumbel for ``onehot``
(``jax.random.categorical(k, l) == argmax(l + gumbel(k, l.shape))``), normal
for ``normal_tanh``/``tanh_normal`` and, for ``trunc_normal``, the uniform
``jax.random.truncated_normal`` draws before scaling it between the bounds.

The helpers here (``_batch``, ``_jax_noise``, ``paired_models``,
``run_two_steps``) also serve
``test_torch_port_{dynamics,options,inference}.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from pydreamer_tpu.models.dreamer import Dreamer as JDreamer
from pydreamer_tpu.models.rssm import draw_z_noise
from pydreamer_tpu.training.train_step import TrainStep as JTrainStep
from pydreamer_tpu_torch.convert import jax_to_state_dict, state_dict_to_jax
from pydreamer_tpu_torch.models.dreamer import Dreamer
from pydreamer_tpu_torch.models.noise import GeneratorNoise, ReplayNoise
from pydreamer_tpu_torch.training.train_step import TrainStep, clip_by_global_norm_

LOSS_RTOL = 1e-4    # losses, metrics and grad norms, relative
PARAM_ATOL = 1e-5   # updated params after two AdamW steps (lr <= 3e-4), absolute
PARAM_RTOL = 1e-4
TENSOR_TOL = 1e-4   # tensors, relative and relative to each tensor's max-abs


def _conf(**overrides):
    return graft._make_conf(tiny=True).replace(
        gru_type="gru_layernorm_dv2", dream_rng="threefry", target_interval=1, **overrides)


def _batch(conf, seed=0, signed=False):
    """A batch of the config's observations. ``signed``: rewards of both
    signs and a few terminal steps (for the per-bucket metrics)."""
    rng = np.random.RandomState(seed)
    T, B, A = conf.batch_length, conf.batch_size, conf.action_dim
    if conf.actor_dist == "onehot":
        action = np.eye(A, dtype=np.float32)[rng.randint(0, A, (T, B))]
    else:
        action = rng.uniform(-1, 1, (T, B, A)).astype(np.float32)
    obs = dict(action=action,
               reward=rng.rand(T, B).astype(np.float32),
               terminal=np.zeros((T, B), np.float32),
               reset=np.zeros((T, B), bool))
    obs["reset"][0] = True
    if conf.image_encoder:
        shape = (T, B, conf.image_size, conf.image_size)
        if conf.image_categorical:
            obs["image"] = np.eye(conf.image_channels, dtype=np.float32)[
                rng.randint(0, conf.image_channels, shape)]
        else:
            obs["image"] = rng.randint(0, 256, shape + (conf.image_channels,)).astype(np.uint8)
    if conf.vecobs_size:
        obs["vecobs"] = rng.randn(T, B, conf.vecobs_size).astype(np.float32)
    if signed:
        obs["reward"] = rng.randn(T, B).astype(np.float32)
        obs["terminal"] = (rng.rand(T, B) < 0.2).astype(np.float32)
    return obs


def _action_noise(key, shape, actor_dist):
    """The standard noise JAX's policy head samples from for ``key``."""
    if actor_dist == "onehot":
        return jax.random.gumbel(key, shape, jnp.float32)
    if actor_dist == "trunc_normal":
        return jax.random.uniform(key, shape, jnp.float32)
    return jax.random.normal(key, shape, jnp.float32)


def _rollout_noise(conf, key, steps, M):
    actions, zs = [], []
    for k in jax.random.split(key, steps):
        k_act, k_prior = jax.random.split(k)
        actions.append(_action_noise(k_act, (M, conf.action_dim), conf.actor_dist))
        zs.append(draw_z_noise(k_prior, (M,), conf.stoch_dim, conf.stoch_discrete))
    return np.stack(actions), np.stack(zs)


def _jax_noise(conf, key, step) -> ReplayNoise:
    """Every draw of JAX's ``TrainStep`` at ``step`` (both log flags on)."""
    T, B, H, I = conf.batch_length, conf.batch_size, conf.imag_horizon, conf.iwae_samples
    S, K = conf.stoch_dim, conf.stoch_discrete
    k_wm, k_dream, k_dream_log = jax.random.split(jax.random.fold_in(key, step), 3)
    k_rssm, k_pred = jax.random.split(k_wm)
    arrays = dict(posterior_z=draw_z_noise(k_rssm, (T, B * I), S, K),
                  pred_z=draw_z_noise(k_pred, (T, B, I), S, K))
    arrays["dream_action"], arrays["dream_z"] = _rollout_noise(conf, k_dream, H, T * B * I)
    arrays["log_action"], arrays["log_z"] = _rollout_noise(conf, k_dream_log, T - 1, B)
    return ReplayNoise(arrays)


def _close(got, want, rtol, atol, msg):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def paired_models(conf, seed=0, classes=(JDreamer, Dreamer)):
    """The JAX model and the port's (``classes``: the two model classes), with
    the port's seeded weights carried into JAX's params tree through
    ``convert.py`` (shaped by ``eval_shape``, so JAX's init need not compile)."""
    jclass, tclass = classes
    jmodel = jclass(conf)
    torch.manual_seed(seed)
    model = tclass(conf, device="cpu")
    like = jax.eval_shape(jmodel.init, jax.random.PRNGKey(seed))
    params = jax.tree_util.tree_map(jnp.asarray, state_dict_to_jax(model.state_dict(), like))
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(like)[0],
                                 jax.tree_util.tree_leaves(params)):
        assert got.shape == want.shape, (jax.tree_util.keystr(path), got.shape, want.shape)
    model.load_state_dict(jax_to_state_dict(params))
    return jmodel, params, model


def run_two_steps(conf, obs, flags=False, pair=paired_models, noise=_jax_noise):
    """Two ``TrainStep`` steps of JAX and of the port from the same weights,
    batch and noise: every JAX metric (rtol 1e-4), every tensor (within 1e-4
    of its largest entry: step 2 starts from parameters that agree to 1e-5,
    and a decoder head passes that on), the out_state and (with ``flags``, ``do_image_pred`` and ``do_dream_tensors``
    on) the dream tensors, then every parameter (atol 1e-5 / rtol 1e-4).
    ``pair`` builds the two models (``paired_models``: ``Dreamer``) and
    ``noise(conf, key, step)`` replays JAX's draws (``_jax_noise``: Dreamer's).
    Returns the port's model."""
    jmodel, params, model = pair(conf)
    jstep = JTrainStep(jmodel, conf, donate=False)
    opt_state = jstep.init_optimizer(params)
    step_fn = TrainStep(model, conf, device="cpu")

    jobs = {k: jnp.asarray(v) for k, v in obs.items()}
    tobs = {k: torch.from_numpy(v) for k, v in obs.items()}
    key = jax.random.PRNGKey(2)
    BI = conf.batch_size * conf.iwae_samples
    jstate, tstate = jmodel.init_state(BI), model.init_state(BI)
    for step in (1, 2):
        params, opt_state, jstate, jmetrics, jtensors, jdream = jstep(
            params, opt_state, jobs, jstate, step, np.asarray(key),
            do_image_pred=flags, do_dream_tensors=flags)
        tstate, tmetrics, ttensors, tdream = step_fn(
            tobs, tstate, step, noise(conf, key, step),
            do_image_pred=flags, do_dream_tensors=flags)
        assert set(jmetrics) <= set(tmetrics)
        for name, want in jmetrics.items():
            _close(tmetrics[name].item(), float(want), LOSS_RTOL, 1e-6, f"step {step} {name}")
        for got, want in ((ttensors, jtensors), (tdream, jdream)):
            assert set(got) == set(want)
            for name in want:
                scale = np.nanmax(np.abs(np.asarray(want[name])), initial=0.0)
                _close(got[name], want[name], TENSOR_TOL, TENSOR_TOL * scale,
                       f"step {step} {name}")
        tleaves, jleaves = jax.tree_util.tree_leaves(tstate), jax.tree_util.tree_leaves(jstate)
        assert len(tleaves) == len(jleaves)
        for i, (got, want) in enumerate(zip(tleaves, jleaves)):
            assert tuple(got.shape) == tuple(want.shape)
            _close(got, want, PARAM_RTOL, PARAM_ATOL, f"step {step} out_state {i}")

    back = state_dict_to_jax(model.state_dict(), params)
    flat_want = jax.tree_util.tree_flatten_with_path(params)[0]
    for (path, want), got in zip(flat_want, jax.tree_util.tree_leaves(back)):
        _close(got, want, PARAM_RTOL, PARAM_ATOL, jax.tree_util.keystr(path))
    return model


def test_two_steps_match_jax():
    conf = _conf()
    run_two_steps(conf, _batch(conf))


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_matches_optax(scale):
    """optax's rule: g * max/norm when norm >= max (no +1e-6), else unchanged."""
    rng = np.random.RandomState(0)
    grads = [rng.randn(3, 4).astype(np.float32) * scale, rng.randn(5).astype(np.float32) * scale]
    want = optax.clip_by_global_norm(2.0).update([jnp.asarray(g) for g in grads], None)[0]
    tgrads = [torch.from_numpy(g.copy()) for g in grads]
    norm = torch.sqrt(sum(g.square().sum() for g in tgrads))
    clip_by_global_norm_(tgrads, norm, 2.0)
    for g, w in zip(tgrads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_generator_noise_steps_and_target_copy():
    """Default noise source: finite losses, the critic target is copied from
    the critic before the update on a target step and left alone otherwise."""
    conf = _conf().replace(target_interval=2)
    model = Dreamer(conf, device="cpu")
    step_fn = TrainStep(model, conf, device="cpu")
    tobs = {k: torch.from_numpy(v) for k, v in _batch(conf, seed=1).items()}
    state = model.init_state(conf.batch_size)

    critic_before = [p.detach().clone() for p in model.ac.critic.parameters()]
    target_before = [p.detach().clone() for p in model.ac.critic_target.parameters()]
    state, metrics, _, _ = step_fn(tobs, state, 1)   # 1 % 2 != 0: no copy
    for p, q in zip(model.ac.critic_target.parameters(), target_before):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    critic_before = [p.detach().clone() for p in model.ac.critic.parameters()]
    state, metrics, _, _ = step_fn(tobs, state, 2)   # copy, then update the critic
    for p, q in zip(model.ac.critic_target.parameters(), critic_before):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    assert all(np.isfinite(metrics[k].item()) for k in
               ("loss_model", "loss_probe", "loss_actor", "loss_critic", "grad_norm"))


def test_generator_noise_is_seeded():
    a, b = GeneratorNoise("cpu", seed=3), GeneratorNoise("cpu", seed=3)
    torch.testing.assert_close(a.draw("posterior_z", (2, 3, 4), "gumbel"),
                               b.draw("posterior_z", (2, 3, 4), "gumbel"), rtol=0, atol=0)
    assert not torch.equal(a.draw("dream_z", (2, 3), "gumbel", 0),
                           GeneratorNoise("cpu", seed=4).draw("dream_z", (2, 3), "gumbel", 0))
