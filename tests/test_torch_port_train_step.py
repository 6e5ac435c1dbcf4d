"""The port's slice as a whole: two TrainStep steps against the JAX package.

Same tiny flagship config (``__graft_entry__._make_conf(tiny=True)``, float32)
with ``gru_type: gru_layernorm_dv2`` and ``target_interval: 1`` so the
critic-target copy runs, same weights (through ``convert.py``), same uint8
batch, and the noise JAX draws from its keys replayed into the port:
``fold_in(key, step)`` -> ``split(3)`` -> (k_wm, k_dream, _);
``split(k_wm)`` -> k_rssm -> posterior gumbel (T,B,S,K); with
``dream_rng: threefry``, ``split(k_dream, H)`` -> per step ``split`` ->
(k_act, k_prior) -> action gumbel (M,A) and prior gumbel (M,S,K)
(``jax.random.categorical(k, l) == argmax(l + gumbel(k, l.shape))``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from pydreamer_tpu.models.dreamer import Dreamer as JDreamer
from pydreamer_tpu.training.train_step import TrainStep as JTrainStep
from pydreamer_tpu_torch.convert import jax_to_state_dict, state_dict_to_jax
from pydreamer_tpu_torch.models.dreamer import Dreamer
from pydreamer_tpu_torch.models.noise import GeneratorNoise, ReplayNoise
from pydreamer_tpu_torch.training.train_step import TrainStep, clip_by_global_norm_

LOSS_RTOL = 1e-4    # losses, metrics and grad norms, relative
PARAM_ATOL = 1e-5   # updated params after two AdamW steps (lr <= 3e-4), absolute
PARAM_RTOL = 1e-4


def _conf():
    return graft._make_conf(tiny=True).replace(
        gru_type="gru_layernorm_dv2", dream_rng="threefry", target_interval=1)


def _batch(conf, seed=0):
    rng = np.random.RandomState(seed)
    T, B, A = conf.batch_length, conf.batch_size, conf.action_dim
    obs = dict(action=np.eye(A, dtype=np.float32)[rng.randint(0, A, (T, B))],
               reward=rng.rand(T, B).astype(np.float32),
               terminal=np.zeros((T, B), np.float32),
               reset=np.zeros((T, B), bool),
               image=rng.randint(0, 256, (T, B, conf.image_size, conf.image_size,
                                          conf.image_channels)).astype(np.uint8))
    obs["reset"][0] = True
    return obs


def _jax_noise(conf, key, step) -> ReplayNoise:
    T, B, H = conf.batch_length, conf.batch_size, conf.imag_horizon
    S, K, A, M = conf.stoch_dim, conf.stoch_discrete, conf.action_dim, T * B
    k_wm, k_dream, _ = jax.random.split(jax.random.fold_in(key, step), 3)
    k_rssm, _ = jax.random.split(k_wm)
    actions, zs = [], []
    for k in jax.random.split(k_dream, H):
        k_act, k_prior = jax.random.split(k)
        actions.append(jax.random.gumbel(k_act, (M, A), jnp.float32))
        zs.append(jax.random.gumbel(k_prior, (M, S, K), jnp.float32))
    return ReplayNoise(dict(posterior_z=jax.random.gumbel(k_rssm, (T, B, S, K), jnp.float32),
                            dream_action=np.stack(actions), dream_z=np.stack(zs)))


def test_two_steps_match_jax():
    conf = _conf()
    jmodel = JDreamer(conf)
    params = jmodel.init(jax.random.PRNGKey(0))
    jstep = JTrainStep(jmodel, conf, donate=False)
    opt_state = jstep.init_optimizer(params)
    model = Dreamer(conf, device="cpu")
    model.load_state_dict(jax_to_state_dict(params))
    step_fn = TrainStep(model, conf, device="cpu")

    obs = _batch(conf)
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}
    tobs = {k: torch.from_numpy(v) for k, v in obs.items()}
    key = jax.random.PRNGKey(2)
    jstate, tstate = jmodel.init_state(conf.batch_size), model.init_state(conf.batch_size)
    for step in (1, 2):
        params, opt_state, jstate, jmetrics, _, _ = jstep(
            params, opt_state, jobs, jstate, step, np.asarray(key))
        tstate, tmetrics, _ = step_fn(tobs, tstate, step, _jax_noise(conf, key, step))
        assert set(jmetrics) <= set(tmetrics)
        for name, want in jmetrics.items():
            np.testing.assert_allclose(tmetrics[name].item(), float(want), rtol=LOSS_RTOL,
                                       atol=1e-6, err_msg=f"step {step} {name}")
        for got, want, name in zip(tstate, jstate, ("h", "z")):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=f"step {step} out_state {name}")

    back = state_dict_to_jax(model.state_dict(), params)
    flat_want = jax.tree_util.tree_flatten_with_path(params)[0]
    for (path, want), got in zip(flat_want, jax.tree_util.tree_leaves(back)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=jax.tree_util.keystr(path))


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
    state, metrics, _ = step_fn(tobs, state, 1)   # 1 % 2 != 0: no copy
    for p, q in zip(model.ac.critic_target.parameters(), target_before):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    critic_before = [p.detach().clone() for p in model.ac.critic.parameters()]
    state, metrics, _ = step_fn(tobs, state, 2)   # copy, then update the critic
    for p, q in zip(model.ac.critic_target.parameters(), critic_before):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    assert all(np.isfinite(metrics[k].item()) for k in
               ("loss_model", "loss_probe", "loss_actor", "loss_critic", "grad_norm"))


def test_generator_noise_is_seeded():
    a, b = GeneratorNoise("cpu", seed=3), GeneratorNoise("cpu", seed=3)
    torch.testing.assert_close(a.posterior_z((2, 3, 4)), b.posterior_z((2, 3, 4)), rtol=0, atol=0)
    assert not torch.equal(a.dream_z(0, (2, 3)), GeneratorNoise("cpu", seed=4).dream_z(0, (2, 3)))
