"""``Dreamer.inference`` and the log-step flags against the JAX package (CPU, float32).

Inference is the acting step the generators call: ``split(key) -> (k_wm,
k_act)``, the posterior noise (1,B,S,K) from k_wm and the action noise from
k_act, replayed into the port. Checked at B=1 and B=3 for the ``onehot`` and
``trunc_normal`` heads: actions, out_state and the per-slot (B,) metrics
(rtol/atol 1e-5). The log step's ``do_image_pred`` and ``do_dream_tensors``
are checked through two ``TrainStep`` steps with both flags on: every metric,
tensor and dream tensor against JAX's; the eval forward (open loop, IWAE,
``do_image_pred``) once, without gradients. Helpers:
``tests/test_torch_port_train_step.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydreamer_tpu.models.rssm import draw_z_noise
from pydreamer_tpu_torch.models.noise import ReplayNoise
from tests.test_torch_port_train_step import (_action_noise, _batch, _close, _conf, _jax_noise,
                                              paired_models, run_two_steps)

RTOL = ATOL = 1e-5


def _head_conf(head):
    if head == "onehot":
        return _conf()
    return _conf(action_dim=6, actor_grad="dynamics", actor_dist=head)


@pytest.fixture(scope="module", params=["onehot", "trunc_normal"])
def models(request):
    """JAX and port models of one policy head, from the same weights."""
    conf = _head_conf(request.param)
    return (conf,) + paired_models(conf, seed=30)


@pytest.mark.parametrize("B", [1, 3])
def test_inference_matches_jax(models, B):
    conf, jmodel, params, model = models
    obs = {k: v[:1, :B] for k, v in _batch(conf, seed=31).items()}
    obs["reset"][0, 0] = False  # one slot carries its state on, the others start over
    rng = np.random.RandomState(32)
    S, K = conf.stoch_dim, conf.stoch_discrete
    h = np.tanh(rng.randn(B, conf.deter_dim)).astype(np.float32)
    z = np.eye(K, dtype=np.float32)[rng.randint(0, K, (B, S))].reshape(B, S * K)
    key = jax.random.PRNGKey(33)

    want_action, want_state, want_metrics = jax.jit(jmodel.inference)(
        params, {k: jnp.asarray(v) for k, v in obs.items()}, (jnp.asarray(h), jnp.asarray(z)), key)
    k_wm, k_act = jax.random.split(key)
    noise = ReplayNoise(dict(posterior_z=draw_z_noise(k_wm, (1, B), S, K),
                             action=_action_noise(k_act, (1, B, conf.action_dim),
                                                  conf.actor_dist)))
    action, out_state, metrics = model.inference(
        {k: torch.from_numpy(v) for k, v in obs.items()}, (torch.from_numpy(h), torch.from_numpy(z)),
        noise)

    assert tuple(action.shape) == (1, B, conf.action_dim)
    _close(action, want_action, RTOL, ATOL, "action")
    for got, want, name in zip(out_state, want_state, ("h", "z")):
        _close(got, want, RTOL, ATOL, f"out_state {name}")
    assert set(metrics) == set(want_metrics)
    for name, want in want_metrics.items():
        assert tuple(metrics[name].shape) == (B,)
        _close(metrics[name], want, RTOL, ATOL, name)
    if conf.actor_dist == "trunc_normal":
        assert action.abs().max() <= 1.0


@pytest.mark.parametrize("head", ["onehot", "trunc_normal"])
def test_log_step_flags_match_jax(head):
    """do_image_pred (logprob_* metrics from prior samples, *_pred tensors)
    and do_dream_tensors (the T-1 step rollout: image_pred (T,B,64,64,3),
    action_pred (T,B,A), rewards, terminals and the value tensors)."""
    conf = _head_conf(head)
    run_two_steps(conf, _batch(conf, signed=True), flags=True)


def test_eval_forward_matches_jax():
    """The learner's eval forward: open loop, IWAE over 3 samples and the
    prior-sample image metrics, without gradients: losses, metrics and
    tensors against JAX's (rtol 1e-4, tensors within 1e-4 of their size)."""
    conf = _conf(iwae_samples=3)
    jmodel, params, model = paired_models(conf, seed=34)
    obs = _batch(conf, seed=35, signed=True)
    key = jax.random.PRNGKey(36)
    BI = conf.batch_size * conf.iwae_samples
    kw = dict(do_open_loop=True, do_image_pred=True)
    want_losses, want_state, want_metrics, want_tensors, _ = jax.jit(
        lambda p, o, s, k: jmodel.training_step(p, o, s, k, **kw))(
        params, {k: jnp.asarray(v) for k, v in obs.items()}, jmodel.init_state(BI),
        jax.random.fold_in(key, 0))
    with torch.no_grad():
        losses, out_state, metrics, tensors, _ = model.training_step(
            {k: torch.from_numpy(v) for k, v in obs.items()}, model.init_state(BI),
            _jax_noise(conf, key, 0), **kw)
    for got, want in ((losses, want_losses), (metrics, want_metrics)):
        assert set(want) <= set(got)
        for name in want:
            _close(got[name].item(), float(want[name]), 1e-4, 1e-6, name)
    assert set(tensors) == set(want_tensors)
    for name, want in want_tensors.items():
        scale = np.nanmax(np.abs(np.asarray(want)), initial=0.0)
        _close(tensors[name], want, 1e-4, 1e-4 * scale, name)
    for got, want, name in zip(out_state, want_state, ("h", "z")):
        _close(got, want, 1e-4, 1e-5, f"out_state {name}")
