"""``actor_grad: dynamics`` and the continuous policy heads against the JAX package.

The dream then carries the gradient through the frozen world model (kernel
K1's plain version on the CPU) into the actor. Checked here: the
``TanhNormal``/``TruncNormal`` heads (log_prob, entropy, mean and a sample
from replayed noise, rtol 1e-5), two ``TrainStep`` steps for each continuous
head, and that the ``wm`` gradients equal JAX's and take nothing from the
actor loss. Helpers: ``tests/test_torch_port_train_step.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydreamer_tpu.models import distributions as jdist
from pydreamer_tpu_torch.convert import state_dict_to_jax
from pydreamer_tpu_torch.models import distributions
from tests.test_torch_port_train_step import (_batch, _close, _conf, _jax_noise, paired_models,
                                              run_two_steps)

RTOL = ATOL = 1e-5
GRAD_TOL = 1e-4  # relative to each gradient leaf's max-abs: f32 sums over T*B*64*64 pixels in another order


def _dmc_conf(actor_dist="trunc_normal", **overrides):
    """The `dmc` preset's policy settings on the tiny config (continuous
    actions, dynamics gradient, kl_weight 1, gamma 0.995, entropy 1e-4)."""
    return _conf(action_dim=6, actor_grad="dynamics", actor_dist=actor_dist, entropy=1e-4,
                 gamma=0.995, kl_weight=1.0, **overrides)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.mark.parametrize("head", ["tanh_normal", "normal_tanh", "trunc_normal"])
def test_continuous_heads_match_jax(head):
    """log_prob, entropy, mean and a sample from the same standard noise, and
    the sample's gradient to the head's input (rtol/atol 1e-5)."""
    rng = np.random.RandomState(11)
    x = (2.0 * rng.randn(5, 7, 8)).astype(np.float32)     # (..., 2A), A = 4
    y = rng.uniform(-0.99, 0.99, (5, 7, 4)).astype(np.float32)
    weights = rng.randn(5, 7, 4).astype(np.float32)
    key = jax.random.PRNGKey(12)
    jd = getattr(jdist, head)(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    td = getattr(distributions, head)(xt)
    _close(td.log_prob(_t(y)), jd.log_prob(jnp.asarray(y)), RTOL, ATOL, "log_prob")
    _close(td.entropy(), jd.entropy(), RTOL, ATOL, "entropy")
    _close(td.mean, jd.mean, RTOL, ATOL, "mean")

    eps = (jax.random.uniform if head == "trunc_normal" else jax.random.normal)(key, (5, 7, 4))
    sample = td.sample_noise(_t(eps))
    _close(sample, jd.sample(key), RTOL, ATOL, "sample")
    (sample * _t(weights)).sum().backward()
    want = jax.grad(lambda v: jnp.sum(getattr(jdist, head)(v).sample(key) * weights))(jnp.asarray(x))
    _close(xt.grad, want, RTOL, ATOL, "sample grad")


def test_trunc_normal_sample_in_the_tails():
    """Draws over a wide range of bounds replay JAX's and stay in [-1, 1].

    ``torch.erf``/``torch.erfinv`` and XLA's ``erf``/``erf_inv`` differ in the
    last bits, and the inverse amplifies that where the uniform draw is within
    ~1e-4 of 0 or 1: over 5 x 65,536 such draws the samples differed by at
    most 4.7e-4, and by more than 1e-5 in about 1 draw in 11,000. So: all
    within 1e-3, and 99.9% within 1e-5."""
    rng = np.random.RandomState(13)
    loc = rng.uniform(-0.999, 0.999, (4096,)).astype(np.float32)
    scale = rng.uniform(0.02, 2.0, (4096,)).astype(np.float32)
    u = jax.random.uniform(jax.random.PRNGKey(14), (4096,))
    want = jdist.TruncNormal(jnp.asarray(loc), jnp.asarray(scale)).sample(jax.random.PRNGKey(14))
    td = distributions.TruncNormal(_t(loc), _t(scale))
    got = td.sample_noise(_t(u)).numpy()
    err = np.abs(got - np.asarray(want))
    assert err.max() <= 1e-3 and (err <= 1e-5).mean() >= 0.999, err.max()
    assert np.abs(got).max() <= 1.0 and torch.isfinite(td._logz()).all()


@pytest.mark.parametrize("head", ["trunc_normal", "tanh_normal", "normal_tanh"])
def test_two_dynamics_steps_match_jax(head):
    """Two TrainStep steps with actor_grad: dynamics and the K1 cell:
    metrics, tensors, out_state and every updated parameter."""
    conf = _dmc_conf(head)
    run_two_steps(conf, _batch(conf))


def test_wm_gradients_take_nothing_from_the_actor_loss():
    """The summed loss's gradient to every wm parameter equals JAX's (within
    1e-4 of each leaf's largest entry), and the actor loss alone gives the
    world model no gradient, though it reaches the actor through the dream."""
    conf = _dmc_conf()
    jmodel, params, model = paired_models(conf, seed=3)
    obs = _batch(conf, seed=4)
    key = jax.random.PRNGKey(5)

    def total(p):
        losses, *_ = jmodel.training_step(p, {k: jnp.asarray(v) for k, v in obs.items()},
                                          jmodel.init_state(conf.batch_size),
                                          jax.random.fold_in(key, 0))
        return sum(losses.values())

    want = jax.jit(jax.grad(total))(params)["wm"]
    tobs = {k: torch.from_numpy(v) for k, v in obs.items()}

    losses, *_ = model.training_step(tobs, model.init_state(conf.batch_size),
                                     _jax_noise(conf, key, 0))
    sum(losses.values()).backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()}
    got = state_dict_to_jax(grads, params)["wm"]
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    for (path, w), g in zip(flat_want, jax.tree_util.tree_leaves(got)):
        w = np.asarray(w)
        err = np.abs(g - w).max()
        assert err <= GRAD_TOL * np.abs(w).max() + 1e-7, ("wm" + jax.tree_util.keystr(path), err)

    model.zero_grad(set_to_none=True)
    losses, *_ = model.training_step(tobs, model.init_state(conf.batch_size),
                                     _jax_noise(conf, key, 0))
    losses["loss_actor"].backward()
    assert all(p.grad is None or not p.grad.any() for p in model.wm.parameters())
    assert any(p.grad is not None and p.grad.any() for p in model.ac.actor.parameters())
    assert all(p.requires_grad for p in model.wm.parameters())  # restored after the dream
