"""The probe heads against the JAX package (CPU, float32).

Per probe (``map``, ``goals``, ``map+goals``): loss, metrics, tensors and the
gradient to the features at I=2, from the same weights (rtol/atol 1e-5).
Then two ``TrainStep`` steps of the tiny Dreamer with each probe, and with
``probe_model: map`` under ``probe_gradients``, through ``run_two_steps``
(every JAX metric at rtol 1e-4, tensors within 1e-4 of their largest entry,
parameters at atol 1e-5 / rtol 1e-4). Under ``probe_gradients`` JAX clips and
updates the probe with the world model as one group but reports
``grad_norm`` over the world model alone and ``grad_norm_probe`` over the
probe (``pydreamer_tpu/training/train_step.py:151-154``); the port did not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydreamer_tpu.models import probes as jprobes
from pydreamer_tpu_torch.convert import jax_to_state_dict
from pydreamer_tpu_torch.models import probes
from tests.test_torch_port_train_step import _batch, _close, _conf, run_two_steps

RTOL = ATOL = 1e-5
PROBES = ("map", "goals", "map+goals")
PROBE_SIZES = dict(map_size=5, map_channels=6, map_hidden_layers=2, map_hidden_dim=32,
                   goals_size=2)
VISAGES = (0, 3, 7, 30, 100, 500, 2000)  # one per LOG_RANGES bucket, and one past them all


def _probe_conf(probe_model, **overrides):
    return _conf(probe_model=probe_model, **PROBE_SIZES, **overrides)


def probe_targets(conf, T, B, seed=0):
    """The probes' targets as ``Preprocessor`` makes them: int map, map_coord,
    map_seen_mask, goal directions and goal visibility ages."""
    rng = np.random.RandomState(seed)
    S, G = conf.map_size, conf.goals_size
    return dict(map=rng.randint(0, conf.map_channels, (T, B, S, S)).astype(np.int32),
                map_coord=rng.uniform(-1, 1, (T, B, 4)).astype(np.float32),
                map_seen_mask=(rng.rand(T, B, S, S) < 0.5).astype(np.float32),
                goal_direction=rng.randn(T, B, 2).astype(np.float32),
                goals_direction=rng.randn(T, B, 2 * G).astype(np.float32),
                goals_visage=rng.choice(VISAGES, (T, B, G)).astype(np.float32))


def _probe_batch(conf, seed=0):
    obs = _batch(conf, seed)
    obs.update(probe_targets(conf, conf.batch_length, conf.batch_size, seed + 100))
    return obs


@pytest.mark.parametrize("probe_model", PROBES)
def test_probe_matches_jax(probe_model):
    """``make_probe``'s head on (T,B,I=2,F) features: loss, every metric
    (``acc_map_seen`` and the empty age bucket's 0 included), every tensor,
    and the gradient of the loss to the features."""
    conf = _probe_conf(probe_model)
    T, B, I, F = 3, 2, 2, 12
    rng = np.random.RandomState(1)
    feats = rng.randn(T, B, I, F).astype(np.float32)
    obs = probe_targets(conf, T, B, seed=2)
    jprobe = jprobes.make_probe(conf, F)
    params = jprobe.init(jax.random.PRNGKey(3))
    probe = probes.make_probe(conf, F)
    probe.load_state_dict(jax_to_state_dict(params))

    jobs = {k: jnp.asarray(v) for k, v in obs.items()}

    def jloss(f):
        loss, metrics, tensors = jprobe.training_step(params, f, jobs)
        return loss, (metrics, tensors)

    (wloss, (wmets, wtens)), wgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(feats))
    tfeats = torch.from_numpy(feats).requires_grad_()
    gloss, gmets, gtens = probe.training_step(tfeats, {k: torch.from_numpy(v) for k, v in obs.items()})
    gloss.backward()
    _close(gloss, wloss, RTOL, ATOL, "loss")
    assert set(gmets) == set(wmets) and set(gtens) == set(wtens)
    for name in wmets:
        _close(gmets[name], wmets[name], RTOL, ATOL, name)
    for name in wtens:
        _close(gtens[name], wtens[name], RTOL, ATOL, name)
    _close(tfeats.grad, wgrad, RTOL, ATOL, "d loss / d features")
    if probe_model != "map":
        assert float(wmets["mse_goal_age1000"]) >= 0 and "mse_goal_age0" in wmets


@pytest.mark.parametrize("probe_model", PROBES)
def test_probes_two_steps_match_jax(probe_model):
    conf = _probe_conf(probe_model)
    model = run_two_steps(conf, _probe_batch(conf))
    assert isinstance(model.probe, {"map": probes.MapProbeHead, "goals": probes.GoalsProbe,
                                    "map+goals": probes.MapGoalsProbe}[probe_model])


def test_probe_gradients_grad_norms_match_jax():
    """``probe_gradients: True``: the features reach the probe undetached,
    the probe is clipped and updated with the world model as one group, and
    ``grad_norm`` / ``grad_norm_probe`` are reported per part as JAX does."""
    conf = _probe_conf("map", probe_gradients=True)
    run_two_steps(conf, _probe_batch(conf))


@pytest.mark.parametrize("probe_model", PROBES)
def test_unknown_probe_or_map_decoder_raises(probe_model):
    """As in JAX: an unknown ``probe_model``, or a map probe with another
    ``map_decoder`` than ``dense``, raises NotImplementedError."""
    conf = _probe_conf(probe_model)
    with pytest.raises(NotImplementedError):
        probes.make_probe(conf.replace(probe_model=probe_model + "_x"), 8)
    if "map" in probe_model:
        with pytest.raises(NotImplementedError):
            probes.make_probe(conf.replace(map_decoder="cnn"), 8)
