"""The baseline world models (``WorldModelProbe``) against the JAX package
(CPU, float32), on the tiny shapes of ``tests/test_baselines.py`` with the
``map+goals`` probe.

The noise JAX draws from its key is replayed: the VAE splits the key it is
given into (k_z, k_prior) and draws its posterior sample's standard normal
(``embed_z``, (T, B, I, S)) from k_z and, under ``do_image_pred``, its prior
sample's (``embed_pred_z``) from k_prior; the GRU and transformer models
hand their whole key to the VAE, and ``gru_probe`` draws nothing. Under
``TrainStep`` that key is ``fold_in(key, step)``.

* One forward of each baseline at I=1 (and at I=3 but ``gru_probe``, which
  refuses I>1) with ``do_image_pred``: both losses, every metric, the
  out_state and every tensor (the ``*_pred`` ones included) at rtol/atol
  1e-5, the summed loss's gradient to every parameter within 1e-4 of its
  leaf's largest entry, and the routing of ``tests/test_baselines.py``:
  ``loss_model`` reaches only ``wm`` and ``loss_probe`` only ``probe``.
* Two ``TrainStep`` steps (``run_two_steps``: metrics rtol 1e-4, tensors
  within 1e-4 of their largest entry, parameters atol 1e-5 / rtol 1e-4) of
  ``gru_vae`` (TBTT state carried) and ``transformer_vae`` with both log
  flags, and of ``gru_probe`` under ``probe_gradients``.
* A JAX baseline learner checkpoint converted by ``jax_checkpoint_to_torch``
  trains on in the port as in JAX; ``convert.py``'s attention rule round
  trips exactly; ``make_model`` builds each baseline; the port's
  ``trainer.run`` trains ``gru_vae`` with the map probe from episode files
  that carry a map and the agent's pose.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydreamer_tpu.models.baselines import WorldModelProbe as JWorldModelProbe
from pydreamer_tpu.tracking import save_checkpoint_file as jax_save_checkpoint_file
from pydreamer_tpu.training.train_step import TrainStep as JTrainStep
from pydreamer_tpu_torch.conf import Conf
from pydreamer_tpu_torch.convert import (jax_checkpoint_to_torch, jax_to_state_dict,
                                         state_dict_to_jax)
from pydreamer_tpu_torch.data.repository import NpzEpisodeRepository
from pydreamer_tpu_torch.models.baselines import WorldModelProbe
from pydreamer_tpu_torch.models.noise import ReplayNoise
from pydreamer_tpu_torch.tracking import Run
from pydreamer_tpu_torch.training import trainer
from pydreamer_tpu_torch.training.train_step import TrainStep
from tests.test_baselines import baseline_conf
from tests.test_torch_port_probes import probe_targets
from tests.test_torch_port_train_step import (LOSS_RTOL, PARAM_ATOL, PARAM_RTOL, _close,
                                              paired_models, run_two_steps)
from tests.test_trainer import tiny_conf
from tests.util import make_batch

RTOL = ATOL = 1e-5
GRAD_TOL = 1e-4  # relative to each gradient leaf's max-abs
MODELS = ("vae", "gru_vae", "transformer_vae", "gru_probe")


def _conf(model, **overrides):
    return baseline_conf(model).replace(probe_model="map+goals", goals_size=2, **overrides)


def _obs(conf, seed=0):
    """``make_batch``'s observations with ``action_next`` (as
    ``SequentialDataset`` makes it) and the probes' targets."""
    obs = make_batch(conf, seed=seed)
    obs["action_next"] = np.concatenate([obs["action"][1:], np.zeros_like(obs["action"][:1])])
    obs.update(probe_targets(conf, conf.batch_length, conf.batch_size, seed + 100))
    return obs


def _noise(conf, key, iwae_samples=None):
    T, B, S = conf.batch_length, conf.batch_size, conf.stoch_dim
    I = iwae_samples or conf.iwae_samples
    k_z, k_prior = jax.random.split(key)
    return ReplayNoise(dict(embed_z=jax.random.normal(k_z, (T, B, I, S)),
                            embed_pred_z=jax.random.normal(k_prior, (T, B, I, S))))


def _step_noise(conf, key, step):
    return _noise(conf, jax.random.fold_in(key, step))


def paired_baselines(conf, seed=0):
    return paired_models(conf, seed, classes=(JWorldModelProbe, WorldModelProbe))


def _grads(model):
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p))
            for k, p in model.named_parameters()}


@pytest.mark.parametrize("model_name,I", [(m, 1) for m in MODELS]
                         + [(m, 3) for m in MODELS if m != "gru_probe"])
def test_baseline_step_matches_jax(model_name, I):
    conf = _conf(model_name, iwae_samples=I)
    jmodel, params, model = paired_baselines(conf, seed=1)
    obs = _obs(conf, seed=2)
    key = jax.random.PRNGKey(3)
    BI = conf.batch_size * I
    rng = np.random.RandomState(4)
    state = (rng.randn(BI, conf.deter_dim).astype(np.float32)
             if model_name in ("gru_vae", "gru_probe") else np.zeros(0, np.float32))
    obs["reset"][0, 0] = False  # stream 0 carries its state, stream 1 starts an episode
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}

    def total(p):
        losses, out_state, metrics, tensors, _ = jmodel.training_step(
            p, jobs, jnp.asarray(state), key, do_image_pred=True)
        return sum(losses.values()), (losses, out_state, metrics, tensors)

    (_, (wlosses, wstate, wmets, wtens)), wgrads = jax.jit(
        jax.value_and_grad(total, has_aux=True))(params)

    tobs = {k: torch.from_numpy(v) for k, v in obs.items()}
    losses, out_state, metrics, tensors, dream = model.training_step(
        tobs, torch.from_numpy(state), _noise(conf, key), do_image_pred=True)
    assert set(losses) == {"loss_model", "loss_probe"} and dream == {}
    for name in wlosses:
        _close(losses[name], wlosses[name], RTOL, ATOL, name)
    assert set(metrics) == set(wmets) and set(tensors) == set(wtens)
    assert "loss_map" in metrics and "mse_goals" in metrics
    assert model_name == "gru_probe" or "image_pred" in tensors
    for name in wmets:
        _close(metrics[name], wmets[name], RTOL, ATOL, name)
    for name in wtens:
        _close(tensors[name], wtens[name], RTOL, ATOL, name)
    assert tuple(out_state.shape) == tuple(wstate.shape) and not out_state.requires_grad
    _close(out_state, wstate, RTOL, ATOL, "out_state")

    sum(losses.values()).backward()
    got = state_dict_to_jax(_grads(model), params)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(wgrads)[0],
                            jax.tree_util.tree_leaves(got)):
        w = np.asarray(w)
        err = np.abs(g - w).max()
        assert err <= GRAD_TOL * np.abs(w).max() + 1e-7, (jax.tree_util.keystr(path), err)

    # Routing: loss_model reaches only wm, loss_probe only the probe.
    for which, reached, spared in (("loss_model", model.wm, model.probe),
                                   ("loss_probe", model.probe, model.wm)):
        model.zero_grad(set_to_none=True)
        losses, *_ = model.training_step(tobs, torch.from_numpy(state), _noise(conf, key))
        if losses[which].requires_grad:
            losses[which].backward()
        assert all(p.grad is None or not p.grad.any() for p in spared.parameters()), which
        assert (any(p.grad is not None and p.grad.any() for p in reached.parameters())
                or (model_name, which) == ("gru_probe", "loss_model")), which


@pytest.mark.parametrize("model_name", ["gru_vae", "transformer_vae", "gru_probe"])
def test_two_steps_match_jax(model_name):
    """``gru_probe`` trains only through its probe, so it runs with
    ``probe_gradients``: one group for both, two norms reported."""
    conf = _conf(model_name, probe_gradients=model_name == "gru_probe", target_interval=1)
    model = run_two_steps(conf, _obs(conf), flags=True, pair=paired_baselines,
                          noise=_step_noise)
    assert not hasattr(model, "ac")


def test_jax_baseline_checkpoint_continues_training_in_the_port(tmp_path):
    """A JAX TrainStep of ``gru_vae`` takes two steps and saves its learner
    checkpoint (its optimizer state has empty actor and critic groups); the
    converted checkpoint loads into the port's TrainStep, and both take step
    3 with the TBTT state carried: metrics and parameters agree."""
    conf = _conf("gru_vae")
    obs = _obs(conf, seed=5)
    jmodel, params, _ = paired_baselines(conf)
    jstep = JTrainStep(jmodel, conf, donate=False)
    opt_state = jstep.init_optimizer(params)
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}
    key = jax.random.PRNGKey(6)
    jstate = jmodel.init_state(conf.batch_size)
    for step in (1, 2):
        params, opt_state, jstate, _, _, _ = jstep(params, opt_state, jobs, jstate, step,
                                                   np.asarray(key))
    path = tmp_path / "latest.ckpt"
    jax_save_checkpoint_file(path, {"params": params, "opt_state": opt_state}, 2)

    model = WorldModelProbe(conf, device="cpu")
    ts = TrainStep(model, conf, device="cpu")
    assert [g["name"] for g in ts.optimizer.param_groups] == ["wm", "probe"]
    ckpt = jax_checkpoint_to_torch(path, ts)
    assert ckpt["step"] == 2
    model.load_state_dict(ckpt["model"])
    ts.optimizer.load_state_dict(ckpt["optimizer"])
    states = list(ts.optimizer.state.values())
    assert len(states) == sum(len(g["params"]) for g in ts.optimizer.param_groups)
    assert all(s["step"].item() == 2 for s in states)

    tstate = torch.from_numpy(np.array(jstate))
    params, opt_state, jstate, jmetrics, _, _ = jstep(params, opt_state, jobs, jstate, 3,
                                                      np.asarray(key))
    tstate, tmetrics, _, _ = ts({k: torch.from_numpy(v) for k, v in obs.items()}, tstate, 3,
                                _step_noise(conf, key, 3))
    assert set(jmetrics) == set(tmetrics)
    for name, want in jmetrics.items():
        _close(tmetrics[name].item(), float(want), LOSS_RTOL, 1e-6, f"step 3 {name}")
    _close(tstate, jstate, PARAM_RTOL, PARAM_ATOL, "out_state")
    back = state_dict_to_jax(model.state_dict(), params)
    for (p, want), got in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                              jax.tree_util.tree_leaves(back)):
        _close(got, want, PARAM_RTOL, PARAM_ATOL, jax.tree_util.keystr(p))


def test_attention_conversion_round_trips_exactly():
    """The transformer's 3-D attention kernels and 2-D biases: a JAX tree of
    random leaves -> state_dict -> JAX tree, and the port's state_dict ->
    JAX tree -> state_dict, both bit for bit; each query/key/value/out maps
    onto a (512, 512) Linear weight."""
    conf = _conf("transformer_vae")
    like = jax.eval_shape(JWorldModelProbe(conf).init, jax.random.PRNGKey(0))
    rng = np.random.RandomState(7)
    tree = jax.tree_util.tree_map(lambda s: rng.randn(*s.shape).astype(np.float32), like)
    sd = jax_to_state_dict(tree)
    back = state_dict_to_jax(sd, like)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    attn = tree["wm"]["transformer"]["params"]["attn_2"]
    for name in ("query", "key", "value", "out"):
        assert tuple(sd[f"wm.transformer.attn_2.{name}.weight"].shape) == (512, 512)
    q = sd["wm.transformer.attn_2.query.weight"].numpy()
    np.testing.assert_array_equal(q[64 * 3 + 5], attn["query"]["kernel"][:, 3, 5])
    o = sd["wm.transformer.attn_2.out.weight"].numpy()
    np.testing.assert_array_equal(o[:, 64 * 3 + 5], attn["out"]["kernel"][3, 5])

    model = WorldModelProbe(conf, device="cpu")
    again = jax_to_state_dict(state_dict_to_jax(model.state_dict(), like))
    assert set(again) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(again[k], v), k


@pytest.mark.parametrize("model_name", MODELS)
def test_make_model_builds_each_baseline(model_name):
    model = trainer.make_model(_conf(model_name), "cpu")
    assert isinstance(model, WorldModelProbe) and set(dict(model.named_children())) == {"wm", "probe"}
    ts = TrainStep(model, _conf(model_name), device="cpu")
    assert [g["name"] for g in ts.optimizer.param_groups] == ["wm", "probe"]


def _map_episodes(path, n_files, length, S, seed):
    """Grid-format episode files with a map probe's keys: a (S,S) class map,
    the agent's position and direction, and the seen mask."""
    rng = np.random.default_rng(seed)
    repo = NpzEpisodeRepository(path)
    for i in range(n_files):
        reset = np.zeros(length, bool)
        reset[0] = True
        angle = rng.uniform(0, 2 * np.pi, length)
        repo.save_data(dict(image_t=rng.integers(0, 256, (64, 64, 3, length), dtype=np.uint8),
                            action=np.eye(4)[rng.integers(0, 4, length)],
                            reward=rng.random(length), terminal=np.zeros(length, bool),
                            reset=reset, map=rng.integers(0, 4, (length, S, S)),
                            agent_pos=rng.integers(0, S, (length, 2)).astype(np.float64),
                            agent_dir=np.stack([np.cos(angle), np.sin(angle)], -1),
                            map_seen=rng.integers(0, 2, (length, S, S))), i, i)


def test_trainer_run_trains_gru_vae_with_the_map_probe(tmp_path):
    """The port's learner loop on a baseline (port only: no JAX run): the
    Preprocessor makes map_coord and map_seen_mask from the files, the probe
    trains (``grad_norm_probe``), and the eval protocol logs
    ``logprob_map_last`` for the episodes that end in a batch."""
    root = tmp_path
    _map_episodes(root / "train", 3, 40, 5, seed=8)
    _map_episodes(root / "eval", 3, 12, 5, seed=9)
    over = dict(model="gru_vae", probe_model="map", map_key="map", map_size=5, map_channels=4,
                map_hidden_layers=2, map_hidden_dim=16, offline_data_dir=str(root / "train"),
                offline_eval_dir=str(root / "eval"), generator_prefill_steps=0, n_steps=4,
                log_interval=2, eval_interval=2, test_batches=3, eval_batches=2)
    conf = Conf(tiny_conf(**over).to_dict())
    trainer.run(conf, run_dir=str(root / "port"), device="cpu")
    rows = Run(root / "port").read_metrics()
    train = [r for r in rows if "train/loss_model" in r]
    test = [r for r in rows if "test/loss_model" in r]
    assert [r["_step"] for r in train] == [4] and test
    for k in ("loss_model", "loss_probe", "loss_dyn", "loss_map", "acc_map", "acc_map_seen",
              "grad_norm", "grad_norm_probe"):
        assert np.isfinite(train[0][f"train/{k}"]), k
    assert "train/loss_actor" not in train[0] and "train/grad_norm_actor" not in train[0]
    assert np.isfinite(test[0]["test/logprob_map_last"])
