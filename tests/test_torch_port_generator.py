"""The port's generator (``pydreamer_tpu_torch/generator.py``) against the JAX package's.

* ``generator.main`` with the random policy: the same env, worker id and
  ``np.random.seed`` give the same file names and array-equal npz contents
  as JAX's, sequentially and with 3 envs in lockstep, with and without the
  train/eval split, and the same agent metric rows (timestamps and fps
  aside, which are clocks).
* ``NetworkPolicy`` (B=1) and ``VectorNetworkPolicy`` (B=3, one slot
  resetting on the third call) load a torch checkpoint holding JAX's weights
  (``convert.jax_to_state_dict``); over 4 calls, with the keys of JAX's
  policies replayed into the port's through ``ReplayNoise``, their actions,
  metrics and carried state match JAX's within 1e-5 (float32, CPU).
* The prefill -> network switch mid-episode pads the policy columns with NaN
  as JAX's does (``test_vectorized_policy_switch_pads_metric_columns``).
* The entry points default to ``"cuda"`` and raise without a card.
"""

import json

import jax
import numpy as np
import pytest
import torch

import pydreamer_tpu.generator as jgen
from pydreamer_tpu.data.preprocessing import Preprocessor as JPreprocessor
from pydreamer_tpu.models.rssm import draw_z_noise
import pydreamer_tpu_torch.envs as tenvs
import pydreamer_tpu_torch.generator as tgen
from pydreamer_tpu_torch.conf import Conf
from pydreamer_tpu_torch.convert import jax_to_state_dict
from pydreamer_tpu_torch.data import NpzEpisodeRepository, Preprocessor
from pydreamer_tpu_torch.models.dreamer import Dreamer
from pydreamer_tpu_torch.models.noise import ReplayNoise
from pydreamer_tpu_torch.tracking import load_checkpoint_model, save_checkpoint_file
from tests.test_torch_port_train_step import _action_noise, _conf, paired_models

RTOL = ATOL = 1e-5


def _npz_files(root):
    return {str(p.relative_to(root)): dict(np.load(p)) for p in sorted(root.rglob("*.npz"))}


def _metric_rows(run_dir):
    path = run_dir / "metrics.jsonl"
    rows = [json.loads(line) for line in path.read_text().splitlines()] if path.exists() else []
    return [{k: v for k, v in r.items() if k not in ("_timestamp", "agent/fps")} for r in rows]


def _run_main(module, root, monkeypatch, split_fraction, envs_per_worker, **extra):
    monkeypatch.setenv("PYDREAMER_RUN_DIR", str(root / "run"))
    np.random.seed(7)
    module.main(env_id="Grid-4x64", save_uri=str(root / "train"),
                save_uri2=str(root / "eval") if split_fraction else None,
                worker_id=2, policy_main="random", num_steps=150, env_time_limit=20,
                steps_per_npz=30, envs_per_worker=envs_per_worker,
                split_fraction=split_fraction, log_every=3, **extra)


@pytest.mark.parametrize("envs_per_worker", [1, 3])
@pytest.mark.parametrize("split_fraction", [0.0, 0.5])
def test_random_policy_files_and_metrics_match(tmp_path, monkeypatch, split_fraction,
                                               envs_per_worker):
    _run_main(jgen, tmp_path / "jax", monkeypatch, split_fraction, envs_per_worker)
    _run_main(tgen, tmp_path / "port", monkeypatch, split_fraction, envs_per_worker, device="cpu")
    want, got = _npz_files(tmp_path / "jax"), _npz_files(tmp_path / "port")
    assert list(got) == list(want) and len(want) >= 4
    if split_fraction:
        assert any(name.startswith("eval/") for name in want)
    for name in want:
        assert set(got[name]) == set(want[name]), name
        for k, v in want[name].items():
            assert got[name][k].dtype == v.dtype, (name, k)
            np.testing.assert_array_equal(got[name][k], v, err_msg=f"{name} {k}")
    rows = _metric_rows(tmp_path / "jax" / "run")
    assert len(rows) >= 3 and "agent/return_discounted" in rows[0]
    assert _metric_rows(tmp_path / "port" / "run") == rows


@pytest.mark.parametrize("min_steps", [1, 4, 7, 20])
def test_chunk_episode_data_matches(min_steps):
    rng = np.random.default_rng(min_steps)
    data = dict(reset=rng.random(19) < 0.2, reward=rng.random(19),
                image=rng.integers(0, 255, (19, 4, 4, 3), dtype=np.uint8))
    got, want = tgen.chunk_episode_data(data, min_steps), jgen.chunk_episode_data(data, min_steps)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("gamma", [0.9, 0.99])
def test_discount_matches(gamma):
    from pydreamer_tpu.tools import discount as jdiscount
    from pydreamer_tpu_torch.tools import discount
    x = np.random.default_rng(0).standard_normal((13, 2))
    np.testing.assert_array_equal(discount(x, gamma), jdiscount(x, gamma))


def test_load_checkpoint_model(tmp_path):
    """The generator's read of the policy channel: the model entry and the
    step on the CPU; None for a missing or a truncated file."""
    path = tmp_path / "latest.ckpt"
    assert load_checkpoint_model(path) is None
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.AdamW(model.parameters())
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    save_checkpoint_file(path, {"model": model.state_dict(), "optimizer": opt.state_dict()}, 12)
    state, step = load_checkpoint_model(path)
    assert step == 12 and set(state) == {"weight", "bias"}
    for k, v in model.state_dict().items():
        assert state[k].device.type == "cpu" and torch.equal(state[k], v)
    path.write_bytes(path.read_bytes()[:100])
    assert load_checkpoint_model(path) is None


@pytest.fixture(scope="module")
def policy_pair(tmp_path_factory):
    """The JAX weights of a tiny model (action_dim 4, gru_layernorm_dv2) and a
    torch checkpoint holding them, written as the learner writes it."""
    conf = _conf(action_dim=4)
    jmodel, params, _ = paired_models(conf, seed=40)
    path = tmp_path_factory.mktemp("ckpt") / "latest.ckpt"
    save_checkpoint_file(path, {"model": jax_to_state_dict(params), "optimizer": {}}, 9)
    return conf, jmodel, params, path


def _port_policy(conf, path, n_envs):
    policy = tgen.create_policy("network", None, Conf(conf.to_dict()), n_envs=n_envs, device="cpu")
    state_dict, step = load_checkpoint_model(path)
    assert step == 9
    policy.set_params(state_dict)
    return policy


def _replay_jax_keys(jpolicy, conf, B):
    """The noise JAX's policy draws on its next call (``rng, key =
    split(rng)``; ``inference`` splits key -> (k_wm, k_act))."""
    _, key = jax.random.split(jpolicy.rng)
    k_wm, k_act = jax.random.split(key)
    return ReplayNoise(dict(
        posterior_z=draw_z_noise(k_wm, (1, B), conf.stoch_dim, conf.stoch_discrete),
        action=_action_noise(k_act, (1, B, conf.action_dim), conf.actor_dist)))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def test_network_policy_matches_jax(policy_pair):
    conf, jmodel, params, path = policy_pair
    policy = _port_policy(conf, path, 1)
    assert isinstance(policy, tgen.NetworkPolicy)
    jpolicy = jgen.NetworkPolicy(jmodel, JPreprocessor.from_conf(conf))
    jpolicy.set_params(params)
    jpolicy.rng = jax.random.PRNGKey(41)
    env = tenvs.create_env("Grid-4x64", False, 0, 1, 0)
    obs = env.reset()
    for call in range(4):
        policy.noise = _replay_jax_keys(jpolicy, conf, 1)
        want_action, want_mets = jpolicy(obs)
        action, mets = policy(obs)
        assert action.shape == (conf.action_dim,) and want_action.shape == action.shape
        _close(action, want_action, f"call {call} action")
        assert set(mets) == set(want_mets) and all(isinstance(v, float) for v in mets.values())
        for k in want_mets:
            _close(mets[k], want_mets[k], f"call {call} {k}")
        for got, want, name in zip(policy.state, jpolicy.state, ("h", "z")):
            _close(got, want, f"call {call} state {name}")
        obs, _, done, _ = env.step(action)
        assert not done


def test_vector_network_policy_matches_jax(policy_pair):
    conf, jmodel, params, path = policy_pair
    N = 3
    policy = _port_policy(conf, path, N)
    assert isinstance(policy, tgen.VectorNetworkPolicy)
    jpolicy = jgen.VectorNetworkPolicy(jmodel, JPreprocessor.from_conf(conf), N)
    jpolicy.set_params(params)
    jpolicy.rng = jax.random.PRNGKey(42)
    env_list = [tenvs.create_env("Grid-4x64", False, 0, 1, i) for i in range(N)]
    obs_list = [e.reset() for e in env_list]
    for call in range(4):
        if call == 2:
            obs_list[1] = env_list[1].reset()  # slot 1 starts a new episode
        policy.noise = _replay_jax_keys(jpolicy, conf, N)
        want_actions, want_mets = jpolicy(obs_list)
        actions, mets = policy(obs_list)
        assert actions.shape == (N, conf.action_dim) == np.asarray(want_actions).shape
        _close(actions, want_actions, f"call {call} actions")
        assert set(mets) == set(want_mets)
        for k in want_mets:
            assert mets[k].shape == (N,)
            _close(mets[k], want_mets[k], f"call {call} {k}")
        for got, want, name in zip(policy.state, jpolicy.state, ("h", "z")):
            _close(got, want, f"call {call} state {name}")
        obs_list = [e.step(a)[0] for e, a in zip(env_list, actions)]


def test_vectorized_policy_switch_pads_metric_columns(tmp_path, monkeypatch):
    """The prefill -> network switch lands mid-episode in the vectorized
    loop (JAX's test of the same name): three CountingEnv slots of 12/30/44
    steps, steps_per_npz 10, so slot 0's first finish flushes a file, the
    switch fires on the next tick and slots 1 and 2 are mid-flight. Their
    first episodes must be head-padded with NaN and every npz column as
    long as ``reward``."""
    from pydreamer_tpu_torch.envs import CountingEnv
    from pydreamer_tpu_torch.envs.wrappers import (ActionRewardResetWrapper, CollectWrapper,
                                                   DictWrapper, OneHotActionWrapper)
    conf = Conf(_conf(action_dim=3).to_dict())
    run_dir = tmp_path / "run"
    monkeypatch.setenv("PYDREAMER_RUN_DIR", str(run_dir))
    torch.manual_seed(0)
    save_checkpoint_file(run_dir / "checkpoints" / "latest.ckpt",
                         {"model": Dreamer(conf, device="cpu").state_dict()}, 5000)
    lengths = iter([12, 30, 44])

    def fixed_len_env(env_id, no_terminal, time_limit, action_repeat, worker_id):
        env = DictWrapper(CountingEnv(episode_length=next(lengths), action_dim=3, seed=worker_id))
        return CollectWrapper(ActionRewardResetWrapper(OneHotActionWrapper(env), no_terminal))

    monkeypatch.setattr(tenvs, "create_env", fixed_len_env)
    save_dir = tmp_path / "episodes"
    tgen.main(env_id="Counting-ignored", save_uri=str(save_dir), worker_id=0,
              policy_main="network", policy_prefill="random", num_steps=100,
              num_steps_prefill=10, env_time_limit=0, steps_per_npz=10, envs_per_worker=3,
              model_conf=conf, model_reload_interval=1e9, log_metrics=False, device="cpu")

    resets, pvs = [], []
    for f in sorted(NpzEpisodeRepository(save_dir).list_files(), key=lambda f: f.path):
        data = f.load_data()
        n = len(data["reset"])
        for k, v in data.items():
            assert (v.shape[-1] if k == "image_t" else len(v)) == n, (f, k, v.shape, n)
        assert np.isnan(data["action_prob"][np.flatnonzero(data["reset"])]).all()
        resets.append(data["reset"])
        pvs.append(data["policy_value"])
    reset, pv_all = np.concatenate(resets), np.concatenate(pvs)
    starts = list(np.flatnonzero(reset)) + [len(reset)]
    padded = [a for a, b in zip(starts[:-1], starts[1:])
              if np.isnan(pv_all[a]) and np.isfinite(pv_all[a:b]).any()]
    assert len(padded) >= 2, f"expected 2 padded episodes by construction, got {padded}"


def test_policies_refuse_cuda_without_a_card(policy_pair, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = Conf(policy_pair[0].to_dict())
    env = tenvs.create_env("Grid-4x64", False, 0, 1, 0)
    for n_envs in (1, 3):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tgen.create_policy("network", env, conf, n_envs=n_envs, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgen.create_policy("random", env, conf)
    model = Dreamer(conf, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgen.NetworkPolicy(model, Preprocessor.from_conf(conf))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgen.VectorNetworkPolicy(model, Preprocessor.from_conf(conf), 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgen.main(env_id="Grid-4x64", num_steps=1)
    with pytest.raises(RuntimeError, match="before a checkpoint load"):
        tgen.NetworkPolicy(model, Preprocessor.from_conf(conf), device="cpu")(env.reset())
