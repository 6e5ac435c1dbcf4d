"""The learning canaries: proof that the port's agent learns, not just that
its losses are finite.

The port's counterpart of the four canaries of ``tests/test_learning.py``,
written once. ``tests/test_torch_learning.py`` holds them to the JAX tests'
gates on the CPU, ``chip_smoke.py`` phase 15 holds them to the same gates on
the card (under ``gru_layernorm_dv2``, so that kernel K1 runs every posterior
and dream step), and the diagnose tools print their curves. Every runner
returns plain numbers and asserts nothing:

* :func:`bandit`: ``Bandit-3x8`` from vector observations; the network
  policy's return before and after 400 steps on random-policy data;
* :func:`gridworld_wm`: the world model on ``Grid-4x64`` pixels, its
  ``loss_model`` at step 5 and at step 60;
* :func:`gridworld_pixels`: the pixel policy on ``Grid-4x64`` with online
  collection, one episode of the current policy every 6 steps re-listed into
  the replay at once; from step 1000, every 100 steps, the mean return of the
  first and the last 80 collected episodes, until the caller's gate clears;
* :func:`point`: ``Point-2x32`` with the ``tanh_normal`` actor trained by
  ``actor_grad: dynamics``; the return before and after 400 steps.

The configs are this module's copies of the tests' (every hyperparameter as
written there, over the float32 base of ``tests/util.py``), with ``gru_type``
a parameter that defaults to ``gru`` as there. The noise comes from seeded
sources: each train step's default ``GeneratorNoise`` is seeded by its step,
and each acting policy's ``GeneratorNoise`` by the seed of its call, the
counterpart of the JAX test's ``collect_policy.rng = PRNGKey(123)``. So a run
depends on its seeds and its device, not on luck.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from .. import generator
from ..conf import Conf
from ..data import ParallelLoader, Preprocessor, SequentialDataset, make_repository
from ..device import resolve_device
from ..envs import create_env
from ..models.dreamer import Dreamer
from ..models.noise import GeneratorNoise
from ..training.train_step import TrainStep

__all__ = ["BASE", "make_conf", "bandit_conf", "gridworld_wm_conf", "gridworld_pixels_conf",
           "point_conf", "CONFS", "collect_random", "Learner", "rollout_returns", "collect",
           "bandit", "gridworld_wm", "gridworld_pixels", "point", "BANDIT_EP_LEN", "GRID_ENV",
           "POINT_ENV"]

# A minimal config of the whole Dreamer stack (RSSM, CNN encoder and decoder,
# actor-critic) in float32: the base the JAX canaries stand on.
BASE = dict(
    image_key="image", image_size=64, image_channels=3, image_categorical=False,
    action_dim=4, clip_rewards=None, vecobs_size=0,
    map_key=None, map_size=0, map_channels=0, map_categorical=True, goals_size=0,
    model="dreamer", deter_dim=64, stoch_dim=8, stoch_discrete=8, hidden_dim=64,
    gru_layers=1, gru_type="gru", layer_norm=True,
    image_encoder="cnn", cnn_depth=8, image_encoder_layers=0,
    image_decoder="cnn", image_decoder_layers=0, image_decoder_min_prob=0.0,
    reward_input=False, reward_decoder_layers=2, reward_decoder_categorical=None,
    terminal_decoder_layers=2,
    probe_model="none", probe_gradients=False,
    map_decoder="dense", map_hidden_layers=2, map_hidden_dim=64,
    iwae_samples=1, kl_balance=0.8, kl_weight=1.0,
    image_weight=1.0, vecobs_weight=1.0, reward_weight=1.0, terminal_weight=1.0,
    adam_lr=3e-4, adam_lr_actor=1e-4, adam_lr_critic=1e-4, adam_eps=1e-5,
    keep_state=True, batch_length=6, batch_size=2,
    grad_clip=200.0, grad_clip_ac=200.0, precision="float32",
    gamma=0.99, lambda_gae=0.95, entropy=1e-3, target_interval=100,
    imag_horizon=5, actor_grad="reinforce", actor_dist="onehot",
    aux_critic=False, aux_critic_weight=1.0, gamma_aux=0.99,
    lambda_gae_aux=0.95, target_interval_aux=1000,
)

BANDIT_ENV, BANDIT_EP_LEN, BANDIT_ACTIONS = "Bandit-3x8", 8, 3
GRID_ENV = "Grid-4x64"
PIXEL_TIME_LIMIT = 16
POINT_ENV = "Point-2x32"
POLICY_COLUMNS = ("policy_value", "policy_entropy", "action_prob")


def make_conf(**over) -> Conf:
    d = dict(BASE)
    d.update(over)
    return Conf(d)


def bandit_conf(gru_type: str = "gru", **over) -> Conf:
    """A vector-observation model: no conv stack, so a run takes seconds."""
    base = dict(
        image_key=None, image_encoder=None, image_decoder=None,
        vecobs_size=1, action_dim=BANDIT_ACTIONS,
        deter_dim=32, stoch_dim=4, stoch_discrete=4, hidden_dim=32,
        reward_decoder_layers=1, terminal_decoder_layers=1,
        batch_length=8, batch_size=16, imag_horizon=5,
        gamma=0.9, lambda_gae=0.95, entropy=1e-3, target_interval=50,
        model="dreamer", keep_state=False, scan_unroll=1, gru_type=gru_type,
    )
    base.update(over)
    return make_conf(**base)


def gridworld_wm_conf(gru_type: str = "gru", **over) -> Conf:
    return make_conf(**dict(dict(
        batch_length=10, batch_size=8, deter_dim=64, stoch_dim=8,
        stoch_discrete=8, hidden_dim=64, cnn_depth=8, imag_horizon=3,
        reward_decoder_layers=1, terminal_decoder_layers=1,
        keep_state=True, scan_unroll=1, gru_type=gru_type), **over))


def gridworld_pixels_conf(gru_type: str = "gru", **over) -> Conf:
    return make_conf(**dict(dict(
        env_id=GRID_ENV, action_dim=4, env_time_limit=PIXEL_TIME_LIMIT,
        deter_dim=64, stoch_dim=8, stoch_discrete=8, hidden_dim=64,
        cnn_depth=8, batch_length=10, batch_size=8, imag_horizon=8,
        gamma=0.9, lambda_gae=0.95, entropy=3e-3, target_interval=50,
        reward_decoder_layers=1, terminal_decoder_layers=1,
        model="dreamer", keep_state=True, scan_unroll=1, gru_type=gru_type), **over))


def point_conf(gru_type: str = "gru", **over) -> Conf:
    return make_conf(**dict(dict(
        image_key=None, image_encoder=None, image_decoder=None,
        vecobs_size=4, action_dim=2,
        actor_dist="tanh_normal", actor_grad="dynamics",
        deter_dim=64, stoch_dim=8, stoch_discrete=8, hidden_dim=64,
        reward_decoder_layers=2, terminal_decoder_layers=2,
        batch_length=16, batch_size=16, imag_horizon=15,
        gamma=0.99, lambda_gae=0.95, entropy=1e-4, target_interval=100,
        adam_lr_actor=1e-4, adam_lr_critic=1e-4, grad_clip_ac=200.0,
        model="dreamer", keep_state=False, scan_unroll=1, gru_type=gru_type), **over))


CONFS = {"bandit": bandit_conf, "gridworld_wm": gridworld_wm_conf,
         "gridworld_pixels": gridworld_pixels_conf, "point": point_conf}


@contextlib.contextmanager
def _generator_run(path: Path):
    """``generator.main`` joins the run ``PYDREAMER_RUN_DIR`` names and sets
    it: keep that run beside the data, and put the caller's value back."""
    old = os.environ.get("PYDREAMER_RUN_DIR")
    os.environ["PYDREAMER_RUN_DIR"] = str(path)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("PYDREAMER_RUN_DIR", None)
        else:
            os.environ["PYDREAMER_RUN_DIR"] = old


def collect_random(env_id: str, data_dir, num_steps: int, steps_per_npz: int,
                   env_time_limit: int = 0, device: str | torch.device = "cuda") -> None:
    """Random-policy episode files in ``data_dir``, written by ``generator.main``."""
    data_dir = Path(data_dir)
    with _generator_run(data_dir.parent / f"{data_dir.name}_generator"):
        generator.main(env_id=env_id, save_uri=str(data_dir), worker_id=0,
                       policy_main="random", num_steps=num_steps,
                       env_time_limit=env_time_limit, steps_per_npz=steps_per_npz,
                       log_metrics=False, device=device)


def _floats(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


class Learner:
    """A Dreamer made from ``seed``, its ``TrainStep`` and a stream of
    preprocessed batches from the episode files in ``data_dir`` (read inline,
    as the JAX tests read them), all on ``device``; a second Dreamer of the
    same config acts from the first one's weights. ``policy_calls`` counts the
    acting calls, one per env step."""

    def __init__(self, conf: Conf, data_dir, device: str | torch.device = "cuda",
                 seed: int = 0, **dataset_kw):
        self.conf = conf
        self.device = resolve_device(device)
        torch.manual_seed(seed)
        self.model = Dreamer(conf, device=self.device)
        self.policy_model = Dreamer(conf, device=self.device)
        self.train_step = TrainStep(self.model, conf, device=self.device)
        self.preprocess = Preprocessor.from_conf(conf)
        self.repository = make_repository(str(data_dir))
        kw = dict(skip_first=True, reset_interval=0, seed=seed)
        kw.update(dataset_kw)
        self.dataset = SequentialDataset(self.repository, conf.batch_length, conf.batch_size,
                                         **kw)
        self.batches = iter(ParallelLoader(lambda wid: self.preprocess(iter(self.dataset)),
                                           num_workers=0))
        self.state = None
        self.policy_calls = 0

    def reset_state(self) -> None:
        self.state = self.model.init_state(self.conf.batch_size * self.conf.iwae_samples)

    def step(self, i: int) -> Dict[str, torch.Tensor]:
        """Train step ``i`` on the next batch, carrying the TBTT state."""
        batch, _wid = next(self.batches)
        obs = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        self.state, metrics, _, _ = self.train_step(obs, self.state, i)
        return metrics

    def train(self, n: int, start: int = 1) -> Dict[str, float]:
        """Steps ``start .. start+n-1`` from a fresh TBTT state, as the JAX
        tests' ``train_steps`` -> the last step's metrics."""
        self.reset_state()
        metrics = {}
        for i in range(start, start + n):
            metrics = self.step(i)
        return _floats(metrics)

    def policy(self, seed: int) -> generator.NetworkPolicy:
        """A network policy acting from the model's weights now, its noise a
        ``GeneratorNoise`` seeded by ``seed``."""
        policy = generator.NetworkPolicy(self.policy_model, self.preprocess, device=self.device)
        policy.noise = GeneratorNoise(self.device, seed=seed)
        policy.set_params(self.model.state_dict())
        return policy

    def episode(self, policy, env) -> Tuple[float, Dict[str, np.ndarray]]:
        """One episode of ``policy`` from a fresh acting state -> (return, the
        env's episode data)."""
        policy.state = self.policy_model.init_state(1)
        obs = env.reset()
        done, total, info = False, 0.0, {}
        while not done:
            action, _ = policy(obs)
            self.policy_calls += 1
            obs, reward, done, info = env.step(action)
            total += float(reward)
        return total, info["episode"]


def rollout_returns(learner: Learner, env_id: str, episodes: int, seed: int,
                    env_time_limit: int = 0) -> List[float]:
    """Each episode's return for the learner's policy now, in the env made
    from ``seed``, with the policy's noise seeded by ``seed``."""
    env = create_env(env_id, no_terminal=False, env_time_limit=env_time_limit,
                     env_action_repeat=1, worker_id=seed)
    policy = learner.policy(seed)
    return [learner.episode(policy, env)[0] for _ in range(episodes)]


def collect(learner: Learner, policy, env, n: int, episode_from: int) -> List[float]:
    """``n`` episodes of ``policy`` acting from the learner's weights now,
    saved as one file of episodes ``episode_from .. episode_from+n-1`` in the
    learner's repository (the policy columns NaN, as the learner ignores
    them) -> their returns. The dataset sees the file at its next re-list."""
    policy.set_params(learner.model.state_dict())
    returns, datas = [], []
    for _ in range(n):
        total, data = learner.episode(policy, env)
        for k in POLICY_COLUMNS:
            data[k] = np.full(data["reward"].shape, np.nan)
        returns.append(total)
        datas.append(data)
    chunk = {k: np.concatenate([d[k] for d in datas], 0) for k in datas[0]}
    learner.repository.save_data(chunk, episode_from, episode_from + n - 1)
    return returns


def bandit(data_dir, device: str | torch.device = "cuda", gru_type: str = "gru",
           steps: int = 400, seed: int = 0) -> dict:
    """Random-policy data, then the mean return of 20 rollouts before and
    after ``steps`` train steps; policy learning is wholly in imagination,
    so offline data suffices. Random acting returns about 8/3, optimal 8."""
    t0 = time.perf_counter()
    collect_random(BANDIT_ENV, data_dir, 1500, 300, device=device)
    learner = Learner(bandit_conf(gru_type), data_dir, device, seed)
    before = float(np.mean(rollout_returns(learner, BANDIT_ENV, 20, seed=1)))
    metrics = learner.train(steps)
    after = float(np.mean(rollout_returns(learner, BANDIT_ENV, 20, seed=2)))
    return dict(before=before, after=after, steps=steps, seconds=time.perf_counter() - t0,
                policy_calls=learner.policy_calls, metrics=metrics)


def gridworld_wm(data_dir, device: str | torch.device = "cuda", gru_type: str = "gru",
                 seed: int = 0) -> dict:
    """Random-policy data, then ``loss_model`` at step 5 (``before``) and at
    step 60 (``after``, after 55 more steps from a fresh state)."""
    t0 = time.perf_counter()
    collect_random(GRID_ENV, data_dir, 400, 200, env_time_limit=20, device=device)
    learner = Learner(gridworld_wm_conf(gru_type), data_dir, device, seed)
    first = learner.train(5)
    metrics = learner.train(55, start=6)
    return dict(before=first["loss_model"], after=metrics["loss_model"], steps=60,
                seconds=time.perf_counter() - t0, policy_calls=0, metrics=metrics)


def gridworld_pixels(data_dir, until: Callable[[float, float], bool],
                     device: str | torch.device = "cuda", gru_type: str = "gru",
                     max_steps: int = 4000, seed: int = 0) -> dict:
    """The pixel policy with online collection (``test_learning.py:157-258``):
    random-policy data, then train steps with one episode of the current
    policy every 6 steps, re-listed into the replay at once so that the data
    mix depends on the step count alone. From step 1000, every 100 steps,
    ``before`` / ``after`` are the mean returns of the first and the last 80
    collected episodes, and the loop stops when ``until(before, after)``
    holds or at ``max_steps``. ``passed`` says which."""
    t0 = time.perf_counter()
    collect_random(GRID_ENV, data_dir, 1000, 300, env_time_limit=PIXEL_TIME_LIMIT,
                   device=device)
    learner = Learner(gridworld_pixels_conf(gru_type), data_dir, device, seed,
                      reload_interval=0, buffer_size=500_000)
    env = create_env(GRID_ENV, no_terminal=False, env_time_limit=PIXEL_TIME_LIMIT,
                     env_action_repeat=1, worker_id=50)
    policy = learner.policy(123)
    collected: List[float] = []
    before = after = float("nan")
    passed = False
    learner.reset_state()
    metrics = {}
    for i in range(1, max_steps + 1):
        metrics = learner.step(i)
        if i % 6 == 0:
            collected += collect(learner, policy, env, 1, 10_000 + i)
            learner.dataset.reload_files()
        if i >= 1000 and i % 100 == 0:
            before, after = float(np.mean(collected[:80])), float(np.mean(collected[-80:]))
            if until(before, after):
                passed = True
                break
    return dict(before=before, after=after, passed=passed, steps=i, episodes=len(collected),
                seconds=time.perf_counter() - t0, policy_calls=learner.policy_calls,
                metrics=_floats(metrics))


def point(data_dir, device: str | torch.device = "cuda", gru_type: str = "gru",
          steps: int = 400, seed: int = 0) -> dict:
    """Random-policy data, then the mean return of 15 rollouts before and
    after ``steps`` train steps. Random acting returns about 2-8, optimal
    about 29."""
    t0 = time.perf_counter()
    collect_random(POINT_ENV, data_dir, 2000, 500, device=device)
    learner = Learner(point_conf(gru_type), data_dir, device, seed)
    before = float(np.mean(rollout_returns(learner, POINT_ENV, 15, seed=3)))
    metrics = learner.train(steps)
    after = float(np.mean(rollout_returns(learner, POINT_ENV, 15, seed=4)))
    return dict(before=before, after=after, steps=steps, seconds=time.perf_counter() - t0,
                policy_calls=learner.policy_calls, metrics=metrics)
