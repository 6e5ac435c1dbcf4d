"""Actor runtime: episode collection workers.

Counterpart of ``pydreamer_tpu/generator.py`` (reference: generator.py:27-331):
  * roll a policy in an env; the prefill policy switches to the main policy
    once ``num_steps_prefill`` steps are saved (generator.py:98-101)
  * the network policy polls the learner's checkpoint every
    ``model_reload_interval`` seconds: the checkpoint IS the policy
    distribution channel (generator.py:105-117)
  * ``limit_step_ratio`` rate-limits data collection against the learner's
    progress (generator.py:118-121)
  * per-episode agent metrics, the discounted return included, logged at
    the learner's ``model_step`` so actor curves align with learner curves
    (generator.py:167-216)
  * episodes are accumulated to >= ``steps_per_npz`` steps, chunked, and
    saved to the train or the eval repository, the eval one with
    probability ``split_fraction`` (generator.py:218-257)

Devices. ``main``, ``create_policy``, ``NetworkPolicy`` and
``VectorNetworkPolicy`` take ``device``, default ``"cuda"``, which raises
without a card; the CPU is used only where the caller passes ``"cpu"`` (the
launcher does, for its generators, so that only the learner uses the card).
A network policy is a ``Dreamer`` on that device calling
``Dreamer.inference`` once per env step (``NetworkPolicy``, B=1) or once per
tick of N envs (``VectorNetworkPolicy``, B=N); with ``gru_layernorm_dv2`` on
the card each call launches kernel K1 once.

The policy's weights are the ``"model"`` entry of the learner's torch
checkpoint (``tracking.py``), read on the CPU by
``tracking.load_checkpoint_model`` and copied into the policy's module.
Each network policy draws its noise from a ``GeneratorNoise`` on its device,
seeded from ``os.urandom`` (the JAX policies seed their keys the same way);
tests replace ``policy.noise``.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .data import Preprocessor, make_repository
from .device import resolve_device
from .models.noise import GeneratorNoise
from .tools import LogColorFormatter, configure_logging, discount, logger, print_once
from .tracking import init_run, load_checkpoint_model

__all__ = ["main", "create_policy", "RandomPolicy", "NetworkPolicy", "VectorNetworkPolicy",
           "chunk_episode_data"]


def main(env_id: str = "Grid-8",
         save_uri: Optional[str] = None,
         save_uri2: Optional[str] = None,
         worker_id: int = 0,
         policy_main: str = "random",
         policy_prefill: str = "random",
         num_steps: int = int(1e6),
         num_steps_prefill: int = 0,
         env_no_terminal: bool = False,
         env_time_limit: int = 0,
         env_action_repeat: int = 1,
         limit_step_ratio: float = 0.0,
         steps_per_npz: int = 1000,
         model_reload_interval: float = 120,
         model_conf=None,
         envs_per_worker: int = 1,
         log_metrics: bool = True,
         split_fraction: float = 0.0,
         metrics_prefix: str = "agent",
         metrics_gamma: float = 0.99,
         log_every: int = 10,
         device: str | torch.device = "cuda"):

    configure_logging(prefix=f"[GEN {worker_id}]", color=LogColorFormatter.GREEN)
    device = resolve_device(device)
    run_ = init_run()
    logger.info("Generator %d started: env=%s, n_steps=%s, n_prefill=%s, "
                "split_fraction=%s, save_uri=%s, device=%s",
                worker_id, env_id, f"{num_steps:,}", f"{num_steps_prefill:,}",
                split_fraction, save_uri, device)

    if not save_uri:
        save_uri = str(run_.artifact_dir(f"episodes/{worker_id}"))
    if split_fraction and not save_uri2:
        raise ValueError("split_fraction > 0 needs a second save destination, save_uri2")

    repository = make_repository(save_uri)
    repository2 = make_repository(save_uri2) if save_uri2 else repository
    nfiles, steps_saved, episodes = repository.count_steps()
    logger.info("Found existing %d files, %d episodes, %d steps in %r",
                nfiles, episodes, steps_saved, repository)

    # Resolved from the package at call time, so a test can swap it.
    from . import envs
    env = envs.create_env(env_id, env_no_terminal, env_time_limit, env_action_repeat, worker_id)

    envs_per_worker = max(1, int(envs_per_worker))
    if num_steps_prefill:
        logger.info("Prefill policy: %s", policy_prefill)
        policy = create_policy(policy_prefill, env, model_conf, n_envs=envs_per_worker,
                               device=device)
        is_prefill_policy = True
    else:
        logger.info("Policy: %s", policy_main)
        policy = create_policy(policy_main, env, model_conf, n_envs=envs_per_worker,
                               device=device)
        is_prefill_policy = False

    datas = []
    datas_episodes = 0
    last_model_load = 0.0
    model_step = 0
    metrics_agg = defaultdict(list)
    all_returns = []
    steps = 0

    def finish_episode(data, metrics, epsteps, fps):
        """Per-episode bookkeeping shared by the sequential and vectorized
        loops: policy columns, agent metrics, npz chunk accumulation."""
        nonlocal episodes, steps_saved, datas, datas_episodes, metrics_agg
        episodes += 1
        if "policy_value" in metrics:
            # A mid-episode policy switch (prefill -> network in the
            # vectorized loop) leaves in-flight slots with policy metrics
            # only from the switch tick on. Pad each column's head with NaN
            # so every npz column is as long as `reward`: the dataset's
            # windows slice all columns alike.
            pv, pe, ap = (list(metrics[k]) for k in
                          ("policy_value", "policy_entropy", "action_prob"))

            def pad_for(col):
                return [np.nan] * max(0, epsteps - len(col))
            data["policy_value"] = np.array(pad_for(pv) + pv + [np.nan])
            data["policy_entropy"] = np.array(pad_for(pe) + pe + [np.nan])
            data["action_prob"] = np.array([np.nan] + pad_for(ap) + ap)
        else:
            # Placeholders so all batches share the same key set.
            for k in ("policy_value", "policy_entropy", "action_prob"):
                data[k] = np.full(data["reward"].shape, np.nan)

        print_once("Episode data sample:", {k: v.shape for k, v in data.items()})
        logger.info("Episode recorded:  steps: %d,  reward: %.1f,  terminal: %.0f,"
                    "  total steps: %d,  episodes: %d,  saved steps (train): %d,"
                    "  fps: %.0f",
                    epsteps, data["reward"].sum(), data["terminal"].sum(),
                    steps, episodes, steps_saved, fps)

        if log_metrics:
            mets = {f"{metrics_prefix}/{k}": float(np.mean(v)) for k, v in metrics.items()}
            all_returns.append(float(data["reward"].sum()))
            mets.update({
                f"{metrics_prefix}/episode_length": epsteps,
                f"{metrics_prefix}/fps": fps,
                f"{metrics_prefix}/steps": steps,
                f"{metrics_prefix}/steps_saved": steps_saved,
                f"{metrics_prefix}/env_steps": steps * env_action_repeat,
                f"{metrics_prefix}/episodes": episodes,
                f"{metrics_prefix}/return": all_returns[-1],
                f"{metrics_prefix}/return_cum": float(np.mean(all_returns[-100:])),
            })

            # Discounted return with a bootstrapped tail on truncation
            # (generator.py:181-188).
            rewards_v = data["reward"].astype(np.float64).copy()
            if not data["terminal"][-1]:
                rewards_v[-1] += rewards_v.mean() / (1.0 - metrics_gamma)
            mets[f"{metrics_prefix}/return_discounted"] = float(
                discount(rewards_v, gamma=metrics_gamma).mean())

            if data["terminal"][-1] and not np.isnan(data["policy_value"][-2]):
                # Should be ~0: value[last] should equal reward[last].
                mets[f"{metrics_prefix}/policy_value_terminal"] = float(
                    data["policy_value"][-2] - data["reward"][-1])

            if "goals_visage" in data:
                seen = data["goals_visage"] < 1e5
                mets[f"{metrics_prefix}/goals_seen_avg"] = float(seen.sum(-1).mean())
                mets[f"{metrics_prefix}/goals_seen_last"] = float(seen[-1].sum())
                mets[f"{metrics_prefix}/goals_seenage"] = float(
                    (data["goals_visage"] * seen).sum() / max(seen.sum(), 1))

            for k, v in mets.items():
                if not np.isnan(v):
                    metrics_agg[k].append(v)
            if len(metrics_agg.get(f"{metrics_prefix}/return", [])) >= log_every:
                agg_max = {k: float(np.max(v)) for k, v in metrics_agg.items()}
                agg = {k: float(np.mean(v)) for k, v in metrics_agg.items()}
                agg[f"{metrics_prefix}/return_max"] = agg_max[f"{metrics_prefix}/return"]
                run_.log_metrics(agg, step=model_step)
                metrics_agg = defaultdict(list)

        # Accumulate and save npz chunks.
        datas.append(data)
        datas_episodes = len(datas)
        datas_steps = sum(len(d["reset"]) - 1 for d in datas)
        if datas_steps >= steps_per_npz:
            data = {k: np.concatenate([b[k] for b in datas], axis=0) for k in datas[0]}
            datas = []
            print_once("Collected data sample:", {k: v.shape for k, v in data.items()})

            if datas_steps >= 2 * steps_per_npz:
                chunks = chunk_episode_data(data, steps_per_npz)
            else:
                chunks = [data]

            # Global numpy state, as in the JAX generator.
            repo = repository if (np.random.rand() > split_fraction) else repository2
            for i, chunk in enumerate(chunks):
                if "image" in chunk and chunk["image"].ndim == 4:
                    # THWC => HWCT transposes like-colored planes together
                    # for much better zlib compression (generator.py:246-249).
                    chunk["image_t"] = chunk["image"].transpose(1, 2, 3, 0)
                    del chunk["image"]
                repo.save_data(chunk, episodes - datas_episodes, episodes - 1, i)
            if repo is repository:
                # Only train-repo steps count for prefill / rate limiting.
                steps_saved += datas_steps

    def maybe_switch_policy(policy, is_prefill_policy):
        if is_prefill_policy and steps_saved >= num_steps_prefill:
            logger.info("Switching to main policy: %s", policy_main)
            return create_policy(policy_main, env, model_conf, n_envs=envs_per_worker,
                                 device=device), False
        return policy, is_prefill_policy

    def maybe_reload_and_ratelimit(policy):
        """Checkpoint poll (the policy channel) + limit_step_ratio wait.
        Returns True if the caller should skip this iteration (rate limit)."""
        nonlocal last_model_load, model_step
        if not isinstance(policy, (NetworkPolicy, VectorNetworkPolicy)):
            return False
        if time.time() - last_model_load > model_reload_interval:
            while True:
                # None while the learner has written no checkpoint yet.
                loaded = load_checkpoint_model(run_.checkpoint_path)
                if loaded is not None:
                    state_dict, model_step = loaded
                    policy.set_params(state_dict)
                    logger.info("Generator loaded model checkpoint %d", model_step)
                    last_model_load = time.time()
                    break
                logger.debug("Generator model checkpoint not found, waiting...")
                time.sleep(10)
        if limit_step_ratio and steps_saved >= model_step * limit_step_ratio:
            time.sleep(1)
            return True
        return False

    if envs_per_worker <= 1:
        while steps_saved < num_steps:
            policy, is_prefill_policy = maybe_switch_policy(policy, is_prefill_policy)
            if maybe_reload_and_ratelimit(policy):
                continue

            # Unroll one episode.
            epsteps = 0
            timer = time.time()
            obs = env.reset()
            done = False
            metrics = defaultdict(list)
            while not done:
                action, mets = policy(obs)
                obs, reward, done, inf = env.step(action)
                steps += 1
                epsteps += 1
                for k, v in mets.items():
                    metrics[k].append(v)

            finish_episode(inf["episode"], metrics, epsteps,
                           fps=epsteps / (time.time() - timer + 1e-6))
    else:
        # Vectorized stepping: N env instances advance in lockstep through
        # one batched policy call per tick (T=1, B=N). Episodes end (and
        # reset) independently per slot; a slot's RSSM state is zeroed by
        # the reset flag the wrapper puts in the obs.
        # Sibling seeds live in a band disjoint from base-env seeds (small
        # worker ids) and from other workers' sibling bands, so no two env
        # instances anywhere share a seed stream.
        env_list = [env] + [
            envs.create_env(env_id, env_no_terminal, env_time_limit,
                            env_action_repeat, 1_000_000 + worker_id * 1000 + i)
            for i in range(1, envs_per_worker)]
        obs_list = [e.reset() for e in env_list]
        ep_metrics = [defaultdict(list) for _ in env_list]
        ep_steps = [0] * envs_per_worker
        ep_timer = [time.time()] * envs_per_worker
        while steps_saved < num_steps:
            policy, is_prefill_policy = maybe_switch_policy(policy, is_prefill_policy)
            if maybe_reload_and_ratelimit(policy):
                continue

            if isinstance(policy, VectorNetworkPolicy):
                actions, vmets = policy(obs_list)   # vmets: {k: (N,)}
                per_mets = [{k: float(v[i]) for k, v in vmets.items()}
                            for i in range(envs_per_worker)]
            else:
                # Non-batched policies (random/scripted/NetworkPolicy) are
                # stepped per slot; their per-env metrics are kept so the
                # vectorized path logs the same agent metrics as the
                # sequential path.
                per = [policy(o) for o in obs_list]
                actions = [a for a, _ in per]
                per_mets = [m for _, m in per]

            for i, e in enumerate(env_list):
                obs_i, reward, done, inf = e.step(actions[i])
                steps += 1
                ep_steps[i] += 1
                for k, v in per_mets[i].items():
                    ep_metrics[i][k].append(float(v))
                if done:
                    finish_episode(
                        inf["episode"], ep_metrics[i], ep_steps[i],
                        fps=ep_steps[i] / (time.time() - ep_timer[i] + 1e-6))
                    obs_i = e.reset()
                    ep_metrics[i] = defaultdict(list)
                    ep_steps[i] = 0
                    ep_timer[i] = time.time()
                obs_list[i] = obs_i

    logger.info("Generator done.")


def chunk_episode_data(data: Dict[str, np.ndarray], min_steps: int):
    """Split concatenated episodes into chunks of [min_steps, 2*min_steps)."""
    n = len(data["reset"])
    chunks = []
    i = 0
    while i < n:
        j = min(i + min_steps, n)
        if n - j < min_steps:
            j = n
        chunks.append({k: v[i:j] for k, v in data.items()})
        i = j
    return chunks


def create_policy(policy_type: str, env, model_conf, n_envs: int = 1,
                  device: str | torch.device = "cuda"):
    """(reference: generator.py:262-300; n_envs>1 selects the batched
    network policy for the vectorized generator loop.)"""
    device = resolve_device(device)
    if policy_type == "network":
        from .models.dreamer import Dreamer
        if model_conf.model not in ("dreamer", "dreamerv3"):
            raise ValueError(f"the network policy needs model: dreamer or dreamerv3, got "
                             f"{model_conf.model!r}")
        model = Dreamer(model_conf, device=device)
        preprocess = Preprocessor.from_conf(model_conf)
        if n_envs > 1:
            return VectorNetworkPolicy(model, preprocess, n_envs, device=device)
        return NetworkPolicy(model, preprocess, device=device)

    if policy_type == "random":
        return RandomPolicy(env.action_space)

    if policy_type == "minigrid_wander":
        from .envs.minigrid import MinigridWanderPolicy
        return MinigridWanderPolicy()

    if policy_type == "maze_bouncing_ball":
        from .envs.miniworld import MazeBouncingBallPolicy
        return MazeBouncingBallPolicy()

    if policy_type in ("maze_dijkstra", "goal_dijkstra"):
        from .envs.miniworld import MazeDijkstraPolicy
        step_size = env.params.params["forward_step"].default / env.room_size
        turn_size = env.params.params["turn_step"].default
        if policy_type == "maze_dijkstra":
            return MazeDijkstraPolicy(step_size, turn_size)
        return MazeDijkstraPolicy(step_size, turn_size,
                                  goal_strategy="goal_direction", random_prob=0)

    raise ValueError(policy_type)


class RandomPolicy:
    def __init__(self, action_space):
        self.action_space = action_space

    def __call__(self, obs) -> Tuple[np.ndarray, dict]:
        return self.action_space.sample(), {}


def _cli():
    """Standalone generator CLI (reference: generator.py:334-345)."""
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--env_id", type=str, required=True)
    p.add_argument("--policy_main", type=str, default="random")
    p.add_argument("--save_uri", type=str, default=None)
    p.add_argument("--num_steps", type=int, default=1_000_000)
    p.add_argument("--worker_id", type=int, default=0)
    p.add_argument("--env_time_limit", type=int, default=0)
    p.add_argument("--env_action_repeat", type=int, default=1)
    p.add_argument("--steps_per_npz", type=int, default=1000)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args()
    main(**vars(args))


class _DreamerPolicy:
    """A ``Dreamer`` on ``device`` acting through ``Dreamer.inference`` with
    the TBTT state of ``batch_size`` slots carried from call to call."""

    def __init__(self, model, preprocess: Preprocessor, batch_size: int,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model is on {model.device}, the policy on {self.device}")
        self.model = model
        self.preprocess = preprocess
        self.loaded = False
        self.state = model.init_state(batch_size)
        self.noise = GeneratorNoise(self.device, seed=int.from_bytes(os.urandom(4), "little"))

    def set_params(self, state_dict: Dict[str, torch.Tensor]):
        """Copy a checkpoint's ``"model"`` entry into the policy's module."""
        self.model.load_state_dict(state_dict)
        self.loaded = True

    def _act(self, batch: Dict[str, np.ndarray]) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """(T=1, B) numpy batch -> actions (B, A) and metrics {k: (B,)} on the
        host, fetched in one copy."""
        if not self.loaded:
            raise RuntimeError(f"{type(self).__name__} used before a checkpoint load")
        obs = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        action, self.state, metrics = self.model.inference(obs, self.state, self.noise)
        keys = list(metrics)
        host = torch.cat([action[0].float()] + [metrics[k].float()[:, None] for k in keys],
                         -1).cpu().numpy()
        A = action.shape[-1]
        return host[:, :A].copy(), {k: host[:, A + i].copy() for i, k in enumerate(keys)}


class NetworkPolicy(_DreamerPolicy):
    """Single-env Dreamer inference (B=1) with TBTT state carry."""

    def __init__(self, model, preprocess: Preprocessor, device: str | torch.device = "cuda"):
        super().__init__(model, preprocess, 1, device)

    def __call__(self, obs) -> Tuple[np.ndarray, dict]:
        actions, metrics = self._act(self.preprocess.apply(obs, expandTB=True))
        # (B=1, A) => (A,). Index, don't squeeze(): a full squeeze would also
        # drop A when A == 1 (1-dim continuous envs like DMC cartpole) and
        # break the env wrappers' action-shape contract.
        return actions[0], {k: float(v[0]) for k, v in metrics.items()}


class VectorNetworkPolicy(_DreamerPolicy):
    """Batched Dreamer inference over N env instances: one (T=1, B=N) call
    per tick instead of N single-slot calls. Per-slot TBTT state lives in
    the (N, ...) state tensors; a slot is zeroed when its obs carries
    reset=True (the mechanism the learner's posterior loop uses)."""

    def __init__(self, model, preprocess: Preprocessor, n_envs: int,
                 device: str | torch.device = "cuda"):
        super().__init__(model, preprocess, n_envs, device)
        self.n_envs = n_envs

    def __call__(self, obs_list) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        if len(obs_list) != self.n_envs:
            raise ValueError(f"{len(obs_list)} observations for {self.n_envs} envs")
        # Stack N obs dicts -> (N, ...), add the T axis -> (1, N, ...).
        stacked = {k: np.stack([o[k] for o in obs_list])[np.newaxis] for k in obs_list[0]}
        return self._act(self.preprocess.apply(stacked))   # (N, A), {k: (N,)}


if __name__ == "__main__":
    _cli()
