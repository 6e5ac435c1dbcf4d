"""Universal wrapper stack applied to every environment.

Counterpart of the reference wrappers (reference: pydreamer/envs/wrappers.py):
  * ``DictWrapper``              — normalize raw obs to a dict (image vs vecobs)
  * ``TimeLimitWrapper``         — done=True + info['time_limit'] past the limit
  * ``ActionRewardResetWrapper`` — inject action/reward/terminal/reset keys
    into the obs dict; terminal != done on time-limit truncation
    (wrappers.py:62 — the distinction the value function depends on)
  * ``CollectWrapper``           — accumulate the full episode into
    info['episode'] at done
  * ``OneHotActionWrapper``      — accept one-hot actions on discrete envs
  * ``RestartOnExceptionWrapper``— rebuild crashy envs; a step error ends the
    episode as a time-limit, not a terminal
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np

from ..tools import logger
from .base import Env, Wrapper

__all__ = ["DictWrapper", "TimeLimitWrapper", "ActionRewardResetWrapper",
           "CollectWrapper", "OneHotActionWrapper", "RestartOnExceptionWrapper"]


class DictWrapper(Wrapper):
    def _to_dict(self, obs):
        if isinstance(obs, dict):
            return obs
        if len(obs.shape) == 1:
            return {"vecobs": obs}
        return {"image": obs}

    def reset(self):
        return self._to_dict(self.env.reset())

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        return self._to_dict(obs), reward, done, info


class TimeLimitWrapper(Wrapper):
    def __init__(self, env: Env, time_limit: int):
        super().__init__(env)
        self.time_limit = time_limit
        self.step_ = 0

    def reset(self):
        self.step_ = 0
        return self.env.reset()

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        self.step_ += 1
        if self.step_ >= self.time_limit:
            done = True
            info["time_limit"] = True
        return obs, reward, done, info


class ActionRewardResetWrapper(Wrapper):
    def __init__(self, env: Env, no_terminal: bool):
        super().__init__(env)
        self.no_terminal = no_terminal
        space = env.action_space
        self.action_size = space.n if hasattr(space, "n") else space.shape[0]

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        if isinstance(action, (int, np.integer)):
            action_vec = np.zeros(self.action_size)
            action_vec[action] = 1.0
        else:
            action = np.asarray(action)
            assert action.shape == (self.action_size,), "Wrong one-hot action shape"
            action_vec = action
        obs["action"] = action_vec
        obs["reward"] = np.array(reward)
        # A time-limit end is NOT a terminal state: V(s) stays bootstrapped.
        truncated = info.get("time_limit") or info.get("TimeLimit.truncated")
        obs["terminal"] = np.array(False if self.no_terminal or truncated else done)
        obs["reset"] = np.array(False)
        return obs, reward, done, info

    def reset(self):
        obs = self.env.reset()
        obs["action"] = np.zeros(self.action_size)
        obs["reward"] = np.array(0.0)
        obs["terminal"] = np.array(False)
        obs["reset"] = np.array(True)
        return obs


class CollectWrapper(Wrapper):
    def __init__(self, env: Env):
        super().__init__(env)
        self.episode = []

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        self.episode.append(obs.copy())
        if done:
            info["episode"] = {
                k: np.array([t[k] for t in self.episode]) for k in self.episode[0]}
        return obs, reward, done, info

    def reset(self):
        obs = self.env.reset()
        self.episode = [obs.copy()]
        return obs


class OneHotActionWrapper(Wrapper):
    """Accept one-hot actions on a discrete-action env."""

    def step(self, action):
        if not isinstance(action, (int, np.integer)):
            action = int(np.asarray(action).argmax())
        return self.env.step(action)


class RestartOnExceptionWrapper(Wrapper):
    def __init__(self, constructor: Callable[[], Env]):
        self.constructor = constructor
        super().__init__(constructor())
        self.last_obs = None

    def step(self, action):
        try:
            obs, reward, done, info = self.env.step(action)
            self.last_obs = obs
            return obs, reward, done, info
        except Exception:
            logger.exception("Error in env.step() - terminating episode.")
            # Terminate as time-limit so it does not count as a true terminal.
            return self.last_obs, 0.0, True, dict(time_limit=True)

    def reset(self):
        while True:
            try:
                obs = self.env.reset()
                self.last_obs = obs
                return obs
            except Exception:
                logger.exception("Error in env.reset() - recreating env.")
                try:
                    self.env.close()
                except Exception:
                    pass
                try:
                    self.env = self.constructor()
                except Exception:
                    pass
            time.sleep(1)
