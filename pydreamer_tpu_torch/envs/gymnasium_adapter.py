"""Adapter: gymnasium (new 5-tuple API) -> framework env protocol.

The generic fallback for any registered gymnasium id (the reference's
``gym.make`` fallback, envs/__init__.py:61-63). Translates
(terminated, truncated) into (done, info['time_limit']) so the wrapper
stack's terminal-vs-truncation distinction keeps working.
"""

from __future__ import annotations

import numpy as np

from .base import Box, Discrete, Env

__all__ = ["GymnasiumEnv"]


class GymnasiumEnv(Env):

    def __init__(self, env_id: str, seed: int = 0, **kwargs):
        import gymnasium
        self._env = gymnasium.make(env_id, **kwargs)
        self._seed = seed
        self._needs_seed = True
        space = self._env.action_space
        if hasattr(space, "n"):
            self.action_space = Discrete(int(space.n), seed=seed)
        else:
            self.action_space = Box(space.low, space.high, space.shape,
                                    np.float32, seed=seed)

    def reset(self):
        if self._needs_seed:
            obs, _ = self._env.reset(seed=self._seed)
            self._needs_seed = False
        else:
            obs, _ = self._env.reset()
        return np.asarray(obs)

    def step(self, action):
        obs, reward, terminated, truncated, info = self._env.step(action)
        info = dict(info)
        if truncated and not terminated:
            info["time_limit"] = True
        return np.asarray(obs), float(reward), bool(terminated or truncated), info

    def close(self):
        self._env.close()
