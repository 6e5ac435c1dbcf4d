"""Minimal env protocol + spaces (no gym dependency).

The framework defines its own tiny env interface matching the classic
step/reset contract the reference builds on (reference: pydreamer/envs/
wrappers.py uses gym.Wrapper):

    obs = env.reset()                      # dict observation
    obs, reward, done, info = env.step(a)

Observations are dicts ('image' HWC uint8 / categorical int, 'vecobs'
float, ...); actions are int (discrete) or float vectors. External SDKs
(gymnasium, dm_control, ALE...) are adapted to this protocol in their
adapter modules, all optional imports.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

__all__ = ["Space", "Discrete", "Box", "Env", "Wrapper"]


class Space:
    def sample(self):
        raise NotImplementedError


class Discrete(Space):
    def __init__(self, n: int, seed: Optional[int] = None):
        self.n = n
        self.rng = np.random.default_rng(seed)

    def sample(self) -> int:
        return int(self.rng.integers(self.n))

    def __repr__(self):
        return f"Discrete({self.n})"


class Box(Space):
    def __init__(self, low, high, shape, dtype=np.float32, seed: Optional[int] = None):
        self.low = np.broadcast_to(np.asarray(low, dtype), shape)
        self.high = np.broadcast_to(np.asarray(high, dtype), shape)
        self.shape = tuple(shape)
        self.dtype = dtype
        self.rng = np.random.default_rng(seed)

    def sample(self) -> np.ndarray:
        return self.rng.uniform(self.low, self.high).astype(self.dtype)

    def __repr__(self):
        return f"Box{self.shape}"


class Env:
    """Base environment."""

    action_space: Space
    observation_space: Optional[Space] = None

    def reset(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def step(self, action) -> Tuple[Dict[str, np.ndarray], float, bool, Dict[str, Any]]:
        raise NotImplementedError

    def close(self):
        pass


class Wrapper(Env):
    def __init__(self, env: Env):
        self.env = env

    @property
    def action_space(self) -> Space:  # type: ignore[override]
        return self.env.action_space

    def reset(self):
        return self.env.reset()

    def step(self, action):
        return self.env.step(action)

    def close(self):
        return self.env.close()

    def __getattr__(self, name):
        return getattr(self.env, name)
