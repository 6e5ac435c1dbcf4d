"""Built-in synthetic environments: zero-dependency test and demo tasks.

These replace "gym classic control" as the always-available envs for
integration tests and end-to-end demos (the reference has no built-in envs;
its test strategy gap is called out in SURVEY §4 — a pure in-memory FakeEnv
is the fix).

  * ``CountingEnv``  — deterministic patterns; for data-pipeline tests
  * ``GridWorld``    — learnable NxN navigation task with image obs: the
    agent (white) must reach the goal (checker). reward +1, episode ends.
    A competent world model + policy solves it; random policy averages
    ~4% success per step.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .base import Box, Discrete, Env

__all__ = ["BanditEnv", "CountingEnv", "GridWorld", "PointEnv"]


class BanditEnv(Env):
    """K-armed bandit: the minimal policy-learning benchmark.

    Constant 1-dim vecobs; reward 1.0 every step the target action is taken,
    0.0 otherwise; fixed episode length. Optimal return = episode_length.
    The world model only has to learn reward(state, action) — so a correct
    imagination + policy-gradient path lifts the return from episode_length/K
    (random) to ~episode_length within a few hundred gradient steps; used by
    tests/test_learning.py as the return-improvement canary.
    """

    def __init__(self, action_dim: int = 3, episode_length: int = 8,
                 target: int = 1, seed: int = 0):
        self.episode_length = episode_length
        self.target = target % action_dim
        self.action_space = Discrete(action_dim, seed=seed)
        self.observation_space = Box(0.0, 1.0, (1,), np.float32)
        self.t = 0

    def _obs(self):
        return {"vecobs": np.ones(1, np.float32)}

    def reset(self):
        self.t = 0
        return self._obs()

    def step(self, action):
        action = int(np.argmax(action)) if np.ndim(action) > 0 else int(action)
        self.t += 1
        reward = 1.0 if action == self.target else 0.0
        done = self.t >= self.episode_length
        return self._obs(), reward, done, {}


class PointEnv(Env):
    """2-D point mass: the minimal continuous-control benchmark.

    Continuous counterpart of BanditEnv, structured like a dense-reward DMC
    task (cartpole_balance): vecobs = [pos, goal] in [-1,1]^4, action
    Box(-1,1,(2,)), dynamics ``pos += step * action`` (clipped to the box),
    reward = clip(1 - ||pos-goal||, 0, 1) each step, fixed episode length
    (time-limit truncation, never terminal) with per-episode random start and
    goal. Random policy averages ~0.4/step; a competent ``tanh_normal`` +
    dynamics-gradients agent drives to the goal and holds ~0.95/step. Used by
    tests/test_learning.py as the continuous-control canary.
    """

    def __init__(self, action_dim: int = 2, episode_length: int = 32,
                 step_size: float = 0.25, seed: Optional[int] = None):
        self.episode_length = episode_length
        self.step_size = step_size
        self.rng = np.random.default_rng(seed)
        self.action_space = Box(-1.0, 1.0, (action_dim,), np.float32,
                                seed=None if seed is None else seed + 1)
        self.observation_space = Box(-1.0, 1.0, (2 * action_dim,), np.float32)
        self.pos = np.zeros(action_dim, np.float32)
        self.goal = np.zeros(action_dim, np.float32)
        self.t = 0

    def _obs(self):
        return {"vecobs": np.concatenate([self.pos, self.goal]).astype(np.float32)}

    def reset(self):
        self.pos = self.rng.uniform(-1, 1, self.pos.shape).astype(np.float32)
        self.goal = self.rng.uniform(-0.5, 0.5, self.goal.shape).astype(np.float32)
        self.t = 0
        return self._obs()

    def step(self, action):
        action = np.clip(np.asarray(action, np.float32), -1.0, 1.0)
        self.pos = np.clip(self.pos + self.step_size * action, -1.0, 1.0)
        self.t += 1
        reward = float(np.clip(1.0 - np.linalg.norm(self.pos - self.goal), 0.0, 1.0))
        done = self.t >= self.episode_length
        info = {"time_limit": True} if done else {}
        return self._obs(), reward, done, info


class CountingEnv(Env):
    """Image encodes the step index; reward = step; episode length fixed."""

    def __init__(self, episode_length: int = 10, image_size: int = 64,
                 action_dim: int = 3, seed: int = 0):
        self.episode_length = episode_length
        self.image_size = image_size
        self.action_space = Discrete(action_dim, seed=seed)
        self.t = 0

    def _obs(self):
        img = np.full((self.image_size, self.image_size, 3), self.t % 256, np.uint8)
        return {"image": img}

    def reset(self):
        self.t = 0
        return self._obs()

    def step(self, action):
        self.t += 1
        done = self.t >= self.episode_length
        return self._obs(), float(self.t), done, {}


class GridWorld(Env):
    """NxN grid navigation rendered to an image.

    Actions: 0=up 1=down 2=left 3=right. The goal is resampled per episode.
    Observation: (image_size, image_size, 3) uint8; agent cell white, goal
    cell green, walls dark border. Reward 1.0 at goal (terminal), small
    step penalty otherwise. max_steps cap counts as time-limit truncation.
    """

    def __init__(self, grid_size: int = 8, image_size: int = 64,
                 max_steps: int = 50, seed: Optional[int] = None):
        self.n = grid_size
        self.image_size = image_size
        self.max_steps = max_steps
        self.rng = np.random.default_rng(seed)
        self.action_space = Discrete(4, seed=None if seed is None else seed + 1)
        self.observation_space = Box(0, 255, (image_size, image_size, 3), np.uint8)
        self.pos = np.zeros(2, np.int64)
        self.goal = np.zeros(2, np.int64)
        self.t = 0

    def _render(self) -> np.ndarray:
        cell = self.image_size // self.n
        img = np.zeros((self.image_size, self.image_size, 3), np.uint8)
        img[:, :, :] = 40  # background
        gy, gx = self.goal * cell
        img[gy:gy + cell, gx:gx + cell] = (0, 200, 0)
        ay, ax = self.pos * cell
        img[ay:ay + cell, ax:ax + cell] = (255, 255, 255)
        return img

    def reset(self):
        self.pos = self.rng.integers(0, self.n, 2)
        while True:
            self.goal = self.rng.integers(0, self.n, 2)
            if not np.array_equal(self.goal, self.pos):
                break
        self.t = 0
        return {"image": self._render()}

    def step(self, action):
        action = int(action)
        delta = {0: (-1, 0), 1: (1, 0), 2: (0, -1), 3: (0, 1)}[action]
        self.pos = np.clip(self.pos + np.array(delta), 0, self.n - 1)
        self.t += 1
        done = bool(np.array_equal(self.pos, self.goal))
        reward = 1.0 if done else -0.01
        info = {}
        if not done and self.t >= self.max_steps:
            done = True
            info["time_limit"] = True
        return {"image": self._render()}, reward, done, info
