"""Atari adapter (ALE via gymnasium), DreamerV2-style preprocessing.

Counterpart of the reference Atari env (reference: pydreamer/envs/atari.py):
sticky actions (p=0.25), full 18-action space, 30 noops, 64x64 RGB (not
grayscale — a deliberate PyDreamer choice, README.md:82), action_repeat with
max-pooled frames, no life-done. Requires ``ale_py`` (optional).
"""

from __future__ import annotations

import threading

import numpy as np

from .base import Discrete, Env

__all__ = ["Atari"]


class Atari(Env):

    LOCK = threading.Lock()

    def __init__(self, name: str, action_repeat: int = 4, size=(64, 64),
                 grayscale: bool = False, noops: int = 30, life_done: bool = False,
                 sticky_actions: bool = True, all_actions: bool = True,
                 worker_id: int = 0):
        assert size[0] == size[1]
        try:
            import gymnasium
            import ale_py  # noqa: F401  (registers ALE envs)
            gymnasium.register_envs(ale_py)
        except ImportError as e:
            raise ImportError(
                "Atari environments need ale_py + gymnasium[atari]; "
                "not available in this image") from e
        game = "".join(w.capitalize() for w in name.split("_"))
        with self.LOCK:
            env = gymnasium.make(
                f"ALE/{game}-v5", frameskip=1,
                repeat_action_probability=0.25 if sticky_actions else 0.0,
                full_action_space=all_actions)
        env = gymnasium.wrappers.AtariPreprocessing(
            env, noop_max=noops, frame_skip=action_repeat, screen_size=size[0],
            terminal_on_life_loss=life_done, grayscale_obs=grayscale)
        self._env = env
        self.grayscale = grayscale
        self.action_space = Discrete(int(env.action_space.n), seed=worker_id)

    def _obs(self, image):
        if self.grayscale:
            image = image[..., None]
        return {"image": np.asarray(image)}

    def reset(self):
        with self.LOCK:
            image, _ = self._env.reset()
        return self._obs(image)

    def step(self, action):
        image, reward, terminated, truncated, info = self._env.step(action)
        info = dict(info)
        if truncated and not terminated:
            info["time_limit"] = True
        return self._obs(image), float(reward), bool(terminated or truncated), info

    def close(self):
        self._env.close()
