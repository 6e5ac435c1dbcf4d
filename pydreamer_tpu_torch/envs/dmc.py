"""DeepMind Control adapter: pixels + proprio (reference: pydreamer/envs/dmc.py).

Domain-specific cameras; empty observation keys dropped; proprio keys
concatenated into ``vecobs`` by the preprocessor downstream. Requires
``dm_control`` (optional).
"""

from __future__ import annotations

import os

import numpy as np

from .base import Box, Env

__all__ = ["DMC"]

# Headless hosts have no X server; MuJoCo needs an explicit GL backend
# there. EGL renders on GPU-less hosts too. (The reference instead wraps
# runs in scripts/xvfb_run.sh.) Must be set before dm_control import.
if not os.environ.get("DISPLAY"):
    os.environ.setdefault("MUJOCO_GL", "egl")

_CAMERAS = dict(
    quadruped_walk=2, quadruped_run=2, quadruped_escape=2, quadruped_fetch=2,
    locom_rodent_maze_forage=1, locom_rodent_two_touch=1,
)


class DMC(Env):

    def __init__(self, name: str, action_repeat: int = 1, size=(64, 64),
                 camera=None):
        domain, task = name.split("_", 1)
        if domain == "cup":  # only domain with multiple words
            domain = "ball_in_cup"
        try:
            if domain == "manip":
                from dm_control import manipulation
                self._env = manipulation.load(task + "_vision")
            elif domain == "locom":
                from dm_control.locomotion.examples import basic_rodent_2020
                self._env = getattr(basic_rodent_2020, task)()
            else:
                from dm_control import suite
                self._env = suite.load(domain, task)
        except ImportError as e:
            raise ImportError("DMC environments need dm_control; "
                              "not available in this image") from e
        self._action_repeat = action_repeat
        self._size = size
        self._camera = camera if camera is not None else _CAMERAS.get(name, 0)
        self._ignored_keys = [
            k for k, v in self._env.observation_spec().items() if v.shape == (0,)]
        spec = self._env.action_spec()
        self.action_space = Box(spec.minimum, spec.maximum, spec.shape, np.float32)

    def _observation(self, time_step):
        obs = {k: np.asarray(v) for k, v in dict(time_step.observation).items()
               if k not in self._ignored_keys}
        # Flatten proprio into one vector for the vecobs branch.
        vec = [v.reshape(-1).astype(np.float32) for k, v in sorted(obs.items())]
        out = {"image": self.render()}
        if vec:
            out["vecobs"] = np.concatenate(vec)
        return out

    def reset(self):
        return self._observation(self._env.reset())

    def step(self, action):
        assert np.isfinite(action).all(), action
        reward = 0.0
        time_step = None
        for _ in range(self._action_repeat):
            time_step = self._env.step(action)
            reward += time_step.reward or 0.0
            if time_step.last():
                break
        done = time_step.last()
        info = {"discount": np.array(time_step.discount, np.float32)}
        if done and time_step.discount == 1.0:
            info["time_limit"] = True  # DMC episodes end by time, not failure
        return self._observation(time_step), reward, done, info

    def render(self):
        return self._env.physics.render(*self._size, camera_id=self._camera)
