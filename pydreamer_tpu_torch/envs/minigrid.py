"""MiniGrid adapter + scripted wander policy.

Counterpart of the reference MiniGrid env (reference: pydreamer/envs/
minigrid.py): 7x7 categorical agent view (values collapsed to a small
class set), global ``map`` for the probe head, agent_pos/agent_dir for
map_coord. Requires the ``minigrid`` package (optional).

The categorical codebook follows the reference's collapse of
(object, color, state) triples into single class ids.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .base import Discrete, Env

__all__ = ["MiniGrid", "MinigridWanderPolicy", "view_to_global_coords",
           "update_last_seen", "centered_map", "map_observation"]

# dir 0..3 = right, down, left, up (minigrid DIR_TO_VEC); right_vec is the
# forward vector rotated clockwise.
_DIR_TO_VEC = np.array([(1, 0), (0, 1), (-1, 0), (0, -1)], np.int64)


def view_to_global_coords(agent_pos, agent_dir: int, view_size: int,
                          width: int, height: int):
    """Map the (view_size, view_size) egocentric view onto global grid cells.

    The agent sits at the bottom-center of its view looking "up" the view's
    j axis. Returns (x, y, mask) arrays of shape (view_size, view_size):
    global coordinates per view cell and an in-bounds mask. Vectorized
    counterpart of the reference's per-cell loop
    (reference: pydreamer/envs/minigrid.py:181-199).
    """
    n = view_size
    f = _DIR_TO_VEC[agent_dir]
    r = np.array([-f[1], f[0]], np.int64)
    top_left = np.asarray(agent_pos, np.int64) + f * (n - 1) - r * (n // 2)
    vis_i = np.arange(n)[:, None, None]  # rightward offset in the view
    vis_j = np.arange(n)[None, :, None]  # how far ahead (0 = farthest row)
    xy = top_left[None, None, :] - f[None, None, :] * vis_j + r[None, None, :] * vis_i
    x, y = xy[..., 0], xy[..., 1]
    mask = (x >= 0) & (x < width) & (y >= 0) & (y < height)
    return x, y, mask


def update_last_seen(last_seen: np.ndarray, vis_mask: np.ndarray,
                     cap: int) -> np.ndarray:
    """Advance the per-cell visibility age: +1 everywhere (clipped at cap),
    zeroed where currently visible (reference: minigrid.py:170-176). Mutates
    and returns ``last_seen``."""
    np.minimum(last_seen + 1, cap, out=last_seen)
    last_seen[vis_mask] = 0
    return last_seen


def centered_map(grid: np.ndarray, agent_pos, agent_dir: int,
                 out_size: int, pad_value: int = 2) -> np.ndarray:
    """Agent-centered, agent-oriented crop of the global class grid.

    Crops an (out_size, out_size) window centered on the agent (out-of-bounds
    cells read ``pad_value`` = wall, like the reference Grid.slice), then
    rotates it so the agent faces "up" in the crop — the counterpart of the
    reference's grid.slice + rotate_left loop (minigrid.py:159-166).
    """
    m = out_size
    half = (m - 1) // 2
    x0 = int(agent_pos[0]) - half
    y0 = int(agent_pos[1]) - half
    out = np.full((m, m), pad_value, grid.dtype)
    sx0, sy0 = max(x0, 0), max(y0, 0)
    sx1 = min(x0 + m, grid.shape[0])
    sy1 = min(y0 + m, grid.shape[1])
    if sx1 > sx0 and sy1 > sy0:
        out[sx0 - x0:sx1 - x0, sy0 - y0:sy1 - y0] = grid[sx0:sx1, sy0:sy1]
    # rotate_left k times, k = agent_dir + 1; one rotate_left of an [x][y]
    # indexed grid is transpose + flip of the second axis.
    for _ in range(agent_dir + 1):
        out = out.T[:, ::-1]
    return np.ascontiguousarray(out)


def map_observation(grid: np.ndarray, agent_pos, agent_dir: int,
                    obs_vis: np.ndarray, last_seen: np.ndarray,
                    vis_cap: int, centered_size: int,
                    agent_class: int = 11) -> dict:
    """The full map-observation family from one global class grid.

    Pure function (SDK-free, testable) producing the reference's map keys
    (reference: pydreamer/envs/minigrid.py:111-118):
      * ``map``         — global grid WITHOUT the agent
      * ``map_agent``   — global grid with the agent cell stamped
      * ``map_masked``  — ``map_agent`` with currently-invisible cells
                          zeroed to the unseen class (0)
      * ``map_vis``     — per-cell visibility age (0 = visible now)
      * ``map_centered``— agent-centered, agent-oriented crop

    ``obs_vis`` is the egocentric view's seen-mask (view coords);
    ``last_seen`` is the persistent age array, mutated in place.
    """
    ax, ay = int(agent_pos[0]), int(agent_pos[1])
    m_agent = grid.copy()
    m_agent[ax, ay] = agent_class

    n = obs_vis.shape[0]
    vx, vy, in_bounds = view_to_global_coords(
        agent_pos, agent_dir, n, grid.shape[0], grid.shape[1])
    glb_vis = np.zeros(grid.shape, bool)
    glb_vis[vx[in_bounds], vy[in_bounds]] = obs_vis[in_bounds]
    map_vis = update_last_seen(last_seen, glb_vis, vis_cap).copy()

    return {
        "map": grid,
        "map_agent": m_agent,
        "map_masked": (m_agent * glb_vis).astype(grid.dtype),
        "map_vis": map_vis,
        "map_centered": centered_map(grid, agent_pos, agent_dir,
                                     centered_size),
    }


class MiniGrid(Env):

    # object-type ids (minigrid core constants): collapse to compact classes
    # 0 unseen, 1 empty, 2 wall, 3 floor, 4 door(open), 5 door(closed),
    # 6 key, 7 ball, 8 box, 9 goal, 10 lava, 11 agent
    N_CLASSES = 12

    def __init__(self, env_id: str, seed: int = 0, max_steps: Optional[int] = None):
        try:
            import gymnasium
            import minigrid  # noqa: F401
        except ImportError as e:
            raise ImportError("MiniGrid environments need the minigrid package; "
                              "not available in this image") from e
        kwargs = {}
        if max_steps:
            kwargs["max_steps"] = max_steps
        self._env = gymnasium.make(env_id, **kwargs)
        self._seed = seed
        self._needs_seed = True
        self.action_space = Discrete(7, seed=seed)
        self.map_size = self._env.unwrapped.grid.width
        # Visibility-age memory feeding map_vis -> map_seen_mask (the probe's
        # seen-mask accuracy); never-seen cells carry the cap value, which the
        # preprocessor thresholds at 500 (reference: minigrid.py:88,168-176).
        self._vis_cap = max(int(max_steps or 0), 500)
        u = self._env.unwrapped
        self._last_seen = np.full((u.grid.width, u.grid.height),
                                  self._vis_cap, np.uint16)
        self.map_centered_size = 2 * self.map_size - 3

    def _compact(self, grid: np.ndarray) -> np.ndarray:
        """(H,W,3) minigrid encoding -> (H,W) compact class ids."""
        obj = grid[..., 0]
        state = grid[..., 2]
        out = np.ones_like(obj)              # default empty
        out[obj == 0] = 0                    # unseen
        out[obj == 1] = 1                    # empty
        out[obj == 2] = 2                    # wall
        out[obj == 3] = 3                    # floor
        out[(obj == 4) & (state == 0)] = 4   # open door
        out[(obj == 4) & (state != 0)] = 5   # closed/locked door
        out[obj == 5] = 6                    # key
        out[obj == 6] = 7                    # ball
        out[obj == 7] = 8                    # box
        out[obj == 8] = 9                    # goal
        out[obj == 9] = 10                   # lava
        out[obj == 10] = 11                  # agent
        return out.astype(np.int64)

    def _obs(self, o) -> dict:
        u = self._env.unwrapped
        image = self._compact(o["image"])
        grid = self._compact(u.grid.encode())
        # obs_vis: the raw view's seen cells (obj id > 0), view coords.
        obs = map_observation(grid, u.agent_pos, int(u.agent_dir),
                              o["image"][..., 0] > 0, self._last_seen,
                              self._vis_cap, self.map_centered_size)
        obs["image"] = image
        obs["agent_pos"] = np.array(u.agent_pos, np.float32)
        obs["agent_dir"] = np.array([np.cos(u.agent_dir * np.pi / 2),
                                     np.sin(u.agent_dir * np.pi / 2)],
                                    np.float32)
        return obs

    def reset(self):
        if self._needs_seed:
            o, _ = self._env.reset(seed=self._seed)
            self._needs_seed = False
        else:
            o, _ = self._env.reset()
        self._last_seen[:] = self._vis_cap
        return self._obs(o)

    def step(self, action):
        o, reward, terminated, truncated, info = self._env.step(int(action))
        info = dict(info)
        if truncated and not terminated:
            info["time_limit"] = True
        return self._obs(o), float(reward), bool(terminated or truncated), info

    def close(self):
        self._env.close()


class MinigridWanderPolicy:
    """Scripted explorer (reference: pydreamer/envs/minigrid.py:221-276):
    walk forward; at obstacles turn towards open space; occasionally random."""

    def __init__(self, random_prob: float = 0.2, seed: int = 0):
        self.random_prob = random_prob
        self.rng = np.random.default_rng(seed)

    def __call__(self, obs) -> Tuple[int, dict]:
        if self.rng.random() < self.random_prob:
            return int(self.rng.integers(3)), {}  # left/right/forward
        image = obs["image"]
        # Agent view: agent at bottom-center facing up; cell ahead is
        # (H-2, W//2) in view coordinates.
        h, w = image.shape[:2]
        ahead = image[h - 2, w // 2]
        blocked = ahead in (2, 5, 10)  # wall, closed door, lava
        if not blocked:
            return 2, {}  # forward
        left = image[h - 1, w // 2 - 1] if w // 2 - 1 >= 0 else 2
        return (0 if left not in (2, 5, 10) else 1), {}  # turn left else right
