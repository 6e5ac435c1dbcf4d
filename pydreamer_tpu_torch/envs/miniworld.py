"""MiniWorld adapter + scripted maze exploration policies.

Counterpart of the reference MiniWorld support (reference: pydreamer/envs/
miniworld.py and envs/__init__.py:25-34): the env comes from gym_miniworld
with its Dict/Map/AgentPos (+ ScavengerHunt goal) wrappers; the scripted
policies generate exploration data for offline probe training:

  * ``MazeBouncingBallPolicy`` — forward until a wall, turn randomly, repeat
    (behavior parity with reference miniworld.py:11-54)
  * ``MazeDijkstraPolicy``     — pick a random reachable map cell, plan the
    shortest action sequence on the continuous pose space, follow it, with
    occasional random kicks (behavior parity with miniworld.py:57-145)
  * ``find_shortest``          — the planner. The reference compiles a
    dict-parent BFS with numba.njit (miniworld.py:148); this is a re-design:
    flat parallel node arrays with integer parent links and integer pose
    keys — dependency-free and fast enough at CPU actor rates.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from ..tools import logger
from .base import Env

__all__ = ["MiniWorld", "MazeBouncingBallPolicy", "MazeDijkstraPolicy",
           "find_shortest", "WALL"]

WALL = 2

# Action ids in miniworld's discrete scheme.
TURN_LEFT, TURN_RIGHT, FORWARD = 0, 1, 2


class MiniWorld(Env):
    """gym_miniworld env with map/agent-pos/goal observation wrappers."""

    def __init__(self, env_id: str, seed: int = 0):
        try:
            import gym
            import gym_miniworld.wrappers as wrap
        except ImportError as e:
            raise ImportError("MiniWorld environments need gym_miniworld; "
                              "not available in this image") from e
        env = gym.make(env_id)
        env = wrap.DictWrapper(env)
        env = wrap.MapWrapper(env)
        env = wrap.AgentPosWrapper(env)
        if env_id.startswith("MiniWorld-ScavengerHunt"):
            env = wrap.GoalPosWrapper(env)
            env = wrap.GoalVisibleWrapper(env)
            env = wrap.GoalVisAgeWrapper(env)
        self._env = env
        from .base import Discrete
        self.action_space = Discrete(int(env.action_space.n), seed=seed)

    def reset(self):
        return self._env.reset()

    def step(self, action):
        return self._env.step(action)

    def close(self):
        self._env.close()


class MazeBouncingBallPolicy:
    """Billiard-ball explorer: drive forward; when the pose stops changing
    (wall hit), make one random left/right turn and drive on."""

    def __init__(self, seed: Optional[int] = None):
        self._last_pos = None
        self.rng = np.random.default_rng(seed)

    def __call__(self, obs) -> Tuple[int, dict]:
        pos = np.asarray(obs["agent_pos"])
        if self._last_pos is not None and np.array_equal(self._last_pos, pos):
            # Bounced off a wall: forget the pose so at least one forward
            # step happens after the turn before re-evaluating.
            self._last_pos = None
            return int(self.rng.choice((TURN_LEFT, TURN_RIGHT))), {}
        self._last_pos = pos
        return FORWARD, {}


class MazeDijkstraPolicy:
    """Scripted maze explorer for offline probe-data collection.

    Every step it (re)plans the shortest action sequence to its current
    target with ``find_shortest`` and emits the first action. Targets are
    random free map cells (``goal_strategy='random'``) or the agent-relative
    goal direction from the env (``'goal_direction'``). Occasional random
    "kicks" de-correlate the trajectories; a pose that stopped matching the
    plan (stuck on geometry the coarse map doesn't model) triggers a short
    random recovery dance.
    """

    _MAX_REPLANS = 25  # re-goal attempts per step before falling back to random

    def __init__(self, step_size: float, turn_size: float,
                 random_prob: float = 0.02, random_steps: int = 5,
                 goal_strategy: str = "random", seed: Optional[int] = None):
        self.step_size = step_size
        self.turn_size = turn_size
        self.random_prob = random_prob
        self.random_steps = random_steps
        self.goal_strategy = goal_strategy
        self.rng = np.random.default_rng(seed)
        self._forget()

    def _forget(self):
        self.goal: Optional[Tuple[float, float]] = None
        self.planned_pose = None  # pose the last emitted action should reach
        self.random_remaining = 0

    def _random_action(self) -> Tuple[int, dict]:
        self.random_remaining = max(self.random_remaining - 1, 0)
        self.planned_pose = None
        return int(self.rng.integers(3)), {}

    def _pick_goal(self, obs) -> Tuple[float, float]:
        if self.goal_strategy == "random":
            free = np.argwhere(np.asarray(obs["map"]) != WALL)
            gx, gy = free[self.rng.integers(len(free))]
            return float(gx), float(gy)
        if self.goal_strategy == "goal_direction":
            # Rotate the agent-relative goal offset into the world frame.
            x, y = obs["agent_pos"]
            dx, dy = obs["agent_dir"]
            norm = max(math.hypot(dx, dy), 1e-8)
            rot = np.array([[dx, -dy], [dy, dx]], np.float64) / norm
            gx, gy = np.array([x, y], np.float64) + rot @ np.asarray(
                obs["goal_direction"], np.float64)
            return float(gx), float(gy)
        raise ValueError(self.goal_strategy)

    def __call__(self, obs) -> Tuple[int, dict]:
        x, y = obs["agent_pos"]
        dx, dy = obs["agent_dir"]
        heading = math.degrees(math.atan2(dy, dx))

        if obs.get("reset"):
            self._forget()

        # Stuck detection: the last action did not land where the plan said.
        if self.planned_pose is not None and not np.allclose(
                self.planned_pose[:2], (x, y), atol=1e-3):
            logger.warning("Pose diverged from plan (stuck?) - random recovery")
            self.random_remaining = self.random_steps

        if self.rng.random() < self.random_prob:
            self.random_remaining = self.random_steps
        if self.random_remaining > 0:
            return self._random_action()

        for _ in range(self._MAX_REPLANS):
            if self.goal is None:
                self.goal = self._pick_goal(obs)
            actions, path, nseen = find_shortest(
                obs["map"], (x, y, heading), self.goal,
                self.step_size, self.turn_size)
            if actions:  # non-empty plan: follow it
                self.planned_pose = path[0]
                return actions[0], {}
            if actions is None:
                logger.warning("No path from (%.2f, %.2f, %.0f) to %s "
                               "(searched %d poses) - new goal",
                               x, y, heading, self.goal, nseen)
            self.goal = None  # reached (empty plan) or unreachable: re-goal
        return self._random_action()


def _blocked(grid: np.ndarray, x: float, y: float, radius: float) -> bool:
    """True if an agent disc at (x, y) would leave the map or overlap a wall
    (disc approximated by its 4 bounding-box corners)."""
    h, w = grid.shape[:2]
    for cx in (x - radius, x + radius):
        for cy in (y - radius, y + radius):
            if not (0.0 <= cx < h and 0.0 <= cy < w):
                return True
            if grid[int(cx), int(cy)] == WALL:
                return True
    return False


def find_shortest(map_: np.ndarray, start: Tuple[float, float, float],
                  goal: Tuple[float, float], step_size: float = 1.0,
                  turn_size: float = 45.0, *, pos_prec: int = 5,
                  agent_radius: float = 0.2, max_nodes: int = 100_000):
    """Shortest action sequence to within one step of ``goal``.

    Breadth-first search over the continuous pose space (x, y, heading°)
    reachable with miniworld's {turn_left, turn_right, forward} actions.
    Poses deduplicate on integer keys at 1/pos_prec spatial and
    1/pos_prec-degree angular resolution; nodes live in flat parallel
    arrays with integer parent links.

    Returns (actions, path, n_seen): ``actions[i]`` leads to pose
    ``path[i]`` (headings reported in [-180, 180]); ``([], [], n)`` when
    already at the goal; ``(None, None, n)`` when unreachable or the search
    exceeded ``max_nodes``.
    """
    gx, gy = float(goal[0]), float(goal[1])
    goal_r2 = step_size * step_size

    def key_of(x: float, y: float, d: float) -> Tuple[int, int, int]:
        return (round(x * pos_prec), round(y * pos_prec),
                round((d % 360.0) * pos_prec))

    # Flat node store in FIFO order: pose arrays + parent/action links.
    xs = [float(start[0])]
    ys = [float(start[1])]
    hs = [float(start[2]) % 360.0]
    parent = [-1]
    via = [-1]
    seen = {key_of(xs[0], ys[0], hs[0])}

    i = 0
    while i < len(xs):
        x, y, d = xs[i], ys[i], hs[i]
        if (x - gx) ** 2 + (y - gy) ** 2 < goal_r2:
            actions, path = [], []
            j = i
            while parent[j] >= 0:
                actions.append(via[j])
                dj = hs[j]
                path.append((xs[j], ys[j], dj - 360.0 if dj > 180.0 else dj))
                j = parent[j]
            actions.reverse()
            path.reverse()
            return actions, path, len(seen)

        fx = x + step_size * math.cos(math.radians(d))
        fy = y + step_size * math.sin(math.radians(d))
        if _blocked(map_, fx, fy, agent_radius):
            fx, fy = x, y  # forward into a wall: pose unchanged
        successors = (
            (x, y, (d - turn_size) % 360.0),   # TURN_LEFT
            (x, y, (d + turn_size) % 360.0),   # TURN_RIGHT
            (fx, fy, d),                       # FORWARD
        )
        for action, (x1, y1, d1) in enumerate(successors):
            k = key_of(x1, y1, d1)
            if k in seen:
                continue
            seen.add(k)
            if len(seen) >= max_nodes:
                return None, None, len(seen)  # runaway search
            xs.append(x1)
            ys.append(y1)
            hs.append(d1)
            parent.append(i)
            via.append(action)
        i += 1

    return None, None, len(seen)
