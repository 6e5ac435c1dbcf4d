"""Environment registry: env_id prefix dispatch + universal wrapper stack.

Counterpart of the reference registry (reference: pydreamer/envs/__init__.py:
11-71). Prefixes:

  ``Grid-*`` / ``Counting-*`` — built-in synthetic envs (always available)
  ``MiniGrid-*``  — minigrid package (optional)
  ``Atari-*`` / ``AtariGray-*`` — ALE (optional)
  ``DMC-*``       — dm_control (optional)
  ``DmLab-*`` / ``DMM-*`` / ``MineRL*`` / ``Embodied-*`` — heavyweight SDKs
  anything else   — gymnasium fallback

Wrapper order (identical to reference): OneHotAction -> TimeLimit ->
ActionRewardReset -> Collect.

The port's copy of ``pydreamer_tpu/envs/`` (framework-free numpy code, kept
here so that the port imports nothing of the JAX package). Every SDK is
imported inside the adapter that needs it, so importing this package needs
none of them; ``create_env`` of an SDK prefix raises ``ImportError`` where
the SDK is absent.
"""

from __future__ import annotations

from .base import Box, Discrete, Env, Space, Wrapper
from .fake import BanditEnv, CountingEnv, GridWorld, PointEnv
from .wrappers import (ActionRewardResetWrapper, CollectWrapper, DictWrapper,
                       OneHotActionWrapper, RestartOnExceptionWrapper,
                       TimeLimitWrapper)

__all__ = ["create_env", "Env", "Wrapper", "Space", "Discrete", "Box",
           "BanditEnv", "CountingEnv", "GridWorld", "PointEnv"]


def create_env(env_id: str, no_terminal: bool, env_time_limit: int,
               env_action_repeat: int, worker_id: int) -> Env:

    if env_id.startswith("Grid-"):
        # Grid-8x64 => 8x8 grid rendered at 64px
        parts = env_id.split("-")[1].split("x")
        grid_size = int(parts[0])
        image_size = int(parts[1]) if len(parts) > 1 else 64
        env = GridWorld(grid_size=grid_size, image_size=image_size, seed=worker_id)
        env = DictWrapper(env)

    elif env_id.startswith("Counting-"):
        env = CountingEnv(episode_length=int(env_id.split("-")[1]), seed=worker_id)
        env = DictWrapper(env)

    elif env_id.startswith("Bandit-"):
        # Bandit-3x8 => 3 actions, episode length 8
        parts = env_id.split("-")[1].split("x")
        env = BanditEnv(action_dim=int(parts[0]),
                        episode_length=int(parts[1]) if len(parts) > 1 else 8,
                        seed=worker_id)
        env = DictWrapper(env)

    elif env_id.startswith("Point-"):
        # Point-2x32 => 2-dim action, episode length 32
        parts = env_id.split("-")[1].split("x")
        env = PointEnv(action_dim=int(parts[0]),
                       episode_length=int(parts[1]) if len(parts) > 1 else 32,
                       seed=worker_id)
        env = DictWrapper(env)

    elif env_id.startswith("MiniGrid-"):
        from .minigrid import MiniGrid
        env = MiniGrid(env_id, seed=worker_id)

    elif env_id.startswith("MiniWorld-"):
        from .miniworld import MiniWorld
        env = MiniWorld(env_id, seed=worker_id)

    elif env_id.startswith("Atari-"):
        from .atari import Atari
        env = Atari(env_id.split("-")[1].lower(), action_repeat=env_action_repeat,
                    worker_id=worker_id)

    elif env_id.startswith("AtariGray-"):
        from .atari import Atari
        env = Atari(env_id.split("-")[1].lower(), action_repeat=env_action_repeat,
                    grayscale=True, worker_id=worker_id)

    elif env_id.startswith("DMC-"):
        from .dmc import DMC
        env = DMC(env_id.split("-", maxsplit=1)[1].lower(),
                  action_repeat=env_action_repeat)

    elif env_id.startswith("DmLab-"):
        from .extra import DmLab
        env = DmLab(env_id.split("-", maxsplit=1)[1].lower(),
                    num_action_repeats=env_action_repeat, seed=worker_id)
        env = DictWrapper(env)

    elif env_id.startswith("DMM-"):
        from .extra import DMMEnv
        env = DMMEnv(env_id.split("-", maxsplit=1)[1].lower(),
                     num_action_repeats=env_action_repeat, worker_id=worker_id)
        env = DictWrapper(env)

    elif env_id.startswith("MineRL"):
        from .extra import MineRL
        constr = lambda: MineRL(env_id, action_repeat=env_action_repeat)
        env = RestartOnExceptionWrapper(constr)

    elif env_id.startswith("Embodied-"):
        from .extra import EmbodiedEnv
        task = env_id.split("-", maxsplit=1)[1].lower()
        env = EmbodiedEnv(task, action_repeat=env_action_repeat,
                          time_limit=env_time_limit)
        env_time_limit = 0  # handled inside embodied

    else:
        from .gymnasium_adapter import GymnasiumEnv
        env = GymnasiumEnv(env_id, seed=worker_id)
        env = DictWrapper(env)

    if hasattr(env.action_space, "n"):
        env = OneHotActionWrapper(env)
    if env_time_limit > 0:
        env = TimeLimitWrapper(env, env_time_limit)
    env = ActionRewardResetWrapper(env, no_terminal)
    env = CollectWrapper(env)
    return env
