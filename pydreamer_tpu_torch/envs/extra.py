"""Optional env adapters for heavyweight SDKs: DmLab, DMM (gRPC), MineRL,
embodied. Import-gated — each raises a clear error if its SDK is absent.

These mirror the reference adapters' data contracts so configs stay portable:
  * ``DmLab``     (reference: pydreamer/envs/dmlab.py) — R2D2 15-action set,
    72x96 RGB center-cropped/resized to 64x64
  * ``DMMEnv``    (reference: pydreamer/envs/dmm.py) — remote DM Memory Tasks
    over dm_env_rpc; server address from TF_CONFIG or env var
  * ``MineRL``    (reference: pydreamer/envs/minerl.py) — crafting enum
    action-set expansion, log1p inventory vecobs
  * ``EmbodiedEnv`` (reference: pydreamer/envs/embodied.py) — danijar
    embodied -> framework adapter
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .base import Discrete, Env

__all__ = ["DmLab", "DMMEnv", "MineRL", "EmbodiedEnv"]

# DMLab R2D2 action set (15 discrete composite actions), as used by the
# reference (dmlab.py:92-134): (look_lr, look_ud, strafe, forward, fire...)
DMLAB_ACTION_SET = (
    (0, 0, 0, 1, 0, 0, 0),    # Forward
    (0, 0, 0, -1, 0, 0, 0),   # Backward
    (0, 0, -1, 0, 0, 0, 0),   # Strafe Left
    (0, 0, 1, 0, 0, 0, 0),    # Strafe Right
    (-10, 0, 0, 0, 0, 0, 0),  # Small Look Left
    (10, 0, 0, 0, 0, 0, 0),   # Small Look Right
    (-60, 0, 0, 0, 0, 0, 0),  # Large Look Left
    (60, 0, 0, 0, 0, 0, 0),   # Large Look Right
    (0, 10, 0, 0, 0, 0, 0),   # Look Down
    (0, -10, 0, 0, 0, 0, 0),  # Look Up
    (-10, 0, 0, 1, 0, 0, 0),  # Forward + Small Look Left
    (10, 0, 0, 1, 0, 0, 0),   # Forward + Small Look Right
    (-60, 0, 0, 1, 0, 0, 0),  # Forward + Large Look Left
    (60, 0, 0, 1, 0, 0, 0),   # Forward + Large Look Right
    (0, 0, 0, 0, 1, 0, 0),    # Fire
)


class DmLab(Env):

    def __init__(self, level: str, num_action_repeats: int = 4,
                 size=(64, 64), seed: Optional[int] = None):
        try:
            import deepmind_lab
        except ImportError as e:
            raise ImportError("DmLab environments need deepmind_lab; "
                              "not available in this image") from e
        self._lab = deepmind_lab.Lab(
            level, ["RGB_INTERLEAVED"],
            config=dict(width="96", height="72",
                        logLevel="WARN", fps="15"))
        self._action_repeat = num_action_repeats
        self._size = size
        self.action_space = Discrete(len(DMLAB_ACTION_SET), seed=seed)

    def _image(self):
        img = self._lab.observations()["RGB_INTERLEAVED"]  # (72,96,3)
        h, w = img.shape[:2]
        off = (w - h) // 2
        img = img[:, off:off + h]  # center crop to square
        # nearest-neighbor resize to target
        idx = (np.linspace(0, h - 1, self._size[0])).astype(int)
        return img[idx][:, idx]

    def reset(self):
        self._lab.reset()
        return np.asarray(self._image())

    def step(self, action):
        raw = np.array(DMLAB_ACTION_SET[int(action)], np.intc)
        reward = self._lab.step(raw, num_steps=self._action_repeat)
        done = not self._lab.is_running()
        obs = self._image() if not done else np.zeros(self._size + (3,), np.uint8)
        return np.asarray(obs), float(reward), done, {}


# DM Memory Tasks discrete action set (reference: dmm.py:34-46).
DMM_ACTION_SET = (
    {"MOVE_BACK_FORWARD": 0, "STRAFE_LEFT_RIGHT": 0, "LOOK_LEFT_RIGHT": 0, "LOOK_DOWN_UP": 0},
    {"MOVE_BACK_FORWARD": +1, "STRAFE_LEFT_RIGHT": 0, "LOOK_LEFT_RIGHT": 0, "LOOK_DOWN_UP": 0},
    {"MOVE_BACK_FORWARD": -1, "STRAFE_LEFT_RIGHT": 0, "LOOK_LEFT_RIGHT": 0, "LOOK_DOWN_UP": 0},
    {"MOVE_BACK_FORWARD": 0, "STRAFE_LEFT_RIGHT": +1, "LOOK_LEFT_RIGHT": 0, "LOOK_DOWN_UP": 0},
    {"MOVE_BACK_FORWARD": 0, "STRAFE_LEFT_RIGHT": -1, "LOOK_LEFT_RIGHT": 0, "LOOK_DOWN_UP": 0},
    {"MOVE_BACK_FORWARD": 0, "STRAFE_LEFT_RIGHT": 0, "LOOK_LEFT_RIGHT": +1, "LOOK_DOWN_UP": 0},
    {"MOVE_BACK_FORWARD": 0, "STRAFE_LEFT_RIGHT": 0, "LOOK_LEFT_RIGHT": -1, "LOOK_DOWN_UP": 0},
    {"MOVE_BACK_FORWARD": +1, "STRAFE_LEFT_RIGHT": 0, "LOOK_LEFT_RIGHT": +1, "LOOK_DOWN_UP": 0},
    {"MOVE_BACK_FORWARD": +1, "STRAFE_LEFT_RIGHT": 0, "LOOK_LEFT_RIGHT": -1, "LOOK_DOWN_UP": 0},
)


class DMMEnv(Env):
    """Remote DeepMind Memory Tasks over gRPC dm_env_rpc
    (reference: pydreamer/envs/dmm.py:67-227). Needs a live env server;
    the address comes from TF_CONFIG worker slots or DMM_SERVER."""

    def __init__(self, level: str, num_action_repeats: int = 1,
                 worker_id: int = 0, address: Optional[str] = None,
                 action_set=DMM_ACTION_SET, size=(64, 64)):
        try:
            import grpc  # noqa: F401
            from dm_env_rpc.v1 import dm_env_adaptor
        except ImportError as e:
            raise ImportError("DMM environments need grpc + dm_env_rpc; "
                              "not available in this image") from e
        import random as _random
        address = address or _dmm_address_from_tf_config(worker_id)
        channel, connection, specs = _dmm_connect(
            level, _random.randint(1, 999999), address)
        self._rpc_env = dm_env_adaptor.DmEnvAdaptor(
            connection, specs, ["RGB_INTERLEAVED"])
        self._channel = channel
        self._num_action_repeats = num_action_repeats
        self._action_set = tuple(action_set)
        self._size = size
        self.action_space = Discrete(len(self._action_set), seed=worker_id)

    def _observation(self, timestep):
        from PIL import Image
        img = timestep.observation["RGB_INTERLEAVED"]
        return np.array(Image.fromarray(img).resize(self._size, Image.NEAREST))

    def reset(self):
        return self._observation(self._rpc_env.reset())

    def step(self, action):
        timestep = None
        reward = 0.0
        for _ in range(self._num_action_repeats):
            timestep = self._rpc_env.step(self._action_set[int(action)])
            reward += timestep.reward or 0.0
            if timestep.last():
                break
        # DMM does not reliably distinguish terminal vs time-limit via
        # discount (reference: dmm.py:119-120); treat done as time-limit so
        # values keep bootstrapping.
        done = timestep.last()
        info = {"time_limit": True} if done else {}
        return self._observation(timestep), reward, done, info

    def close(self):
        self._rpc_env.close()
        self._channel.close()


def _dmm_connect(level_name: str, seed: int, address: str,
                 width: int = 96, height: int = 72,
                 episode_length_seconds: float = 120.0,
                 max_attempts: int = 10):
    """Create world + join over dm_env_rpc (reference: dmm.py:155-227)."""
    import time as _time
    import grpc
    from dm_env_rpc.v1 import connection as rpc_connection
    from dm_env_rpc.v1 import dm_env_rpc_pb2, tensor_utils
    from dm_env_rpc.v1 import error as rpc_error
    from ..tools import logger

    channel = connection = None
    for _ in range(max_attempts):
        channel = grpc.insecure_channel(address)
        try:
            grpc.channel_ready_future(channel).result(timeout=1)
        except grpc.FutureTimeoutError:
            channel.close()
            _time.sleep(1.0)
            continue
        connection = rpc_connection.Connection(channel)
        try:
            connection.send(dm_env_rpc_pb2.StepRequest())
            break  # unexpected success still means reachable
        except rpc_error.DmEnvRpcError:
            break  # server answered with a protocol error: connected
        except grpc.RpcError:
            logger.warning("GRPC problem connecting to %s - retrying", address)
            connection.close()
            channel.close()
            connection = None
            _time.sleep(1.0)
    if connection is None:
        raise ConnectionError(f"Could not connect to DMM env on {address}")

    world_name = connection.send(dm_env_rpc_pb2.CreateWorldRequest(settings={
        "seed": tensor_utils.pack_tensor(seed),
        "episodeId": tensor_utils.pack_tensor(0),
        "levelName": tensor_utils.pack_tensor(level_name),
    })).world_name
    specs = connection.send(dm_env_rpc_pb2.JoinWorldRequest(
        world_name=world_name,
        settings={
            "width": tensor_utils.pack_tensor(width),
            "height": tensor_utils.pack_tensor(height),
            "EpisodeLengthSeconds": tensor_utils.pack_tensor(episode_length_seconds),
        })).specs
    return channel, connection, specs


def _dmm_address_from_tf_config(worker_id: int) -> str:  # noqa: E302
    import json
    tf_config = os.environ.get("TF_CONFIG")
    if tf_config:
        cluster = json.loads(tf_config).get("cluster", {})
        servers = cluster.get("env_server", [])
        if worker_id < len(servers):
            return servers[worker_id]
    return os.environ.get("DMM_SERVER", "localhost:8000")


def _minerl_action(pitch=0, yaw=0, **kwargs):
    action = dict(camera=[pitch, yaw], forward=0, back=0, left=0, right=0,
                  attack=0, sprint=0, jump=0, sneak=0)
    action.update(kwargs)
    return action


# Basic movement/attack action set; crafting enum actions are appended per
# environment (reference: pydreamer/envs/minerl.py:18-31,79-106).
MINERL_BASIC_ACTIONS = (
    _minerl_action(),
    _minerl_action(pitch=-10),
    _minerl_action(pitch=10),
    _minerl_action(yaw=-30),
    _minerl_action(yaw=30),
    _minerl_action(attack=1),
    _minerl_action(forward=1),
    _minerl_action(back=1),
    _minerl_action(left=1),
    _minerl_action(right=1),
    _minerl_action(sprint=1),
    _minerl_action(jump=1, forward=1),
)


class MineRL(Env):
    """MineRL adapter: discrete action set expanded with crafting enums,
    log1p inventory + one-hot equipped-item vecobs components."""

    def __init__(self, env_id: str, action_repeat: int = 1,
                 action_set=MINERL_BASIC_ACTIONS):
        try:
            import gym
            import minerl  # noqa: F401
        except ImportError as e:
            raise ImportError("MineRL environments need the minerl package; "
                              "not available in this image") from e
        self._env = gym.make(env_id)
        self.action_set = self._extend_with_enum_actions(list(action_set))
        self.action_repeat = action_repeat
        self._inv_keys = list(self._env.observation_space["inventory"].spaces)
        self._equip_enum = list(
            self._env.observation_space["equipped_items"]["mainhand"]["type"].values)
        self.action_space = Discrete(len(self.action_set))

    def _observation(self, obs):
        inventory = np.array([obs["inventory"][k] for k in self._inv_keys])
        inventory = np.log1p(inventory.astype(np.float32))
        equipped = np.zeros(len(self._equip_enum), np.float32)
        equipped[self._equip_enum.index(
            obs["equipped_items"]["mainhand"]["type"])] = 1.0
        return {"image": obs["pov"], "inventory": inventory, "equipped": equipped}

    def reset(self):
        return self._observation(self._env.reset())

    def step(self, action):
        act = self.action_set[int(action)]
        reward = 0.0
        done = False
        obs = info = None
        for _ in range(self.action_repeat):
            obs, rew, done, info = self._env.step(act)
            reward += rew
            if done:
                break
        return self._observation(obs), reward, done, dict(info or {})

    def _extend_with_enum_actions(self, action_set):
        """Append one action per non-default crafting-enum value and stamp
        enum defaults into the movement actions (reference: minerl.py:79-106)."""
        action_set = [dict(a) for a in action_set]
        assert all(x in (0, [0, 0]) for x in action_set[0].values()), \
            f"first action should be noop but is {action_set[0]}"
        enums, defaults = {}, {}
        for key, space in self._env.action_space.spaces.items():
            if type(space).__name__ == "Enum":
                enums[key] = list(space.values)
                defaults[key] = space.default
        for action in action_set:
            for key, values in enums.items():
                action[key] = values.index(defaults[key])
        for key, values in sorted(enums.items()):
            for index, value in enumerate(values):
                if value == defaults[key]:
                    continue
                action = dict(action_set[0])
                action[key] = index
                action_set.append(action)
        for action in action_set:
            for key, enum in enums.items():
                action[key] = enum[action[key]]
        return tuple(action_set)


class EmbodiedEnv(Env):

    def __init__(self, task: str, action_repeat: int = 1, time_limit: int = 0):
        try:
            import embodied
        except ImportError as e:
            raise ImportError("Embodied environments need the embodied package; "
                              "not available in this image") from e
        from embodied.envs import load_env
        self._env = load_env(task, repeat=action_repeat, length=time_limit or None)
        acts = self._env.act_space["action"]
        self.action_space = Discrete(acts.high.item()) if acts.discrete else None
        self._done = True

    def reset(self):
        act = {"action": 0, "reset": True}
        ts = self._env.step(act)
        self._done = False
        return self._obs(ts)

    def step(self, action):
        ts = self._env.step({"action": action, "reset": False})
        done = bool(ts["is_last"])
        info = {}
        if done and not ts["is_terminal"]:
            info["time_limit"] = True
        return self._obs(ts), float(ts["reward"]), done, info

    def _obs(self, ts):
        out = {"image": ts["image"]}
        vec = [np.asarray(v, np.float32).reshape(-1)
               for k, v in ts.items()
               if k not in ("image", "reward", "is_first", "is_last", "is_terminal")
               and np.asarray(v).dtype != np.uint8]
        if vec:
            out["vecobs"] = np.concatenate(vec)
        return out
