"""Host-side batch preprocessing: numpy episode data -> model input format.

Counterpart of ``pydreamer_tpu/data/preprocessing.py`` (reference:
pydreamer/preprocessing.py:70-188). Images stay HWC (the layout the port's
encoders take) and uint8 images pass through to the card unchanged:
``models/dreamer.py::prepare_obs`` scales them there, so the host neither
converts nor moves four times the bytes.

Transformations:
  * float image -> float32; categorical image -> one-hot (class axis last)
  * discrete action ints -> one-hot float32
  * reward clip (tanh / log1p / symlog)
  * map / map_coord / map_seen_mask assembly; MineRL inventory+equipped ->
    vecobs concat; goals features reshaped
  * removes the policy columns logged by the actor
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..models.functions import clip_rewards_np
from ..tools import print_once

__all__ = ["Preprocessor", "to_onehot", "to_image"]


def to_onehot(x: np.ndarray, n_categories: int) -> np.ndarray:
    e = np.eye(n_categories, dtype=np.float32)
    return e[x]


def to_image(x: np.ndarray) -> np.ndarray:
    """RGB image -> model input: uint8 passes through (scaled on the card),
    float images (already in [0, 1]) become float32."""
    if x.dtype == np.uint8:
        return x
    assert 0.0 <= x.reshape(-1)[0] <= 1.0
    return x.astype(np.float32)


def _remove_keys(data: dict, keys):
    for key in keys:
        data.pop(key, None)


class Preprocessor:

    def __init__(self,
                 image_key: str = "image",
                 map_key: Optional[str] = None,
                 image_categorical: Optional[int] = None,
                 map_categorical: Optional[int] = None,
                 action_dim: int = 0,
                 clip_rewards: Optional[str] = None):
        self.image_key = image_key
        self.image_categorical = image_categorical
        self.map_key = map_key
        self.map_categorical = map_categorical
        self.action_dim = action_dim
        self.clip_rewards = clip_rewards

    @classmethod
    def from_conf(cls, conf) -> "Preprocessor":
        return cls(image_key=conf.image_key,
                   map_key=conf.map_key,
                   image_categorical=conf.image_channels if conf.image_categorical else None,
                   map_categorical=conf.map_channels if conf.map_categorical else None,
                   action_dim=conf.action_dim,
                   clip_rewards=conf.clip_rewards)

    def __call__(self, iterator):
        for batch in iterator:
            yield self.apply(batch)

    def apply(self, batch: Dict[str, np.ndarray], expandTB: bool = False
              ) -> Dict[str, np.ndarray]:
        batch = dict(batch)
        print_once("Preprocess batch (before):",
                   {k: v.shape + (v.dtype.name,) for k, v in batch.items()})

        if expandTB:
            batch = {k: v[np.newaxis, np.newaxis] for k, v in batch.items()}

        # Policy columns logged by the actor are diagnostics, not model input.
        _remove_keys(batch, ["policy_value", "policy_entropy", "action_prob"])

        T, B = batch["reward"].shape[:2]

        if self.image_key:
            image = batch[self.image_key]
            if self.image_categorical:
                batch["image"] = to_onehot(image, self.image_categorical)
            else:
                batch["image"] = to_image(image)

        if self.map_key:
            map_ = batch[self.map_key]
            if self.map_categorical:
                # Categorical maps stay int indices: the categorical decoder
                # consumes class indices directly.
                batch["map"] = map_.astype(np.int32)
            else:
                batch["map"] = to_image(map_)
            _remove_keys(batch, ["map_centered"])

        if "map_seen" in batch:
            batch["map_seen_mask"] = (batch.pop("map_seen") > 0).astype(np.float32)
        elif "map_vis" in batch:
            batch["map_seen_mask"] = (batch.pop("map_vis") < 500).astype(np.float32)

        for key in ("action", "action_next"):
            if key in batch:
                if batch[key].ndim == 2:
                    batch[key] = to_onehot(batch[key].astype(np.int64), self.action_dim)
                assert batch[key].ndim == 3
                batch[key] = batch[key].astype(np.float32)

        batch["terminal"] = batch.get("terminal", np.zeros((T, B))).astype(np.float32)
        batch["reward"] = batch.get("reward", np.zeros((T, B))).astype(np.float32)
        batch["reward"] = clip_rewards_np(batch["reward"], self.clip_rewards)
        batch["reset"] = batch.get("reset", np.zeros((T, B))).astype(bool)

        if "agent_pos" in batch and "agent_dir" in batch and "map" in batch:
            map_size = float(batch["map"].shape[-1 if self.map_categorical else -2])
            agent_pos = batch["agent_pos"] / map_size * 2 - 1.0
            batch["map_coord"] = np.concatenate(
                [agent_pos, batch["agent_dir"]], axis=-1).astype(np.float32)

        if "vecobs" in batch:
            batch["vecobs"] = batch["vecobs"].astype(np.float32)
        elif "inventory" in batch and "equipped" in batch:
            batch["vecobs"] = np.concatenate([
                batch["inventory"].astype(np.float32),
                batch["equipped"].astype(np.float32)], axis=-1)

        if "targets_vec" in batch:
            batch["goals_direction"] = batch["targets_vec"].reshape(
                batch["targets_vec"].shape[:-2] + (-1,)).astype(np.float32)
        if "target_vec" in batch:
            batch["goal_direction"] = batch["target_vec"].astype(np.float32)

        print_once("Preprocess batch (after):",
                   {k: v.shape + (v.dtype.name,) for k, v in batch.items()})
        return batch
