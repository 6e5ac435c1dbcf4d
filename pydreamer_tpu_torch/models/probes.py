"""Probe heads: diagnostic decoders on world-model features.

Counterparts of ``pydreamer_tpu/models/probes.py``: ``MapProbeHead``
(32-77), ``GoalsProbe`` (80-134), ``MapGoalsProbe`` (137-151), ``NoProbeHead``
(154-161) and ``make_probe`` (164-174). Each probe is an ``nn.Module`` with
``training_step(features, obs) -> (loss, metrics, tensors)``; the caller
detaches the features unless ``probe_gradients`` is on.

Module names follow the JAX params tree, so ``convert.py`` maps them with its
usual rules: the map probe *is* its decoder (``probe/Dense_0/...``, or
``probe/map/Dense_0/...`` inside ``map+goals``), the goals probe holds
``goal_direction`` and ``goals_direction``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from .decoders import CatImageDecoder, DenseNormalDecoder
from .functions import batch_var, insert_dim, nanmean

__all__ = ["MapProbeHead", "GoalsProbe", "MapGoalsProbe", "NoProbeHead", "make_probe"]


class MapProbeHead(CatImageDecoder):
    """Predict the global map from the features and the 4-dim ``map_coord``.
    ``batch_reduce``: as ``decoders.MultiDecoder``'s, for the accuracies."""

    batch_reduce = None

    def __init__(self, map_state_dim: int, conf, dtype=torch.float32):
        if conf.map_decoder != "dense":
            raise NotImplementedError(f"map_decoder={conf.map_decoder}")
        super().__init__(map_state_dim, (conf.map_size, conf.map_size, conf.map_channels),
                         hidden_dim=conf.map_hidden_dim, hidden_layers=conf.map_hidden_layers,
                         layer_norm=conf.layer_norm, dtype=dtype)

    def training_step(self, features, obs):
        I = features.shape[2]
        map_coord = insert_dim(obs["map_coord"], 2, I).to(features.dtype)
        _, loss, map_pred = super().training_step(torch.cat([features, map_coord], -1),
                                                  obs["map"])
        map_pred = map_pred.detach()
        acc_map = self.accuracy(map_pred, obs["map"])
        tensors = dict(map_rec=map_pred, loss_map=loss.detach(), acc_map=acc_map)
        metrics = dict(loss_map=loss.mean().detach(), acc_map=nanmean(acc_map, self.batch_reduce))
        if "map_seen_mask" in obs:
            metrics["acc_map_seen"] = nanmean(
                self.accuracy(map_pred, obs["map"], obs["map_seen_mask"]), self.batch_reduce)
        return loss.mean(), metrics, tensors

    @staticmethod
    def accuracy(output, target, map_seen_mask=None):
        """Per-(T,B) pixel accuracy; the class axis is last."""
        if output.dim() == target.dim():
            target = torch.argmax(target, -1)
        acc = (torch.argmax(output, -1) == target).float()
        if map_seen_mask is None:
            return acc.mean((-1, -2))
        m = map_seen_mask.float()
        return (acc * m).sum((-1, -2)) / m.sum((-1, -2))


class GoalsProbe(nn.Module):
    """Predict goal directions; MSE metrics bucketed by goal visibility age.
    ``batch_reduce``: as ``decoders.MultiDecoder``'s, for ``var_goals`` and
    the buckets."""

    batch_reduce = None

    LOG_RANGES = (-1, 0, 5, 10, 50, 200, 1000)
    NAMES = ("goal_direction", "goals_direction")

    def __init__(self, state_dim: int, conf, dtype=torch.float32):
        super().__init__()
        self.goal_direction = DenseNormalDecoder(state_dim, out_dim=2, hidden_layers=4,
                                                 layer_norm=True, dtype=dtype)
        self.goals_direction = DenseNormalDecoder(state_dim, out_dim=conf.goals_size * 2,
                                                  hidden_layers=4, layer_norm=True, dtype=dtype)

    def training_step(self, features, obs):
        loss_total = 0.0
        metrics: Dict[str, torch.Tensor] = {}
        tensors: Dict[str, torch.Tensor] = {}
        for name in self.NAMES:
            _, loss, pred = getattr(self, name).training_step(features, obs[name])
            loss_total = loss_total + loss.mean()
            metrics[f"loss_{name}"] = loss.mean().detach()
            tensors[f"loss_{name}"] = loss.detach()
            tensors[f"{name}_pred"] = pred.detach()

        goals = obs["goals_direction"]
        pred = tensors["goals_direction_pred"]
        mse_per_coord = (goals - pred).square()                          # (T,B,2G)
        mse_per_goal = mse_per_coord.reshape(mse_per_coord.shape[:-1] + (-1, 2)).sum(-1)
        metrics["mse_goals"] = mse_per_goal.mean(-1).mean()
        var_per_coord = batch_var(goals.reshape(-1, goals.shape[-1]), 0, self.batch_reduce)
        metrics["var_goals"] = var_per_coord.reshape(-1, 2).sum(-1).mean()

        visage = obs.get("goals_visage")
        if visage is not None:
            for i in range(1, len(self.LOG_RANGES)):
                vmin, vmax = self.LOG_RANGES[i - 1] + 1, self.LOG_RANGES[i]
                mask = ((vmin <= visage) & (visage <= vmax)).float()
                metrics[f"mse_goal_age{vmax}"] = nanmean(mse_per_goal * mask / mask,
                                                         self.batch_reduce)
        return loss_total, metrics, tensors


class MapGoalsProbe(nn.Module):
    """``MapProbeHead`` and ``GoalsProbe`` together."""

    def __init__(self, state_dim: int, conf, dtype=torch.float32):
        super().__init__()
        self.map = MapProbeHead(state_dim + 4, conf, dtype)
        self.goals = GoalsProbe(state_dim, conf, dtype)

    def training_step(self, features, obs):
        loss_m, met_m, ten_m = self.map.training_step(features, obs)
        loss_g, met_g, ten_g = self.goals.training_step(features, obs)
        return loss_m + loss_g, {**met_m, **met_g}, {**ten_m, **ten_g}


class NoProbeHead(nn.Module):
    """Dummy probe with one parameter so the probe optimizer has state."""

    def __init__(self):
        super().__init__()
        self.dummy = nn.Parameter(torch.zeros(1))

    def training_step(self, features, obs):
        return self.dummy.square().sum(), {}, {}


def make_probe(conf, features_dim: int, dtype=torch.float32) -> nn.Module:
    if conf.probe_model == "map":
        return MapProbeHead(features_dim + 4, conf, dtype)
    if conf.probe_model == "goals":
        return GoalsProbe(features_dim, conf, dtype)
    if conf.probe_model == "map+goals":
        return MapGoalsProbe(features_dim, conf, dtype)
    if conf.probe_model == "none":
        return NoProbeHead()
    raise NotImplementedError(f"Unknown probe_model={conf.probe_model}")
