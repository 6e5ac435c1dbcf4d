"""Probe heads. Only ``probe_model: none`` is ported (probes.py:154-174)."""

from __future__ import annotations

import torch
import torch.nn as nn

__all__ = ["NoProbeHead", "make_probe"]


class NoProbeHead(nn.Module):
    """Dummy probe with one parameter so the probe optimizer has state."""

    def __init__(self):
        super().__init__()
        self.dummy = nn.Parameter(torch.zeros(1))

    def training_step(self, features, obs):
        return self.dummy.square().sum(), {}, {}


def make_probe(conf, features_dim: int, dtype=torch.float32) -> nn.Module:
    if conf.probe_model == "none":
        return NoProbeHead()
    raise NotImplementedError(f"probe_model={conf.probe_model!r} is not ported yet")
