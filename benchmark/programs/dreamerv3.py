"""The port's DreamerV3 agent (``model: dreamerv3``) and its ``TrainStep``, as
the benchmark drives them.

The same adapter as ``programs/dreamer.py``: the model built from the
configuration, loaded with the benchmark's weights, its ``TrainStep`` (the
timed call), what the optimizer holds after the first step, the parameters
and the K1 launch counter. The readings map DreamerV3's loss terms onto the
names ``check.py`` reads: the continue head's loss is ``loss_terminal`` and
``loss_kl`` is the KL term of the loss, ``KL_DYN * dyn + KL_REP * rep``,
each side clipped below at ``KL_FREE`` (the port's constants).

A port without DreamerV3 fails at this module's import, before any work.
"""

from __future__ import annotations

from typing import Dict

import torch
from pydreamer_tpu_torch.models.dreamer import KL_DYN, KL_REP

from .dreamer import Program as DreamerV2Program

__all__ = ["Program"]


class Program(DreamerV2Program):
    def __init__(self, conf: Dict, weights: Dict[str, torch.Tensor], device):
        if conf["model"] != "dreamerv3":
            raise ValueError(f"this adapter runs model: dreamerv3, got {conf['model']!r}")
        super().__init__(conf, weights, device)

    def readings(self, metrics) -> Dict[str, float]:
        out = {k: float(metrics[k]) for k in ("loss_model", "loss_probe", "loss_actor",
                                              "loss_critic", "loss_image", "loss_reward",
                                              "loss_terminal")}
        out["loss_kl"] = KL_DYN * float(metrics["loss_dyn"]) + KL_REP * float(metrics["loss_rep"])
        return out
