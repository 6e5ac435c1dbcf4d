"""The port's DreamerV2 agent and its ``TrainStep``, as the benchmark drives them.

From the program the benchmark takes only this: the model built from the
configuration, loaded with the benchmark's weights, its ``TrainStep`` (the
timed call), what the optimizer holds after the first step, the parameters,
and the K1 launch counter.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["Program"]


class Program:
    def __init__(self, conf: Dict, weights: Dict[str, torch.Tensor], device):
        from pydreamer_tpu_torch.conf import Conf
        from pydreamer_tpu_torch.models.dreamer import Dreamer
        from pydreamer_tpu_torch.training.train_step import TrainStep

        self.conf = Conf(conf)
        self.model = Dreamer(self.conf, device=device)
        self.model.load_state_dict(weights, strict=True)
        self.trainstep = TrainStep(self.model, self.conf, device=device)

    def init_state(self, batch_size: int):
        return self.model.init_state(batch_size)

    def step(self, obs, state, step: int, noise=None, seed: int = 0):
        """The timed call: one ``TrainStep``, with the given noise source or,
        without one, the program's own seeded from ``(seed, step)``.
        -> (state, metrics on the device)."""
        state, metrics, _, _ = self.trainstep(obs, state, step, noise=noise, seed=seed)
        return state, metrics

    @staticmethod
    def health(metrics) -> torch.Tensor:
        """A 0-d tensor that is finite where the step went right."""
        return metrics["loss_model"]

    @staticmethod
    def readings(metrics) -> Dict[str, float]:
        keys = ("loss_model", "loss_probe", "loss_actor", "loss_critic", "loss_image",
                "loss_reward", "loss_terminal", "loss_kl")
        return {k: float(metrics[k]) for k in keys}

    def first_grads(self) -> Dict[str, torch.Tensor]:
        """The gradient AdamW took at its first step, from its first moment:
        exp_avg = (1 - beta1) * g (nought for a parameter it never updated)."""
        opt = self.trainstep.optimizer
        names = {id(p): n for n, p in self.model.named_parameters()}
        out = {}
        for group in opt.param_groups:
            beta1 = group["betas"][0]
            for p in group["params"]:
                moment = opt.state[p].get("exp_avg", torch.zeros_like(p))
                out[names[id(p)]] = moment / (1.0 - beta1)
        return out

    def params(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach() for n, p in self.model.named_parameters() if p.requires_grad}

    @staticmethod
    def counters() -> Dict[str, Dict]:
        """K1's launches so far, by rows (M) and by schedule."""
        from pydreamer_tpu_torch.ops.gru_dv2 import LAUNCHES
        return {"k1_by_rows": dict(LAUNCHES.by_rows),
                "k1_by_schedule": dict(LAUNCHES.by_schedule)}
