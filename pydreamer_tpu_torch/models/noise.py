"""Noise sources for the train step and the acting step.

JAX draws its noise from keys (``fold_in(key, step)`` and splits), and
PyTorch cannot reproduce those streams. So the port's entry points take an
explicit noise source. Every draw is ``draw(name, shape, kind, t=None)``:
``kind`` is the distribution's ``NOISE`` (``"gumbel"``, ``"normal"`` or
``"uniform"``, see ``models/distributions.py``) and ``t`` the step of a
rollout. The names, in the order ``Dreamer`` asks for them, then the baselines':

* ``posterior_z``: the posterior-loop latent noise (T, B*I, S, K), drawn up
  front for the whole loop (rssm.py:52-65, 199); gumbel for discrete latents,
  normal otherwise;
* ``pred_z``: the prior sample of ``do_image_pred`` (T, B, I, S, K);
* ``dream_action`` / ``dream_z``: the action and prior-latent noise of dream
  step t, (M, A) and (M, S, K);
* ``log_action`` / ``log_z``: the same for the ``do_dream_tensors`` rollout
  (T-1 steps at M = B);
* ``action``: the action noise of ``Dreamer.inference``, (1, B, A);
* ``embed_z`` / ``embed_pred_z``: the baselines' VAE (``models/baselines.py``):
  the standard normal of its posterior sample and, under ``do_image_pred``,
  of its prior sample, (T, B, I, S) each.

:class:`GeneratorNoise` draws them from a ``torch.Generator`` on the device;
:class:`ReplayNoise` feeds arrays computed elsewhere (the parity tests replay
the noise JAX draws from its keys).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .distributions import gumbel_from_uniform

__all__ = ["GeneratorNoise", "ReplayNoise", "NOISE_KINDS"]

NOISE_KINDS = ("gumbel", "normal", "uniform")


class GeneratorNoise:
    """Standard noise of each kind from a ``torch.Generator`` on ``device``."""

    def __init__(self, device: torch.device | str, seed: int = 0):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def draw(self, name: str, shape: Sequence[int], kind: str,
             t: Optional[int] = None) -> torch.Tensor:
        shape = tuple(shape)
        if kind == "normal":
            return torch.randn(shape, generator=self.generator, device=self.device)
        u = torch.rand(shape, generator=self.generator, device=self.device)
        if kind == "uniform":
            return u
        if kind == "gumbel":
            return gumbel_from_uniform(u)
        raise ValueError(f"unknown noise kind {kind!r}; options: {NOISE_KINDS}")


class ReplayNoise:
    """Replays fixed noise arrays as CPU tensors.

    ``arrays[name]`` holds the whole draw, or for a rollout (``t`` given) all
    its steps stacked on a leading axis; each draw checks that the shape asked
    for matches. The kind is the caller's business: the arrays hold it.
    """

    def __init__(self, arrays: Dict[str, np.ndarray]):
        self.arrays = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in arrays.items()}

    def draw(self, name: str, shape: Sequence[int], kind: str,
             t: Optional[int] = None) -> torch.Tensor:
        x = self.arrays[name] if t is None else self.arrays[name][t]
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"replayed {name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
        return x
