"""Noise sources for the train step.

JAX draws its noise from keys (``fold_in(key, step)`` and splits), and
PyTorch cannot reproduce those streams. So the port's train step takes an
explicit noise source with three draws, all standard gumbel for the discrete
latents and the one-hot actor:

* ``posterior_z(shape)``: the posterior-loop latent noise (T, B*I, S, K),
  drawn up front for the whole loop (rssm.py:52-65, 199);
* ``dream_action(t, shape)``: the action noise of dream step t, (M, A);
* ``dream_z(t, shape)``: the prior latent noise of dream step t, (M, S, K).

:class:`GeneratorNoise` draws them from a ``torch.Generator`` on the device;
:class:`ReplayNoise` feeds arrays computed elsewhere (the parity tests replay
the noise JAX draws from its keys).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .distributions import gumbel_from_uniform

__all__ = ["GeneratorNoise", "ReplayNoise"]


class GeneratorNoise:
    """Standard gumbel noise from a ``torch.Generator`` on ``device``."""

    def __init__(self, device: torch.device | str, seed: int = 0):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _gumbel(self, shape: Sequence[int]) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self.generator, device=self.device)
        return gumbel_from_uniform(u)

    def posterior_z(self, shape):
        return self._gumbel(shape)

    def dream_action(self, t: int, shape):
        return self._gumbel(shape)

    def dream_z(self, t: int, shape):
        return self._gumbel(shape)


class ReplayNoise:
    """Replays fixed noise arrays as CPU tensors.

    ``arrays`` holds ``posterior_z`` (T,B*I,S,K), ``dream_action`` (H,M,A) and
    ``dream_z`` (H,M,S,K); each draw checks that the shape asked for matches.
    """

    def __init__(self, arrays: Dict[str, np.ndarray]):
        self.arrays = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in arrays.items()}

    def _get(self, name: str, shape, t: Optional[int] = None) -> torch.Tensor:
        x = self.arrays[name] if t is None else self.arrays[name][t]
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"replayed {name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
        return x

    def posterior_z(self, shape):
        return self._get("posterior_z", shape)

    def dream_action(self, t: int, shape):
        return self._get("dream_action", shape, t)

    def dream_z(self, t: int, shape):
        return self._get("dream_z", shape, t)
