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

:class:`DataShardNoise` is the draw of one rank of a ``data`` axis
(``parallel/``). JAX draws every array at its global shape from one key and
shards it, so a mesh step draws what a single-device step draws. The wrapper
does the same over any source: it asks the inner source for the global shape
and returns the rows of its data index. The batch axis of each name, with
B, M the rank's sizes and n the data ranks:

========================== ==================== =========================
name                       local shape          rank d's rows of the draw
========================== ==================== =========================
``posterior_z``            (T, B*I, S, K)       axis 1, [d*B*I, (d+1)*B*I)
``pred_z``                 (T, B, I, S, K)      axis 1, [d*B, (d+1)*B)
``embed_z``,
``embed_pred_z``           (T, B, I, S)         axis 1, [d*B, (d+1)*B)
``action``                 (1, B, A)            axis 1, [d*B, (d+1)*B)
``log_action``, ``log_z``  (B, ...) at each t   axis 0, [d*B, (d+1)*B)
``dream_action``,
``dream_z``                (M, ...) at each t   M = T*B*I flattened t-major:
                                                the global draw as
                                                (T, n*B*I, ...), axis 1
                                                [d*B*I, (d+1)*B*I), so not
                                                one block of the global M
========================== ==================== =========================

A ``GeneratorNoise`` seeded alike on every rank then gives exactly the
single-process noise, and ranks of one ``model`` group draw the same rows;
a ``ReplayNoise`` of JAX's global arrays gives exactly JAX's mesh noise.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .distributions import gumbel_from_uniform

__all__ = ["GeneratorNoise", "ReplayNoise", "DataShardNoise", "NOISE_KINDS"]

NOISE_KINDS = ("gumbel", "normal", "uniform")


class GeneratorNoise:
    """Standard noise of each kind from a ``torch.Generator`` on ``device``,
    seeded with ``seed``: a new one, or ``generator`` (one that CUDA graphs
    hold, ``training/train_step.py``), reseeded."""

    def __init__(self, device: torch.device | str, seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        self.device = torch.device(device)
        self.generator = (generator or torch.Generator(device=self.device)).manual_seed(seed)

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


# The batch axis of each draw's local shape (table above); the dream's rows
# are t-major blocks of the rank's TBTT streams.
_BATCH_AXIS = {"posterior_z": 1, "pred_z": 1, "embed_z": 1, "embed_pred_z": 1, "action": 1,
               "log_action": 0, "log_z": 0}
_DREAM = ("dream_action", "dream_z")


class DataShardNoise:
    """Rank ``index`` of ``count`` data ranks: the rows of the global draw of
    ``inner`` that belong to it (the module docstring's table). ``streams``
    is the rank's TBTT streams, B*I, the rows of each dream step."""

    def __init__(self, inner, index: int, count: int, streams: int):
        self.inner, self.index, self.count, self.streams = inner, index, count, streams

    def draw(self, name: str, shape: Sequence[int], kind: str,
             t: Optional[int] = None) -> torch.Tensor:
        shape = tuple(shape)
        if name in _DREAM:
            steps, rest = shape[0] // self.streams, shape[1:]
            if steps * self.streams != shape[0]:
                raise ValueError(f"{name}: {shape[0]} rows are not whole steps of "
                                 f"{self.streams} streams")
            full = self.inner.draw(name, (self.count * shape[0],) + rest, kind, t)
            full = full.reshape((steps, self.count * self.streams) + rest)
            return full.narrow(1, self.index * self.streams, self.streams).reshape(shape)
        try:
            axis = _BATCH_AXIS[name]
        except KeyError:
            raise KeyError(f"no batch axis known for noise {name!r}") from None
        glob = shape[:axis] + (self.count * shape[axis],) + shape[axis + 1:]
        full = self.inner.draw(name, glob, kind, t)
        return full.narrow(axis, self.index * shape[axis], shape[axis])
