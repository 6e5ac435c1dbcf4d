"""Seeded weights, made on the device in one draw.

The benchmark makes the weights both sides start from: the names and shapes
come from the reference's own modules, the values from one ``torch.rand``
over all of them on a generator seeded from ``--seed``. A matrix or kernel
is uniform in +-sqrt(6 / (fan_in + fan_out)) (Xavier's range), a vector
(bias, LayerNorm offset) uniform in +-0.1, a LayerNorm scale 1 +- 0.1, so
that every parameter takes part. A critic target starts as a copy of its
critic, as the agent's does.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

__all__ = ["make_weights"]

def _is_scale(name: str) -> bool:
    """A LayerNorm's scale: ``Norm_<i>.weight``, ``<x>_norm.weight`` or ``ln_scale``."""
    if name.endswith("ln_scale"):
        return True
    return name.endswith("weight") and ("Norm_" in name or "_norm." in name)


def _range(name: str, shape) -> tuple:
    """(centre, half-width) of the uniform draw for one parameter."""
    if len(shape) == 1:
        return (1.0, 0.1) if _is_scale(name) else (0.0, 0.1)
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    fan_a, fan_b = shape[0] * receptive, shape[1] * receptive
    return 0.0, math.sqrt(6.0 / (fan_a + fan_b))


def make_weights(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """Weights for ``shapes`` (name -> shape, in the model's order) from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    names = [n for n in shapes if ".critic_target." not in n]
    sizes = [math.prod(shapes[n]) for n in names]
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out = {}
    for name, part in zip(names, flat.split(sizes)):
        centre, half = _range(name, shapes[name])
        out[name] = (part * half + centre).reshape(shapes[name])
    for name in shapes:
        if ".critic_target." in name:
            out[name] = out[name.replace(".critic_target.", ".critic.")].clone()
    return {n: out[n] for n in shapes}
