"""The noise both sides sample with, keyed by what it is for.

Every draw ``draw(name, shape, kind, t)`` reseeds one generator on the
device from (run seed, step, name, t), so a draw does not depend on the
order in which a side asks for them: the program and the reference get the
same numbers for the same request. ``kind`` is ``gumbel``, ``normal`` or
``uniform`` (standard noise of that kind).
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence

import torch

__all__ = ["KeyedNoise"]

KINDS = ("gumbel", "normal", "uniform")


class KeyedNoise:
    def __init__(self, seed: int, step: int, device, generator: Optional[torch.Generator] = None,
                 margin: float = 0.0):
        self.seed, self.step, self.device = seed, step, torch.device(device)
        self.generator = generator or torch.Generator(device=self.device)
        self.margin = margin

    def _key(self, name: str, t) -> int:
        text = f"{self.seed}/{self.step}/{name}/{t}".encode()
        return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(), "little") >> 1

    def draw(self, name: str, shape: Sequence[int], kind: str, t: Optional[int] = None):
        if kind not in KINDS:
            raise ValueError(f"unknown noise kind {kind!r}; options: {KINDS}")
        self.generator.manual_seed(self._key(name, t))
        shape = tuple(shape)
        if kind == "normal":
            return torch.randn(shape, generator=self.generator, device=self.device)
        u = torch.rand(shape, generator=self.generator, device=self.device)
        if kind == "uniform":
            return u
        gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))
        if self.margin:
            pick = torch.randint(0, shape[-1], shape[:-1], generator=self.generator,
                                 device=self.device)
            gumbel = gumbel + self.margin * torch.nn.functional.one_hot(pick, shape[-1])
        return gumbel
