"""Structure/shape utilities shared by all models.

Counterparts of ``pydreamer_tpu/models/functions.py:31-120``. Shape
vocabulary: T = sequence length, B = batch, I = IWAE samples, A = action dim,
E = embed dim, F = feature dim (deter + stoch), H = imagination horizon,
M = T*B*I.
"""

from __future__ import annotations

import math
from typing import Iterable, Tuple

import numpy as np
import torch

__all__ = [
    "flatten_batch", "unflatten_batch", "insert_dim", "expand_iwae",
    "logavgexp", "nanmean", "clip_rewards", "clip_rewards_np", "symlog", "symexp",
    "global_norm", "BatchReduce", "batch_mean", "batch_var",
]


def flatten_batch(x: torch.Tensor, nonbatch_dims: int = 1) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """(b1,b2,...,X) -> (B,X); returns folded tensor and the batch shape."""
    if nonbatch_dims > 0:
        batch_dim = tuple(x.shape[:-nonbatch_dims])
        return x.reshape((-1,) + tuple(x.shape[-nonbatch_dims:])), batch_dim
    return x.reshape(-1), tuple(x.shape)


def unflatten_batch(x: torch.Tensor, batch_dim: Tuple[int, ...]) -> torch.Tensor:
    """(B,X) -> (b1,b2,...,X)."""
    return x.reshape(tuple(batch_dim) + tuple(x.shape[1:]))


def insert_dim(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """Insert a broadcast dimension of the given size at `dim`."""
    x = x.unsqueeze(dim)
    shape = list(x.shape)
    shape[dim] = size
    return x.expand(shape)


def expand_iwae(x: torch.Tensor, I: int) -> torch.Tensor:
    """(T,B,...) -> (T,B*I,...): replicate batch for multi-sample IWAE bound."""
    if I == 1:
        return x
    T, B = x.shape[:2]
    x = insert_dim(x, 2, I)
    return x.reshape((T, B * I) + tuple(x.shape[3:]))


def logavgexp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """log(mean(exp(x))) along dim; identity-squeeze when the dim is size 1.

    Computed in float32 for IWAE stability.
    """
    if x.shape[dim] > 1:
        return torch.logsumexp(x.float(), dim=dim) - math.log(x.shape[dim])
    return x.squeeze(dim)


class BatchReduce:
    """Sums a metric's statistics over the ranks that split the batch.

    The metrics that are not means over equal shards of the batch (a mean
    that skips NaNs, a variance) need the sums, counts and moments of the
    whole batch. ``parallel.DistributedContext`` gives each module that
    computes one a ``BatchReduce`` over its ``data`` group and switches it on
    for the train step's forward only (``active``), so an evaluation that one
    rank runs alone reaches no collective.
    """

    def __init__(self, all_reduce_sum):
        self.all_reduce_sum = all_reduce_sum
        self.active = False


def _on(reduce: BatchReduce | None) -> bool:
    return reduce is not None and reduce.active


def nanmean(x: torch.Tensor, reduce: BatchReduce | None = None) -> torch.Tensor:
    """Mean ignoring NaNs (0 when every entry is NaN); over every rank's
    shard when ``reduce`` is on."""
    mask = ~torch.isnan(x)
    if not _on(reduce):
        return torch.nansum(x) / mask.sum().clamp(min=1)
    total, count = reduce.all_reduce_sum(torch.stack([torch.nansum(x), mask.sum().to(x.dtype)]))
    return total / count.clamp(min=1)


def batch_mean(x: torch.Tensor, dim: int | None = None, reduce: BatchReduce | None = None,
               keepdim: bool = False) -> torch.Tensor:
    """``x.mean(dim)`` (every axis when ``dim`` is None), over every rank's
    shard when ``reduce`` is on."""
    dims = tuple(range(x.dim())) if dim is None else (dim,)
    if not _on(reduce):
        return x.mean(dims, keepdim=keepdim)
    total = x.sum(dims, keepdim=keepdim)
    count = math.prod(x.shape[d] for d in dims)
    both = reduce.all_reduce_sum(torch.cat([total.reshape(-1), total.new_full((1,), count)]))
    return (both[:-1] / both[-1]).reshape(total.shape)


def batch_var(x: torch.Tensor, dim: int | None = None,
              reduce: BatchReduce | None = None) -> torch.Tensor:
    """Population variance (``correction=0``, ``jnp.var``) over ``dim`` or all
    axes, two-pass, over every rank's shard when ``reduce`` is on."""
    if not _on(reduce):
        return x.var(dim, correction=0)
    mean = batch_mean(x, dim, reduce, keepdim=True)
    return batch_mean((x - mean).square(), dim, reduce)


def symlog(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log1p(x.abs())


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * (torch.exp(x.abs()) - 1.0)


def clip_rewards(x: torch.Tensor, mode: str | None = None) -> torch.Tensor:
    """Reward squashing: none, ``tanh``, ``log1p`` or ``symlog``."""
    if not mode:
        return x
    if mode == "tanh":
        return torch.tanh(x)
    if mode == "log1p":
        return torch.log1p(x)
    if mode == "symlog":
        return symlog(x)
    raise ValueError(f"unknown clip_rewards mode {mode!r}")


def clip_rewards_np(x, mode: str | None = None):
    """The numpy version, for host-side preprocessing."""
    if not mode:
        return x
    if mode == "tanh":
        return np.tanh(x)
    if mode == "log1p":
        return np.log1p(x)
    if mode == "symlog":
        return np.sign(x) * np.log1p(np.abs(x))
    raise ValueError(f"unknown clip_rewards mode {mode!r}")


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """Global L2 norm of a collection of tensors, in float32."""
    sq = [t.float().square().sum() for t in tensors if t is not None]
    if not sq:
        return torch.zeros(())
    return torch.stack(sq).sum().sqrt()
