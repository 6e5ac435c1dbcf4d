"""The distributions the Dreamer train step uses, on torch tensors.

Counterparts of ``pydreamer_tpu/models/distributions.py``: ``OneHotCategorical``
(49-124), ``DiagNormal``/``Normal`` (127-192), ``Bernoulli`` (195-225) and the
``diag_normal`` constructor (324-328). As there, every distribution parameter is
promoted to float32 whatever the compute dtype, because softmax/KL in bfloat16
loses the precision the KL-balancing gradients depend on.

Sampling takes pre-drawn standard noise (gumbel or normal) instead of a key:
the caller owns the random stream (``models/noise.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["OneHotCategorical", "DiagNormal", "Normal", "Bernoulli", "diag_normal",
           "gumbel_from_uniform"]

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Standard gumbel noise from uniform (0,1) draws: -log(-log(u))."""
    tiny = torch.finfo(u.dtype).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def _sum_events(x: torch.Tensor, event_dims: int) -> torch.Tensor:
    for _ in range(event_dims):
        x = x.sum(-1)
    return x


class OneHotCategorical:
    """(Batched, optionally factorized) one-hot categorical over the last axis.

    With ``event_dims=1``, logits shaped (..., S, K) and log_prob/entropy/kl
    sum over S. ``rsample_noise`` is the straight-through estimator.
    """

    def __init__(self, logits: torch.Tensor, event_dims: int = 0):
        logits = logits.float()
        self.logits = logits - torch.logsumexp(logits, -1, keepdim=True)
        self.event_dims = event_dims

    @property
    def probs(self) -> torch.Tensor:
        return self.logits.exp()

    def log_prob(self, onehot: torch.Tensor) -> torch.Tensor:
        return _sum_events((self.logits * onehot.float()).sum(-1), self.event_dims)

    def entropy(self) -> torch.Tensor:
        return _sum_events(-(self.logits.exp() * self.logits).sum(-1), self.event_dims)

    def sample_noise(self, gumbel: torch.Tensor) -> torch.Tensor:
        """Gumbel-max sample: one_hot(argmax(logits + gumbel))."""
        idx = torch.argmax(self.logits + gumbel, -1)
        return F.one_hot(idx, self.logits.shape[-1]).float()

    def rsample_noise(self, gumbel: torch.Tensor) -> torch.Tensor:
        """Straight-through sample: hard one-hot forward, softmax gradient."""
        sample = self.sample_noise(gumbel)
        probs = self.probs
        return sample + (probs - probs.detach())

    def kl_to(self, other: "OneHotCategorical") -> torch.Tensor:
        kl = (self.logits.exp() * (self.logits - other.logits)).sum(-1)
        return _sum_events(kl, self.event_dims)


class DiagNormal:
    """Independent Normal over the last ``event_dims`` axes."""

    def __init__(self, mean: torch.Tensor, std: torch.Tensor, event_dims: int = 1):
        self.loc = mean.float()
        self.scale = std.float()
        self.event_dims = event_dims

    @property
    def mean(self) -> torch.Tensor:
        return self.loc

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        z = (x.float() - self.loc) / self.scale
        lp = -0.5 * z.square() - self.scale.log() - _HALF_LOG_2PI
        return _sum_events(lp, self.event_dims)

    def entropy(self) -> torch.Tensor:
        return _sum_events(0.5 + _HALF_LOG_2PI + self.scale.log(), self.event_dims)

    def sample_noise(self, eps: torch.Tensor) -> torch.Tensor:
        return self.loc + self.scale * eps

    rsample_noise = sample_noise

    def kl_to(self, other: "DiagNormal") -> torch.Tensor:
        var_ratio = (self.scale / other.scale).square()
        t1 = ((self.loc - other.loc) / other.scale).square()
        return _sum_events(0.5 * (var_ratio + t1 - 1.0 - var_ratio.log()), self.event_dims)


class Normal(DiagNormal):
    """Scalar Normal (no event dims) — decoder heads with out_dim == 1."""

    def __init__(self, mean: torch.Tensor, std: torch.Tensor):
        super().__init__(mean, std, event_dims=0)


class Bernoulli:
    """Bernoulli from logits (terminal-flag decoder head)."""

    def __init__(self, logits: torch.Tensor):
        self.logits = logits.float()

    @property
    def mean(self) -> torch.Tensor:
        return torch.sigmoid(self.logits)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return x.float() * self.logits - F.softplus(self.logits)

    def entropy(self) -> torch.Tensor:
        return F.softplus(self.logits) - self.logits * self.mean


def diag_normal(x: torch.Tensor, min_std: float = 0.1, max_std: float = 2.0) -> DiagNormal:
    """Split last axis into (mean, std_param); std = max*sigmoid(p) + min."""
    mean, std = x.float().chunk(2, -1)
    return DiagNormal(mean, max_std * torch.sigmoid(std) + min_std, event_dims=1)
