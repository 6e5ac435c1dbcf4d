"""The distributions the Dreamer agent uses, on torch tensors.

Counterparts of ``pydreamer_tpu/models/distributions.py``:
``support_to_categorical`` (38-45), ``OneHotCategorical`` (49-124),
``DiagNormal``/``Normal`` (127-192), ``Bernoulli`` (195-225),
``CategoricalSupport`` (228-272), ``TanhNormal`` (275-317), ``TruncNormal``
(345-427) and the constructors ``diag_normal``, ``normal_tanh``, ``tanh_normal``
and ``trunc_normal`` (324-342, 430-434). DreamerV3's (Hafner et al. 2023,
arXiv:2301.04104) add ``unimix`` to ``OneHotCategorical`` and the two-hot
symlog distribution ``TwoHotSymlog``. As there, every distribution
parameter is promoted to float32 whatever the compute dtype, because
softmax/KL in bfloat16 loses the precision the KL-balancing gradients depend
on.

Sampling takes pre-drawn standard noise instead of a key: the caller owns the
random stream (``models/noise.py``). Each class names the kind of noise its
``sample_noise`` takes in ``NOISE``: ``"gumbel"``, ``"normal"`` or, for
``TruncNormal``, ``"uniform"`` on [0, 1), the draw that
``jax.random.truncated_normal`` scales between the bounds' CDF values before
its inverse error function.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["OneHotCategorical", "DiagNormal", "Normal", "Bernoulli", "CategoricalSupport",
           "TanhNormal", "TruncNormal", "diag_normal", "normal_tanh", "tanh_normal",
           "trunc_normal", "support_to_categorical", "gumbel_from_uniform", "TwoHotSymlog",
           "symlog", "symexp", "twohot", "unimix_logits"]

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
_SQRT2 = math.sqrt(2.0)


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Standard gumbel noise from uniform (0,1) draws: -log(-log(u))."""
    tiny = torch.finfo(u.dtype).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def support_to_categorical(target: torch.Tensor, support: torch.Tensor) -> torch.Tensor:
    """Index of the support value nearest to each target (the first on a tie)."""
    return torch.argmin((target.float().unsqueeze(-1) - support.float()).square(), -1)


def _sum_events(x: torch.Tensor, event_dims: int) -> torch.Tensor:
    for _ in range(event_dims):
        x = x.sum(-1)
    return x


def unimix_logits(logits: torch.Tensor, unimix: float) -> torch.Tensor:
    """Normalized log-probabilities of ``(1 - unimix) * softmax + unimix / K``
    over the last axis (DreamerV3's uniform mix)."""
    probs = torch.softmax(logits, -1)
    return torch.log((1.0 - unimix) * probs + unimix / logits.shape[-1])


class OneHotCategorical:
    """(Batched, optionally factorized) one-hot categorical over the last axis.

    With ``event_dims=1``, logits shaped (..., S, K) and log_prob/entropy/kl
    sum over S. ``rsample_noise`` is the straight-through estimator. With
    ``unimix`` the probabilities are mixed with the uniform (DreamerV3).
    """

    NOISE = "gumbel"

    def __init__(self, logits: torch.Tensor, event_dims: int = 0, unimix: float = 0.0):
        logits = logits.float()
        if unimix:
            self.logits = unimix_logits(logits, unimix)
        else:
            self.logits = logits - torch.logsumexp(logits, -1, keepdim=True)
        self.event_dims = event_dims

    @property
    def probs(self) -> torch.Tensor:
        return self.logits.exp()

    mean = probs

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

    NOISE = "normal"

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


class CategoricalSupport:
    """Categorical over a fixed support of scalar values (the categorical
    reward head): ``mean = probs . support``."""

    NOISE = "gumbel"

    def __init__(self, logits: torch.Tensor, support: torch.Tensor):
        logits = logits.float()
        self.logits = logits - torch.logsumexp(logits, -1, keepdim=True)
        self.support = support.float()

    @property
    def probs(self) -> torch.Tensor:
        return self.logits.exp()

    @property
    def mean(self) -> torch.Tensor:
        return (self.probs * self.support).sum(-1)

    def log_prob(self, target: torch.Tensor) -> torch.Tensor:
        idx = support_to_categorical(target, self.support)
        return self.logits.gather(-1, idx.unsqueeze(-1)).squeeze(-1)

    def entropy(self) -> torch.Tensor:
        return -(self.probs * self.logits).sum(-1)

    def sample_noise(self, gumbel: torch.Tensor) -> torch.Tensor:
        return self.support[torch.argmax(self.logits + gumbel, -1)]


class TanhNormal:
    """tanh(Normal) over the last axis. ``entropy()`` is the base normal's
    (the tanh Jacobian term is left out, as in the JAX package)."""

    NOISE = "normal"

    def __init__(self, mean: torch.Tensor, std: torch.Tensor):
        self.base = DiagNormal(mean, std, event_dims=1)

    @property
    def mean(self) -> torch.Tensor:
        return torch.tanh(self.base.mean)

    def sample_noise(self, eps: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.base.sample_noise(eps))

    rsample_noise = sample_noise

    def log_prob(self, y: torch.Tensor) -> torch.Tensor:
        x = torch.atanh(y.float().clamp(-0.999999, 0.999999))
        ldj = 2.0 * (math.log(2.0) - x - F.softplus(-2.0 * x))
        base_lp = (-0.5 * ((x - self.base.loc) / self.base.scale).square()
                   - self.base.scale.log() - _HALF_LOG_2PI)
        return (base_lp - ldj).sum(-1)

    def entropy(self) -> torch.Tensor:
        return self.base.entropy()


def _phi(t: torch.Tensor) -> torch.Tensor:
    return torch.exp(-0.5 * t * t - _HALF_LOG_2PI)


class TruncNormal:
    """Normal truncated to [-1, 1] per dimension (DreamerV2's DMC policy).

    ``sample_noise`` takes uniform [0, 1) draws and turns them into the
    truncated standard normal as ``jax.random.truncated_normal`` does, with
    the bounds detached; the sample is ``clip(loc + scale * eps, -1, 1)`` with
    ``eps`` detached, so the gradient flows through loc and scale only.
    """

    NOISE = "uniform"
    LO, HI = -1.0, 1.0

    def __init__(self, mean: torch.Tensor, std: torch.Tensor):
        self.loc = mean.float()
        self.scale = std.float()

    def _bounds(self):
        return (self.LO - self.loc) / self.scale, (self.HI - self.loc) / self.scale

    def _logz(self) -> torch.Tensor:
        a, b = self._bounds()
        lb, la = torch.special.log_ndtr(b), torch.special.log_ndtr(a)
        return lb + torch.log1p(-torch.exp(la - lb))

    def sample_noise(self, u: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            a, b = self._bounds()
            alpha, beta = torch.erf(a / _SQRT2), torch.erf(b / _SQRT2)
            p = torch.maximum(alpha, u * (beta - alpha) + alpha)
            eps = _SQRT2 * torch.erfinv(p)
            eps = torch.clamp(eps, torch.nextafter(a, torch.full_like(a, math.inf)),
                              torch.nextafter(b, torch.full_like(b, -math.inf)))
        return torch.clamp(self.loc + self.scale * eps, self.LO, self.HI)

    rsample_noise = sample_noise

    @property
    def mean(self) -> torch.Tensor:
        a, b = self._bounds()
        return self.loc + self.scale * (_phi(a) - _phi(b)) / torch.exp(self._logz())

    def log_prob(self, y: torch.Tensor) -> torch.Tensor:
        lp = (-0.5 * ((y.float() - self.loc) / self.scale).square()
              - self.scale.log() - _HALF_LOG_2PI - self._logz())
        return lp.sum(-1)

    def entropy(self) -> torch.Tensor:
        a, b = self._bounds()
        logz = self._logz()
        h = (_HALF_LOG_2PI + 0.5 + self.scale.log() + logz
             + (a * _phi(a) - b * _phi(b)) / (2.0 * torch.exp(logz)))
        return h.sum(-1)


def normal_tanh(x: torch.Tensor, min_std: float = 0.01, max_std: float = 1.0) -> DiagNormal:
    """Normal(tanh(mean), max*sigmoid(p) + min): bounded-mean gaussian policy."""
    mean, std = x.float().chunk(2, -1)
    return DiagNormal(torch.tanh(mean), max_std * torch.sigmoid(std) + min_std, event_dims=1)


def tanh_normal(x: torch.Tensor) -> TanhNormal:
    """tanh(Normal(5 tanh(m/5), softplus(s) + 0.1))."""
    mean, std = x.float().chunk(2, -1)
    return TanhNormal(5.0 * torch.tanh(mean / 5.0), F.softplus(std) + 0.1)


def symlog(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log1p(x.abs())


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.expm1(x.abs())


def twohot(x: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """(..., K) weights on the two bins around each ``x`` (already in the
    bins' space), by the distance to each; a value at or past an end bin
    puts all its weight there (DreamerV3's ``DiscDist.log_prob``)."""
    K = bins.shape[0]
    below = ((bins <= x.unsqueeze(-1)).sum(-1) - 1).clamp(0, K - 1)
    above = (K - (bins > x.unsqueeze(-1)).sum(-1)).clamp(0, K - 1)
    equal = below == above
    to_below = torch.where(equal, torch.ones_like(x), (bins[below] - x).abs())
    to_above = torch.where(equal, torch.ones_like(x), (bins[above] - x).abs())
    total = to_below + to_above
    return (F.one_hot(below, K) * (to_above / total).unsqueeze(-1)
            + F.one_hot(above, K) * (to_below / total).unsqueeze(-1))


class TwoHotSymlog:
    """DreamerV3's reward and critic head: a categorical over ``bins``
    (``linspace(-20, 20, K)``, K = ``BINS`` in DreamerV3) in symlog space. ``mean`` is
    ``symexp(sum(probs * bins))``; ``log_prob(x)`` is the cross-entropy
    against the two-hot of ``symlog(x)``."""

    BINS, LOW, HIGH = 255, -20.0, 20.0

    def __init__(self, logits: torch.Tensor, bins: torch.Tensor):
        logits = logits.float()
        self.logits = logits - torch.logsumexp(logits, -1, keepdim=True)
        self.bins = bins

    @staticmethod
    def make_bins(n: int, device=None) -> torch.Tensor:
        return torch.linspace(TwoHotSymlog.LOW, TwoHotSymlog.HIGH, n, device=device)

    @property
    def mean(self) -> torch.Tensor:
        return symexp((self.logits.exp() * self.bins).sum(-1))

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return (twohot(symlog(x.float()), self.bins) * self.logits).sum(-1)


def trunc_normal(x: torch.Tensor, min_std: float = 0.1) -> TruncNormal:
    """TruncNormal(tanh(m), 2*sigmoid(s/2) + min_std)."""
    mean, std = x.float().chunk(2, -1)
    return TruncNormal(torch.tanh(mean), 2.0 * torch.sigmoid(std / 2.0) + min_std)
