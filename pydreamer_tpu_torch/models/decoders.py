"""Decoder heads and the multi-head reconstruction loss.

Counterparts of ``pydreamer_tpu/models/decoders.py``: ``ConvDecoder``
(114-166), ``CatImageDecoder`` (169-216), ``DenseBernoulliDecoder``
(219-240), ``DenseNormalDecoder`` with ``vector_head`` (243-277),
``DenseCategoricalSupportDecoder`` (280-302) and ``MultiDecoder`` with
``extra_metrics``, ``reward_terminal`` and ``image_forward`` (305-428).
DreamerV3's heads have no JAX counterpart: ``NormConvDecoder`` (a Dense to
4x4x8d, then transposed convs k4 s2 SAME with channel LayerNorm and SiLU),
the two-hot symlog reward head ``DenseTwoHotDecoder`` and the continue head
(``DenseBernoulliDecoder`` with ``predict_continue``: a Bernoulli on
1 - terminal).

All heads follow the (T,B,I,F) feature layout: the target is broadcast over
the IWAE axis and per-sample losses are aggregated with -logavgexp over I.
Images are (...,H,W,C) at the boundary; the transposed convolutions run NCHW
inside. ``conv_transpose_impl`` chose among XLA lowerings of the same math in
the JAX package; it is accepted and every value maps to ``nn.ConvTranspose2d``.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..tracing import span
from .distributions import (Bernoulli, CategoricalSupport, DiagNormal, Normal, TwoHotSymlog,
                            support_to_categorical)
from .encoders import channel_norm
from .functions import flatten_batch, insert_dim, logavgexp, nanmean, unflatten_batch
from .modules import MLP, Dense, Norm, cast_param

__all__ = ["ConvDecoder", "NormConvDecoder", "CatImageDecoder", "DenseBernoulliDecoder",
           "DenseNormalDecoder", "DenseCategoricalSupportDecoder", "DenseTwoHotDecoder",
           "MultiDecoder"]

TRANSPOSE_IMPLS = ("auto", "xla", "subpixel", "fused")


class ConvTransposeS2(nn.ConvTranspose2d):
    """Stride-2 VALID transposed conv with Xavier-uniform weight, cast per op.

    The weight is PyTorch's (in, out, kh, kw). JAX's ``lax.conv_transpose``
    (``transpose_kernel=False``) correlates the dilated input with its HWIO
    kernel as it is, while ``conv_transpose2d`` correlates with the spatially
    flipped kernel, so ``convert.py`` flips the kernel across frameworks.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dtype=torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=2)
        self.compute_dtype = dtype
        nn.init.xavier_uniform_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv_transpose2d(x.to(dt), cast_param(self.weight, dt), cast_param(self.bias, dt),
                                  stride=2)


class ConvDecoder(nn.Module):
    """Dense(32d) -> reshape (1,1,32d) -> 4x ConvTranspose (k 5,5,6,6, s2)."""

    KERNELS = (5, 5, 6, 6)

    def __init__(self, in_dim: int, out_channels: int = 3, cnn_depth: int = 32,
                 transpose_impl: str = "auto", dtype=torch.float32):
        super().__init__()
        for impl in transpose_impl.split(","):
            if impl.strip() not in TRANSPOSE_IMPLS:
                raise ValueError(f"unknown conv_transpose_impl {impl!r}; options: {TRANSPOSE_IMPLS}")
        self.compute_dtype = dtype
        d = cnn_depth
        self.cnn_depth = d
        self.Dense_0 = Dense(in_dim, d * 32, dtype=dtype)  # no activation (DreamerV2)
        chans = (d * 32, d * 4, d * 2, d, out_channels)
        for i, k in enumerate(self.KERNELS):
            self.add_module(f"deconv_{i}", ConvTransposeS2(chans[i], chans[i + 1], k, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, bd = flatten_batch(x, 1)
        x = self.Dense_0(x.to(self.compute_dtype))
        x = x.reshape(x.shape[0], self.cnn_depth * 32, 1, 1)
        for i in range(len(self.KERNELS)):
            x = getattr(self, f"deconv_{i}")(x)
            if i < 3:
                x = F.elu(x)
        x = x.permute(0, 2, 3, 1).float()
        return unflatten_batch(x, bd)  # (...,H,W,C)

    @staticmethod
    def loss(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """0.5 * sum-of-squares over (H,W,C)."""
        return 0.5 * (output.float() - target.float()).square().sum((-1, -2, -3))

    def training_step(self, features, target):
        """(T,B,I,F),(T,B,H,W,C) -> (loss_tbi, loss_tb, decoded_TBHWC)."""
        I = features.shape[2]
        decoded = self(features)
        loss_tbi = self.loss(decoded, insert_dim(target, 2, I))
        loss_tb = -logavgexp(-loss_tbi, 2)
        return loss_tbi, loss_tb, decoded.mean(2)


class NormConvDecoder(nn.Module):
    """DreamerV3 CNN decoder: Dense(8d*4*4) (with bias, no activation),
    reshaped (4, 4, 8d), then 4x ConvTranspose k4 s2 SAME (4 -> 64), channels
    8d -> 4d -> 2d -> d -> C, with channel LayerNorm and SiLU on all but the
    last, which alone has a bias. The output is the mean image less 0.5, in
    the space of ``prepare_obs``'s images (the source adds 0.5 and compares
    with image / 255: the same squared error). The activations are held
    channels-last, as in ``NormConvEncoder``."""

    def __init__(self, in_dim: int, out_channels: int = 3, cnn_depth: int = 96,
                 image_size: int = 64, dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        d = cnn_depth
        self.minres, self.depth = image_size // 16, 8 * d
        self.Dense_0 = Dense(in_dim, self.minres ** 2 * 8 * d, dtype=dtype)
        chans = (8 * d, 4 * d, 2 * d, d, out_channels)
        for i in range(4):
            last = i == 3
            deconv = nn.ConvTranspose2d(chans[i], chans[i + 1], 4, stride=2, padding=1, bias=last)
            nn.init.xavier_uniform_(deconv.weight)
            self.add_module(f"deconv_{i}", deconv)
            if last:
                nn.init.zeros_(deconv.bias)
            else:
                self.add_module(f"Norm_{i}", Norm(chans[i + 1], dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, bd = flatten_batch(x, 1)
        dt = self.compute_dtype
        x = self.Dense_0(x.to(dt)).reshape(x.shape[0], self.minres, self.minres, self.depth)
        x = x.permute(0, 3, 1, 2)
        for i in range(4):
            deconv = getattr(self, f"deconv_{i}")
            bias = None if deconv.bias is None else cast_param(deconv.bias, dt)
            x = F.conv_transpose2d(x, cast_param(deconv.weight, dt), bias, stride=2, padding=1)
            if i < 3:
                x = F.silu(channel_norm(getattr(self, f"Norm_{i}"), x))
        x = x.permute(0, 2, 3, 1).float()
        return unflatten_batch(x, bd)  # (...,H,W,C)

    @staticmethod
    def loss(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """Sum of squares over (H,W,C): DreamerV3's ``mse`` image distribution."""
        return (output.float() - target.float()).square().sum((-1, -2, -3))

    training_step = ConvDecoder.training_step


class CatImageDecoder(MLP):
    """MLP decoder for categorical images, class axis last: (...,H,W,K) logits."""

    def __init__(self, in_dim: int, out_shape: Tuple[int, int, int], hidden_dim: int = 400,
                 hidden_layers: int = 2, layer_norm: bool = True, min_prob: float = 0.0,
                 dtype=torch.float32):
        super().__init__(in_dim, math.prod(out_shape), hidden_dim, hidden_layers, layer_norm, dtype)
        self.out_shape = tuple(out_shape)
        self.min_prob = min_prob

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, bd = flatten_batch(x, 1)
        x = super().forward(x).reshape((x.shape[0],) + self.out_shape).float()
        return unflatten_batch(x, bd)

    def loss(self, logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """Cross-entropy summed over (H,W); target int (...,H,W) or one-hot."""
        if logits.dim() == target.dim():
            target = torch.argmax(target, -1)
        logp = F.log_softmax(logits, -1)
        if self.min_prob > 0:
            prob = (1.0 - self.min_prob) * logp.exp() + self.min_prob / logits.shape[-1]
            logp = prob.log()
        nll = -logp.gather(-1, target.long().unsqueeze(-1)).squeeze(-1)
        return nll.sum((-1, -2))

    def training_step(self, features, target):
        """Returns (loss_tbi, loss_tb, logits (T,B,H,W,K)): the I samples are
        aggregated in log space and renormalized over the classes."""
        I = features.shape[2]
        logits = self(features)
        loss_tbi = self.loss(logits, insert_dim(target, 2, I))
        loss_tb = -logavgexp(-loss_tbi, 2)
        logits = logits - torch.logsumexp(logits, -1, keepdim=True)
        logits = torch.logsumexp(logits, 2)
        logits = logits - torch.logsumexp(logits, -1, keepdim=True)
        return loss_tbi, loss_tb, logits


class DenseBernoulliDecoder(nn.Module):
    """Terminal-flag head: MLP -> Bernoulli(logits). With ``predict_continue``
    the Bernoulli is of 1 - terminal (DreamerV3's continue head); the target
    handed in stays the terminal flag."""

    def __init__(self, in_dim: int, hidden_dim: int = 400, hidden_layers: int = 2,
                 layer_norm: bool = True, dtype=torch.float32, predict_continue: bool = False,
                 act: str = "elu", hidden_bias: bool = True):
        super().__init__()
        self.predict_continue = predict_continue
        self.model = MLP(in_dim, 1, hidden_dim, hidden_layers, layer_norm, dtype, act, hidden_bias)

    def forward(self, features: torch.Tensor) -> Bernoulli:
        return Bernoulli(self.model(features))

    def terminal(self, features: torch.Tensor) -> torch.Tensor:
        """The dream's terminal flags: the probability of a terminal, or, for
        the continue head, 1 - its mode (DreamerV3 takes the mode)."""
        if self.predict_continue:
            return (self.model(features).float() <= 0).float()
        return self(features).mean

    def training_step(self, features, target):
        I = features.shape[2]
        p = self(features)
        if self.predict_continue:
            target = 1.0 - target
        loss_tbi = -p.log_prob(insert_dim(target, 2, I))
        loss_tb = -logavgexp(-loss_tbi, 2)
        return loss_tbi, loss_tb, p.mean.mean(2)


class DenseTwoHotDecoder(nn.Module):
    """DreamerV3's reward head: MLP -> ``TwoHotSymlog`` over ``bins`` bins.
    Its two-hot work (the target's encoding, the log-softmax, the mean) runs
    in the ``pd.twohot`` span."""

    def __init__(self, in_dim: int, bins: int = 255, hidden_dim: int = 1024,
                 hidden_layers: int = 5, layer_norm: bool = True, dtype=torch.float32,
                 act: str = "silu", hidden_bias: bool = False):
        super().__init__()
        self.model = MLP(in_dim, bins, hidden_dim, hidden_layers, layer_norm, dtype, act,
                         hidden_bias)
        self.register_buffer("bins", TwoHotSymlog.make_bins(bins), persistent=False)

    def forward(self, features: torch.Tensor) -> TwoHotSymlog:
        return TwoHotSymlog(self.model(features), self.bins)

    def mean(self, features: torch.Tensor) -> torch.Tensor:
        logits = self.model(features)
        with span("pd.twohot"):
            return TwoHotSymlog(logits, self.bins).mean

    def training_step(self, features, target):
        I = features.shape[2]
        logits = self.model(features)
        with span("pd.twohot"):
            p = TwoHotSymlog(logits, self.bins)
            loss_tbi = -p.log_prob(insert_dim(target, 2, I))
            mean = p.mean
        loss_tb = -logavgexp(-loss_tbi, 2)
        return loss_tbi, loss_tb, mean.mean(2)


class DenseNormalDecoder(nn.Module):
    """Fixed-sigma gaussian head. sigma = 1/sqrt(2 pi) makes loss == 0.5*MSE.

    With ``vector_head`` the target keeps a trailing event axis even at
    ``out_dim == 1`` (the vecobs head); scalar heads (reward) squeeze it.
    """

    def __init__(self, in_dim: int, out_dim: int = 1, hidden_dim: int = 400,
                 hidden_layers: int = 2, layer_norm: bool = True, std: float = 0.3989422804,
                 vector_head: bool = False, dtype=torch.float32):
        super().__init__()
        self.out_dim = out_dim
        self.std = std
        self.vector_head = vector_head
        self.model = MLP(in_dim, out_dim, hidden_dim, hidden_layers, layer_norm, dtype=dtype)

    def forward(self, features: torch.Tensor):
        y = self.model(features).float()
        if self.out_dim == 1 and self.vector_head:
            y = y.unsqueeze(-1)
        if self.out_dim > 1 or self.vector_head:
            return DiagNormal(y, torch.full_like(y, self.std), event_dims=1)
        return Normal(y, torch.full_like(y, self.std))

    def training_step(self, features, target):
        I = features.shape[2]
        p = self(features)
        loss_tbi = -p.log_prob(insert_dim(target, 2, I)) * (self.std ** 2)  # == 0.5*MSE
        loss_tb = -logavgexp(-loss_tbi, 2)
        return loss_tbi, loss_tb, p.mean.mean(2)


class DenseCategoricalSupportDecoder(nn.Module):
    """Categorical head over a fixed scalar support (reward buckets)."""

    def __init__(self, in_dim: int, support: Sequence[float] = (0.0, 1.0), hidden_dim: int = 400,
                 hidden_layers: int = 2, layer_norm: bool = True, dtype=torch.float32):
        super().__init__()
        self.model = MLP(in_dim, len(support), hidden_dim, hidden_layers, layer_norm, dtype=dtype)
        self.register_buffer("support", torch.tensor(support, dtype=torch.float32),
                             persistent=False)

    def forward(self, features: torch.Tensor) -> CategoricalSupport:
        return CategoricalSupport(self.model(features), self.support)

    def training_step(self, features, target):
        I = features.shape[2]
        p = self(features)
        loss_tbi = -p.log_prob(insert_dim(target, 2, I))
        loss_tb = -logavgexp(-loss_tbi, 2)
        return loss_tbi, loss_tb, p.mean.mean(2)


class MultiDecoder(nn.Module):
    """Weighted multi-head reconstruction (image + vecobs + reward + terminal).

    ``batch_reduce`` (``functions.BatchReduce``, set by a data-parallel
    ``parallel.DistributedContext``) makes the per-bucket ``extra_metrics``
    NaN-skipping means of the whole batch."""

    batch_reduce = None

    def __init__(self, features_dim: int, image_decoder, image_size: int, image_channels: int,
                 cnn_depth: int, image_decoder_layers: int, image_decoder_min_prob: float,
                 reward_decoder_layers: int, terminal_decoder_layers: int,
                 reward_decoder_categorical, vecobs_size: int, image_weight: float = 1.0,
                 vecobs_weight: float = 1.0, reward_weight: float = 1.0,
                 terminal_weight: float = 1.0, transpose_impl: str = "auto",
                 layer_norm: bool = True, dtype=torch.float32, cnn_norm: bool = False,
                 twohot_bins: int = 0, predict_continue: bool = False, mlp_units: int = 400,
                 act: str = "elu", hidden_bias: bool = True):
        super().__init__()
        if image_decoder == "cnn" and cnn_norm:
            self.image = NormConvDecoder(features_dim, image_channels, cnn_depth, image_size,
                                         dtype=dtype)
        elif image_decoder == "cnn":
            self.image = ConvDecoder(features_dim, image_channels, cnn_depth,
                                     transpose_impl=transpose_impl, dtype=dtype)
        elif image_decoder == "dense":
            self.image = CatImageDecoder(features_dim, (image_size, image_size, image_channels),
                                         hidden_layers=image_decoder_layers, layer_norm=layer_norm,
                                         min_prob=image_decoder_min_prob, dtype=dtype)
        elif not image_decoder:
            self.image = None
        else:
            raise ValueError(f"unknown image_decoder {image_decoder!r}")
        if twohot_bins:
            self.reward = DenseTwoHotDecoder(features_dim, twohot_bins, mlp_units,
                                             reward_decoder_layers, layer_norm, dtype, act,
                                             hidden_bias)
        elif reward_decoder_categorical:
            self.reward = DenseCategoricalSupportDecoder(
                features_dim, tuple(reward_decoder_categorical), hidden_dim=mlp_units,
                hidden_layers=reward_decoder_layers, layer_norm=layer_norm, dtype=dtype)
        else:
            self.reward = DenseNormalDecoder(features_dim, hidden_dim=mlp_units,
                                             hidden_layers=reward_decoder_layers,
                                             layer_norm=layer_norm, dtype=dtype)
        self.terminal = DenseBernoulliDecoder(features_dim, mlp_units, terminal_decoder_layers,
                                              layer_norm, dtype, predict_continue, act,
                                              hidden_bias)
        self.vecobs = (DenseNormalDecoder(features_dim, vecobs_size, hidden_layers=4,
                                          layer_norm=layer_norm, vector_head=True, dtype=dtype)
                       if vecobs_size else None)
        self.image_weight = image_weight
        self.vecobs_weight = vecobs_weight
        self.reward_weight = reward_weight
        self.terminal_weight = terminal_weight

    def forward(self, features, obs, extra_metrics: bool = False):
        """Multi-head loss: returns (loss_reconstr_tbi, metrics, tensors).

        ``extra_metrics`` adds the reward loss per reward bucket (per sign
        without the categorical head) and the loss on terminal steps.
        """
        tensors: Dict[str, torch.Tensor] = {}
        metrics: Dict[str, torch.Tensor] = {}
        loss_reconstr = 0.0

        if self.image is not None:
            loss_image_tbi, loss_image, image_rec = self.image.training_step(features, obs["image"])
            loss_reconstr = loss_reconstr + self.image_weight * loss_image_tbi
            metrics["loss_image"] = loss_image.mean().detach()
            tensors["loss_image"] = loss_image.detach()
            tensors["image_rec"] = image_rec.detach()

        if self.vecobs is not None:
            loss_vecobs_tbi, loss_vecobs, vecobs_rec = self.vecobs.training_step(
                features, obs["vecobs"])
            loss_reconstr = loss_reconstr + self.vecobs_weight * loss_vecobs_tbi
            metrics["loss_vecobs"] = loss_vecobs.mean().detach()
            tensors["loss_vecobs"] = loss_vecobs.detach()
            tensors["vecobs_rec"] = vecobs_rec.detach()

        loss_reward_tbi, loss_reward, reward_rec = self.reward.training_step(features, obs["reward"])
        loss_reconstr = loss_reconstr + self.reward_weight * loss_reward_tbi
        metrics["loss_reward"] = loss_reward.mean().detach()
        tensors["loss_reward"] = loss_reward.detach()
        tensors["reward_rec"] = reward_rec.detach()

        loss_terminal_tbi, loss_terminal, terminal_rec = self.terminal.training_step(
            features, obs["terminal"])
        loss_reconstr = loss_reconstr + self.terminal_weight * loss_terminal_tbi
        metrics["loss_terminal"] = loss_terminal.mean().detach()
        tensors["loss_terminal"] = loss_terminal.detach()
        tensors["terminal_rec"] = terminal_rec.detach()

        if extra_metrics:
            reward = obs["reward"]
            if isinstance(self.reward, DenseCategoricalSupportDecoder):
                buckets = support_to_categorical(reward, self.reward.support)
                parts = [(f"reward{i}", loss_reward, buckets == i)
                         for i in range(len(self.reward.support))]
            else:
                parts = [(f"reward{sig}", loss_reward, torch.sign(reward) == sig)
                         for sig in (-1, 1)]
            parts.append(("terminal1", loss_terminal, obs["terminal"] > 0))
            for name, loss, mask in parts:
                mask = mask.float()
                masked = loss.detach() * mask / mask  # nan off the mask
                metrics[f"loss_{name}"] = nanmean(masked, self.batch_reduce)
                tensors[f"loss_{name}"] = masked
        return loss_reconstr, metrics, tensors

    def reward_terminal(self, features):
        """Reward means and terminal flags for imagination rollouts (dream)."""
        reward = (self.reward.mean(features) if isinstance(self.reward, DenseTwoHotDecoder)
                  else self.reward(features).mean)
        return reward, self.terminal.terminal(features)

    def image_forward(self, features):
        """Raw image head output (dream-log decoding)."""
        return self.image(features)
