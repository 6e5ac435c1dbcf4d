"""Decoder heads and the multi-head reconstruction loss.

Counterparts of ``pydreamer_tpu/models/decoders.py``: ``ConvDecoder``
(114-166), ``DenseBernoulliDecoder`` (219-240), ``DenseNormalDecoder``
(243-277) and ``MultiDecoder.__call__``/``reward_terminal`` (305-424).

All heads follow the (T,B,I,F) feature layout: the target is broadcast over
the IWAE axis and per-sample losses are aggregated with -logavgexp over I.
Images are (...,H,W,C) at the boundary; the transposed convolutions run NCHW
inside. ``conv_transpose_impl`` chose among XLA lowerings of the same math in
the JAX package; it is accepted and every value maps to ``nn.ConvTranspose2d``.

Not ported yet (they raise ``NotImplementedError``): ``CatImageDecoder``, the
categorical reward head, the vecobs head and ``extra_metrics``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from .distributions import Bernoulli, DiagNormal, Normal
from .functions import flatten_batch, insert_dim, logavgexp, unflatten_batch
from .modules import MLP, Dense

__all__ = ["ConvDecoder", "DenseBernoulliDecoder", "DenseNormalDecoder", "MultiDecoder"]

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
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), self.bias.to(dt), stride=2)


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


class DenseBernoulliDecoder(nn.Module):
    """Terminal-flag head: MLP -> Bernoulli(logits)."""

    def __init__(self, in_dim: int, hidden_dim: int = 400, hidden_layers: int = 2,
                 layer_norm: bool = True, dtype=torch.float32):
        super().__init__()
        self.model = MLP(in_dim, 1, hidden_dim, hidden_layers, layer_norm, dtype=dtype)

    def forward(self, features: torch.Tensor) -> Bernoulli:
        return Bernoulli(self.model(features))

    def training_step(self, features, target):
        I = features.shape[2]
        p = self(features)
        loss_tbi = -p.log_prob(insert_dim(target, 2, I))
        loss_tb = -logavgexp(-loss_tbi, 2)
        return loss_tbi, loss_tb, p.mean.mean(2)


class DenseNormalDecoder(nn.Module):
    """Fixed-sigma gaussian head. sigma = 1/sqrt(2 pi) makes loss == 0.5*MSE."""

    def __init__(self, in_dim: int, out_dim: int = 1, hidden_dim: int = 400,
                 hidden_layers: int = 2, layer_norm: bool = True, std: float = 0.3989422804,
                 dtype=torch.float32):
        super().__init__()
        self.out_dim = out_dim
        self.std = std
        self.model = MLP(in_dim, out_dim, hidden_dim, hidden_layers, layer_norm, dtype=dtype)

    def forward(self, features: torch.Tensor):
        y = self.model(features).float()
        if self.out_dim > 1:
            return DiagNormal(y, torch.full_like(y, self.std), event_dims=1)
        return Normal(y, torch.full_like(y, self.std))

    def training_step(self, features, target):
        I = features.shape[2]
        p = self(features)
        loss_tbi = -p.log_prob(insert_dim(target, 2, I)) * (self.std ** 2)  # == 0.5*MSE
        loss_tb = -logavgexp(-loss_tbi, 2)
        return loss_tbi, loss_tb, p.mean.mean(2)


class MultiDecoder(nn.Module):
    """Weighted multi-head reconstruction (image + reward + terminal)."""

    def __init__(self, features_dim: int, image_decoder, image_size: int, image_channels: int,
                 cnn_depth: int, image_decoder_layers: int, image_decoder_min_prob: float,
                 reward_decoder_layers: int, terminal_decoder_layers: int,
                 reward_decoder_categorical, vecobs_size: int, image_weight: float = 1.0,
                 vecobs_weight: float = 1.0, reward_weight: float = 1.0,
                 terminal_weight: float = 1.0, transpose_impl: str = "auto",
                 layer_norm: bool = True, dtype=torch.float32):
        super().__init__()
        if image_decoder == "cnn":
            self.image = ConvDecoder(features_dim, image_channels, cnn_depth,
                                     transpose_impl=transpose_impl, dtype=dtype)
        elif not image_decoder:
            self.image = None
        else:
            raise NotImplementedError(f"image_decoder={image_decoder!r} is not ported yet")
        if reward_decoder_categorical:
            raise NotImplementedError("the categorical reward decoder is not ported yet")
        if vecobs_size:
            raise NotImplementedError("the vecobs decoder is not ported yet")
        self.reward = DenseNormalDecoder(features_dim, hidden_layers=reward_decoder_layers,
                                         layer_norm=layer_norm, dtype=dtype)
        self.terminal = DenseBernoulliDecoder(features_dim, hidden_layers=terminal_decoder_layers,
                                              layer_norm=layer_norm, dtype=dtype)
        self.image_weight = image_weight
        self.reward_weight = reward_weight
        self.terminal_weight = terminal_weight

    def forward(self, features, obs, extra_metrics: bool = False):
        """Multi-head loss: returns (loss_reconstr_tbi, metrics, tensors)."""
        if extra_metrics:
            raise NotImplementedError("extra_metrics is not ported yet")
        tensors: Dict[str, torch.Tensor] = {}
        metrics: Dict[str, torch.Tensor] = {}
        loss_reconstr = 0.0

        if self.image is not None:
            loss_image_tbi, loss_image, image_rec = self.image.training_step(features, obs["image"])
            loss_reconstr = loss_reconstr + self.image_weight * loss_image_tbi
            metrics["loss_image"] = loss_image.mean().detach()
            tensors["loss_image"] = loss_image.detach()
            tensors["image_rec"] = image_rec.detach()

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
        return loss_reconstr, metrics, tensors

    def reward_terminal(self, features):
        """Reward/terminal means for imagination rollouts (dream)."""
        return self.reward(features).mean, self.terminal(features).mean
