"""Observation encoders.

Counterparts of ``pydreamer_tpu/models/encoders.py``: ``ConvEncoder`` (4x
Conv k4 s2 VALID + ELU, 90-116), ``DenseEncoder`` (119-142) and
``MultiEncoder`` with the vecobs branch (145-208). Images are
(T,B,H,W,C) at the boundary, as in the JAX package; inside, the convolutions
run NCHW and the last feature map is flattened in (H,W,C) order so that the
embedding matches the JAX layout element for element.

``conv_impl`` chose among XLA lowerings of the same math in the JAX package
(``ops/subpixel.py`` is plain XLA, not a kernel); it is accepted and every
value maps to ``nn.Conv2d``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .functions import flatten_batch, unflatten_batch
from .modules import MLP, cast_param

__all__ = ["ConvEncoder", "DenseEncoder", "MultiEncoder", "ConvS2"]

CONV_IMPLS = ("auto", "xla", "s2d")


class ConvS2(nn.Conv2d):
    """Stride-2 VALID conv with Xavier-uniform weight / zero bias, cast per op."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dtype=torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=2)
        self.compute_dtype = dtype
        # Xavier over the flax (kh,kw,in,out) fan: fan_in=k*k*in, fan_out=k*k*out.
        nn.init.xavier_uniform_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), cast_param(self.weight, dt), cast_param(self.bias, dt), stride=2)


class ConvEncoder(nn.Module):
    """DreamerV2 CNN encoder: 4x [Conv k4 s2 VALID, ELU], flatten.

    For 64x64 input: 64->31->14->6->2 spatial, so out_dim = 2*2*8d = 32d.
    """

    def __init__(self, in_channels: int = 3, cnn_depth: int = 32, conv_impl: str = "auto",
                 dtype=torch.float32):
        super().__init__()
        if conv_impl not in CONV_IMPLS:
            raise ValueError(f"unknown conv_impl {conv_impl!r}; options: {CONV_IMPLS}")
        self.compute_dtype = dtype
        d = cnn_depth
        chans = (in_channels, d, d * 2, d * 4, d * 8)
        for i in range(4):
            self.add_module(f"conv_{i}", ConvS2(chans[i], chans[i + 1], 4, dtype=dtype))
        self.out_dim = cnn_depth * 32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (..., H, W, C) -> (..., 32d)
        x, bd = flatten_batch(x, 3)
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        for i in range(4):
            x = F.elu(getattr(self, f"conv_{i}")(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return unflatten_batch(x, bd)


class DenseEncoder(MLP):
    """Flatten (H,W,C) -> MLP -> ELU (small categorical images)."""

    def __init__(self, in_dim: int, out_dim: int = 256, hidden_dim: int = 400,
                 hidden_layers: int = 2, layer_norm: bool = True, dtype=torch.float32):
        # The JAX module always has its first hidden layer.
        super().__init__(in_dim, out_dim, hidden_dim, max(hidden_layers, 1), layer_norm, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, bd = flatten_batch(x, 3)
        return unflatten_batch(F.elu(super().forward(x.reshape(x.shape[0], -1))), bd)


class MultiEncoder(nn.Module):
    """Image (``cnn`` or ``dense``) and vecobs encoders, embeddings
    concatenated; with ``reward_input`` the reward and terminal are appended
    to the image as two constant planes."""

    def __init__(self, image_encoder, image_size: int, image_channels: int,
                 cnn_depth: int, image_encoder_layers: int, vecobs_size: int,
                 reward_input: bool, conv_impl: str = "auto", layer_norm: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.reward_input = reward_input
        self.image_encoder = image_encoder
        channels = image_channels + (2 if reward_input else 0)
        self.out_dim = 0
        # Named as the JAX param tree names the auto-named flax submodules.
        if image_encoder == "cnn":
            self.ConvEncoder_0 = ConvEncoder(channels, cnn_depth, conv_impl=conv_impl, dtype=dtype)
            self.out_dim += self.ConvEncoder_0.out_dim
        elif image_encoder == "dense":
            self.DenseEncoder_0 = DenseEncoder(image_size * image_size * channels, 256,
                                               hidden_layers=image_encoder_layers,
                                               layer_norm=layer_norm, dtype=dtype)
            self.out_dim += 256
        elif image_encoder:
            raise ValueError(f"unknown image_encoder {image_encoder!r}")
        self.encoder_vecobs = (MLP(vecobs_size, 256, 400, 2, layer_norm, dtype)
                               if vecobs_size else None)
        if vecobs_size:
            self.out_dim += 256
        if self.out_dim == 0:
            raise ValueError("Either image_encoder or vecobs_size must be set")

    def forward(self, obs) -> torch.Tensor:
        embeds = []
        if self.image_encoder:
            image = obs["image"]  # (T,B,H,W,C)
            if self.reward_input:
                T, B, H, W, _ = image.shape
                plane = lambda v: v[:, :, None, None, None].to(image.dtype).expand(T, B, H, W, 1)
                image = torch.cat([image, plane(obs["reward"]), plane(obs["terminal"])], -1)
            enc = self.ConvEncoder_0 if self.image_encoder == "cnn" else self.DenseEncoder_0
            embeds.append(enc(image))
        if self.encoder_vecobs is not None:
            embeds.append(self.encoder_vecobs(obs["vecobs"]))
        return torch.cat(embeds, -1)
