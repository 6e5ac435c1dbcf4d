"""Observation encoders.

Counterparts of ``pydreamer_tpu/models/encoders.py``: ``ConvEncoder`` (4x
Conv k4 s2 VALID + ELU, 90-116), ``DenseEncoder`` (119-142) and
``MultiEncoder`` with the vecobs branch (145-208). ``NormConvEncoder`` is
DreamerV3's (no JAX counterpart): 4x [Conv k4 s2 SAME, channel LayerNorm,
SiLU] down to 4x4. Images are
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
from .modules import MLP, Norm, cast_param

__all__ = ["ConvEncoder", "NormConvEncoder", "DenseEncoder", "MultiEncoder", "ConvS2",
           "channel_norm"]

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


def channel_norm(norm: Norm, x: torch.Tensor) -> torch.Tensor:
    """``norm`` over the channels of an NCHW tensor held channels-last (the
    NHWC view is contiguous, so no copy); the result is held alike."""
    return norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class NormConvEncoder(nn.Module):
    """DreamerV3 CNN encoder: 4x [Conv k4 s2 SAME (no bias), channel
    LayerNorm, SiLU], flatten. For 64x64 input: 64->32->16->8->4 spatial,
    channels d, 2d, 4d, 8d, so out_dim = 4*4*8d = 128d. The activations are
    held channels-last, so each norm reads its pixels' channels in place."""

    def __init__(self, in_channels: int = 3, cnn_depth: int = 96, image_size: int = 64,
                 dtype=torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        d = cnn_depth
        chans = (in_channels, d, d * 2, d * 4, d * 8)
        for i in range(4):
            conv = nn.Conv2d(chans[i], chans[i + 1], 4, stride=2, padding=1, bias=False)
            nn.init.xavier_uniform_(conv.weight)
            self.add_module(f"conv_{i}", conv)
            self.add_module(f"Norm_{i}", Norm(chans[i + 1], dtype=dtype))
        self.out_dim = (image_size // 16) ** 2 * d * 8

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (..., H, W, C) -> (..., (H/16)*(W/16)*8d), flattened in (H, W, C) order
        x, bd = flatten_batch(x, 3)
        dt = self.compute_dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        for i in range(4):
            conv = getattr(self, f"conv_{i}")
            x = F.conv2d(x, cast_param(conv.weight, dt), None, stride=2, padding=1)
            x = F.silu(channel_norm(getattr(self, f"Norm_{i}"), x))
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
    to the image as two constant planes. ``cnn_norm`` takes DreamerV3's
    ``NormConvEncoder`` for ``cnn``."""

    def __init__(self, image_encoder, image_size: int, image_channels: int,
                 cnn_depth: int, image_encoder_layers: int, vecobs_size: int,
                 reward_input: bool, conv_impl: str = "auto", layer_norm: bool = True,
                 dtype=torch.float32, cnn_norm: bool = False):
        super().__init__()
        self.reward_input = reward_input
        self.image_encoder = image_encoder
        channels = image_channels + (2 if reward_input else 0)
        self.out_dim = 0
        # Named as the JAX param tree names the auto-named flax submodules.
        if image_encoder == "cnn" and cnn_norm:
            self.ConvEncoder_0 = NormConvEncoder(channels, cnn_depth, image_size, dtype=dtype)
            self.out_dim += self.ConvEncoder_0.out_dim
        elif image_encoder == "cnn":
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
