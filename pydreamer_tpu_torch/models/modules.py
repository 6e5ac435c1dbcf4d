"""Common NN building blocks with per-op compute-dtype casts.

Counterparts of ``pydreamer_tpu/models/modules.py:26-83``. Parameters are
float32 master copies; each module casts its input and its parameters to the
compute ``dtype`` per op, as the flax modules do with ``dtype=...,
param_dtype=float32``. Every parameter cast of the models goes through
``cast_param``, which counts those that change a dtype
(``tracing.COUNTERS.weight_casts``). LayerNorm uses eps=1e-3 (PyTorch's
default is 1e-5) and, as flax does, computes its statistics and affine map
in float32 before casting the result to the compute dtype.

Submodule names follow the JAX param tree (``Dense_0``, ``Norm_0``, ...) so
that ``convert.py`` maps parameter paths one to one.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..tracing import COUNTERS

__all__ = ["Dense", "Norm", "MLP", "layer_norm", "cast_param", "ACTIVATIONS"]

LN_EPS = 1e-3
# The hidden activation: DreamerV2's ELU, DreamerV3's SiLU.
ACTIVATIONS = {"elu": F.elu, "silu": F.silu}


def cast_param(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The parameter ``p`` in ``dtype``: ``p`` itself where it is in ``dtype``
    already, else a copy, counted in ``COUNTERS.weight_casts``."""
    if p.dtype == dtype:
        return p
    COUNTERS.weight_casts += 1
    return p.to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               dtype: torch.dtype, eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm over the last axis computed in float32, result in ``dtype``."""
    f32 = torch.float32
    y = F.layer_norm(x.float(), (x.shape[-1],), cast_param(weight, f32), cast_param(bias, f32), eps)
    return y.to(dtype)


class Dense(nn.Linear):
    """Linear layer with Xavier-uniform weight / zero bias, cast per op.

    Under a ``model`` axis (``parallel.DistributedContext``) ``weight`` holds
    the rank's rows (output features) and ``tensor_parallel`` runs the
    column-parallel product; the bias stays whole, as JAX keeps its 1-D
    leaves replicated.
    """

    tensor_parallel = None

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        nn.init.xavier_uniform_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        w = cast_param(self.weight, dt)
        b = None if self.bias is None else cast_param(self.bias, dt)
        if self.tensor_parallel is not None:
            return self.tensor_parallel.linear(x.to(dt), w, b)
        return F.linear(x.to(dt), w, b)


class Norm(nn.Module):
    """LayerNorm(eps=1e-3) or identity — the reference's `norm`/`NoNorm` switch.
    ``eps`` 1e-5 gives flax ``nn.LayerNorm``'s default."""

    def __init__(self, dim: int, enabled: bool = True, dtype: torch.dtype = torch.float32,
                 eps: float = LN_EPS):
        super().__init__()
        self.enabled = enabled
        self.compute_dtype = dtype
        self.eps = eps
        if enabled:
            self.weight = nn.Parameter(torch.ones(dim))
            self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.enabled:
            return x
        return layer_norm(x, self.weight, self.bias, self.compute_dtype, self.eps)


class MLP(nn.Module):
    """[Dense -> LayerNorm -> act] x hidden_layers -> Dense(out).

    Applies over the last axis of any-rank input. When ``out_dim == 1`` the
    trailing singleton axis is squeezed. ``act`` names the activation
    (``ACTIVATIONS``); ``hidden_bias`` False drops the bias of the hidden
    Dense layers, which the LayerNorm's offset follows (DreamerV3).
    """

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int = 400,
                 hidden_layers: int = 4, layer_norm: bool = True,
                 dtype: torch.dtype = torch.float32, act: str = "elu",
                 hidden_bias: bool = True):
        super().__init__()
        self.out_dim = out_dim
        self.hidden_layers = hidden_layers
        self.compute_dtype = dtype
        self.act = ACTIVATIONS[act]
        dims = [in_dim] + [hidden_dim] * hidden_layers
        for i in range(hidden_layers):
            self.add_module(f"Dense_{i}", Dense(dims[i], hidden_dim, bias=hidden_bias, dtype=dtype))
            self.add_module(f"Norm_{i}", Norm(hidden_dim, layer_norm, dtype=dtype))
        self.add_module(f"Dense_{hidden_layers}", Dense(dims[-1], out_dim, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        for i in range(self.hidden_layers):
            x = getattr(self, f"Dense_{i}")(x)
            x = self.act(getattr(self, f"Norm_{i}")(x))
        x = getattr(self, f"Dense_{self.hidden_layers}")(x)
        if self.out_dim == 1:
            x = x.squeeze(-1)
        return x
