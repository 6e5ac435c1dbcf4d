"""Common NN building blocks with per-op compute-dtype casts.

Counterparts of ``pydreamer_tpu/models/modules.py:26-83``. Parameters are
float32 master copies; each module casts its input and its parameters to the
compute ``dtype`` per op, as the flax modules do with ``dtype=...,
param_dtype=float32``. Every parameter cast of the models goes through
``cast_param``, which counts those that change a dtype
(``tracing.COUNTERS.weight_casts``).

While ``WeightCopies.serving()`` is open (``TrainStep``'s forward, in the
calling context alone: a context variable), a cast is served by the step's
copy of the parameter instead, made at the first eager step and refreshed
once a step (``WeightCopies.refresh``). A use of a parameter that takes a
gradient then goes through ``CopyUse``, whose backward adds the use's
gradient straight into the parameter's float32 ``.grad``: the same sums in
the same order as the per-call cast's backward (upcast, then autograd's
add), in one pass. Outside it the cast is made per call.

LayerNorm uses eps=1e-3 (PyTorch's default is 1e-5) and, as flax does,
computes its statistics and affine map in float32 before casting the result
to the compute dtype.

Submodule names follow the JAX param tree (``Dense_0``, ``Norm_0``, ...) so
that ``convert.py`` maps parameter paths one to one.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.accumulate import accumulate_
from ..tracing import COUNTERS

__all__ = ["Dense", "Norm", "MLP", "layer_norm", "cast_param", "WeightCopies", "CopyUse",
           "ACTIVATIONS"]

LN_EPS = 1e-3
# The hidden activation: DreamerV2's ELU, DreamerV3's SiLU.
ACTIVATIONS = {"elu": F.elu, "silu": F.silu}


# The copies ``cast_param`` serves, or None.
_SERVING: contextvars.ContextVar = contextvars.ContextVar("weight_copies", default=None)


class WeightCopies:
    """One step's copies of the parameters it reads in another dtype, each
    made at the first such read and allocated once, so that its address is
    fixed for a captured step. ``refresh()`` casts every master into its copy;
    ``serving()`` has ``cast_param`` hand them out. Each cast, made or
    refreshed, counts in ``COUNTERS.weight_casts`` and ``weight_copies``.
    While ``sealed()`` is open (a capture) no copy is made: one made there
    would live in the graph's pool and count in every replay."""

    def __init__(self):
        self.copies: Dict[nn.Parameter, torch.Tensor] = {}
        self.is_sealed = False

    def __len__(self) -> int:
        return len(self.copies)

    @torch.no_grad()
    def refresh(self) -> None:
        """Each copy <- its master, in one foreach pass."""
        if not self.copies:
            return
        torch._foreach_copy_(list(self.copies.values()), list(self.copies))
        COUNTERS.weight_casts += len(self.copies)
        COUNTERS.weight_copies += len(self.copies)

    def get(self, p: nn.Parameter, dtype: torch.dtype) -> torch.Tensor:
        """The copy of ``p`` (in ``dtype``, made at the first call)."""
        copy = self.copies.get(p)
        if copy is None:
            if self.is_sealed:
                raise RuntimeError(f"no step copy of a {tuple(p.shape)} parameter was made "
                                   f"before the capture")
            with torch.no_grad():
                copy = self.copies[p] = p.to(dtype)
            COUNTERS.weight_casts += 1
            COUNTERS.weight_copies += 1
        return copy

    @contextlib.contextmanager
    def serving(self):
        token = _SERVING.set(self)
        try:
            yield self
        finally:
            _SERVING.reset(token)

    @contextlib.contextmanager
    def sealed(self):
        self.is_sealed = True
        try:
            yield self
        finally:
            self.is_sealed = False


class CopyUse(torch.autograd.Function):
    """One use of a parameter's step copy: the copy itself forward (a view, no
    launch); backward, the use's gradient added into the parameter's float32
    ``.grad``, which must exist (``TrainStep`` zeroes it in place before
    ``backward()``), by ``ops.accumulate.accumulate_``, and none passed on to
    autograd. Each use is a node of its own, where the per-call cast's
    ``ToCopyBackward`` was, so the uses' gradients reach ``.grad`` in the
    same order."""

    @staticmethod
    def forward(ctx, p, copy):
        ctx.leaf = p
        return copy

    @staticmethod
    def backward(ctx, grad):
        accumulate_(ctx.leaf.grad, grad)
        return None, None


def cast_param(p: nn.Parameter, dtype: torch.dtype) -> torch.Tensor:
    """The parameter ``p`` in ``dtype``: ``p`` itself where it is in ``dtype``
    already; the step's copy while ``WeightCopies.serving()`` is open, through
    ``CopyUse`` where ``p`` takes a gradient, counted in
    ``COUNTERS.weight_copy_uses``; else a copy made here, counted in
    ``COUNTERS.weight_casts``."""
    if p.dtype == dtype:
        return p
    copies = _SERVING.get()
    if copies is None:
        COUNTERS.weight_casts += 1
        return p.to(dtype)
    copy = copies.get(p, dtype)
    COUNTERS.weight_copy_uses += 1
    return CopyUse.apply(p, copy) if p.requires_grad and torch.is_grad_enabled() else copy


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
