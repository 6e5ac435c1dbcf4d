"""GRU cell family for the RSSM deterministic path.

Counterparts of ``pydreamer_tpu/models/rnn.py:45-164``, with the same type
names:

  * ``gru``                    — plain GRU cell (GRUCell)
  * ``gru_layernorm``          — per-gate LayerNorm GRU (NormGRUCell)
  * ``gru_layernorm_dv2``,
    ``gru_pallas_dv2``         — DreamerV2 late-reset cell through kernel K1
                                 (NormGRUCellLateResetFused -> ops/gru_dv2.py)
  * ``gru_layernorm_dv2_xla``  — the same math unfused (NormGRUCellLateReset)

Gate weights keep the JAX layout, ``weight_ih`` (in, 3H) and ``weight_hh``
(H, 3H) with gate columns in r, u, n order, and the products are ``x @ W``.
That is also the (K, N) row-major layout K1 reads.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.gru_dv2 import gru_dv2, step_weights
from .modules import cast_param, layer_norm

__all__ = ["GRUCell", "NormGRUCell", "NormGRUCellLateReset",
           "NormGRUCellLateResetFused", "GRUCellStack", "make_gru_cell"]


class _GateWeights(nn.Module):
    """Fused ih (Xavier) and hh (orthogonal) gate kernels, stored (in, 3H).

    Under a ``model`` axis (``parallel.DistributedContext``) each kernel holds
    the rank's columns and ``tensor_parallel`` gathers them before the cell
    runs, so every cell, K1 included, sees whole weights."""

    tensor_parallel = None

    def __init__(self, input_size: int, hidden_size: int, use_bias: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.hidden_size = hidden_size
        self.compute_dtype = dtype
        self.weight_ih = nn.Parameter(nn.init.xavier_uniform_(
            torch.empty(3 * hidden_size, input_size)).T.contiguous())
        self.weight_hh = nn.Parameter(nn.init.orthogonal_(
            torch.empty(hidden_size, 3 * hidden_size)))
        if use_bias:
            self.bias_ih = nn.Parameter(torch.zeros(3 * hidden_size))
            self.bias_hh = nn.Parameter(torch.zeros(3 * hidden_size))

    def gate_weights(self, dt: torch.dtype):
        """(W_ih, W_hh) in ``dt``, whole."""
        w_ih, w_hh = cast_param(self.weight_ih, dt), cast_param(self.weight_hh, dt)
        if self.tensor_parallel is not None:
            w_ih, w_hh = (self.tensor_parallel.gather_columns(w) for w in (w_ih, w_hh))
        return w_ih, w_hh


class GRUCell(_GateWeights):
    """Plain GRU cell (same math as torch.nn.GRUCell)."""

    def __init__(self, input_size: int, hidden_size: int, dtype=torch.float32):
        super().__init__(input_size, hidden_size, True, dtype)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        w_ih, w_hh = self.gate_weights(dt)
        gates_i = x.to(dt) @ w_ih + cast_param(self.bias_ih, dt)
        gates_h = h.to(dt) @ w_hh + cast_param(self.bias_hh, dt)
        ri, ui, ni = gates_i.chunk(3, -1)
        rh, uh, nh = gates_h.chunk(3, -1)
        reset = torch.sigmoid(ri + rh)
        update = torch.sigmoid(ui + uh)
        newval = torch.tanh(ni + reset * nh)
        return update * newval + (1.0 - update) * h.to(dt)


class _LN(nn.Module):
    """Parameter holder for a named LayerNorm (JAX path ``<name>/{scale,bias}``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class NormGRUCell(_GateWeights):
    """GRU with per-gate LayerNorm (no gate biases; LN provides the offset)."""

    def __init__(self, input_size: int, hidden_size: int, dtype=torch.float32):
        super().__init__(input_size, hidden_size, False, dtype)
        self.ln_reset = _LN(hidden_size)
        self.ln_update = _LN(hidden_size)
        self.ln_newval = _LN(hidden_size)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        H = self.hidden_size
        w_ih, w_hh = self.gate_weights(dt)
        x, h = x.to(dt), h.to(dt)
        r, u, _ = (x @ w_ih + h @ w_hh).chunk(3, -1)
        ln = lambda m, v: layer_norm(v, m.weight, m.bias, dt)
        reset = torch.sigmoid(ln(self.ln_reset, r))
        update = torch.sigmoid(ln(self.ln_update, u))
        ni = x @ w_ih[:, 2 * H:]
        nh = h @ w_hh[:, 2 * H:]
        newval = torch.tanh(ln(self.ln_newval, ni + reset * nh))
        return update * newval + (1.0 - update) * h


class NormGRUCellLateReset(_GateWeights):
    """DreamerV2 GRU, unfused: fused 3H gates -> one LayerNorm -> late reset."""

    def __init__(self, input_size: int, hidden_size: int, dtype=torch.float32):
        super().__init__(input_size, hidden_size, False, dtype)
        self.lnorm = _LN(3 * hidden_size)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        w_ih, w_hh = self.gate_weights(dt)
        gates = x.to(dt) @ w_ih + h.to(dt) @ w_hh
        gates = layer_norm(gates, self.lnorm.weight, self.lnorm.bias, dt)
        r, u, n = gates.chunk(3, -1)
        reset = torch.sigmoid(r)
        update = torch.sigmoid(u - 1.0)
        newval = torch.tanh(reset * n)
        return update * newval + (1.0 - update) * h.to(dt)


class NormGRUCellLateResetFused(_GateWeights):
    """DreamerV2 late-reset cell through kernel K1 (``ops/gru_dv2.py``).

    Counterpart of ``NormGRUCellLateResetPallas`` (gru_pallas.py:125-164),
    with the same parameter names. On CUDA tensors the step always runs K1
    (the bf16 schedules under ``precision: bfloat16``, the full-f32 schedule
    under ``precision: float32``); on the CPU it runs K1's plain version in
    either dtype. Inside an unroll's ``dw_batches()`` a bf16 step on the card
    whose weights take a gradient reads them once an unroll
    (``step_weights``), and its dW is summed once over the loop.
    """

    def __init__(self, input_size: int, hidden_size: int, dtype=torch.float32):
        super().__init__(input_size, hidden_size, False, dtype)
        self.ln_scale = nn.Parameter(torch.ones(3 * hidden_size))
        self.ln_bias = nn.Parameter(torch.zeros(3 * hidden_size))

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x, h = x.to(dt).contiguous(), h.to(dt).contiguous()
        w_ih, w_hh, batch = step_weights(self, x, (self.weight_ih, self.weight_hh),
                                         lambda: self.gate_weights(dt))
        return gru_dv2(x, h, w_ih, w_hh, self.ln_scale, self.ln_bias, batch).to(dt)


_CELLS = {
    "gru": GRUCell,
    "gru_layernorm": NormGRUCell,
    "gru_layernorm_dv2": NormGRUCellLateResetFused,
    "gru_pallas_dv2": NormGRUCellLateResetFused,
    "gru_layernorm_dv2_xla": NormGRUCellLateReset,
}


def make_gru_cell(cell_type: str, input_size: int, hidden_size: int,
                  dtype=torch.float32) -> nn.Module:
    try:
        cls = _CELLS[cell_type]
    except KeyError:
        raise ValueError(f"Unknown gru_type {cell_type!r}; options: {sorted(_CELLS)}") from None
    return cls(input_size, hidden_size, dtype=dtype)


class GRUCellStack(nn.Module):
    """N stacked GRU cells, each owning hidden_size // N of the state.

    The input feeds layer 0; each layer's output state feeds the next; output
    states are re-concatenated.
    """

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 cell_type: str = "gru", dtype=torch.float32):
        super().__init__()
        if hidden_size % num_layers != 0:
            raise ValueError("hidden_size must be divisible by num_layers")
        self.num_layers = num_layers
        layer_size = hidden_size // num_layers
        for i in range(num_layers):
            self.add_module(f"cell_{i}", make_gru_cell(
                cell_type, input_size if i == 0 else layer_size, layer_size, dtype))

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        states = h.chunk(self.num_layers, -1)
        outs = []
        for i in range(self.num_layers):
            x = getattr(self, f"cell_{i}")(x, states[i])
            outs.append(x)
        return torch.cat(outs, -1)
