"""The error budget of K1's float32 schedules, on the CPU.

``skinny_f32`` and ``wide_f32`` (``pydreamer_tpu_torch/ops/csrc/gru_dv2.cu``)
run only on the card. They compute the gate products in 3xTF32: each f32
operand v is split into ``hi = tf32(v)`` and ``lo = tf32(v - hi)``, both
rounded to nearest with ties away from zero (``cvt.rna.tf32.f32``), and each
8-deep k step adds ``a_lo.b_hi``, then ``a_hi.b_lo``, then ``a_hi.b_hi`` to
f32 accumulators. ``skinny_f32`` does so per block of ``kc`` weight rows and
``ln_gate_kernel`` sums the blocks' partial gates in order; ``wide_f32``
walks all of K in one accumulator. A torch emulation of that arithmetic,
with the K split of ``plan``, is held here against JAX's ``_reference_math``
in f32 at the flagship width (In=1000, H=1024), inside the tolerance that
chip_smoke.py holds the kernels to on the card, with a margin. One TF32 pass
(``a_hi.b_hi`` alone) is shown to miss that tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydreamer_tpu.ops.gru_pallas import _reference_math
from pydreamer_tpu_torch.ops import gru_dv2 as k1

FWD_TOL_F32 = 1e-4  # chip_smoke.py: max-abs on h' for f32 operands
MARGIN = 10         # the emulated 3xTF32 stays this far inside FWD_TOL_F32
IN, H = 1000, 1024


def tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 explicit mantissa bits) to nearest, ties away
    from zero, on the bit pattern, as ``cvt.rna.tf32.f32`` does: add half of
    the dropped 13 bits' range to the magnitude, then clear them."""
    bits = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    out = (bits & 0x80000000) | mag
    return torch.where(out > 0x7FFFFFFF, out - (1 << 32), out).to(torch.int32).view(torch.float32)


def split(t: torch.Tensor):
    hi = tf32_rna(t)
    return hi, tf32_rna(t - hi)


def emulated_gates(xh, w, k_ranges, passes=3):
    """The kernels' gates: per K range, f32 accumulators from 0 over 8-deep k
    steps (3xTF32: lo.hi, hi.lo, hi.hi; one pass: hi.hi); the ranges' partial
    gates then summed in order from 0, as ln_gate_kernel does."""
    a_hi, a_lo = split(xh)
    b_hi, b_lo = split(w)
    terms = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)][3 - passes:]
    total = torch.zeros(xh.shape[0], w.shape[1])
    for begin, end in k_ranges:
        acc = torch.zeros_like(total)
        for k in range(begin, end, 8):
            s = slice(k, min(k + 8, end))
            for a, b in terms:
                acc = acc + a[:, s] @ b[s]
        total = total + acc
    return total


def ln_gates(gates, h, scale, bias):
    """LayerNorm over 3H (two passes, eps 1e-3) and the late-reset gates, f32."""
    mean = gates.mean(-1, keepdim=True)
    var = (gates - mean).square().mean(-1, keepdim=True)
    g = (gates - mean) * torch.rsqrt(var + k1.LN_EPS) * scale + bias
    r, u, n = g.chunk(3, -1)
    update = torch.sigmoid(u - 1.0)
    return update * torch.tanh(torch.sigmoid(r) * n) + (1.0 - update) * h


def inputs(M, seed):
    """chip_smoke.py's K1 inputs (k1_inputs), drawn with numpy."""
    rng = np.random.RandomState(seed)
    f = np.float32
    return (rng.randn(M, IN).astype(f), np.tanh(rng.randn(M, H)).astype(f),
            (0.03 * rng.randn(IN, 3 * H)).astype(f), (0.03 * rng.randn(H, 3 * H)).astype(f),
            (1.0 + 0.1 * rng.randn(3 * H)).astype(f), (0.1 * rng.randn(3 * H)).astype(f))


def emulate(M, seed, passes=3):
    """-> (h' of the emulated schedule plan() picks, h' of JAX's _reference_math)."""
    arrays = inputs(M, seed)
    want = np.asarray(_reference_math(*map(jnp.asarray, arrays)))
    x, h, w_ih, w_hh, scale, bias = map(torch.from_numpy, arrays)
    p = k1.plan(M, IN, H, torch.float32)
    K = IN + H
    kc = p.kc if p.schedule == "skinny_f32" else K
    ranges = [(b, min(b + kc, K)) for b in range(0, K, kc)]
    assert len(ranges) == p.nsplit
    gates = emulated_gates(torch.cat([x, h], 1), torch.cat([w_ih, w_hh], 0), ranges, passes)
    return p.schedule, ln_gates(gates, h, scale, bias).numpy(), want


@pytest.mark.parametrize("M,schedule", [(32, "skinny_f32"), (96, "wide_f32")])
def test_3xtf32_within_the_f32_tolerance(M, schedule):
    """The flagship's posterior rows (M=32, 8 splits of 256 rows) and a
    dream-sized stand-in (M=96 in place of 1536, one K walk): h' within
    FWD_TOL_F32 / MARGIN of JAX's f32 math."""
    got_schedule, got, want = emulate(M, seed=M)
    assert got_schedule == schedule
    err = np.abs(got - want).max()
    assert err <= FWD_TOL_F32 / MARGIN, err


def test_one_tf32_pass_misses_the_f32_tolerance():
    """One TF32 pass keeps about three digits: h' leaves FWD_TOL_F32, so the
    tolerance tells 3xTF32 from TF32."""
    _, got, want = emulate(32, seed=32, passes=1)
    assert np.abs(got - want).max() > FWD_TOL_F32


@pytest.mark.parametrize("value,want", [
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),        # a tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -12, 1.0),                     # under half: down
    (1.0 + 3 * 2.0 ** -12, 1.0 + 2.0 ** -10),    # over half: up
    (2.0 - 2.0 ** -23, 2.0),                     # carries into the exponent
    (0.0, 0.0),
])
def test_tf32_rna_rounds_as_cvt_rna(value, want):
    got = tf32_rna(torch.tensor([value], dtype=torch.float32))
    assert got.item() == want
    hi, lo = split(torch.tensor([value], dtype=torch.float32))
    assert hi.item() == want and (hi + lo).item() == np.float32(value)
