"""K1's backward on the CPU: the plain version of its bf16 pass, and its route.

``ops/gru_dv2.py::k1_backward`` is the backward that bf16 operands take on the
card: the forward's gates recomputed, the LayerNorm and gate backward
(``ln_gate_backward_reference`` is the plain version of its kernel), then
three products from the gate gradient. In float32 on the CPU it is the same
arithmetic as autograd through ``gru_dv2_reference``, which float32 operands
still take, and as the JAX package's backward (``jax.vjp`` through
``_reference_math``, what ``fused_gru_dv2``'s ``_bwd`` runs); chip_smoke.py
holds the kernels against the float32 recompute on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydreamer_tpu.ops.gru_pallas import _reference_math
from pydreamer_tpu_torch.ops import gru_dv2 as k1

NAMES = ("x", "h", "w_ih", "w_hh", "scale", "bias")

ALL = (True,) * 6
X_H = (True, True, False, False, False, False)  # the dream under actor_grad: dynamics


def _inputs(M, In, H, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    ins = [torch.randn(M, In, generator=g), torch.tanh(torch.randn(M, H, generator=g)),
           0.1 * torch.randn(In, 3 * H, generator=g), 0.1 * torch.randn(H, 3 * H, generator=g),
           1.0 + 0.1 * torch.randn(3 * H, generator=g), 0.1 * torch.randn(3 * H, generator=g)]
    return [t.to(dtype) for t in ins[:4]] + ins[4:], torch.randn(M, H, generator=g)


def _autograd(ins, grad_out, needs):
    leaves = [t.detach().clone().requires_grad_(need) for t, need in zip(ins, needs)]
    out = k1.gru_dv2_reference(*leaves)
    got = torch.autograd.grad(out, [t for t in leaves if t.requires_grad], grad_out)
    it = iter(got)
    return [next(it) if need else None for need in needs]


def _jax_vjp(ins, grad_out, needs):
    """The JAX package's K1 backward: jax.vjp through ``_reference_math``."""
    _, vjp = jax.vjp(_reference_math, *(jnp.asarray(t.numpy()) for t in ins))
    got = vjp(jnp.asarray(grad_out.numpy()))
    return [np.asarray(g) if need else None for g, need in zip(got, needs)]


@pytest.mark.parametrize("needs", [ALL, X_H], ids=["all_six", "x_h_only"])
@pytest.mark.parametrize("In,H", [(32, 32), (64, 128)])
@pytest.mark.parametrize("M", [1, 16, 32])
def test_plain_backward_matches_autograd_through_the_plain_version(M, In, H, needs):
    """In float32, the pass (gates, LayerNorm/gate backward, products) gives
    autograd's gradients and the JAX package's within float32 rounding, and
    only those asked for."""
    ins, grad_out = _inputs(M, In, H, seed=M + H)
    got = k1.k1_backward(*ins, grad_out, needs)
    want = _autograd(ins, grad_out, needs)
    want_jax = _jax_vjp(ins, grad_out, needs)
    for name, a, b, j in zip(NAMES, got, want, want_jax):
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape == j.shape, name
        atol = 1e-5 * float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=1e-5, atol=atol, msg=name)
        np.testing.assert_allclose(a.numpy(), j, rtol=1e-5, atol=atol, err_msg=name)


@pytest.mark.parametrize("dtype,route", [(torch.float32, "plain"), (torch.bfloat16, "kernel")])
def test_the_backward_route_follows_the_operands_dtype(monkeypatch, dtype, route):
    """GRUDv2Function (the plain version standing in for the forward launch):
    float32 operands take autograd through the plain version, exactly; bf16
    ones take the bf16 pass (its plain pieces on the CPU), counted by route
    and rows in ``K1_BACKWARDS``."""
    monkeypatch.setattr(k1, "gru_dv2_cuda", k1.gru_dv2_reference)
    M, In, H = 16, 32, 64
    ins, grad_out = _inputs(M, In, H, seed=3, dtype=dtype)
    leaves = [t.clone().requires_grad_() for t in ins]
    k1.K1_BACKWARDS.reset()
    k1.GRUDv2Function.apply(*leaves).backward(grad_out)
    assert k1.K1_BACKWARDS.by_route == {route: 1} and k1.K1_BACKWARDS.by_rows == {M: 1}
    want = (_autograd(ins, grad_out, ALL) if route == "plain"
            else k1.k1_backward(*ins, grad_out, ALL))
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == leaf.dtype
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=0)
    assert k1.backward_route(dtype) == route
    assert [k1.backward_rows(m) for m in (1, 16, 64, 65, 1024, 1536)] == [1, 1, 1, 1, 4, 6]
