"""Kernel K1 of the PyTorch port: its plain version against the JAX package.

The JAX side runs as tests/test_pallas.py runs it on the CPU: the Pallas
kernel through its interpreter (``fused_gru_dv2(..., True)``) and the plain
``_reference_math``. The CUDA kernel itself only runs on the card
(chip_smoke.py holds it against the same plain version there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydreamer_tpu.ops.gru_pallas import _reference_math, fused_gru_dv2
from pydreamer_tpu_torch.ops import gru_dv2 as k1

NAMES = ["x", "h", "w_ih", "w_hh", "scale", "bias"]


def make_inputs(M=8, In=64, H=128, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(M, In).astype(np.float32),
            rng.randn(M, H).astype(np.float32),
            (rng.randn(In, 3 * H) * 0.1).astype(np.float32),
            (rng.randn(H, 3 * H) * 0.1).astype(np.float32),
            (1.0 + 0.1 * rng.randn(3 * H)).astype(np.float32),
            (0.1 * rng.randn(3 * H)).astype(np.float32)]


@pytest.mark.parametrize("shape", [(8, 64, 128), (5, 37, 50)])
def test_forward_matches_jax(shape):
    """Plain version == Pallas interpreter == _reference_math (rtol/atol 1e-5)."""
    inputs = make_inputs(*shape)
    got = k1.gru_dv2_reference(*map(torch.from_numpy, inputs)).numpy()
    jin = [jnp.asarray(x) for x in inputs]
    np.testing.assert_allclose(got, np.asarray(fused_gru_dv2(*jin, True)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(_reference_math(*jin)), rtol=1e-5, atol=1e-5)


def test_gradients_match_jax():
    """Gradients w.r.t. all six inputs vs jax.grad through the Pallas
    interpreter's custom_vjp (rtol/atol 1e-4, as tests/test_pallas.py)."""
    inputs = make_inputs(seed=1)
    leaves = [torch.from_numpy(x).requires_grad_() for x in inputs]
    k1.gru_dv2(*leaves).square().sum().backward()

    def loss(*args):
        return jnp.sum(jnp.square(fused_gru_dv2(*args, True)))

    want = jax.grad(loss, argnums=tuple(range(6)))(*map(jnp.asarray, inputs))
    for leaf, w, name in zip(leaves, want, NAMES):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_cpu_tensors_take_plain_version():
    inputs = [torch.from_numpy(x) for x in make_inputs(seed=2)]
    k1.LAUNCHES.reset()
    torch.testing.assert_close(k1.gru_dv2(*inputs), k1.gru_dv2_reference(*inputs),
                               rtol=0, atol=0)
    assert k1.LAUNCHES.count == 0


def test_cuda_wrapper_refuses_cpu_tensors():
    inputs = [torch.from_numpy(x) for x in make_inputs(seed=3)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        k1.gru_dv2_cuda(*inputs)


def test_autograd_function_backward_is_plain_recompute(monkeypatch):
    """GRUDv2Function's backward == autograd through the plain version (exact,
    same ops), checked on the CPU with the launch replaced by the plain version."""
    monkeypatch.setattr(k1, "gru_dv2_cuda", k1.gru_dv2_reference)
    inputs = make_inputs(seed=4)
    proj = torch.from_numpy(np.random.RandomState(5).randn(8, 128).astype(np.float32))
    a = [torch.from_numpy(x).requires_grad_() for x in inputs]
    b = [torch.from_numpy(x).requires_grad_() for x in inputs]
    (k1.GRUDv2Function.apply(*a) * proj).sum().backward()
    (k1.gru_dv2_reference(*b) * proj).sum().backward()
    for ga, gb, name in zip(a, b, NAMES):
        torch.testing.assert_close(ga.grad, gb.grad, rtol=0, atol=0, msg=name)


def test_autograd_function_skips_unneeded_grads(monkeypatch):
    monkeypatch.setattr(k1, "gru_dv2_cuda", k1.gru_dv2_reference)
    inputs = [torch.from_numpy(x) for x in make_inputs(seed=6)]
    inputs[2].requires_grad_()
    k1.GRUDv2Function.apply(*inputs).sum().backward()
    assert inputs[2].grad is not None
    assert all(t.grad is None for i, t in enumerate(inputs) if i != 2)
