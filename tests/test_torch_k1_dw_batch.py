"""K1's weight gradient summed once over an unroll, on the CPU.

``ops/gru_dv2.py``: inside ``dw_batches()`` a K1 cell on the bf16 route whose
weights take a gradient reads them once (``step_weights``) through a
``DWSum`` node; each step's backward writes its gate gradient into a slot of
the cell's ``DWBatch`` and makes no dW, and ``DWSum``'s backward makes the
one sum. Here ``GRUDv2Function`` runs with the plain version standing in for
the forward launch and ``k1_backward``'s CPU branch as its backward (as
``tests/test_torch_k1_backward.py`` drives the route), so the batch is held to
the per-call path in float32; chip_smoke.py holds it on the card in bf16.
"""

import pytest
import torch

from pydreamer_tpu_torch.models.modules import WeightCopies
from pydreamer_tpu_torch.models.rnn import NormGRUCellLateResetFused
from pydreamer_tpu_torch.models.rssm import RSSMCore
from pydreamer_tpu_torch.ops import gru_dv2 as k1
from pydreamer_tpu_torch.tracing import COUNTERS


@pytest.fixture
def kernel_route(monkeypatch):
    """The CPU as a device that launches K1 (the plain version launched), and
    every dtype on the bf16 pass's route (``k1_backward``'s CPU branch)."""
    monkeypatch.setattr(k1, "gru_dv2_cuda", k1.gru_dv2_reference)
    monkeypatch.setattr(k1, "KERNEL_DEVICES", ("cpu",))
    monkeypatch.setattr(k1, "backward_route", lambda dtype: "kernel")


def _weights(In, H, g):
    return [0.1 * torch.randn(In, 3 * H, generator=g), 0.1 * torch.randn(H, 3 * H, generator=g),
            1.0 + 0.1 * torch.randn(3 * H, generator=g), 0.1 * torch.randn(3 * H, generator=g)]


def _unroll(T, M, In, H, batched: bool, used=None, chained: bool = True, seed: int = 0):
    """T K1 steps in float32 (h chained from step to step, or each step its
    own h), the loss a fixed projection of the outputs of the steps in
    ``used`` (all by default) -> every leaf's gradient and the counts of
    ``K1_DW``."""
    g = torch.Generator().manual_seed(seed)
    w_ih, w_hh, scale, bias = [t.requires_grad_() for t in _weights(In, H, g)]
    xs = [torch.randn(M, In, generator=g).requires_grad_() for _ in range(T)]
    hs = [torch.tanh(torch.randn(M, H, generator=g)).requires_grad_() for _ in range(T)]
    projections = [torch.randn(M, H, generator=g) for _ in range(T)]
    batch = k1.DWBatch() if batched else None
    wi, wh = k1.DWSum.apply(batch, w_ih, w_hh) if batched else (w_ih, w_hh)
    k1.K1_DW.reset()
    h, loss = hs[0], 0.0
    for t in range(T):
        h = k1.GRUDv2Function.apply(xs[t], h if chained else hs[t], wi, wh, scale, bias, batch)
        if used is None or t in used:
            loss = loss + (h * projections[t]).sum()
    loss.backward()
    leaves = {"w_ih": w_ih, "w_hh": w_hh, "scale": scale, "bias": bias, "h0": hs[0],
              **{f"x{t}": x for t, x in enumerate(xs)}}
    grads = {n: t.grad for n, t in leaves.items()}
    return grads, dict(k1.K1_DW.by_path), k1.K1_DW.products


@pytest.mark.parametrize("In,H", [(32, 32), (64, 128)])
@pytest.mark.parametrize("T", [1, 5, 8])
def test_the_batched_dw_is_the_sum_of_the_per_call_ones(kernel_route, T, In, H):
    """The batch's two products over T*M rows give the per-call path's summed
    weight gradients within float32 rounding; dx, dh, d_scale and d_bias are
    the per-call path's bit for bit; ``K1_DW`` counts T batched calls and one
    sum, or T per-call calls and none."""
    batched, counts, products = _unroll(T, 16, In, H, batched=True)
    per_call, counts_pc, products_pc = _unroll(T, 16, In, H, batched=False)
    assert (counts, products) == ({"batched": T}, 1)
    assert (counts_pc, products_pc) == ({"per_call": T}, 0)
    for name in ("w_ih", "w_hh"):
        want = per_call[name]
        torch.testing.assert_close(batched[name], want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()), msg=name)
    for name in set(per_call) - {"w_ih", "w_hh"}:
        assert torch.equal(batched[name], per_call[name]), name


def test_a_step_no_gradient_reaches_adds_nothing(kernel_route):
    """Steps 1 and 3 of five, each on its own h, feed no loss: autograd never
    runs their backward, their slots stay zero, and the sum is the three
    other steps' per-call dW."""
    used = {0, 2, 4}
    batched, counts, products = _unroll(5, 8, 32, 32, batched=True, used=used, chained=False)
    per_call, _, _ = _unroll(5, 8, 32, 32, batched=False, used=used, chained=False)
    assert (counts, products) == ({"batched": 3}, 1)
    for name in ("w_ih", "w_hh"):
        want = per_call[name]
        torch.testing.assert_close(batched[name], want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()), msg=name)
    assert batched["x1"] is None and batched["x3"] is None


@pytest.mark.parametrize("case,want", [("unroll", {"batched": 4}), ("no_unroll", {"per_call": 4}),
                                       ("float32", {"per_call": 4}), ("frozen", {})])
def test_the_batch_engages_only_in_an_unroll_on_the_bf16_route_with_a_weight_gradient(
        monkeypatch, case, want):
    """A K1 cell stepped four times: inside ``dw_batches()`` in bf16 it reads
    its weights once (two casts) and sums dW once; without the unroll, in
    float32 (autograd through the plain version) or with its weights frozen
    each step keeps the per-call path (two casts a step in bf16)."""
    monkeypatch.setattr(k1, "gru_dv2_cuda", k1.gru_dv2_reference)
    monkeypatch.setattr(k1, "KERNEL_DEVICES", ("cpu",))
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    torch.manual_seed(0)
    cell = NormGRUCellLateResetFused(16, 64, dtype=dtype)
    if case == "frozen":
        cell.requires_grad_(False)
    x = torch.randn(4, 8, 16, requires_grad=True)
    k1.K1_DW.reset()
    COUNTERS.reset()
    with k1.dw_batches() if case != "no_unroll" else torch.enable_grad():
        h = torch.zeros(8, 64)
        for t in range(4):
            h = cell(x[t], h)
    h.float().sum().backward()
    assert dict(k1.K1_DW.by_path) == want
    assert k1.K1_DW.products == (1 if case == "unroll" else 0)
    assert COUNTERS.weight_casts == {"unroll": 2, "no_unroll": 8, "float32": 0, "frozen": 8}[case]
    assert x.grad is not None


def _core_grads(core, serving: bool, T=4, B=3, seed=5):
    """One posterior unroll of ``core`` and a backward -> each parameter's
    gradient; ``serving``: through the step's weight copies (``CopyUse``
    adding into a zeroed ``.grad``), else a per-call cast."""
    g = torch.Generator().manual_seed(seed)
    embed, action = torch.randn(T, B, 8, generator=g), torch.randn(T, B, 3, generator=g)
    reset = torch.zeros(T, B, dtype=torch.bool)
    reset[2, 0] = True
    state = (torch.zeros(B, 64), torch.zeros(B, 16))
    noise = -torch.log(-torch.log(torch.rand(T, B, 4, 4, generator=g)))
    copies = WeightCopies()
    for p in core.parameters():
        p.grad = torch.zeros_like(p) if serving else None
    with copies.serving() if serving else torch.enable_grad():
        prior, post, _, features, _, _ = core(embed, action, reset, state, noise)
    (features.float().square().mean() + post.square().mean() + prior.square().mean()).backward()
    return {n: p.grad for n, p in core.named_parameters()}


def test_the_posterior_unroll_sums_k1s_dw_once_on_either_path(kernel_route):
    """``RSSMCore.forward`` opens the batch: a bf16 posterior unroll with a K1
    cell counts T batched calls and one sum, and every parameter's gradient
    is the same bit for bit through the step's weight copies as through
    per-call casts."""
    torch.manual_seed(1)
    cores = [RSSMCore(8, 3, 64, 4, 4, 16, gru_type="gru_layernorm_dv2", dtype=torch.bfloat16)
             for _ in range(2)]
    cores[1].load_state_dict(cores[0].state_dict())
    k1.K1_DW.reset()
    served = _core_grads(cores[0], serving=True)
    assert (dict(k1.K1_DW.by_path), k1.K1_DW.products) == ({"batched": 4}, 1)
    per_call = _core_grads(cores[1], serving=False)
    assert set(served) == set(per_call)
    for name, grad in served.items():
        assert torch.equal(grad, per_call[name]), name
    assert float(served["cell.gru.cell_0.weight_hh"].abs().sum()) > 0
