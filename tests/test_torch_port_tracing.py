"""The port's spans and counters (``pydreamer_tpu_torch/tracing.py``).

Without a profiler a span site is one flag check that returns the shared
null context; under ``torch.profiler`` a ``TrainStep`` records its layer
spans, each inside ``pd.train_step``; ``tools.Timer``'s phases are
``pd.loop.*`` spans with unchanged samples; ``COUNTERS.weight_casts`` counts
exactly the parameter casts that change a dtype. Port only, on the CPU at the
tiny flagship size.
"""

from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pydreamer_tpu_torch import tools, tracing
from pydreamer_tpu_torch.models.dreamer import Dreamer
from pydreamer_tpu_torch.ops import gru_dv2
from pydreamer_tpu_torch.scripts.flagship import make_batch, make_conf
from pydreamer_tpu_torch.tracing import COUNTERS, NULL, span
from pydreamer_tpu_torch.training.train_step import TrainStep

LEAVES = ("pd.encoder", "pd.posterior", "pd.heads", "pd.dream", "pd.actor_critic",
          "pd.backward", "pd.optimizer")


def _stepper(**overrides):
    conf = make_conf(tiny=True).replace(**{"gru_type": "gru_layernorm_dv2", **overrides})
    torch.manual_seed(0)
    model = Dreamer(conf, device="cpu")
    trainstep = TrainStep(model, conf, device="cpu")
    obs = make_batch(conf, device="cpu")
    state = [model.init_state(conf.batch_size)]

    def step(n):
        state[0], metrics, _, _ = trainstep(obs, state[0], n, seed=3)
        return metrics
    return model, step


def _spans(prof, prefix="pd."):
    return [(e.name, e.time_range.start, e.time_range.end, e.thread) for e in prof.events()
            if e.name.startswith(prefix)]


def test_span_without_a_profiler_is_the_null_context_and_a_step_records_nothing(monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled
    assert span("pd.train_step") is NULL and span("pd.encoder") is NULL
    opened = []
    monkeypatch.setattr(tracing, "record_function", lambda name: opened.append(name) or NULL)
    _, step = _stepper()
    step(1)
    with tools.Timer("tracing_off_phase"):
        pass
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        step(2)
    assert "pd.train_step" in opened and "pd.backward" in opened


def test_train_step_records_each_layer_span_inside_the_root():
    _, step = _stepper()
    step(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(2)
    spans = _spans(prof)
    roots = [(s, e) for name, s, e, _ in spans if name == "pd.train_step"]
    assert len(roots) == 1
    (root_start, root_end), = roots
    names = {name for name, *_ in spans}
    assert names == {"pd.train_step", *LEAVES}  # no K1 on the CPU: no pd.k1_backward
    for name, s, e, _ in spans:
        assert root_start <= s <= e <= root_end, name
    leaves = sorted((s, e, name) for name, s, e, _ in spans if name in LEAVES)
    for (_, e0, n0), (s1, _, n1) in zip(leaves, leaves[1:]):
        assert e0 <= s1, (n0, n1)  # the leaves never nest in one another


def test_k1_backward_span_opens_inside_the_backward(monkeypatch):
    """``GRUDv2Function`` with the plain version standing in for the kernel:
    its backward's ``pd.k1_backward`` lies inside the caller's span."""
    monkeypatch.setattr(gru_dv2, "gru_dv2_cuda", gru_dv2.gru_dv2_reference)
    g = torch.Generator().manual_seed(0)
    x, h = torch.randn(4, 8, generator=g), torch.randn(4, 16, generator=g)
    w_ih = torch.randn(8, 48, generator=g, requires_grad=True)
    w_hh = torch.randn(16, 48, generator=g, requires_grad=True)
    scale, bias = torch.ones(48), torch.zeros(48)
    out = gru_dv2.GRUDv2Function.apply(x, h, w_ih, w_hh, scale, bias)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("pd.backward"):
            out.square().sum().backward()
    spans = {name: (s, e) for name, s, e, _ in _spans(prof)}
    assert set(spans) == {"pd.backward", "pd.k1_backward"}
    assert spans["pd.backward"][0] <= spans["pd.k1_backward"][0]
    assert spans["pd.k1_backward"][1] <= spans["pd.backward"][1]
    assert w_ih.grad is not None and w_hh.grad is not None


def test_timer_phases_are_loop_spans_with_unchanged_samples(monkeypatch):
    """The same samples of the host clock with and without a profiler; the
    phase is a ``pd.loop.`` span only under one."""
    name = "tracing_test_phase"
    ticks = iter([10.0, 10.5, 20.0, 20.25])
    monkeypatch.setattr(tools, "time", SimpleNamespace(time=lambda: next(ticks)))
    tools.Timer(name).reset()
    with tools.Timer(name):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tools.Timer(name) as timer:
            pass
    assert timer.times == [0.5, 0.25]
    assert [s[0] for s in _spans(prof)] == [f"pd.loop.{name}"]
    timer.reset()


@pytest.mark.parametrize("gru_type", ["gru_layernorm_dv2", "gru"])
def test_weight_casts_count_the_parameter_casts_in_bfloat16(monkeypatch, gru_type):
    """One cast a step per parameter read in bfloat16, the step copy's: made
    by ``Tensor.to`` at step 1 and refreshed by ``torch._foreach_copy_`` after.
    Each counted cast is one that these calls make, and no parameter is cast
    twice in a step."""
    model, step = _stepper(precision="bfloat16", gru_type=gru_type)
    params = {id(p) for p in model.parameters()}
    to, foreach_copy = torch.Tensor.to, torch._foreach_copy_
    seen = []

    def counting_to(self, *args, **kwargs):
        out = to(self, *args, **kwargs)
        if id(self) in params and out.dtype != self.dtype:
            seen.append(id(self))
        return out

    def counting_foreach_copy(dst, src, *args, **kwargs):
        seen.extend(id(s) for d, s in zip(dst, src) if id(s) in params and d.dtype != s.dtype)
        return foreach_copy(dst, src, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "to", counting_to)
    monkeypatch.setattr(torch, "_foreach_copy_", counting_foreach_copy)
    per_step = []
    for n in (1, 2):
        COUNTERS.reset()
        seen.clear()
        step(n)
        assert COUNTERS.train_steps == 1
        assert COUNTERS.weight_casts == COUNTERS.weight_copies == len(seen) == len(set(seen)) > 0
        per_step.append(set(seen))
    assert per_step[0] == per_step[1]


def test_weight_casts_are_none_in_float32():
    _, step = _stepper(precision="float32")
    COUNTERS.reset()
    step(1)
    step(2)
    assert COUNTERS.train_steps == 2
    assert COUNTERS.weight_casts == 0
