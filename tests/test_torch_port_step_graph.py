"""The train step replayed from CUDA graphs (``training/train_step.py``
``StepGraphs``), on the CPU with a fake capture backend.

The backend records the graphs it is asked to make and replay; the step it
"captures" runs eagerly on the CPU. So these tests hold the bookkeeping, not
the arithmetic: which calls replay, capture or run eagerly; the segments
cut at the layer spans, merged and replayed in capture order inside their
spans; the counters a replay credits; the outputs each call owns. The
replayed step against the eager one, on the card, is ``chip_smoke.py``'s
phase 17. Port only, at the tiny flagship size.
"""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pydreamer_tpu_torch import tracing
from pydreamer_tpu_torch.models import modules
from pydreamer_tpu_torch.models.dreamer import Dreamer
from pydreamer_tpu_torch.models.noise import GeneratorNoise
from pydreamer_tpu_torch.ops import gru_dv2
from pydreamer_tpu_torch.ops.accumulate import ACCUMULATES
from pydreamer_tpu_torch.ops.gru_dv2 import K1_BACKWARDS, K1_DW, LAUNCHES
from pydreamer_tpu_torch.scripts.flagship import make_batch, make_conf
from pydreamer_tpu_torch.tracing import COUNTERS, NULL, span
from pydreamer_tpu_torch.training import train_step
from pydreamer_tpu_torch.training.train_step import (Packed, Segments, StepGraphs, TrainStep,
                                                     graphable, noise_seed, replay_segments)

LEAVES = ("pd.encoder", "pd.posterior", "pd.heads", "pd.dream", "pd.actor_critic",
          "pd.backward", "pd.optimizer")


class FakeGraphs:
    """A capture backend that makes numbered graphs and logs what it does."""

    generator = None  # the step's noise draws from a generator of its own

    def __init__(self):
        self.log = []
        self.made = 0
        self.pools = 0
        self.in_capture = False

    def pool(self):
        self.pools += 1
        return self.pools

    @contextlib.contextmanager
    def capturing(self):
        self.in_capture = True
        try:
            yield
        finally:
            self.in_capture = False

    def begin(self, pool):
        self.made += 1
        self.log.append(("begin", self.made, pool))
        return self.made

    def end(self, graph):
        self.log.append(("end", graph))

    def replay(self, graph):
        self.log.append(("replay", graph, torch.autograd.profiler._is_profiler_enabled))

    def replayed(self):
        return [entry[1] for entry in self.log if entry[0] == "replay"]


def _stepper(k1=False, monkeypatch=None, **overrides):
    conf = make_conf(tiny=True).replace(**{"gru_type": "gru_layernorm_dv2", **overrides})
    if k1:  # GRUDv2Function on the CPU, the plain version standing in for the kernel
        def launch(x, h, *rest):
            LAUNCHES.add(x.shape[0], "skinny" if x.shape[0] == conf.batch_size else "wide")
            return gru_dv2.gru_dv2_reference(x, h, *rest)
        monkeypatch.setattr(gru_dv2, "gru_dv2_cuda", launch)
        monkeypatch.setattr(gru_dv2, "KERNEL_DEVICES", ("cpu",))

        def accumulate(acc, g):  # the accumulate kernel's count, torch's add_ for its sums
            ACCUMULATES.add(acc.numel())
            acc.add_(g)
        monkeypatch.setattr(modules, "accumulate_", accumulate)
    torch.manual_seed(0)
    model = Dreamer(conf, device="cpu")
    ts = TrainStep(model, conf, device="cpu")
    fake = FakeGraphs()
    ts.graphs = StepGraphs(fake)
    return conf, model, ts, fake


def _counts():
    return (COUNTERS.graph_captures, COUNTERS.graph_replays)


def test_graphs_engage_only_on_cuda_without_a_mesh():
    assert graphable(torch.device("cuda", 0), None)
    assert not graphable(torch.device("cuda", 0), object())
    assert not graphable(torch.device("cpu"), None)
    conf = make_conf(tiny=True)
    model = Dreamer(conf, device="cpu")
    ts = TrainStep(model, conf, device="cpu")
    assert ts.graphs is None
    assert not any(g.get("capturable") for g in ts.optimizer.param_groups)
    obs = make_batch(conf, device="cpu")
    before = _counts()
    state = model.init_state(conf.batch_size)
    for step in (1, 2, 3):
        state, *_ = ts(obs, state, step, seed=1)
    assert _counts() == before


def test_eligibility_replay_capture_or_eager():
    conf, model, ts, fake = _stepper()
    obs = make_batch(conf, device="cpu")
    state = model.init_state(conf.batch_size)
    seen = []

    def call(step, obs=obs, **kw):
        before = _counts()
        out = ts(obs, model.init_state(obs["action"].shape[1]), step, seed=5, **kw)
        after = _counts()
        seen.append({(0, 0): "eager", (1, 1): "capture", (0, 1): "replay"}[
            (after[0] - before[0], after[1] - before[1])])
        return out

    call(1)                       # the first call of a signature warms it
    call(2)                       # the second captures (and replays)
    call(3)                       # then replays
    call(4, noise=GeneratorNoise("cpu", seed=9))   # an explicit noise source
    call(5, do_image_pred=True)   # the trainer's log flags
    call(6, do_dream_tensors=True)
    call(7)
    assert seen == ["eager", "capture", "replay", "eager", "eager", "eager", "replay"]
    assert train_step.MAX_GRAPHS == 1
    small = {k: v[:, :2] for k, v in obs.items()}     # a new signature past the bound: B=2
    seen.clear()
    for step, o in enumerate((small, small, small, obs), 8):
        call(step, obs=o)
    assert seen == ["eager", "eager", "eager", "replay"]
    assert len(ts.graphs.captured) == 1 and fake.pools == 1
    del state


def test_an_eager_call_of_any_kind_warms_its_signature_for_the_capture():
    conf, model, ts, _ = _stepper()
    obs = make_batch(conf, device="cpu")
    state = model.init_state(conf.batch_size)
    before = _counts()
    ts(obs, state, 1, seed=5, noise=GeneratorNoise("cpu", seed=1))   # keyed noise: eager
    assert _counts() == before
    ts(obs, state, 2, seed=5)                                         # captures at once
    assert _counts() == (before[0] + 1, before[1] + 1)
    _, model, ts, _ = _stepper()
    small = {k: v[:, :2] for k, v in obs.items()}
    ts(small, model.init_state(2), 3, seed=5, do_image_pred=True)     # a log step: eager
    assert _counts() == (before[0] + 1, before[1] + 1)
    ts(small, model.init_state(2), 4, seed=5)
    assert _counts() == (before[0] + 2, before[1] + 2)


def test_the_signature_holds_shapes_dtypes_and_the_step_options():
    conf, model, ts, _ = _stepper()
    obs = make_batch(conf, device="cpu")
    state = model.init_state(conf.batch_size)
    sig = ts.signature(obs, state)
    assert sig == ts.signature({k: v.clone() for k, v in obs.items()}, state)
    assert sig != ts.signature({**obs, "reward": obs["reward"].double()}, state)
    assert sig != ts.signature(obs, model.init_state(conf.batch_size + 1))
    assert sig[1:] == (conf.iwae_samples, model.imag_horizon)


def test_segments_follow_the_leaf_spans_merge_neighbours_and_replay_in_order(monkeypatch):
    conf, model, ts, fake = _stepper(k1=True, monkeypatch=monkeypatch)
    obs = make_batch(conf, device="cpu")
    state = model.init_state(conf.batch_size)
    for step in (1, 2):
        state, *_ = ts(obs, state, step, seed=2)
    (captured,) = ts.graphs.captured.values()
    tags = [t for t, _ in captured.segments]
    T = conf.batch_length
    # Encoder and heads are each entered twice in a row (prepare_obs and the
    # encoder; the world model's heads and the probe): one segment each. The
    # tiny reinforce dream takes no gradient, so K1's backward cuts the
    # backward at the T posterior steps alone.
    assert tags == ([("pd.encoder",), ("pd.posterior",), ("pd.heads",), ("pd.dream",),
                     ("pd.actor_critic",), ("pd.backward",)]
                    + [("pd.backward", "pd.k1_backward"), ("pd.backward",)] * T
                    + [("pd.optimizer",)])
    graphs = [g for _, g in captured.segments]
    assert graphs == list(range(1, len(graphs) + 1))
    begun = [e[1] for e in fake.log if e[0] == "begin"]
    ended = [e[1] for e in fake.log if e[0] == "end"]
    assert begun == ended == graphs
    assert fake.replayed() == graphs          # the capture call's replay
    state, *_ = ts(obs, state, 3, seed=2)
    assert fake.replayed() == graphs * 2


def test_segments_cut_back_into_the_enclosing_span_and_take_the_first_leaf():
    fake = FakeGraphs()
    cut = Segments(fake, pool=7)
    for name in ("pd.encoder", "pd.encoder"):
        cut.enter(name)
        cut.exit(name)
    cut.enter("pd.backward")
    for _ in range(2):
        cut.enter("pd.k1_backward")
        cut.exit("pd.k1_backward")
    cut.exit("pd.backward")
    cut.enter("pd.optimizer")
    cut.exit("pd.optimizer")
    segments = cut.finish()
    assert segments == [(("pd.encoder",), 1), (("pd.backward",), 2),
                        (("pd.backward", "pd.k1_backward"), 3), (("pd.backward",), 4),
                        (("pd.backward", "pd.k1_backward"), 5), (("pd.backward",), 6),
                        (("pd.optimizer",), 7)]
    assert all(e[2] == 7 for e in fake.log if e[0] == "begin")
    assert cut.stack == []


def test_replay_opens_each_segments_spans_as_the_eager_step_nests_them():
    fake = FakeGraphs()
    segments = [(("pd.encoder",), 1), (("pd.backward",), 2),
                (("pd.backward", "pd.k1_backward"), 3), (("pd.backward",), 4),
                (("pd.backward", "pd.k1_backward"), 5), (("pd.optimizer",), 6), ((), 7)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        replay_segments(fake, segments)
    assert fake.replayed() == list(range(1, 8))
    assert all(e[2] for e in fake.log if e[0] == "replay")
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.name.startswith("pd."))
    assert [name for *_, name in spans] == ["pd.encoder", "pd.backward", "pd.k1_backward",
                                            "pd.k1_backward", "pd.optimizer"]
    (b0, b1, _), = [s for s in spans if s[2] == "pd.backward"]
    for s, e, name in spans:
        if name == "pd.k1_backward":
            assert b0 <= s <= e <= b1


def test_each_replay_credits_what_the_captured_step_counted(monkeypatch):
    conf, model, ts, _ = _stepper(k1=True, monkeypatch=monkeypatch, precision="bfloat16")
    obs = make_batch(conf, device="cpu")
    state = [model.init_state(conf.batch_size)]
    per_call, backwards, accumulates = [], [], []
    for step in range(1, 6):
        COUNTERS.reset()
        LAUNCHES.reset()
        K1_BACKWARDS.reset()
        K1_DW.reset()
        ACCUMULATES.reset()
        state[0], *_ = ts(obs, state[0], step, seed=4)
        per_call.append((COUNTERS.weight_casts, COUNTERS.weight_copies,
                         COUNTERS.weight_copy_uses, LAUNCHES.count, dict(LAUNCHES.by_rows),
                         dict(LAUNCHES.by_schedule), COUNTERS.graph_replays,
                         COUNTERS.graph_captures, COUNTERS.train_steps))
        backwards.append((dict(K1_BACKWARDS.by_route), dict(K1_BACKWARDS.by_rows),
                          dict(K1_DW.by_path), K1_DW.products))
        accumulates.append((ACCUMULATES.count, dict(ACCUMULATES.by_numel)))
    T, B, H = conf.batch_length, conf.batch_size, conf.imag_horizon
    eager = per_call[0]
    assert eager[0] == eager[1] > 0 and eager[2] > eager[1]  # one cast a copy; the copies' uses
    # One accumulate a use that takes a gradient, the same in every call.
    assert 0 < accumulates[0][0] <= eager[2] and accumulates == [accumulates[0]] * 5
    assert eager[3:6] == (T + H, {B: T, T * B: H}, {"skinny": T, "wide": H})
    assert eager[6:] == (0, 0, 1)
    assert per_call[1][:6] == eager[:6] and per_call[1][6:] == (1, 1, 1)   # capture + replay
    for replay in per_call[2:]:
        assert replay[:6] == eager[:6] and replay[6:] == (1, 0, 1)
    # K1's backward: the posterior loop's T calls, the bf16 pass, in every call,
    # each a slot of the loop's one dW sum.
    assert backwards == [({"kernel": T}, {B: T}, {"batched": T}, 1)] * 5
    delta = ts.graphs.captured[ts.signature(obs, state[0])].delta
    assert {name: change for c, name, change in delta if c in (COUNTERS, LAUNCHES)} == dict(
        zip(("weight_casts", "weight_copies", "weight_copy_uses", "count", "by_rows",
             "by_schedule"), eager[:6]))
    assert {name: change for c, name, change in delta if c in (K1_BACKWARDS, K1_DW)} == dict(
        zip(("by_route", "by_rows", "by_path", "products"), backwards[0]))
    # The capture cuts at each step's backward and at the loop's one dW sum.
    (captured,) = ts.graphs.captured.values()
    assert sum(tags[-1:] == ("pd.k1_backward",) for tags, _ in captured.segments) == T + 1
    assert {name: change for c, name, change in delta if c is ACCUMULATES} == dict(
        zip(("count", "by_numel"), accumulates[0]))


def test_a_counter_registered_with_tallies_is_credited_by_each_replay(monkeypatch):
    class Kernels:
        def __init__(self):
            self.count, self.by_name = 0, {}

    kernels = Kernels()
    monkeypatch.setattr(tracing.TALLIES, "fields", list(tracing.TALLIES.fields))
    tracing.TALLIES.register(kernels, "count", "by_name")
    conf, model, ts, _ = _stepper()
    forward = model.training_step

    def counted(*args, **kwargs):
        kernels.count += 3
        kernels.by_name["x"] = kernels.by_name.get("x", 0) + 2
        return forward(*args, **kwargs)
    monkeypatch.setattr(model, "training_step", counted)
    obs = make_batch(conf, device="cpu")
    state = model.init_state(conf.batch_size)
    seen = []
    for step in (1, 2, 3, 4):                          # eager, capture + replay, replays
        ts(obs, state, step, seed=7)
        seen.append((kernels.count, dict(kernels.by_name)))
    assert seen == [(3 * n, {"x": 2 * n}) for n in (1, 2, 3, 4)]
    snap = tracing.TALLIES.snapshot()
    kernels.by_name["y"] = 1
    assert {n: c for k, n, c in tracing.TALLIES.since(snap) if k is kernels} == {
        "count": 0, "by_name": {"y": 1}}
    tracing.TALLIES.restore(snap)
    assert kernels.by_name == {"x": 8}


def test_replays_return_their_own_tensors_and_keep_the_gradients():
    conf, model, ts, _ = _stepper()
    obs = make_batch(conf, device="cpu")
    state = model.init_state(conf.batch_size)
    eager = ts(obs, state, 1, seed=6)
    grads = [(p, p.grad) for p in ts.params]  # made once, zeroed in place by every step
    outs = [ts(obs, state, step, seed=6) for step in (2, 3)]
    for (s0, m0, t0, d0), (s1, m1, t1, d1) in [(eager, outs[0]), (outs[0], outs[1])]:
        assert list(m0) == list(m1) and list(t0) == list(t1) and d1 == {}
        assert [x.shape for x in s0] == [x.shape for x in s1]
    ptrs = [{t.untyped_storage().data_ptr() for t in torch.utils._pytree.tree_leaves(o[:3])}
            for o in outs]
    assert not ptrs[0] & ptrs[1]
    assert all(p.grad is g for p, g in grads)
    ts(obs, state, 4, seed=6, do_image_pred=True)     # an eager log step in between
    assert all(p.grad is g for p, g in grads)
    ts(obs, state, 5, seed=6)
    assert all(p.grad is g for p, g in grads)
    # Gradients set to None between calls (torch's zero_grad): the replay
    # writes into the held tensors, and sets them back as .grad.
    for zero_grad in (model.zero_grad, ts.optimizer.zero_grad):
        zero_grad()
        assert all(p.grad is None for p, _ in grads)
        ts(obs, state, 6, seed=6)
        assert all(p.grad is g for p, g in grads)
        assert any(g.any() for _, g in grads)


def test_outputs_pack_each_part_by_dtype_and_unpack_fresh_copies():
    out = ((torch.arange(6.0).reshape(2, 3), torch.ones(2, dtype=torch.bfloat16)),
           {"a": torch.tensor(3.5), "b": torch.tensor(True)},
           {"c": torch.arange(4, dtype=torch.bfloat16).reshape(2, 2)})
    packed = [Packed(part) for part in out]
    assert [len(part.flat) for part in packed] == [2, 2, 1]
    one, two = [tuple(part.copy() for part in packed) for _ in range(2)]
    for got in (one, two):
        leaves = torch.utils._pytree.tree_leaves(got)
        for a, b in zip(leaves, torch.utils._pytree.tree_leaves(out)):
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    one[0][0].add_(1.0)
    assert torch.equal(two[0][0], out[0][0])
    # A metric kept holds the metrics' storage alone, not the tensors'.
    kept = one[1]["a"]
    assert kept.untyped_storage().nbytes() == 4
    assert kept.untyped_storage().data_ptr() not in {
        t.untyped_storage().data_ptr() for t in (*one[0], *one[2].values())}


def test_span_is_the_null_context_without_a_profiler_or_a_capture(monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled and tracing._capture is None

    def refuse(*_):
        raise AssertionError("span made an object")
    monkeypatch.setattr(tracing, "record_function", refuse)
    monkeypatch.setattr(tracing, "_Cut", refuse)
    for name in (*LEAVES, "pd.k1_backward", "pd.train_step", "pd.loop.x"):
        assert span(name) is NULL


def test_span_cuts_a_capture_only_at_the_leaves():
    calls = []

    class Capture:
        def enter(self, name):
            calls.append(("enter", name))

        def exit(self, name, failed=False):
            calls.append(("exit", name, failed))

    with tracing.cutting(Capture()):
        with span("pd.train_step"), span("pd.loop.data"):
            pass
        with span("pd.backward"):
            with span("pd.k1_backward"):
                pass
        with pytest.raises(ValueError):
            with span("pd.optimizer"):
                raise ValueError
        with pytest.raises(RuntimeError):
            with tracing.cutting(Capture()):
                pass
    assert tracing._capture is None
    assert calls == [("enter", "pd.backward"), ("enter", "pd.k1_backward"),
                     ("exit", "pd.k1_backward", False), ("exit", "pd.backward", False),
                     ("enter", "pd.optimizer"), ("exit", "pd.optimizer", True)]


def test_a_generator_given_to_the_noise_is_reseeded_and_draws_as_a_new_one():
    seed = noise_seed(12345678901, 7)
    assert seed == 12345678901 * 1_000_003 + 7
    held = torch.Generator()
    held.manual_seed(1)
    torch.rand(5, generator=held)
    a = GeneratorNoise("cpu", seed=seed, generator=held)
    b = GeneratorNoise("cpu", seed=seed)
    assert a.generator is held
    for kind in ("gumbel", "normal", "uniform"):
        assert torch.equal(a.draw("x", (3, 4), kind), b.draw("x", (3, 4), kind))


def test_a_failed_capture_leaves_the_counters_and_runs_eagerly_from_then_on(monkeypatch):
    conf, model, ts, fake = _stepper()
    obs = make_batch(conf, device="cpu")
    state = model.init_state(conf.batch_size)
    ts(obs, state, 1, seed=8)
    training_step = ts.model.training_step
    calls = []

    def refused_in_capture(*args, **kwargs):
        calls.append(fake.in_capture)
        if fake.in_capture:
            COUNTERS.weight_casts += 1
            raise RuntimeError("operation not permitted when stream is capturing")
        return training_step(*args, **kwargs)
    monkeypatch.setattr(ts.model, "training_step", refused_in_capture)
    COUNTERS.reset()
    with pytest.raises(RuntimeError, match="stream is capturing"):
        ts(obs, state, 2, seed=8)
    assert calls == [True]
    assert COUNTERS.weight_casts == 0
    assert tracing._capture is None and fake.log[-1][0] == "end"
    assert COUNTERS.graph_captures == COUNTERS.graph_replays == 0 and not ts.graphs.captured
    _, metrics, _, _ = ts(obs, state, 3, seed=8)      # a caller that goes on: eager
    assert calls == [True, False]
    assert torch.isfinite(metrics["loss_model"])
    ts(obs, state, 4, seed=8)
    assert calls == [True, False, False]
    assert COUNTERS.graph_captures == COUNTERS.graph_replays == 0


def test_a_capture_makes_no_weight_copy():
    """The copies are made by the eager step before the capture; one that a
    capture would make (here: all, dropped after that step) refuses it."""
    conf, model, ts, fake = _stepper(precision="bfloat16")
    obs = make_batch(conf, device="cpu")
    state = model.init_state(conf.batch_size)
    ts(obs, state, 1, seed=9)
    made = len(ts.copies)
    ts.copies.copies.clear()
    with pytest.raises(RuntimeError, match="no step copy"):
        ts(obs, state, 2, seed=9)
    assert not ts.graphs.captured and not ts.copies.is_sealed
    ts(obs, state, 3, seed=9)                          # eager from then on: made again
    assert len(ts.copies) == made > 0


def test_adamw_is_capturable_only_on_cuda_whatever_a_loaded_file_says():
    conf, model, ts, _ = _stepper()
    obs = make_batch(conf, device="cpu")
    state = model.init_state(conf.batch_size)
    ts(obs, state, 1, seed=3, noise=GeneratorNoise("cpu", seed=1))
    saved = ts.optimizer.state_dict()
    for group in saved["param_groups"]:  # as a file written on the card says
        group["capturable"] = True
    for param_state in saved["state"].values():
        param_state["step"] = param_state["step"].float()
    ts.optimizer.load_state_dict(saved)
    assert not any(g["capturable"] for g in ts.optimizer.param_groups)
    _, metrics, _, _ = ts(obs, state, 2, seed=3, noise=GeneratorNoise("cpu", seed=2))
    assert torch.isfinite(metrics["loss_model"])
