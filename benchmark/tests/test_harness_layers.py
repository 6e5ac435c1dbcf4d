"""The layer split of the train step (``benchmark/layers.py``) and its metrics.

On a made-up window, as ``test_harness_trace.py``; on the tiny CPU cell; and
on the card (``chip``): ``pd.k1_backward`` holds device activity, on
autograd's device thread, and the spans change neither the launches nor the
device's busy time.
"""

import pytest
import torch

from benchmark import layers, run
from benchmark.tests.tiny import tiny_spec
from benchmark.trace import Trace

NEW = [f"{layer}_{kind}_ms.train" for layer in layers.LAYERS for kind in ("device", "idle")] + [
    "k1_backward_device_ms.train", "weight_casts_per_step.train", "span_coverage.train"]


def _quiet(*args, **kwargs):
    pass


def _bf16_spec():
    """The tiny ``dmc-train`` in bfloat16, the precision the cells state."""
    spec = tiny_spec("dmc-train")
    spec.conf["precision"] = "bfloat16"  # the same dict as spec.config["conf"]
    return spec


def _trace():
    """Two steps' worth: the encoder's conv, the backward's kernel before
    and inside ``pd.k1_backward`` (which the port opens on autograd's device
    thread; the trace keeps no threads, only the interval), a copy with no
    launch, the optimizer's kernel, one kernel in ``pd.train_step`` outside
    every leaf and one launched outside the step (the feed)."""
    t = Trace(steps=2, window_s=1.0)
    t.host_ops = [(0, 1000, "pd.train_step"), (10, 100, "pd.encoder"), (15, 25, "aten::conv2d"),
                  (200, 600, "pd.backward"), (300, 400, "pd.k1_backward"),
                  (700, 900, "pd.optimizer"), (1100, 1105, "aten::index")]
    t.launches = [(20, 1), (250, 2), (320, 3), (720, 5), (950, 6), (1100, 7)]
    t.device = [(30, 80, "conv"), (260, 300, "gemm"), (330, 380, "sm80_xmma_gemm_f32f32"),
                (380, 400, "Memcpy DtoD"), (730, 760, "multi_tensor_apply"),
                (960, 970, "fill"), (1110, 1120, "index")]
    t.device_corr = [1, 2, 3, 99, 5, 6, 7]
    return t


def test_activity_belongs_to_the_span_of_its_launch():
    t = _trace()
    ms = lambda ns: ns / 1e6 / 2
    assert layers.device_ms(t, "encoder") == ms(50)
    assert layers.device_ms(t, "backward") == ms(40 + 50)  # the child's kernel counts in it
    assert layers.device_ms(t, "k1_backward") == ms(50)
    assert layers.device_ms(t, "optimizer") == ms(30)
    assert layers.device_ms(t, "posterior") is None  # no such span in the window
    # The copy without a launch belongs to no layer: the layers sum below busy.
    total = sum(layers.device_ms(t, layer) or 0 for layer in layers.LAYERS)
    assert total == ms(50 + 90 + 30) < t.busy_s() * 1e3 / 2


def test_idle_gaps_belong_to_the_span_of_the_launch_that_ended_them():
    t = _trace()
    ms = lambda ns: ns / 1e6 / 2
    assert layers.idle_ms(t, "encoder") == 0.0  # the window's first activity ends no gap
    assert layers.idle_ms(t, "backward") == ms(180 + 30)
    assert layers.idle_ms(t, "k1_backward") == ms(30)
    assert layers.idle_ms(t, "optimizer") == ms(330)


def test_coverage_is_the_leaves_share_of_the_root_timeline():
    t = _trace()
    root = (50 + 40 + 50 + 30 + 10) + (180 + 30 + 330 + 200)  # busy + idle launched in the root
    covered = (50 + 40 + 50 + 30) + (180 + 30 + 330)            # ... and in a leaf
    assert layers.coverage(t) == pytest.approx(100.0 * covered / root)


def test_a_program_without_spans_reads_none():
    t = _trace()
    t.host_ops = [op for op in t.host_ops if not op[2].startswith("pd.")]
    assert layers.device_ms(t, "encoder") is None
    assert layers.idle_ms(t, "backward") is None
    assert layers.coverage(t) is None
    assert layers.device_ms(Trace(steps=1, window_s=1.0), "encoder") is None


def test_tiny_cpu_run_reads_the_counter_and_no_device_metric():
    from pydreamer_tpu_torch.tracing import COUNTERS

    COUNTERS.reset()
    spec = _bf16_spec()
    result = run.run_cell(spec, 2200000017, 0.2, True, torch.device("cpu"), log=_quiet)
    got = result["metrics"]
    assert got["weight_casts_per_step.train"]["value"] > 0
    assert got["weight_casts_per_step.train"]["value"] == int(got["weight_casts_per_step.train"][
        "value"])
    assert not set(got) & (set(NEW) - {"weight_casts_per_step.train"})


@pytest.mark.chip
def test_on_the_card_k1_backward_holds_device_time_and_spans_cost_no_device_work(cuda,
                                                                                 monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    from benchmark.check import make_inputs
    from benchmark.programs.dreamer import Program
    from benchmark.reference import dreamer as reference
    from pydreamer_tpu_torch import tracing

    spec = _bf16_spec()
    weights, feed = make_inputs(reference, spec.conf, spec.mix, 2200000019, cuda)
    program = Program(spec.conf, weights, cuda)
    state = program.init_state(spec.conf["batch_size"])
    for step in (1, 2):
        state, _ = program.step(feed.batch(step), state, step, seed=5)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        program.step(feed.batch(3), state, 3, seed=5)
        torch.cuda.synchronize(cuda)
    # The host side of each span (the profiler also puts a copy of each on
    # the device's timeline).
    spans = [(e.name, e.thread, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.name.startswith("pd.") and e.device_type == torch.autograd.DeviceType.CPU]
    threads = {}
    for name, thread, _, _ in spans:
        threads.setdefault(name, set()).add(thread)
    # Recorded on autograd's device thread, not the caller's, and inside the
    # caller's pd.backward.
    assert threads["pd.k1_backward"].isdisjoint(threads["pd.train_step"])
    backward = [(s, e) for name, _, s, e in spans if name == "pd.backward"]
    for name, _, s, e in spans:
        if name == "pd.k1_backward":
            assert any(b0 <= s <= e <= b1 for b0, b1 in backward)
    del program, state

    seed = 2200000023
    on = run.run_cell(spec, seed, 1.0, True, cuda, log=_quiet)["metrics"]
    monkeypatch.setattr(tracing, "record_function", lambda name: tracing.NULL)
    off = run.run_cell(spec, seed, 1.0, True, cuda, log=_quiet)["metrics"]
    assert on["k1_backward_device_ms.train"]["value"] > 0
    assert on["span_coverage.train"]["value"] >= 95.0
    assert set(NEW) <= set(on)
    assert not set(off) & (set(NEW) - {"weight_casts_per_step.train"})
    launches = "cuda_launches_per_step.train"
    assert on[launches]["value"] == off[launches]["value"]
    busy = "device_busy_ms.train"
    assert on[busy]["value"] == pytest.approx(off[busy]["value"], rel=0.05)
