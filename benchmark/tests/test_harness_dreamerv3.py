"""The DreamerV3 cell (``atari-dv3xl-train``) on the CPU at tiny widths, and the
span reader its two metrics use (``benchmark/spans.py``).

As ``test_harness_check.py`` holds the DreamerV2 cells: the reference agrees
with the port in float32, a run whose timed path is broken underneath is not
correct, the float8 control reads far above the port; as
``test_harness_flops.py``: the FLOP count equals PyTorch's counter over the
reference; and the reader of one span's device time follows
``layers.py``'s rule on a made-up window.
"""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import calibrate, layers, run, spans
from benchmark.feed import Feed
from benchmark.flops.dreamerv3 import count
from benchmark.noise import KeyedNoise
from benchmark.reference.dreamerv3 import Model
from benchmark.tests.test_harness_check import _ac_lr, _HalfBatch, _state_unchanged
from benchmark.tests.test_harness_layers import _trace
from benchmark.tests.tiny import tiny_spec
from benchmark.trace import Trace
from benchmark.weights import make_weights

CELL = "atari-dv3xl-train"
QUIET = dict(log=lambda *a, **k: None)


def _spec():
    return tiny_spec(CELL, mlp_units=32)


def test_reference_agrees_with_the_port():
    result = run.run_cell(_spec(), 2**31 + 7, 0.2, True, torch.device("cpu"), **QUIET)
    assert result["correct"]
    assert result["compared"]["grad"]["value"] < 1e-4
    assert result["compared"]["change"]["value"] < 1e-2
    # The CPU trace has no device activity: the span metrics stay silent.
    assert "twohot_device_ms.train" not in result["metrics"]


@pytest.mark.parametrize("fault", [_state_unchanged, _HalfBatch, _ac_lr])
def test_a_broken_step_is_not_correct(fault):
    result = run.run_cell(_spec(), 2**31 + 7, 0.2, False, torch.device("cpu"), adapt=fault,
                          **QUIET)
    assert not result["correct"]


def test_control_reads_far_above_the_program():
    got = calibrate.readings_for_seed(_spec(), 5, torch.device("cpu"),
                                      sides={"control": dict(cast=calibrate.cast_fp8)})
    program, control = got["program"]["numbers"], got["control"]["numbers"]
    assert max(control.values()) > 1e3 * max(max(program.values()), 1e-9)


def test_count_equals_flop_counter():
    spec = _spec()
    conf = spec.conf
    model = Model(conf)
    shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    model.load_state_dict(make_weights(shapes, 3, "cpu"))
    feed = Feed(conf, spec.mix, 4, "cpu")
    state = model.init_state(conf["batch_size"], "cpu")
    with FlopCounterMode(display=False) as counter:
        losses, _, _ = model.losses(feed.batch(1), state, KeyedNoise(5, 1, "cpu"))
        sum(losses.values()).backward()
    assert count(conf) == counter.get_total_flops()


def test_count_at_the_cells_widths():
    """The count of the cell as configured (the number PERF.md quotes)."""
    assert count(run.load_spec(CELL).conf) == 8_704_355_205_120


def test_span_reader_follows_the_layer_rule():
    """On ``test_harness_layers``' window the reader gives each layer's
    device ms as ``layers.py`` does, a nested span's alone, and None for a
    span the window lacks."""
    t = _trace()
    for layer in layers.LAYERS + ("k1_backward",):
        assert spans.device_ms(t, f"pd.{layer}") == layers.device_ms(t, layer), layer
    assert spans.device_ms(t, "pd.twohot") is None
    nested = Trace(steps=2, window_s=1.0)
    nested.host_ops = [(0, 1000, "pd.actor_critic"), (100, 200, "pd.twohot"),
                       (500, 600, "pd.twohot"), (700, 800, "pd.retnorm")]
    nested.launches = [(50, 1), (150, 2), (550, 3), (750, 4), (599, 5)]
    nested.device = [(60, 90, "gemm"), (160, 170, "softmax"), (560, 580, "sum"),
                     (760, 790, "sort"), (575, 600, "mul")]
    nested.device_corr = [1, 2, 3, 4, 5]
    ms = lambda ns: ns / 1e6 / 2
    assert spans.device_ms(nested, "pd.twohot") == ms(10 + 40)  # 560-600: a union, not a sum
    assert spans.device_ms(nested, "pd.retnorm") == ms(30)
    assert spans.device_ms(nested, "pd.actor_critic") == ms(30 + 10 + 40 + 30)
    assert spans.device_ms(Trace(steps=1, window_s=1.0), "pd.twohot") is None


@pytest.mark.chip
def test_control_fails_the_limits_on_the_card(cuda):
    """At the cell's own widths: the float8 control breaks a limit."""
    spec = run.load_spec(CELL)
    got = calibrate.readings_for_seed(spec, 2**31 + 101, cuda,
                                      sides={"control": dict(cast=calibrate.cast_fp8)})
    limits = spec.config["limits"]
    assert any(got["control"]["numbers"][k] > limits[k] for k in limits)
    assert all(got["program"]["numbers"][k] <= limits[k] for k in limits)
