"""The FLOP count of ``benchmark/flops/dreamer.py`` against PyTorch's own
counter over one forward and backward of the plain reference."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.feed import Feed
from benchmark.flops.dreamer import count
from benchmark.noise import KeyedNoise
from benchmark.reference.dreamer import Model
from benchmark.tests.tiny import tiny_spec
from benchmark.weights import make_weights


@pytest.mark.parametrize("workload", ["atari-train", "dmc-train"])
def test_count_equals_flop_counter(workload):
    spec = tiny_spec(workload)
    conf = spec.conf
    model = Model(conf)
    shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    model.load_state_dict(make_weights(shapes, 3, "cpu"))
    feed = Feed(conf, spec.mix, 4, "cpu")
    B, Z = conf["batch_size"], conf["stoch_dim"] * conf["stoch_discrete"]
    state = (torch.randn(B, conf["deter_dim"]), torch.randn(B, Z))
    with FlopCounterMode(display=False) as counter:
        losses, _, _ = model.losses(feed.batch(1), state, KeyedNoise(5, 1, "cpu"))
        sum(losses.values()).backward()
    assert count(conf) == counter.get_total_flops()


def test_count_at_the_cells_widths():
    """The count of the cells as configured (the numbers PERF.md quotes)."""
    from benchmark.run import load_spec
    assert count(load_spec("atari-train").conf) == 1_909_980_545_024
    assert count(load_spec("dmc-train").conf) == 4_320_285_458_432
