"""Tiny versions of the cells, for CPU tests: the cells' own files with the
widths shrunk and the pool cut to four batches."""

from __future__ import annotations

import copy

from benchmark.run import load_spec

TINY = dict(deter_dim=64, stoch_dim=4, stoch_discrete=4, hidden_dim=32, cnn_depth=4,
            batch_length=5, batch_size=4, imag_horizon=3, precision="float32")


def tiny_spec(workload: str, **overrides):
    spec = load_spec(workload)
    conf = dict(spec.conf, **TINY, **overrides)
    spec.conf = conf
    spec.config = dict(copy.deepcopy(spec.config), conf=conf)
    spec.mix = dict(spec.mix, pool_batches=4)
    return spec
