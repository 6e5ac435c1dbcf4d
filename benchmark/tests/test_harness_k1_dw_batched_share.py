"""``k1_dw_batched_share.train`` (``benchmark/metrics/``) on made-up tallies:
the port's ``K1_DW`` swapped for one that counted what each case needs, or
taken away, as a program without it (the parent of the change) has none."""

from types import SimpleNamespace

import pytest

from benchmark import run
from pydreamer_tpu_torch.ops import gru_dv2

READER = run.load_file(run.ROOT / "metrics" / "k1_dw_batched_share.train.py",
                       "benchmark_metric_k1_dw_batched_share_train")


@pytest.mark.parametrize("by_path,want", [({"batched": 64}, 100.0),
                                          ({"batched": 48, "per_call": 16}, 75.0),
                                          ({}, None)],
                         ids=["only_batched", "some_per_call", "no_call_needed_dw"])
def test_reads_the_batched_share_of_the_calls_that_needed_dw(monkeypatch, by_path, want):
    monkeypatch.setattr(gru_dv2, "K1_DW", SimpleNamespace(by_path=by_path, products=1))
    assert READER.read(SimpleNamespace()) == want


def test_silent_without_the_tally(monkeypatch):
    monkeypatch.delattr(gru_dv2, "K1_DW")
    assert READER.read(SimpleNamespace()) is None
