"""The training traffic: distinct rows, resets at the episode length, the
same inputs from the same seed, keyed noise."""

import torch

from benchmark.feed import Feed
from benchmark.noise import KeyedNoise
from benchmark.tests.tiny import tiny_spec


def test_batches_differ_and_repeat_by_seed():
    spec = tiny_spec("dmc-train")
    a, b = Feed(spec.conf, spec.mix, 9, "cpu"), Feed(spec.conf, spec.mix, 9, "cpu")
    for s in (1, 2, 3):
        assert all(torch.equal(a.batch(s)[k], b.batch(s)[k]) for k in a.batch(s))
    assert not torch.equal(a.batch(1)["image"], a.batch(2)["image"])
    assert torch.equal(a.batch(1)["image"], a.batch(1 + spec.mix["pool_batches"])["image"])
    assert a.batch(1)["action"].abs().max() <= 1.0


def test_resets_fall_every_episode():
    spec = tiny_spec("dmc-train", env_time_limit=7)
    feed = Feed(spec.conf, spec.mix, 3, "cpu")
    T = spec.conf["batch_length"]
    resets = torch.cat([feed.batch(s)["reset"] for s in range(1, 15)])  # (14 T, B)
    for b in range(resets.shape[1]):
        at = torch.nonzero(resets[:, b]).flatten()
        assert len(at) >= (14 * T) // 7 and torch.all(at.diff() == 7)


def test_noise_is_keyed_not_ordered():
    a, b = KeyedNoise(1, 2, "cpu"), KeyedNoise(1, 2, "cpu")
    x1 = a.draw("dream_z", (3, 4), "gumbel", 0)
    a.draw("other", (5,), "normal")
    y1 = b.draw("other", (5,), "normal")
    x2 = b.draw("dream_z", (3, 4), "gumbel", 0)
    assert torch.equal(x1, x2)
    assert not torch.equal(x1, KeyedNoise(1, 3, "cpu").draw("dream_z", (3, 4), "gumbel", 0))
    assert y1.shape == (5,)
