"""The port's data pipeline against the JAX package's: episode names, the
repository over files the JAX generator wrote, SequentialDataset and
Preprocessor byte for byte for the same seed, the loaders, the CPU prefetch
and the native npz reader."""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from pydreamer_tpu import generator as gen
from pydreamer_tpu.data import repository as jrepo
from pydreamer_tpu.data.dataset import SequentialDataset as JSequentialDataset
from pydreamer_tpu.data.preprocessing import Preprocessor as JPreprocessor
from pydreamer_tpu_torch import native
from pydreamer_tpu_torch.data import (ParallelLoader, Preprocessor, SequentialDataset,
                                      make_repository, prefetch_iterator)
from pydreamer_tpu_torch.data import repository as trepo

N_BATCHES = 12


@pytest.fixture(scope="module")
def gen_dir(tmp_path_factory):
    """Episode files written by the JAX generator (random policy, Grid env)."""
    d = tmp_path_factory.mktemp("gen") / "episodes"
    gen.main(env_id="Grid-4x64", save_uri=str(d), worker_id=0, policy_main="random",
             num_steps=400, env_time_limit=40, steps_per_npz=60, log_metrics=False)
    return d


@pytest.mark.parametrize("args", [
    (0, 5, 4.0, 65, None), (12, 13, -1.4, 1000, 3), (7, 7, 0.49, 0, 0), (123456, 123499, 2.5, 12345, 17),
], ids=str)
def test_episode_names_round_trip(args):
    name = trepo.build_episode_name(*args)
    assert name == jrepo.build_episode_name(*args)
    assert trepo.parse_episode_name(name) == jrepo.parse_episode_name(name) == (args[0], args[1], args[3])


@pytest.mark.parametrize("name", ["foo-0123.npz", "ep_bad-x.npz", "dir/ep000001_000002-r3-0050.npz",
                                  "episode.npz", "epx_y-1-r0-12.npz"])
def test_foreign_names_parse_as_jax(name):
    assert trepo.parse_episode_name(name) == jrepo.parse_episode_name(name)


def test_repository_reads_jax_generator_files(gen_dir):
    mine, ref = make_repository(str(gen_dir)), jrepo.make_repository(str(gen_dir))
    assert mine.count_steps() == ref.count_steps()
    assert mine.count_steps()[1] >= 300
    files = sorted(mine.list_files(), key=lambda f: f.path)
    assert [f.path for f in files] == sorted(f.path for f in ref.list_files())
    with np.load(files[0].path) as npz:
        want = {k: npz[k] for k in npz.files}
    got = files[0].load_data()
    assert set(got) == set(want) and "image_t" in got
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_save_data_writes_jax_names_atomically(tmp_path):
    data = dict(reset=np.array([True, False, False, True, False]), reward=np.array([0, 1, 2, 0, 0.5]),
                action=np.eye(3)[[0, 1, 2, 0, 1]], image_t=np.zeros((4, 4, 3, 5), np.uint8))
    trepo.NpzEpisodeRepository(tmp_path / "a").save_data(data, 3, 4, 2)
    jrepo.NpzEpisodeRepository(tmp_path / "b").save_data(data, 3, 4, 2)
    names = [sorted(p.name for p in (tmp_path / d).iterdir()) for d in "ab"]
    assert names[0] == names[1] == ["ep000003_000004-2-r4-0003.npz"]
    loaded = make_repository(str(tmp_path / "a")).list_files()[0].load_data()
    for k, v in data.items():
        np.testing.assert_array_equal(loaded[k], v)


@pytest.mark.parametrize("reset_interval", [0, 12])
@pytest.mark.parametrize("allow_mid_reset", [True, False])
@pytest.mark.parametrize("skip_first", [True, False])
def test_sequential_dataset_matches_jax(gen_dir, reset_interval, allow_mid_reset, skip_first):
    kw = dict(batch_length=10, batch_size=3, skip_first=skip_first, reset_interval=reset_interval,
              allow_mid_reset=allow_mid_reset, seed=5)
    mine = iter(SequentialDataset(make_repository(str(gen_dir)), **kw))
    ref = iter(JSequentialDataset(jrepo.make_repository(str(gen_dir)), **kw))
    prep, jprep = (P(image_key="image", action_dim=4, clip_rewards="tanh")
                   for P in (Preprocessor, JPreprocessor))
    resets = 0
    for i in range(N_BATCHES):
        got, want = next(mine), next(ref)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), f"batch {i} {k}"
        got_p, want_p = prep.apply(got), jprep.apply(want)
        assert set(got_p) == set(want_p)
        for k in want_p:
            assert got_p[k].dtype == want_p[k].dtype, k
            assert got_p[k].tobytes() == want_p[k].tobytes(), f"preprocessed batch {i} {k}"
        assert got_p["image"].dtype == np.uint8 and got_p["image"].shape[:2] == (10, 3)
        resets += int(got["reset"][1:].sum()) + int(got["reset"][0].sum())
    assert resets > 0


def test_preprocessor_matches_jax_on_options():
    rng = np.random.default_rng(0)
    T, B = 4, 3
    batch = dict(image=rng.integers(0, 5, (T, B, 6, 6)), action=rng.integers(0, 3, (T, B)),
                 reward=rng.normal(size=(T, B)) * 5, terminal=rng.random((T, B)) < 0.2,
                 reset=rng.random((T, B)) < 0.2, vecobs=rng.normal(size=(T, B, 2)),
                 map=rng.integers(0, 4, (T, B, 5, 5)), map_seen=rng.integers(0, 2, (T, B, 5, 5)),
                 agent_pos=rng.random((T, B, 2)), agent_dir=rng.random((T, B, 2)),
                 targets_vec=rng.random((T, B, 3, 2)), target_vec=rng.random((T, B, 2)),
                 policy_value=rng.random((T, B)))
    for clip in ("tanh", "log1p", "symlog", None):
        kw = dict(image_key="image", map_key="map", image_categorical=5, map_categorical=4,
                  action_dim=3, clip_rewards=clip)
        got, want = Preprocessor(**kw).apply(batch), JPreprocessor(**kw).apply(batch)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{clip} {k}")


def _counting_stream(worker_id):
    for i in range(1000):
        yield {"x": np.full((2, 3), 10 * worker_id + i, np.int64)}


@pytest.mark.parametrize("num_workers", [0, 3])
def test_parallel_loader(num_workers):
    loader = ParallelLoader(_counting_stream, num_workers=num_workers, strict_order=num_workers > 0)
    it = iter(loader)
    seen = [next(it) for _ in range(9)]
    wids = [wid for _, wid in seen]
    assert wids == ([0] * 9 if num_workers == 0 else [0, 1, 2] * 3)
    counts = {}
    for batch, wid in seen:
        assert batch["x"][0, 0] == 10 * wid + counts.get(wid, 0)
        counts[wid] = counts.get(wid, 0) + 1
    loader.close()
    it.close()
    for t in loader._threads:
        t.join(timeout=10)
        assert not t.is_alive()


def test_parallel_loader_stress_more_workers_than_cores():
    """Arrival order through one shared queue with more threads than cores and
    a short switch interval: every worker's items arrive once, in its order."""
    n_workers, n_items = (os.cpu_count() or 1) + 2, 40

    def make(worker_id):
        for i in range(n_items):
            yield {"i": np.array(i)}

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        loader = ParallelLoader(make, num_workers=n_workers, queue_size=3)
        it = iter(loader)
        got = {}
        for _ in range(n_workers * n_items):
            batch, wid = next(it)
            got.setdefault(wid, []).append(int(batch["i"]))
        it.close()
    finally:
        sys.setswitchinterval(old)
    assert got == {w: list(range(n_items)) for w in range(n_workers)}
    for t in loader._threads:
        t.join(timeout=10)
        assert not t.is_alive()


def test_parallel_loader_worker_crash_raises():
    def make(worker_id):
        yield {"x": np.zeros(1)}
        raise OSError("disk gone")

    it = iter(ParallelLoader(make, num_workers=2))
    with pytest.raises(RuntimeError, match="crashed"):
        for _ in range(10):
            next(it)


def test_prefetch_cpu_yields_tensors_equal_to_numpy():
    rng = np.random.default_rng(1)
    items = [({"image": rng.integers(0, 256, (4, 2, 8, 8, 3), dtype=np.uint8).swapaxes(0, 1),
               "reset": rng.random((4, 2)) < 0.5, "action": rng.random((4, 2, 3)).astype(np.float32)},
              i % 2) for i in range(5)]
    stats = lambda item: (*item, {"n": float(item[0]["action"].sum())})  # noqa: E731
    out = list(prefetch_iterator(iter(items), "cpu", size=2, transform=stats))
    assert len(out) == len(items)
    for (batch, wid, st), (src, src_wid) in zip(out, items):
        assert wid == src_wid and st == {"n": float(src["action"].sum())}
        for k, v in src.items():
            assert isinstance(batch[k], torch.Tensor) and batch[k].device.type == "cpu"
            np.testing.assert_array_equal(batch[k].numpy(), v)


def test_prefetch_producer_error_reaches_consumer():
    def items():
        yield {"x": np.zeros(2)}
        raise KeyError("bad item")

    it = prefetch_iterator(items(), "cpu")
    next(it)
    with pytest.raises(KeyError, match="bad item"):
        next(it)


def test_prefetch_close_stops_producer():
    it = prefetch_iterator(({"x": np.zeros(3)} for _ in iter(int, 1)), "cpu", size=1)
    next(it)
    before = {t for t in threading.enumerate() if t.name == "prefetch"}
    it.close()
    assert not any(t.is_alive() for t in before)


def test_native_reader_matches_np_load(tmp_path):
    assert native.native_available() and native.reader_name() == "native"
    rng = np.random.RandomState(0)
    data = {"image_t": rng.randint(0, 255, (16, 16, 3, 70), dtype=np.uint8),
            "action": rng.rand(70, 6), "reward": rng.randn(70).astype(np.float32),
            "reset": rng.rand(70) < 0.1, "scalarish": np.array(3.5), "f_order": np.asfortranarray(rng.rand(3, 4))}
    for i, save in enumerate((lambda f: trepo.save_npz_fast(f, data),
                              lambda f: np.savez_compressed(f, **data),
                              lambda f: np.savez(f, **data))):
        path = tmp_path / f"s{i}.npz"
        with open(path, "wb") as f:
            save(f)
        got = native.load_npz(path)
        with np.load(path) as npz:
            want = {k: npz[k] for k in npz.files}
        assert set(got) == set(want) == set(data)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
