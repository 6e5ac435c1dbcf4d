"""Public names of the JAX package that the port keeps under the same names:
``tools.NoProfiler`` (in ``__all__``), ``tools.Timer``'s ``verbose``,
``times``, ``dt_mean`` and ``reset``, ``native.load_npz``'s ``nthreads``
and the package's ``__version__``; each against the JAX package on the same
calls."""

import time

import numpy as np
import pytest

import pydreamer_tpu
import pydreamer_tpu_torch
from pydreamer_tpu import tools as jtools
from pydreamer_tpu.native import load_npz as jload_npz
from pydreamer_tpu_torch import tools
from pydreamer_tpu_torch.native import load_npz


def test_version_matches_jax():
    assert pydreamer_tpu_torch.__version__ == pydreamer_tpu.__version__ == "0.1.0"


def test_no_profiler_is_public_as_in_jax():
    assert "NoProfiler" in tools.__all__
    assert set(tools.__all__) == set(jtools.__all__)
    for mod in (tools, jtools):
        with mod.NoProfiler() as prof:
            prof.step()
        assert mod.NoProfiler().__exit__(None, None, None) is False


def _timer_trace(mod, name):
    """The same calls on ``mod.Timer``: two samples, a reset, one more."""
    out = []
    timer = mod.Timer(name, verbose=True)
    out.append((list(timer.times), timer.dt_mean))
    for _ in range(2):
        with mod.Timer(name):
            pass
    out.append((list(timer.times), timer.dt_mean))
    summary = mod.timers_summary(reset=False)[f"timer_{name}"]
    timer.reset()
    out.append((list(timer.times), timer.dt_mean, summary))
    with timer:
        pass
    out.append((list(timer.times), timer.dt_mean))
    timer.reset()
    mod.Timer.registry.pop(name)
    return out


def test_timer_matches_jax(monkeypatch):
    """Both Timers read the same clock values (enter, exit, ...): samples of
    0.5, 1.5 and, after the reset, 0.25 seconds."""
    clock = [0.0, 0.5, 10.0, 11.5, 20.0, 20.25]
    got, want = [], []
    for mod, trace in ((tools, got), (jtools, want)):
        ticks = iter(clock)
        monkeypatch.setattr(time, "time", lambda: next(ticks))
        trace.extend(_timer_trace(mod, "port_names_timer"))
    assert got == want
    assert got == [([], 0.0), ([0.5, 1.5], 1.0), ([], 0.0, 1.0), ([0.25], 0.25)]


@pytest.mark.parametrize("nthreads", [None, 1, 2])
def test_load_npz_nthreads_matches_jax(tmp_path, nthreads):
    rng = np.random.default_rng(0)
    data = {
        "image_t": rng.integers(0, 255, (8, 8, 3, 40), dtype=np.uint8),
        "action": np.eye(4, dtype=np.float32)[rng.integers(0, 4, 40)],
        "reward": rng.normal(size=40).astype(np.float32),
        "reset": np.arange(40) % 7 == 0,
        "fortran": np.asfortranarray(rng.normal(size=(5, 3))),
    }
    path = tmp_path / "ep.npz"
    np.savez_compressed(path, **data)
    got, want = load_npz(path, nthreads=nthreads), jload_npz(path, nthreads=nthreads)
    assert sorted(got) == sorted(want) == sorted(data)
    for k, v in data.items():
        assert got[k].dtype == want[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], v)
