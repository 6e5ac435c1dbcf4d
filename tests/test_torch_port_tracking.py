"""The port's run tracking and torch checkpoints, and a JAX learner
checkpoint carried into the port that then trains on as JAX does."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydreamer_tpu.tracking import save_checkpoint_file as jax_save_checkpoint_file
from pydreamer_tpu.training.train_step import TrainStep as JTrainStep
from pydreamer_tpu_torch import tracking
from pydreamer_tpu_torch.convert import jax_checkpoint_to_torch, state_dict_to_jax
from pydreamer_tpu_torch.models.dreamer import Dreamer
from pydreamer_tpu_torch.training.train_step import TrainStep
from tests.test_torch_port_train_step import (LOSS_RTOL, PARAM_ATOL, PARAM_RTOL, _batch, _close,
                                              _conf, _jax_noise, paired_models)


def _trained(conf, steps=1):
    torch.manual_seed(0)
    model = Dreamer(conf, device="cpu")
    ts = TrainStep(model, conf, device="cpu")
    obs = {k: torch.from_numpy(v) for k, v in _batch(conf).items()}
    state = model.init_state(conf.batch_size)
    for step in range(1, steps + 1):
        state, _, _, _ = ts(obs, state, step)
    return model, ts


def _assert_same(a, b):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape and a.device == b.device
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


def test_checkpoint_round_trip(tmp_path):
    """Model (critic targets included), AdamW state and step come back equal;
    the AdamW step counts stay on the CPU; the state loads into a fresh
    model and optimizer."""
    conf = _conf()
    model, ts = _trained(conf, steps=2)
    run = tracking.Run(tmp_path / "run")
    run.save_checkpoint({"model": model.state_dict(), "optimizer": ts.optimizer.state_dict()}, 2)
    state, step = run.load_checkpoint("cpu")
    assert step == 2
    assert any(k.startswith("ac.critic_target.") for k in state["model"])
    _assert_same(state["model"], model.state_dict())
    _assert_same(state["optimizer"], ts.optimizer.state_dict())
    steps = [s["step"] for s in state["optimizer"]["state"].values()]
    assert steps and all(s.device.type == "cpu" and s.item() == 2 for s in steps)

    fresh = Dreamer(conf, device="cpu")
    fresh_ts = TrainStep(fresh, conf, device="cpu")
    fresh.load_state_dict(state["model"])
    fresh_ts.optimizer.load_state_dict(state["optimizer"])
    _assert_same(fresh.state_dict(), model.state_dict())
    _assert_same(fresh_ts.optimizer.state_dict(), ts.optimizer.state_dict())


def test_checkpoint_write_is_atomic(tmp_path, monkeypatch):
    """A save that fails half-way leaves the previous file whole and no
    temporary file behind."""
    path = tmp_path / "checkpoints" / "latest.ckpt"
    tracking.save_checkpoint_file(path, {"model": {"w": torch.ones(3)}}, 1)
    before = path.read_bytes()

    def broken_save(obj, f):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken_save)
    with pytest.raises(OSError, match="disk full"):
        tracking.save_checkpoint_file(path, {"model": {"w": torch.zeros(3)}}, 2)
    assert path.read_bytes() == before
    assert sorted(p.name for p in path.parent.iterdir()) == ["latest.ckpt"]
    monkeypatch.undo()
    state, step = tracking.load_checkpoint_file(path, "cpu")
    assert step == 1 and torch.equal(state["model"]["w"], torch.ones(3))


@pytest.mark.parametrize("content", [None, b"", b"not a checkpoint", b"PK\x03\x04truncated"],
                         ids=["missing", "empty", "garbage", "truncated-zip"])
def test_missing_or_corrupt_checkpoint_is_none(tmp_path, content):
    path = tmp_path / "latest.ckpt"
    if content is not None:
        path.write_bytes(content)
    assert tracking.load_checkpoint_file(path, "cpu") is None


def test_checkpoint_loader_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tracking.load_checkpoint_file(tmp_path / "latest.ckpt")


def test_env_join_and_resume_by_id(tmp_path, monkeypatch):
    monkeypatch.delenv("PYDREAMER_RUN_DIR", raising=False)
    root = tmp_path / "runs"
    first = tracking.init_run(root_dir=str(root), resume_id="job-7")
    assert json.loads((first.dir / "meta.json").read_text())["resume_id"] == "job-7"
    # A subprocess joins the parent run through the environment.
    assert tracking.init_run(root_dir=str(root)).dir == first.dir
    monkeypatch.delenv("PYDREAMER_RUN_DIR")
    # A restarted job finds its run by id; another id makes a new run.
    assert tracking.init_run(root_dir=str(root), resume_id="job-7").dir == first.dir
    monkeypatch.delenv("PYDREAMER_RUN_DIR")
    other = tracking.init_run(root_dir=str(root), resume_id="job-8")
    assert other.dir != first.dir and other.dir.parent == root
    monkeypatch.delenv("PYDREAMER_RUN_DIR")
    explicit = tracking.init_run(run_dir=str(tmp_path / "mine"))
    assert explicit.dir == tmp_path / "mine"


def test_metrics_and_artifacts(tmp_path):
    run = tracking.Run(tmp_path / "run")
    run.log_metrics({"a": 1.5, "b": float("nan"), "c": np.float32(2)}, step=3)
    run.log_metrics({"a": 2}, step=4)
    rows = run.read_metrics()
    assert [r["_step"] for r in rows] == [3, 4]
    assert rows[0]["a"] == 1.5 and "b" not in rows[0] and rows[0]["c"] == 2.0
    data = {"x": np.arange(6).reshape(2, 3), "y": np.ones((1, 2, 2), np.uint8)}
    run.log_npz(data, "d.npz", subdir="dumps")
    back = run.load_npz("d.npz", subdir="dumps")
    for k in data:
        np.testing.assert_array_equal(back[k], data[k])
    run.log_text("hello", "notes.txt")
    assert (run.dir / "notes.txt").read_text() == "hello"


def test_jax_checkpoint_continues_training_in_the_port(tmp_path):
    """A JAX TrainStep takes two steps and saves its learner checkpoint; the
    converted checkpoint loads into the port's TrainStep; both take step 3 on
    the same batch with JAX's noise replayed: losses, metrics, grad norms and
    parameters agree within the two-step test's tolerances."""
    conf = _conf()
    obs = _batch(conf)
    jmodel, params, _ = paired_models(conf)
    jstep = JTrainStep(jmodel, conf, donate=False)
    opt_state = jstep.init_optimizer(params)
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}
    key = np.asarray(jax.random.PRNGKey(2))
    jstate = jmodel.init_state(conf.batch_size)
    for step in (1, 2):
        params, opt_state, jstate, _, _, _ = jstep(params, opt_state, jobs, jstate, step, key)
    path = tmp_path / "latest.ckpt"
    jax_save_checkpoint_file(path, {"params": params, "opt_state": opt_state}, 2)

    model = Dreamer(conf, device="cpu")
    ts = TrainStep(model, conf, device="cpu")
    ckpt = jax_checkpoint_to_torch(path, ts)
    assert ckpt["step"] == 2
    model.load_state_dict(ckpt["model"])
    ts.optimizer.load_state_dict(ckpt["optimizer"])
    # The port's own checkpoint format carries it unchanged.
    tracking.save_checkpoint_file(tmp_path / "port.ckpt", {k: ckpt[k] for k in ("model", "optimizer")}, 2)
    again, step = tracking.load_checkpoint_file(tmp_path / "port.ckpt", "cpu")
    assert step == 2
    _assert_same(again["optimizer"]["state"], ts.optimizer.state_dict()["state"])
    states = list(ts.optimizer.state.values())
    assert len(states) == sum(len(g["params"]) for g in ts.optimizer.param_groups)
    assert all(s["step"].item() == 2 and s["step"].device.type == "cpu" for s in states)
    assert sum(int((s["exp_avg_sq"] > 0).sum()) for s in states) > 0

    tstate = tuple(torch.from_numpy(np.array(x)) for x in jstate)
    params, opt_state, jstate, jmetrics, _, _ = jstep(params, opt_state, jobs, jstate, 3, key)
    tstate, tmetrics, _, _ = ts({k: torch.from_numpy(v) for k, v in obs.items()}, tstate, 3,
                                _jax_noise(conf, jax.random.PRNGKey(2), 3))
    assert set(jmetrics) <= set(tmetrics)
    for name, want in jmetrics.items():
        _close(tmetrics[name].item(), float(want), LOSS_RTOL, 1e-6, f"step 3 {name}")
    back = state_dict_to_jax(model.state_dict(), params)
    flat_want = jax.tree_util.tree_flatten_with_path(params)[0]
    for (p, want), got in zip(flat_want, jax.tree_util.tree_leaves(back)):
        _close(got, want, PARAM_RTOL, PARAM_ATOL, jax.tree_util.keystr(p))
