"""The port's learner loop against the JAX package's: ``trainer.run`` on the
CPU from episode files the JAX generator wrote, the metric names it logs
(train, test and eval, open loop included), resume, the eval protocol with
several samples, the profiler window, the RSS recycle and
``prepare_batch_npz``."""

import numpy as np
import pytest
import torch

from pydreamer_tpu.conf import Conf as JConf
from pydreamer_tpu.tracking import Run as JRun
from pydreamer_tpu.training import trainer as jtrainer
from pydreamer_tpu_torch.conf import Conf
from pydreamer_tpu_torch.data.repository import NpzEpisodeRepository
from pydreamer_tpu_torch.tracking import Run, load_checkpoint_file
from pydreamer_tpu_torch.training import trainer
from tests.test_trainer import collect, tiny_conf


def _conf(**over):
    return Conf(tiny_conf(**over).to_dict())


def _long_episodes(path, n_files=2, length=60, seed=0):
    """Files of one long episode each (Grid format), so eval batches after
    the first continue their episodes and the open loop runs."""
    rng = np.random.default_rng(seed)
    repo = NpzEpisodeRepository(path)
    for i in range(n_files):
        reset = np.zeros(length, bool)
        reset[0] = True
        repo.save_data(dict(image_t=rng.integers(0, 256, (64, 64, 3, length), dtype=np.uint8),
                            action=np.eye(4)[rng.integers(0, 4, length)],
                            reward=rng.random(length), terminal=np.zeros(length, bool),
                            reset=reset), i, i)


def _rows(run_dir, prefix):
    return [m for m in Run(run_dir).read_metrics() if any(k.startswith(prefix) for k in m)]


def _keys(rows, prefix):
    return {k for m in rows for k in m if k.startswith(prefix)}


@pytest.fixture(scope="module")
def paired_runs(tmp_path_factory):
    """One JAX and one port trainer.run on the same conf and files: 4 steps,
    logged at 2 and 4 (the first window is skipped), eval at step 2."""
    root = tmp_path_factory.mktemp("paired")
    collect(root / "train")
    _long_episodes(root / "eval")
    over = dict(offline_data_dir=str(root / "train"), offline_eval_dir=str(root / "eval"),
                generator_prefill_steps=0, n_steps=4, log_interval=2, eval_interval=2,
                eval_batches=3, gru_type="gru_layernorm_dv2")
    jtrainer.run(JConf(tiny_conf(**over).to_dict()), run_dir=str(root / "jax"))
    trainer.run(_conf(**over), run_dir=str(root / "port"), device="cpu")
    return root / "jax", root / "port"


def test_port_run_logs_finite_train_metrics(paired_runs):
    _, port = paired_runs
    rows = _rows(port, "train/")
    assert [r["_step"] for r in rows] == [4]
    for k in ("loss_model", "loss_actor", "loss_critic", "grad_norm", "fps", "timer_step"):
        assert np.isfinite(rows[-1][f"train/{k}"]), k
    state, step = load_checkpoint_file(port / "checkpoints" / "latest.ckpt", "cpu")
    assert step == 4 and set(state) == {"model", "optimizer"}
    for sub in ("d2_wm_closed", "d2_wm_dream", "d2_wm_closed_test", "d2_wm_closed_eval"):
        assert list((port / sub).glob("*.npz")), sub


def test_train_metric_names_match_jax(paired_runs):
    jax_dir, port = paired_runs
    want = {k for m in JRun(jax_dir).read_metrics() for k in m if k.startswith("train/")}
    assert _keys(_rows(port, "train/"), "train/") == want


@pytest.mark.parametrize("prefix", ["test/", "eval/"])
def test_eval_metric_names_match_jax(paired_runs, prefix):
    jax_dir, port = paired_runs
    want = {k for m in JRun(jax_dir).read_metrics() for k in m if k.startswith(prefix)}
    got = _keys(_rows(port, prefix), prefix)
    assert got == want
    assert f"{prefix}loss_model" in got and any(k.endswith("_open") for k in got), got
    assert [r["_step"] for r in _rows(port, prefix)] == [2]


def test_resume_at_saved_step(tmp_path, monkeypatch):
    """2 steps, then a run to 4: the second run loads step 2 with the saved
    parameters and optimizer state, takes steps 3 and 4, and logs the
    prefill counter at step 2 (not at 0 as the JAX loop does)."""
    run_dir = tmp_path / "run"
    collect(run_dir / "episodes" / "0")
    conf = _conf(generator_prefill_steps=100, n_steps=2, log_interval=1)
    trainer.run(conf, run_dir=str(run_dir), device="cpu")
    saved, saved_step = load_checkpoint_file(run_dir / "checkpoints" / "latest.ckpt", "cpu")
    assert saved_step == 2

    calls = []

    class Recording(trainer.TrainStep):
        def __call__(self, obs, in_state, step, **kw):
            if not calls:
                for k, v in self.model.state_dict().items():
                    assert torch.equal(v, saved["model"][k]), k
                for i, s in self.optimizer.state_dict()["state"].items():
                    for name, v in s.items():
                        assert torch.equal(v, saved["optimizer"]["state"][i][name]), (i, name)
            calls.append(step)
            return super().__call__(obs, in_state, step, **kw)

    monkeypatch.setattr(trainer, "TrainStep", Recording)
    trainer.run(conf.replace(n_steps=4), run_dir=str(run_dir), device="cpu")
    assert calls == [3, 4]
    prefill = [r["_step"] for r in Run(run_dir).read_metrics() if "train/data_steps" in r
               and "train/loss_model" not in r]
    assert prefill == [0, 2]
    assert load_checkpoint_file(run_dir / "checkpoints" / "latest.ckpt", "cpu")[1] == 4


def test_eval_multisample_open_loop(tmp_path):
    """eval_samples > 1: the (B*I) state threads through the open-loop
    masking across batches, with B != I."""
    run_dir = tmp_path / "run"
    collect(run_dir / "episodes" / "0")
    _long_episodes(run_dir / "episodes_eval" / "0")
    conf = _conf(generator_prefill_steps=100, n_steps=3, eval_interval=2, eval_samples=2,
                 eval_batches=3, eval_batch_size=3)
    trainer.run(conf, run_dir=str(run_dir), device="cpu")
    got = _keys(_rows(run_dir, "eval/"), "eval/")
    assert "eval/loss_model" in got and any(k.startswith("eval/logprob") and k.endswith("_open")
                                            for k in got), got


def test_profiler_writes_a_trace_and_rss_recycle(tmp_path):
    run_dir = tmp_path / "run"
    collect(run_dir / "episodes" / "0")
    conf = _conf(generator_prefill_steps=100, n_steps=14, log_interval=7, enable_profiler=True)
    assert trainer.run(conf, run_dir=str(run_dir), device="cpu") is None
    assert list((run_dir / "profiling").glob("trace_*.json"))
    # Past max_rss_gb the loop checkpoints at the next log step and asks for a recycle.
    out = trainer.run(conf.replace(n_steps=30, enable_profiler=False, max_rss_gb=1e-6),
                      run_dir=str(run_dir), device="cpu")
    assert out == "recycle"
    assert load_checkpoint_file(run_dir / "checkpoints" / "latest.ckpt", "cpu")[1] == 21


def test_profile_window_resumed_past_its_start_or_ended_inside(tmp_path):
    """A run resumed at step 12 reaches the window's end without a trace and
    goes on; a run that ends inside the window leaves no profiler running."""
    run_ = Run(tmp_path / "run")
    resumed = trainer._ProfileWindow(run_, torch.device("cpu"), enabled=True)
    for step in (13, 14):
        resumed.before_step(step)
    assert resumed.profiler is None and not (tmp_path / "run" / "profiling").exists()
    ended = trainer._ProfileWindow(run_, torch.device("cpu"), enabled=True)
    ended.before_step(11)
    assert torch.autograd._profiler_enabled()
    ended.close()
    assert not torch.autograd._profiler_enabled()


def test_prepare_batch_npz_matches_jax():
    rng = np.random.default_rng(0)
    T, B = 3, 4
    onehot = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (T, B, 6, 6))]
    data = {"image": rng.integers(0, 256, (T, B, 6, 6, 3), dtype=np.uint8),
            "image_rec": rng.random((T, B, 6, 6, 3)).astype(np.float32) - 0.5,
            "image_pred": rng.random((T, B, 6, 6, 1)),
            "map": onehot, "map_rec": rng.normal(size=(T, B, 6, 6, 5)).astype(np.float16),
            "reward": rng.random((T, B)), "action": rng.random((T, B, 2)).astype(np.float32)}
    for take_b in (999, 2):
        got = trainer.prepare_batch_npz(dict(data), take_b=take_b)
        want = jtrainer.prepare_batch_npz(dict(data), take_b=take_b)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_run_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.run(_conf(), run_dir=str(tmp_path / "run"))
    assert not (tmp_path / "run").exists()


def test_make_model_raises_for_baselines():
    """The four baselines build (tests/test_torch_port_baselines.py trains
    them); a name that is neither ``dreamer`` nor a baseline raises, as in JAX."""
    assert type(trainer.make_model(_conf(model="vae"), "cpu")).__name__ == "WorldModelProbe"
    with pytest.raises(ValueError, match="unknown baseline model"):
        trainer.make_model(_conf(model="vae_x"), "cpu")
