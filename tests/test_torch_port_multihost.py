"""The port's learner on several ranks: ``trainer.run`` on gloo CPU ranks and
the launcher that starts them (the port's counterpart of
``tests/test_multihost.py``, small enough for Tier-1).

Two ranks train from one offline dataset (``Grid-4x64`` files written by the
port's generator) into one run directory. Rank 1 makes every ``Run`` writer
raise (``test_torch_port_parallel_worker.py``), so a write that is not rank
0's fails the run. Checked: unique metric steps, the checkpoint, npz dumps of
the global batch, the eval on rank 0, a resume on two ranks, a tensor-parallel
checkpoint in the single-process format, the unanimous RSS recycle, and the
launcher starting two learner ranks.
"""

import json
import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import psutil
import pytest
import torch

from pydreamer_tpu_torch import generator
from pydreamer_tpu_torch.conf import Conf
from pydreamer_tpu_torch.models.dreamer import Dreamer
from pydreamer_tpu_torch.tracking import Run, load_checkpoint_file
from pydreamer_tpu_torch.training import trainer
from tests.test_torch_port_parallel import ROOT, spawn_ranks
from tests.test_trainer import tiny_conf


def _collect(path, steps=150):
    generator.main(env_id="Grid-4x64", save_uri=str(path), worker_id=0, policy_main="random",
                   num_steps=steps, env_time_limit=20, steps_per_npz=50, log_metrics=False,
                   device="cpu")


def _conf(data_dir, run_dir, **over):
    """JAX's multihost worker conf (tests/multihost_worker.py:42-62): global
    batch 4, 2 data streams, logs at 2, a dump at 1 and 4, checkpoints every
    2 steps, the eval at 3."""
    base = dict(batch_size=4, batch_length=8, mesh_data=2, mesh_model=1,
                n_steps=4, log_interval=2, logbatch_interval=3, save_interval=2, eval_interval=3,
                data_workers=2, generator_workers=0, generator_prefill_steps=0,
                buffer_size_offline=10**6, offline_data_dir=str(data_dir),
                offline_eval_dir=str(data_dir), offline_test_dir=str(data_dir),
                run_dir=str(run_dir), keep_state=True, platform="cpu")
    base.update(over)
    return tiny_conf(**base).to_dict()


def _train(tmp, conf, world=2, per_rank=None):
    """``trainer.run`` on ``world`` gloo ranks; -> each rank's output."""
    inputs = tmp / f"in_{len(list(tmp.glob('in_*')))}"
    inputs.mkdir()
    (inputs / "conf.json").write_text(json.dumps(conf))
    for r, over in (per_rank or {}).items():
        (inputs / f"conf{r}.json").write_text(json.dumps(over))
    return spawn_ranks("trainer", inputs, inputs, world)


@pytest.fixture(scope="module")
def episodes(tmp_path_factory):
    root = tmp_path_factory.mktemp("episodes")
    old = os.environ.get("PYDREAMER_RUN_DIR")
    os.environ["PYDREAMER_RUN_DIR"] = str(root / "gen_run")
    try:
        _collect(root / "data")
    finally:
        if old is None:
            os.environ.pop("PYDREAMER_RUN_DIR", None)
        else:
            os.environ["PYDREAMER_RUN_DIR"] = old
    return root / "data"


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory, episodes):
    """Two data ranks, 4 steps; -> (run dir, outputs by rank)."""
    tmp = tmp_path_factory.mktemp("dp")
    outs = _train(tmp, _conf(episodes, tmp / "run"))
    return tmp / "run", outs


def _trained_steps(run_dir):
    return [m["_step"] for m in Run(run_dir).read_metrics() if "train/loss_model" in m]


def test_rank_0_alone_writes_unique_metric_rows(dp_run):
    run_dir, outs = dp_run
    assert [f"RESULT {r} None" in out for r, out in enumerate(outs)] == [True, True]
    rows = [m for m in Run(run_dir).read_metrics() if "train/loss_model" in m]
    assert [m["_step"] for m in rows] == [4]
    assert all(np.isfinite(m["train/loss_model"]) for m in rows)
    assert (run_dir / "architecture.txt").exists()


def test_checkpoint_holds_the_last_step(dp_run):
    run_dir, _ = dp_run
    state, step = load_checkpoint_file(run_dir / "checkpoints" / "latest.ckpt", "cpu")
    assert step == 4 and set(state) == {"model", "optimizer"}


@pytest.mark.parametrize("subdir", ["d2_wm_closed", "d2_wm_dream"])
def test_npz_dumps_hold_the_global_batch(dp_run, subdir):
    """The dumps hold B = 4, the global batch, though each rank steps on 2."""
    run_dir, _ = dp_run
    files = sorted((run_dir / subdir).glob("*.npz"))
    assert [f.name for f in files] == ["0000001.npz", "0000004.npz"]
    for f in files:
        with np.load(f) as data:
            assert data["reward"].shape == (4, 8), f    # (B, T) after prepare_batch_npz
            assert all(v.shape[0] == 4 for v in data.values()), {k: v.shape for k, v in data.items()}


def test_eval_runs_on_rank_0_only(dp_run):
    run_dir, outs = dp_run
    evals = [m["_step"] for m in Run(run_dir).read_metrics() if "eval/loss_model" in m]
    assert evals == [3]
    assert "Evaluation (eval)" in outs[0] and "Evaluation (" not in outs[1]


def test_resume_on_two_ranks(dp_run, episodes, tmp_path):
    """A second session on two ranks loads step 4 on each and trains to 6."""
    run_dir = tmp_path / "run"
    shutil.copytree(dp_run[0], run_dir)
    outs = _train(tmp_path, _conf(episodes, run_dir, n_steps=6))
    assert all("Loaded model from checkpoint epoch 4" in out for out in outs)
    assert load_checkpoint_file(run_dir / "checkpoints" / "latest.ckpt", "cpu")[1] == 6
    steps = _trained_steps(run_dir)
    assert steps == [4, 6], steps


def test_tensor_parallel_checkpoint_is_the_single_process_format(episodes, tmp_path):
    """(data 1, model 2) with the GRU gate kernels and the wide Dense weights
    sharded, the eval on rank 0's gathered copy: the checkpoint is whole,
    loads into a single-process model and equals a single-process run of the
    same steps."""
    over = dict(mesh_data=1, mesh_model=2, tp_min_size=64, data_workers=0,
                gru_type="gru_layernorm_dv2", n_steps=3, eval_interval=2, logbatch_interval=1000)
    outs = _train(tmp_path, _conf(episodes, tmp_path / "tp", **over))
    assert "Sharded over 'model'" in outs[0] and "cell_0.weight_ih" in outs[0]
    assert "Evaluation (eval)" in outs[0] and "Evaluation (" not in outs[1]
    tp, step = load_checkpoint_file(tmp_path / "tp" / "checkpoints" / "latest.ckpt", "cpu")
    assert step == 3

    single = _conf(episodes, tmp_path / "single", **dict(over, mesh_model=1, mesh_data=1))
    trainer.run(Conf(single), run_dir=single["run_dir"], device="cpu")
    want, _ = load_checkpoint_file(tmp_path / "single" / "checkpoints" / "latest.ckpt", "cpu")
    model = Dreamer(Conf(single), device="cpu")
    model.load_state_dict(tp["model"])  # strict: every parameter whole
    for k, v in want["model"].items():
        torch.testing.assert_close(tp["model"][k], v, rtol=1e-4, atol=1e-5, msg=k)
    for i, s in want["optimizer"]["state"].items():
        for k, v in s.items():
            torch.testing.assert_close(tp["optimizer"]["state"][i][k], v, rtol=1e-4, atol=1e-5)


def test_rss_recycle_is_unanimous(episodes, tmp_path):
    """Only rank 1 passes its max_rss_gb; both ranks checkpoint and return
    "recycle" at the first log step (JAX lets each process decide alone)."""
    conf = _conf(episodes, tmp_path / "run", n_steps=30, eval_interval=0, max_rss_gb=1e6)
    outs = _train(tmp_path, conf, per_rank={1: {"max_rss_gb": 1e-6}})
    assert ["RESULT 0 recycle" in outs[0], "RESULT 1 recycle" in outs[1]] == [True, True]
    assert load_checkpoint_file(tmp_path / "run" / "checkpoints" / "latest.ckpt", "cpu")[1] == 2


def _session(p):
    try:
        return os.getsid(p.pid)
    except (ProcessLookupError, PermissionError):
        return None


def test_launcher_starts_two_learner_ranks(tmp_path):
    """``launch`` with ``mesh_data: 2`` on the CPU: one generator, two learner
    ranks that train, and exit 0 with no process left."""
    run_dir = tmp_path / "run"
    cmd = [sys.executable, "-m", "pydreamer_tpu_torch.launch", "--configs", "defaults",
           "gridworld", "debug", "--mesh_data", "2", "--batch_size", "4", "--eval_interval", "0",
           "--run_dir", str(run_dir), "--n_steps", "4", "--generator_prefill_steps", "300",
           "--save_interval", "3", "--log_interval", "2", "--logbatch_interval", "1000"]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    env.pop("PYDREAMER_RUN_DIR", None)
    proc = subprocess.Popen(cmd, env=env, cwd=ROOT, start_new_session=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        out, _ = proc.communicate(timeout=240)
    finally:
        os.killpg(proc.pid, signal.SIGKILL) if proc.poll() is None else None
    assert proc.returncode == 0, f"launch failed:\n{out[-6000:]}"
    for line in ("Launching learner rank 0", "Launching learner rank 1", "Learner K1 launches",
                 "Learner rank 1 K1 launches", "Learner finished; shutting down generators."):
        assert line in out, line
    assert out.count("Done prefilling") == 2
    assert load_checkpoint_file(run_dir / "checkpoints" / "latest.ckpt", "cpu")[1] == 4
    assert _trained_steps(run_dir) == [4]
    left = [p for p in psutil.process_iter(["pid"]) if _session(p) == proc.pid]
    assert not left, left
