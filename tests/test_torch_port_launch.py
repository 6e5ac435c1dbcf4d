"""The port's launcher (``pydreamer_tpu_torch/launch.py``) against the JAX package's.

The role helpers (TF_CONFIG) and the watchdog are checked on both packages
with the same cases. Then one whole ``python -m pydreamer_tpu_torch.launch
--configs defaults gridworld debug`` on the CPU, with the assertions of the
JAX package's ``test_full_topology_launch``: generators wrote episodes, the
learner logged finite losses and a checkpoint, and the launcher shut the
generators down and exited 0 with no child left. Last, SIGTERM to the
launcher reaps its workers.
"""

import json
import multiprocessing as mp
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import psutil
import pytest

import pydreamer_tpu.launch as jlaunch
import pydreamer_tpu_torch.launch as tlaunch

REPO_ROOT = Path(__file__).resolve().parent.parent
BOTH = pytest.mark.parametrize("launch", [jlaunch, tlaunch], ids=["jax", "port"])

_CLUSTER = {"chief": ["c:1"], "worker": ["w0:1", "w1:1"]}


@BOTH
@pytest.mark.parametrize("tf_config,info,owned,not_owned", [
    (None, (None, None), [("learner", 0), ("generator", 3)], []),
    ({"cluster": _CLUSTER, "task": {"type": "chief", "index": 0}}, ("learner", 0),
     [("learner", 0)], [("generator", 0)]),
    ({"cluster": _CLUSTER, "task": {"type": "worker", "index": 1}}, ("generator", 1),
     [("generator", 1)], [("generator", 0), ("learner", 0)]),
    ({"cluster": {"chief": ["c:1"]}, "task": {"type": "chief", "index": 0}}, (None, None),
     [("learner", 0), ("generator", 2)], []),
], ids=["single_node", "chief", "worker", "no_workers"])
def test_worker_roles(launch, monkeypatch, tf_config, info, owned, not_owned):
    if tf_config is None:
        monkeypatch.delenv("TF_CONFIG", raising=False)
    else:
        monkeypatch.setenv("TF_CONFIG", json.dumps(tf_config))
    assert launch.get_worker_info() == info
    assert all(launch.belongs_to_worker(*w) for w in owned)
    assert not any(launch.belongs_to_worker(*w) for w in not_owned)


def _exit_zero():
    pass


def _exit_nonzero():
    raise SystemExit(3)


@BOTH
@pytest.mark.parametrize("target,raises", [(_exit_zero, False), (_exit_nonzero, True)])
def test_watchdog(launch, target, raises):
    p = mp.get_context("spawn").Process(target=target)
    p.start()
    p.join(timeout=30)
    assert not p.is_alive()
    procs = [p]
    if raises:
        with pytest.raises(RuntimeError, match="exitcode 3"):
            launch.check_subprocesses(procs)
    else:
        launch.check_subprocesses(procs)
        assert procs == []


def test_log_params_matches_jax(tmp_path):
    """The launcher's ``run_.log_params(conf.to_dict())``: the same params.json."""
    from pydreamer_tpu.conf import parse_args as jparse
    from pydreamer_tpu.tracking import Run as JRun
    from pydreamer_tpu_torch.conf import parse_args
    from pydreamer_tpu_torch.tracking import Run
    argv = ["--configs", "defaults", "gridworld", "debug", "--n_steps", "7"]
    config_dir = str(REPO_ROOT / "config")
    JRun(tmp_path / "jax").log_params(jparse(argv, config_dir=config_dir).to_dict())
    Run(tmp_path / "port").log_params(parse_args(argv, config_dir=config_dir).to_dict())
    want = (tmp_path / "jax" / "params.json").read_text()
    assert (tmp_path / "port" / "params.json").read_text() == want
    assert json.loads(want)["n_steps"] == 7


def _append_metrics(run_dir, worker):
    from pydreamer_tpu_torch.tracking import Run
    run_ = Run(run_dir)
    for i in range(200):
        run_.log_metrics({f"agent/m{k}": worker + i / 1000 for k in range(150)}, step=i)


def test_metrics_lines_from_many_processes(tmp_path):
    """Generators and the learner append to one metrics.jsonl: lines of
    ~4 KB from four processes at once stay whole."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_append_metrics, args=(tmp_path, w)) for w in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=60)
        assert p.exitcode == 0
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 800
    rows = [json.loads(line) for line in lines]
    for w in range(4):
        mine = [r for r in rows if int(r["agent/m0"]) == w]
        assert [r["_step"] for r in mine] == list(range(200))
        assert all(len(r) == 152 for r in mine)


def _launch_cmd(run_dir, *extra):
    return [sys.executable, "-m", "pydreamer_tpu_torch.launch",
            "--configs", "defaults", "gridworld", "debug",
            "--eval_interval", "0", "--run_dir", str(run_dir), *extra]


def _env():
    # Two threads a process: the tier-1 run shares the host's cores among its
    # test workers, and oversubscribed OpenMP threads spin each other out.
    return dict(os.environ, PYTHONPATH=str(REPO_ROOT), OMP_NUM_THREADS="2")


def test_full_topology_launch(tmp_path):
    """The CPU launcher end to end: 1 generator (random prefill of 300 steps,
    then the network policy), the learner for 4 steps on the CPU (the debug
    preset), a checkpoint at 3 and at 4."""
    run_dir = tmp_path / "run"
    proc = subprocess.Popen(
        _launch_cmd(run_dir, "--n_steps", "4", "--generator_prefill_steps", "300",
                    "--save_interval", "3", "--log_interval", "2",
                    "--logbatch_interval", "1000"),
        env=_env(), cwd=str(REPO_ROOT), start_new_session=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        out, _ = proc.communicate(timeout=240)
    finally:
        os.killpg(proc.pid, signal.SIGKILL) if proc.poll() is None else None
    assert proc.returncode == 0, f"launch failed:\n{out[-4000:]}"
    assert list((run_dir / "episodes" / "0").glob("*.npz")), "generator wrote no episodes"
    from pydreamer_tpu_torch.tracking import Run, load_checkpoint_file
    trained = [m for m in Run(run_dir).read_metrics() if "train/loss_model" in m]
    assert trained and np.isfinite(trained[-1]["train/loss_model"])
    assert load_checkpoint_file(run_dir / "checkpoints" / "latest.ckpt", "cpu")[1] == 4
    assert json.loads((run_dir / "params.json").read_text())["env_id"] == "Grid-8x64"
    assert "Done prefilling" in out and "Learner device: cpu" in out
    assert "Learner finished; shutting down generators." in out
    left = [p for p in psutil.process_iter(["pid"]) if _session(p) == proc.pid]
    assert not left, left


def _session(p):
    try:
        return os.getsid(p.pid)
    except (ProcessLookupError, PermissionError):
        return None


def test_sigterm_reaps_worker_pool(tmp_path):
    """SIGTERM to the launcher kills the spawned learner and generators."""
    proc = subprocess.Popen(
        _launch_cmd(tmp_path / "run", "--n_steps", "100000",
                    "--generator_prefill_steps", "100000"),
        env=_env(), cwd=str(REPO_ROOT),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        ps = psutil.Process(proc.pid)
        deadline = time.time() + 120
        workers = []
        while time.time() < deadline and len(workers) < 2:
            workers = [c for c in ps.children(recursive=True)
                       if "spawn_main" in " ".join(c.cmdline())]
            time.sleep(0.5)
        assert len(workers) >= 2, "launcher never spawned its learner and generator"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 128 + signal.SIGTERM
        time.sleep(1)
        survivors = [c for c in workers if c.is_running() and c.status() != psutil.STATUS_ZOMBIE]
        assert not survivors, survivors
    finally:
        for c in psutil.Process(proc.pid).children(recursive=True) if proc.poll() is None else []:
            c.kill()
        proc.kill()


def test_model_reload_interval_reaches_every_generator(tmp_path, monkeypatch):
    """``--model_reload_interval`` is the launcher's own flag, not a config
    key (the config stays JAX's): it goes to each generator it starts, 120 s
    (``generator.main``'s default) when not given."""
    seen = []

    class Stop(Exception):
        pass

    def fake_generator(ctx, env_id, conf, **kw):
        seen.append((conf.to_dict(), kw["model_reload_interval"]))
        if len(seen) % 2 == 0:  # both generators asked for: stop before the learner starts
            raise Stop
        return None

    monkeypatch.setattr(tlaunch, "launch_generator", fake_generator)
    monkeypatch.setenv("PYDREAMER_RUN_DIR", str(tmp_path / "run"))
    handler = signal.getsignal(signal.SIGTERM)
    argv = ["--configs", "defaults", "gridworld", "debug", "--generator_workers", "2",
            "--model", "dreamer"]  # a config key that starts like the flag
    try:
        with pytest.raises(Stop):
            tlaunch.launch(argv + ["--model_reload_interval", "15"],
                           config_dir=str(REPO_ROOT / "config"))
        with pytest.raises(Stop):
            tlaunch.launch(argv, config_dir=str(REPO_ROOT / "config"))
    finally:
        signal.signal(signal.SIGTERM, handler)
    from pydreamer_tpu.conf import parse_args as jparse
    want = jparse(argv, config_dir=str(REPO_ROOT / "config")).to_dict()
    assert [r for _, r in seen] == [15.0, 15.0, 120.0, 120.0]
    assert all(conf == want for conf, _ in seen)
