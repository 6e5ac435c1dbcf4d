"""The port's run tools (``pydreamer_tpu_torch/scripts/``) against the JAX
side's ``scripts/`` on the same inputs.

``demo_gridworld.sh`` runs two segments of two steps under ``debug`` on the
CPU (segment 2 resumes from segment 1's checkpoint, so the run's
metrics.jsonl holds a restart: the learner logs its prefill counter again at
the resumed step). On that run directory, and on a synthetic stream with a
restart, ``export_metrics`` writes the same bytes as the JAX script (its
export is a plain copy of the rows, which the restart defect of the reference
``analysis.py`` does not touch); ``make_gif`` writes the frames of JAX's
``make_dream_gif`` on the run's ``d2_wm_dream`` dump; ``plot_curves`` writes
a PNG. ``demo_dmc.sh`` runs one short segment under ``debug``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageSequence

from pydreamer_tpu import analysis as janalysis
from pydreamer_tpu_torch.tracking import Run, load_checkpoint_model

ROOT = Path(__file__).resolve().parent.parent
TOOLS = ROOT / "pydreamer_tpu_torch" / "scripts"


def _env():
    # Two threads a process: the tier-1 run shares the host's cores among its
    # test workers. The demos' own PYTHONPATH finds the package.
    env = {k: v for k, v in os.environ.items() if k != "PYDREAMER_RUN_DIR"}
    return dict(env, OMP_NUM_THREADS="2")


def _run(cmd, timeout=240, **kw):
    proc = subprocess.run([str(c) for c in cmd], capture_output=True, text=True,
                          timeout=timeout, env=_env(), **kw)
    assert proc.returncode == 0, f"{cmd} exit {proc.returncode}:\n{proc.stdout[-3000:]}\n" \
                                 f"{proc.stderr[-3000:]}"
    return proc.stdout + proc.stderr


def _port_tool(tool, *args):
    return _run([sys.executable, "-m", f"pydreamer_tpu_torch.scripts.{tool}", *args], cwd=ROOT)


def _jax_tool(tool, *args):
    return _run([sys.executable, ROOT / "scripts" / f"{tool}.py", *args], cwd=ROOT)


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """``demo_gridworld.sh RUN 4 2`` under ``debug``, run from outside the
    repo -> (its run directory, its output)."""
    run_dir = tmp_path_factory.mktemp("demo") / "grid"
    out = _run([TOOLS / "demo_gridworld.sh", run_dir, 4, 2, "--configs", "defaults", "gridworld",
                "debug"], cwd=run_dir.parent)
    return run_dir, out


def test_demo_gridworld_resumes_segment_by_segment(demo):
    run_dir, out = demo
    lines = [ln for ln in out.splitlines() if ln.startswith("===")]
    assert lines == ["=== resuming from step 0 ===", "=== segment to step 2 ===",
                     "=== segment to step 4 ===", "=== demo done at 4 steps ==="], lines
    assert out.count("Loaded model from checkpoint epoch 2") == 1
    assert out.count("Learner finished; shutting down generators.") == 2
    assert load_checkpoint_model(run_dir / "checkpoints" / "latest.ckpt")[1] == 4
    # Segment 2 logs the prefill counter again at the resumed step: a restart.
    steps = [m["_step"] for m in Run(run_dir).read_metrics() if "train/data_steps" in m]
    assert steps[0] == 0 and 2 in steps[1:], steps
    # A third call finds the run done and starts no segment.
    again = _run([TOOLS / "demo_gridworld.sh", run_dir, 4, 2, "--configs", "defaults",
                  "gridworld", "debug"], cwd=run_dir.parent)
    assert [ln for ln in again.splitlines() if ln.startswith("===")] == [
        "=== resuming from step 4 ===", "=== demo done at 4 steps ==="]


def _restart_stream(run_dir):
    """A learner and a generator whose run restarted from step 20's
    checkpoint: steps 20 and 30 are logged twice."""
    run = Run(run_dir)
    for step, metrics in [(0, {"train/data_env_steps": 1000}), (10, {"train/loss_model": 9.0}),
                          (20, {"train/loss_model": 8.0}), (25, {"agent/return": 1.0}),
                          (30, {"train/loss_model": 7.5}),
                          (20, {"train/data_env_steps": 2400}), (30, {"train/loss_model": 7.0}),
                          (35, {"agent/return": 2.0, "agent/return_cum": 1.5})]:
        run.log_metrics(metrics, step=step)
    return run.dir


@pytest.mark.parametrize("source", ["demo", "restart_stream"])
def test_export_metrics_matches_the_jax_script(demo, tmp_path, source):
    run_dir = demo[0] if source == "demo" else _restart_stream(tmp_path / "run")
    for keys in ([], ["--keys", "_step", "train/loss_model", "agent/return"]):
        said = _port_tool("export_metrics", run_dir, tmp_path / "port.csv", *keys)
        want = _jax_tool("export_metrics", run_dir, tmp_path / "jax.csv", *keys)
        assert said.strip().splitlines()[-1].replace("port.csv", "jax.csv") == \
            want.strip().splitlines()[-1]
        port = (tmp_path / "port.csv").read_bytes()
        assert port == (tmp_path / "jax.csv").read_bytes()
        assert port.split(b",")[0] == b"_step"


def test_make_gif_frames_match_jax(demo, tmp_path):
    dumps = sorted((demo[0] / "d2_wm_dream").glob("*.npz"))
    assert dumps, "the demo wrote no d2_wm_dream dump"
    said = _port_tool("make_gif", dumps[0], tmp_path / "port.gif", "--batch_index", 1,
                      "--fps", 4)
    n = janalysis.make_dream_gif(dumps[0], tmp_path / "jax.gif", batch_index=1, fps=4)
    assert said.strip().splitlines()[-1] == f"Wrote {n} frames to {tmp_path / 'port.gif'}"
    got, want = ([np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(Image.open(p))]
                 for p in (tmp_path / "port.gif", tmp_path / "jax.gif"))
    assert len(got) == len(want) == n > 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_plot_curves_writes_a_png(demo, tmp_path):
    out = tmp_path / "curves.png"
    said = _port_tool("plot_curves", demo[0], _restart_stream(tmp_path / "run"), "--metric",
                      "train/loss_model", "--out", out, "--smooth", 2)
    assert said.strip().splitlines()[-1] == f"Wrote {out}"
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert Image.open(out).size[0] > 100


def test_demo_dmc_runs_a_segment(tmp_path):
    """One segment of two steps of ``DMC-cartpole_balance`` under ``debug``
    (one env, a short prefill: the generator's first file needs 1000 steps)."""
    run_dir = tmp_path / "dmc"
    out = _run([TOOLS / "demo_dmc.sh", run_dir, 2, 2, "--configs", "defaults", "dmc", "debug",
                "--generator_prefill_steps", 100, "--generator_envs_per_worker", 1],
               cwd=tmp_path)
    assert "=== dmc demo done at 2 steps ===" in out
    assert "env=DMC-cartpole_balance" in out
    assert load_checkpoint_model(run_dir / "checkpoints" / "latest.ckpt")[1] == 2
    trained = [m for m in Run(run_dir).read_metrics() if "train/loss_model" in m]
    assert not trained or np.isfinite(trained[-1]["train/loss_model"])
