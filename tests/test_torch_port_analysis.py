"""The port's analysis.py against the JAX package's, on the port's own
metrics.jsonl: the same rows, CSV, curves, plots and GIF frames on metric
streams without a restart; on a restarted run the port's ``_step`` axis for
``x_metric`` stays increasing (the later row of a repeated step counts)."""

import numpy as np
import pytest
from PIL import Image

from pydreamer_tpu import analysis as janalysis
from pydreamer_tpu_torch import analysis
from pydreamer_tpu_torch.tracking import Run


def _run(tmp_path, rows):
    """A run directory whose metrics.jsonl the port's tracking wrote."""
    run = Run(tmp_path / "run")
    for step, metrics in rows:
        run.log_metrics(metrics, step=step)
    return run.dir


def _stream():
    """A learner and two generators' rows without a restart: the prefill
    counter at 0, train rows every 10 steps with the env-step counter, agent
    rows of several episodes at the same model step, an eval row, a NaN."""
    rows = [(0, {"train/data_steps": 400, "train/data_env_steps": 1600})]
    for step in range(10, 60, 10):
        rows.append((step, {"train/loss_model": 100.0 - step, "train/data_env_steps": 1600 + 40 * step,
                            "train/grad_norm": float("nan") if step == 30 else 1.0 / step}))
        for ep in range(2):
            rows.append((step - 5, {"agent/return": step * 0.1 + ep, "agent/episode_length": 50}))
    rows.append((40, {"eval/loss_model": 77.0, "eval/logprob_map_last": -3.5}))
    return rows


def test_load_metrics_and_csv_match_jax(tmp_path):
    run_dir = _run(tmp_path, _stream())
    rows = analysis.load_metrics(run_dir)
    assert rows == janalysis.load_metrics(run_dir) and len(rows) == 17
    train30 = [r for r in rows if r["_step"] == 30 and "train/loss_model" in r]
    assert len(train30) == 1 and "train/grad_norm" not in train30[0]  # NaN not logged
    for keys in (None, ["_step", "agent/return", "train/loss_model"]):
        n = analysis.export_csv(run_dir, tmp_path / "port.csv", keys)
        assert n == janalysis.export_csv(run_dir, tmp_path / "jax.csv", keys) == 17
        assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert analysis.load_metrics(tmp_path / "none") == [] and analysis.export_csv(
        tmp_path / "none", tmp_path / "x.csv") == 0


@pytest.mark.parametrize("metric,x_metric", [("agent/return", "_step"),
                                             ("agent/return", "train/data_env_steps"),
                                             ("train/loss_model", "train/data_env_steps"),
                                             ("eval/logprob_map_last", "_step")])
def test_learning_curve_matches_jax(tmp_path, metric, x_metric):
    run_dir = _run(tmp_path, _stream())
    got = analysis.learning_curve(run_dir, metric, x_metric)
    want = janalysis.learning_curve(run_dir, metric, x_metric)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) == (10 if metric == "agent/return" else 5 if metric.startswith("train") else 1)


def test_learning_curve_after_a_restart_keeps_the_later_row(tmp_path):
    """The run restarts from its step-20 checkpoint: the learner logs the
    prefill counter at step 20 again (with more env steps by then) and steps
    30-40 anew. The env-step axis keeps the later row of each step, sorted,
    so the interpolation sees an increasing axis."""
    rows = [(0, {"train/data_env_steps": 1000}),
            (10, {"train/data_env_steps": 1400}), (20, {"train/data_env_steps": 1800}),
            (30, {"train/data_env_steps": 2200}),
            (25, {"agent/return": 1.0}),
            # restart from the checkpoint of step 20
            (20, {"train/data_env_steps": 2400}), (30, {"train/data_env_steps": 2800}),
            (40, {"train/data_env_steps": 3200}),
            (25, {"agent/return": 2.0}), (35, {"agent/return": 3.0})]
    run_dir = _run(tmp_path, rows)
    xs, ys = analysis.learning_curve(run_dir, "agent/return", "train/data_env_steps")
    np.testing.assert_array_equal(ys, [1.0, 2.0, 3.0])
    # axis: steps 0, 10, 20, 30, 40 -> 1000, 1400, 2400, 2800, 3200
    np.testing.assert_array_equal(xs, [2600.0, 2600.0, 3000.0])


def test_plot_curves_draws_each_run(tmp_path):
    baseline = tmp_path / "baseline.csv"
    baseline.write_text("env,method,run,env_steps,return\natari_pong,dreamerv2,1,0,-21\n"
                        "atari_pong,dreamerv2,1,1000000,5\natari_breakout,dreamerv2,1,0,1\n")
    runs = [_run(tmp_path / "a", _stream()), _run(tmp_path / "b", _stream()[:4])]
    for pkg, name in ((analysis, "port.png"), (janalysis, "jax.png")):
        pkg.plot_curves(runs, "agent/return", tmp_path / name, baseline_csv=str(baseline),
                        smooth=2, x_metric="train/data_env_steps", baseline_env="atari_pong")
    png = Image.open(tmp_path / "port.png")
    assert png.size == Image.open(tmp_path / "jax.png").size and png.size[0] > 100


@pytest.mark.parametrize("kind", ["rgb_uint8", "categorical_float_pred", "rgb_float_pred"])
def test_make_dream_gif_matches_jax(tmp_path, kind):
    """Frames of every image/prediction kind the trainer dumps: uint8 RGB,
    class maps (T,H,W) beside float predictions, float RGB in [-0.5, 0.5]."""
    rng = np.random.default_rng(0)
    B, T, H = 2, 5, 8
    if kind == "rgb_uint8":
        image = rng.integers(0, 256, (B, T, H, H, 3), dtype=np.uint8)
        pred = rng.integers(0, 256, (B, T, H, H, 3), dtype=np.uint8)
    elif kind == "categorical_float_pred":
        image = rng.integers(0, 6, (B, T, H, H)).astype(np.uint8)
        pred = rng.integers(0, 6, (B, T, H, H)).astype(np.float32)
    else:
        image = rng.integers(0, 256, (B, T, H, H, 3), dtype=np.uint8)
        pred = (rng.random((B, T, H, H, 3)) - 0.5).astype(np.float32)
    npz = tmp_path / "dump.npz"
    np.savez(npz, image=image, image_pred=pred)
    for side_by_side in (True, False):
        n = analysis.make_dream_gif(npz, tmp_path / "port.gif", batch_index=1,
                                    side_by_side=side_by_side)
        assert n == janalysis.make_dream_gif(npz, tmp_path / "jax.gif", batch_index=1,
                                             side_by_side=side_by_side) == T
        assert (tmp_path / "port.gif").read_bytes() == (tmp_path / "jax.gif").read_bytes()
