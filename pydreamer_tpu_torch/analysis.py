"""Results tooling: metrics export, learning curves, dream GIFs.

The port's own copy of ``pydreamer_tpu/analysis.py:22-157`` (it needs no
framework): ``load_metrics``, ``export_csv``, ``learning_curve``,
``plot_curves`` and ``make_dream_gif``, over a run directory's
``metrics.jsonl`` (``tracking.Run.log_metrics``) and the trainer's npz dumps.
matplotlib and PIL are imported by the functions that draw.

One difference: ``learning_curve`` with an ``x_metric`` interpolates over
that metric's rows by ``_step``, and a restarted run logs steps again (the
JAX learner logs its prefill counter at step 0 on every start; a resumed run
logs the steps after its checkpoint again). ``np.interp`` needs an increasing
axis, so of the rows with the same ``_step`` the later one is kept, and the
axis is sorted.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

__all__ = ["load_metrics", "export_csv", "learning_curve", "plot_curves", "make_dream_gif"]

PathLike = Union[str, Path]


def load_metrics(run_dir: PathLike) -> List[Dict[str, float]]:
    """Read a run's metrics.jsonl into a list of row dicts (torn lines skipped)."""
    path = Path(run_dir) / "metrics.jsonl"
    rows = []
    if not path.exists():
        return rows
    with open(path) as f:
        for line in f:
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                pass
    return rows


def export_csv(run_dir: PathLike, out_path: PathLike,
               keys: Optional[Sequence[str]] = None) -> int:
    """metrics.jsonl -> wide CSV (one column per metric). Returns the row count."""
    rows = load_metrics(run_dir)
    if not rows:
        return 0
    if keys is None:
        keys = sorted({k for r in rows for k in r})
        keys = ["_step"] + [k for k in keys if k != "_step"]
    with open(out_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(keys), extrasaction="ignore")
        w.writeheader()
        for r in rows:
            w.writerow(r)
    return len(rows)


def learning_curve(run_dir: PathLike, metric: str = "agent/return", x_metric: str = "_step"):
    """-> (steps, values) arrays for one metric.

    With an ``x_metric`` other than '_step' (e.g. 'train/data_env_steps', an
    env-step axis comparable to published baselines) the x value is
    interpolated over the rows that carry it, by ``_step``: agent and train
    metrics land on different rows. Of that metric's rows with the same
    ``_step`` the later one counts (a restarted run logs steps again)."""
    rows = load_metrics(run_dir)
    xs, ys = [], []
    for r in rows:
        if metric in r:
            xs.append(r.get("_step", 0))
            ys.append(r[metric])
    xs, ys = np.asarray(xs, np.float64), np.asarray(ys)
    if x_metric != "_step" and len(xs):
        by_step = {r.get("_step", 0): r[x_metric] for r in rows if x_metric in r}
        if by_step:
            bs = np.asarray(sorted(by_step), np.float64)
            bv = np.asarray([by_step[s] for s in sorted(by_step)], np.float64)
            xs = np.interp(xs, bs, bv)
    return xs, ys


def plot_curves(run_dirs: Sequence[PathLike], metric: str, out_path: PathLike,
                baseline_csv: Optional[str] = None, smooth: int = 1, x_metric: str = "_step",
                baseline_env: Optional[str] = None, baseline_label: str = "baseline"):
    """Learning curves for N runs (and an optional baseline CSV) -> PNG.

    The baseline CSV has the columns ``env, method, run, env_steps, return``;
    ``baseline_env`` keeps one task of a CSV that holds several. Pass
    ``x_metric='train/data_env_steps'`` to put the runs on the baseline's
    env-step axis.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4.5))
    for rd in run_dirs:
        xs, ys = learning_curve(rd, metric, x_metric=x_metric)
        if len(ys) == 0:
            continue
        if smooth > 1 and len(ys) >= smooth:
            ys = np.convolve(ys, np.ones(smooth) / smooth, mode="valid")
            xs = xs[len(xs) - len(ys):]
        ax.plot(xs, ys, label=Path(rd).name)
    if baseline_csv:
        bx, by = [], []
        with open(baseline_csv) as f:
            for row in csv.DictReader(f):
                if baseline_env and row.get("env") not in (None, baseline_env):
                    continue
                bx.append(float(row.get("env_steps", row.get("step", 0))))
                by.append(float(row.get("return", row.get("value", 0))))
        ax.plot(bx, by, "k--", label=baseline_label, alpha=0.6)
    ax.set_xlabel("env steps" if x_metric != "_step" else "step")
    ax.set_ylabel(metric)
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def _to_rgb(frame: np.ndarray) -> np.ndarray:
    """A (H,W) class map as grey levels, or a float image in [-0.5, 0.5] (or
    any non-uint8 image past 1.0 as it is) as uint8 RGB."""
    if frame.ndim == 2:
        frame = (frame * (255 // max(int(frame.max()), 1))).astype(np.uint8)
        return np.stack([frame] * 3, -1)
    if frame.dtype != np.uint8:
        if frame.max() <= 1.0:
            return ((frame + 0.5) * 255.0).clip(0, 255).astype(np.uint8)
        return frame.astype(np.uint8)
    return frame


def make_dream_gif(npz_path: PathLike, out_path: PathLike, batch_index: int = 0, fps: int = 8,
                   side_by_side: bool = True) -> int:
    """A trainer npz dump (``d2_wm_dream`` / ``d2_wm_closed``, (B,T,...)
    batch-major) -> animated GIF of ``image`` with ``image_pred`` beside it,
    frame by frame. Returns the number of frames written."""
    from PIL import Image

    with np.load(npz_path) as npz:
        data = {k: npz[k] for k in npz.files}
    image = data["image"][batch_index]        # (T,H,W,C) uint8, or (T,H,W) classes
    pred = data.get("image_pred")
    frames = []
    for t in range(image.shape[0]):
        img = image[t]
        if img.ndim == 2:
            img = _to_rgb(img)
        if pred is not None and side_by_side:
            img = np.concatenate([img, _to_rgb(pred[batch_index][t])], axis=1)
        frames.append(Image.fromarray(img))
    if frames:
        frames[0].save(out_path, save_all=True, append_images=frames[1:],
                       duration=int(1000 / fps), loop=0)
    return len(frames)
