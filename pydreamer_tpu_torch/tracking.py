"""Run tracking: params, metrics, artifacts, checkpoints.

Counterpart of ``pydreamer_tpu/tracking.py`` (reference: pydreamer/tools.py:
49-197), filesystem-first:

  * ``Run``: a directory holding meta.json, metrics.jsonl (one JSON object
    per line: ``_step``, ``_timestamp`` and the finite metrics), npz and
    text artifacts and ``checkpoints/``
  * resume-by-id: ``init_run(resume_id=...)`` finds or creates the run with
    that tag, so a restarted job continues the same run
  * subprocesses join the parent run through the ``PYDREAMER_RUN_DIR``
    environment variable
  * if mlflow is importable and MLFLOW_TRACKING_URI is set, metrics are
    mirrored to MLflow as well

**The checkpoint is the policy channel.** The learner writes
``<run>/checkpoints/latest.ckpt`` atomically (a temporary file in the same
directory, then a rename), so a reader polling the path sees the previous
file or the new one, never a partial one. The file is a ``torch.save`` of::

    {"step": int,                      # gradient steps taken
     "model": Dreamer.state_dict(),    # float32; the critic targets included
     "optimizer": AdamW.state_dict()}  # per-parameter exp_avg, exp_avg_sq, step

``load_checkpoint_file(path, device)`` reads it with ``weights_only=True``
onto ``device``, except the optimizer's ``step`` counts, which stay on the
CPU where ``torch.optim.AdamW`` keeps them; a missing or unreadable file
gives ``None``. A generator that only acts needs ``"model"``:
``load_checkpoint_model(path)`` maps the file into memory on the CPU and
reads that entry alone, so the AdamW moments (two thirds of the file) are
never read.

``metrics.jsonl`` is shared: generator processes and the learner join one
run and append to it. ``Run.log_metrics`` writes each record as one line in
one unbuffered ``write`` to a file opened for appending, so lines from
several processes never interleave.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
import uuid
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .device import resolve_device
from .tools import logger

__all__ = ["Run", "init_run", "save_checkpoint_file", "load_checkpoint_file",
           "load_checkpoint_model"]


@contextlib.contextmanager
def _atomic_file(path: Path):
    """A file object whose content appears at ``path`` only once it is whole."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            yield f
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _atomic_write(path: Path, data: bytes):
    with _atomic_file(path) as f:
        f.write(data)


def save_checkpoint_file(path: Union[str, Path], state: Dict[str, Any], step: int):
    """Write ``{"step": step, **state}`` (``state``: ``model`` and ``optimizer``
    state dicts) to one atomic file."""
    with _atomic_file(Path(path)) as f:
        torch.save({"step": int(step), **state}, f)


def load_checkpoint_file(path: Union[str, Path], device: str | torch.device = "cuda"
                         ) -> Optional[Tuple[Dict[str, Any], int]]:
    """-> (state, step) or None if the file is missing or unreadable.
    Tensors land on ``device``; the optimizer's ``step`` counts on the CPU."""
    device = resolve_device(device)
    path = Path(path)
    if not path.exists():
        return None
    try:
        payload = torch.load(path, map_location=device, weights_only=True)
    except Exception:  # truncated or foreign file: the caller starts fresh
        logger.exception("Failed to read checkpoint %s", path)
        return None
    for param_state in payload.get("optimizer", {}).get("state", {}).values():
        if "step" in param_state:
            param_state["step"] = param_state["step"].cpu()
    step = int(payload.pop("step"))
    return payload, step


def load_checkpoint_model(path: Union[str, Path]
                          ) -> Optional[Tuple[Dict[str, torch.Tensor], int]]:
    """-> (the ``"model"`` state dict on the CPU, step) or None if the file is
    missing or unreadable. The file is memory-mapped, so only the model's
    tensors are read from disk; the caller copies them where it needs them."""
    path = Path(path)
    if not path.exists():
        return None
    try:
        payload = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
        return payload["model"], int(payload["step"])
    except Exception:  # truncated or foreign file: the caller polls again
        logger.exception("Failed to read checkpoint %s", path)
        return None


class Run:
    """One training run rooted at a directory."""

    def __init__(self, run_dir: Union[str, Path], resume_id: Optional[str] = None):
        self.dir = Path(run_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.id = self.dir.name
        meta = self.dir / "meta.json"
        if not meta.exists():
            _atomic_write(meta, json.dumps({
                "run_id": self.id,
                "resume_id": resume_id,
                "created": time.time(),
            }).encode())
        self._metrics_path = self.dir / "metrics.jsonl"
        self._mlflow = _maybe_mlflow(self.id)

    # -- layout -----------------------------------------------------------

    def artifact_dir(self, subdir: str = "") -> Path:
        p = self.dir / subdir if subdir else self.dir
        p.mkdir(parents=True, exist_ok=True)
        return p

    @property
    def checkpoint_path(self) -> Path:
        return self.dir / "checkpoints" / "latest.ckpt"

    # -- params / metrics -------------------------------------------------

    def log_params(self, params: Dict[str, Any]):
        _atomic_write(self.dir / "params.json",
                      json.dumps(params, default=str, indent=2).encode())
        if self._mlflow:
            try:
                import mlflow
                items = list(params.items())
                for i in range(0, len(items), 100):
                    mlflow.log_params(dict(items[i:i + 100]))
            except Exception:  # the mirror is optional; the run goes on
                logger.exception("mlflow param logging failed")

    def log_metrics(self, metrics: Dict[str, float], step: int):
        rec = {"_step": int(step), "_timestamp": time.time()}
        rec.update({k: float(v) for k, v in metrics.items() if _is_finite(v)})
        # One write of the whole line: other processes append to this file too.
        with open(self._metrics_path, "ab", buffering=0) as f:
            f.write((json.dumps(rec) + "\n").encode())
        if self._mlflow:
            try:
                import mlflow
                mlflow.log_metrics({k: v for k, v in rec.items()
                                    if not k.startswith("_")}, step=step)
            except Exception:  # the mirror is optional; the run goes on
                logger.exception("mlflow metric logging failed")

    def read_metrics(self) -> List[Dict[str, float]]:
        if not self._metrics_path.exists():
            return []
        out = []
        with open(self._metrics_path) as f:
            for line in f:
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    pass
        return out

    # -- artifacts --------------------------------------------------------

    def log_npz(self, data: Dict[str, np.ndarray], name: str, subdir: str = "artifacts"):
        with _atomic_file(self.artifact_dir(subdir) / name) as f:
            np.savez_compressed(f, **data)

    def load_npz(self, name: str, subdir: str = "artifacts") -> Dict[str, np.ndarray]:
        with np.load(self.artifact_dir(subdir) / name) as npz:
            return {k: npz[k] for k in npz.files}

    def log_text(self, text: str, name: str):
        _atomic_write(self.dir / name, text.encode())

    # -- checkpoints ------------------------------------------------------

    def save_checkpoint(self, state: Dict[str, Any], step: int):
        save_checkpoint_file(self.checkpoint_path, state, step)

    def load_checkpoint(self, device: str | torch.device = "cuda"
                        ) -> Optional[Tuple[Dict[str, Any], int]]:
        return load_checkpoint_file(self.checkpoint_path, device)


def _is_finite(v) -> bool:
    try:
        return bool(np.isfinite(v))
    except (TypeError, ValueError):
        return False


def _maybe_mlflow(run_name: str):
    if not os.environ.get("MLFLOW_TRACKING_URI"):
        return None
    try:
        import mlflow
        mlflow.start_run(run_name=run_name)
        return True
    except Exception:  # the mirror is optional; the run goes on without it
        logger.warning("MLFLOW_TRACKING_URI set but mlflow unavailable")
        return None


def init_run(run_dir: Optional[str] = None,
             root_dir: str = "./runs",
             resume_id: Optional[str] = None,
             wait_for_resume: bool = False) -> Run:
    """Create or join a run (reference: tools.py:49-93 ``mlflow_init``).

    Resolution order:
      1. explicit ``run_dir`` argument
      2. ``PYDREAMER_RUN_DIR`` env (subprocesses join the parent run)
      3. ``resume_id``: search root_dir for a run with that tag; with
         ``wait_for_resume`` poll until another process creates it
      4. fresh run under root_dir
    """
    env_dir = os.environ.get("PYDREAMER_RUN_DIR")
    if run_dir is None and env_dir:
        run_dir = env_dir

    if run_dir is None and resume_id:
        root = Path(root_dir)
        while True:
            if root.exists():
                for d in sorted(root.iterdir()):
                    meta = d / "meta.json"
                    if meta.exists():
                        try:
                            if json.loads(meta.read_text()).get("resume_id") == resume_id:
                                run_dir = str(d)
                                break
                        except json.JSONDecodeError:
                            pass
            if run_dir or not wait_for_resume:
                break
            logger.info("Waiting for main worker to create run (resume_id=%s)...", resume_id)
            time.sleep(10)

    if run_dir is None:
        stamp = time.strftime("%Y%m%d_%H%M%S")
        run_dir = str(Path(root_dir) / f"{stamp}_{uuid.uuid4().hex[:6]}")

    run = Run(run_dir, resume_id=resume_id)
    os.environ["PYDREAMER_RUN_DIR"] = str(run.dir)
    logger.info("Run dir: %s", run.dir)
    return run
