"""The flagship configuration and batch the measurement tools run, and what
they share.

``make_conf`` and ``make_batch`` are the port's own copies of
``__graft_entry__.py::_make_conf`` and ``_make_batch``: the same keys and
values (``scan_unroll`` and the other keys the port does not read included)
and the same numpy draws from the same seed, as tensors on the given device.
The flagship is the Atari config (``config/defaults.yaml`` ``defaults`` +
``atari``): T=48, B=32, deter 1024, stoch 32x32, hidden 1000, cnn_depth 48,
H=15, bf16, ``gru_type: gru``; ``tiny`` shrinks it for a CPU run.

The rest is the tools' common harness: ``--device`` / ``--tiny``, the card's
provenance on every line (``card``), and ``Stepper``, a flagship
``TrainStep`` whose timed windows end in ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import json
import subprocess
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..conf import Conf
from ..device import resolve_device
from ..ops import gru_dv2

__all__ = ["make_conf", "make_batch", "add_device_args", "card", "sync", "emit", "Stepper",
           "k1_launches_since", "BASELINE_STEPS_PER_SEC"]

BASELINE_STEPS_PER_SEC = 1.4  # the reference on an NVIDIA T4 (BASELINE.md)


def make_conf(tiny: bool = False) -> Conf:
    return Conf(dict(
        image_key="image", image_size=64, image_channels=3, image_categorical=False,
        action_dim=18, clip_rewards="tanh", vecobs_size=0,
        map_key=None, map_size=0, map_channels=0, map_categorical=True, goals_size=0,
        model="dreamer",
        deter_dim=64 if tiny else 1024,
        stoch_dim=8 if tiny else 32,
        stoch_discrete=8 if tiny else 32,
        hidden_dim=128 if tiny else 1000,
        gru_layers=1, gru_type="gru", layer_norm=True,
        scan_unroll=1 if tiny else 4,
        image_encoder="cnn", cnn_depth=8 if tiny else 48, image_encoder_layers=0,
        image_decoder="cnn", image_decoder_layers=0, image_decoder_min_prob=0.0,
        reward_input=False, reward_decoder_layers=1 if tiny else 4,
        reward_decoder_categorical=None, terminal_decoder_layers=1 if tiny else 4,
        probe_model="none", probe_gradients=False,
        map_decoder="dense", map_hidden_layers=4, map_hidden_dim=1024,
        iwae_samples=1, kl_balance=0.8, kl_weight=0.1,
        image_weight=1.0, vecobs_weight=1.0, reward_weight=1.0, terminal_weight=1.0,
        adam_lr=3e-4, adam_lr_actor=1e-4, adam_lr_critic=1e-4, adam_eps=1e-5,
        keep_state=True,
        batch_length=4 if tiny else 48,
        batch_size=8 if tiny else 32,
        grad_clip=200.0, grad_clip_ac=200.0,
        precision="float32" if tiny else "bfloat16",
        gamma=0.99, lambda_gae=0.95, entropy=1e-3, target_interval=100,
        imag_horizon=3 if tiny else 15, actor_grad="reinforce", actor_dist="onehot",
        aux_critic=False, aux_critic_weight=1.0, gamma_aux=0.99,
        lambda_gae_aux=0.95, target_interval_aux=1000,
        mesh_data=0, mesh_model=1, tp_min_size=1024,
    ))


def make_batch(conf: Conf, seed: int = 0, device: str | torch.device = "cuda"
               ) -> Dict[str, torch.Tensor]:
    """``_make_batch``'s draws, in its order, as tensors on ``device``."""
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    T, B = conf.batch_length, conf.batch_size
    reset = np.zeros((T, B), bool)
    reset[0] = True
    arrays = {
        "action": np.eye(conf.action_dim, dtype=np.float32)[
            rng.randint(0, conf.action_dim, (T, B))],
        "reward": rng.rand(T, B).astype(np.float32),
        "terminal": np.zeros((T, B), np.float32),
        "reset": reset,
        "image": rng.rand(T, B, conf.image_size, conf.image_size,
                          conf.image_channels).astype(np.float32) - 0.5,
    }
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def add_device_args(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--tiny", action="store_true",
                        help="the tiny config of __graft_entry__.py (a CPU run)")


def card(device: torch.device) -> Dict[str, Optional[str]]:
    """What ran the numbers: ``device`` (the card's name, or "cpu") and
    ``nvidia_smi``, the card's name and power limit as nvidia-smi prints them
    (None on the CPU)."""
    if device.type != "cuda":
        return {"device": "cpu", "nvidia_smi": None}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    index = device.index if device.index is not None else torch.cuda.current_device()
    return {"device": torch.cuda.get_device_name(index),
            "nvidia_smi": smi.splitlines()[index]}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def k1_launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """K1's launches by schedule since ``before``, a copy of
    ``gru_dv2.LAUNCHES.by_schedule``; the count itself is left running, so a
    caller may count a whole run of a tool."""
    now = gru_dv2.LAUNCHES.by_schedule
    return {k: v - before.get(k, 0) for k, v in now.items() if v != before.get(k, 0)}


def emit(line: dict, device: torch.device, provenance: Optional[dict] = None) -> dict:
    """Print ``line`` as one JSON line with the card's provenance; returns it."""
    line = dict(line, **(provenance or card(device)))
    print(json.dumps(line), flush=True)
    return line


class Stepper:
    """A flagship ``Dreamer`` and its ``TrainStep`` on a constant batch, from
    random weights made from ``seed``; the TBTT state is carried from step
    to step, as the JAX tools carry theirs."""

    def __init__(self, conf: Conf, device: torch.device, seed: int = 0, ctx=None, batch=None):
        from ..models.dreamer import Dreamer
        from ..training.train_step import TrainStep

        torch.manual_seed(seed)
        self.conf, self.device = conf, device
        self.model = Dreamer(conf, device=device)
        self.trainstep = TrainStep(self.model, conf, device=device, ctx=ctx)
        self.batch = make_batch(conf, device=device) if batch is None else batch
        self.state = self.model.init_state(self.batch["action"].shape[1] * conf.iwae_samples)
        self.step = 0
        self.k1_launches: Dict[str, int] = {}  # K1's launches in the last window, by schedule

    def window(self, n: int, batches=None) -> tuple:
        """``n`` steps -> (steps per second, the last ``loss_model``). The host
        clock runs from the first step to a ``synchronize()`` after the last.
        ``batches``: an iterator of ``(batch, wid, stats)`` in place of the
        constant batch."""
        before = dict(gru_dv2.LAUNCHES.by_schedule)
        sync(self.device)
        t0 = time.perf_counter()
        for _ in range(n):
            self.step += 1
            batch = self.batch if batches is None else next(batches)[0]
            self.state, metrics, _, _ = self.trainstep(batch, self.state, self.step)
        sync(self.device)
        dt = time.perf_counter() - t0
        self.k1_launches = k1_launches_since(before)
        loss = metrics["loss_model"].item()
        if not np.isfinite(loss):
            raise FloatingPointError(f"non-finite loss_model {loss} at step {self.step}")
        return n / dt, loss
