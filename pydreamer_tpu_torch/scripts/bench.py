"""Gradient steps per second of the flagship train step on one card.

    python -m pydreamer_tpu_torch.scripts.bench [--warmup 10] [--steps 50]
    python -m pydreamer_tpu_torch.scripts.bench --tiny --device cpu --warmup 1 --steps 1

The port's counterpart of the root ``bench.py``: the whole ``TrainStep``
(forward, backward, clip, AdamW) of the flagship config (``gru``) on a
constant batch, ``--warmup`` steps, then two timed windows of ``--steps``;
the better window is reported against the reference's 1.4 grad-steps/s on an
NVIDIA T4 (``BASELINE.md``). A window's time is the host clock from its
first step to a ``torch.cuda.synchronize()`` after its last.

Prints one JSON line: ``metric``, ``value``, ``unit``, ``vs_baseline``,
``provenance`` (``/proc/loadavg`` and the median host-to-device copy rate of
an 18.9 MB uint8 probe, before, between and after the windows, under the JAX
script's ``bw_*_MBps`` names; the copy rate is None on the CPU, where nothing
is copied), the card's ``device`` and ``nvidia_smi``.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .flagship import BASELINE_STEPS_PER_SEC, Stepper, add_device_args, emit, make_conf, sync

PROBE_SHAPE = (48, 32, 64, 64, 3)  # the flagship batch of uint8 frames: 18.9 MB


def loadavg() -> float:
    try:
        with open("/proc/loadavg") as f:
            return float(f.read().split()[0])
    except OSError:  # no /proc
        return -1.0


def copy_rate_mbps(device: torch.device, probe: Optional[np.ndarray] = None) -> Optional[float]:
    """Median of 3 host-to-device copies of the probe (pageable host memory,
    as ``jax.device_put`` of a numpy array), MB/s; None on the CPU."""
    if device.type != "cuda":
        return None
    if probe is None:
        probe = np.random.RandomState(7).randint(0, 255, PROBE_SHAPE, np.uint8)
    host = torch.from_numpy(probe)
    times = []
    for _ in range(3):
        sync(device)
        t0 = time.perf_counter()
        host.to(device)
        sync(device)
        times.append(time.perf_counter() - t0)
    return probe.nbytes / 1e6 / float(np.median(times))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_args(p)
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--steps", type=int, default=50, help="steps a timed window (two windows)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    stepper = Stepper(make_conf(args.tiny), device)
    stepper.window(args.warmup)
    stamps = {"load_before": loadavg(), "bw_before_MBps": copy_rate_mbps(device)}
    sps1, _ = stepper.window(args.steps)
    stamps.update(load_mid=loadavg(), bw_mid_MBps=copy_rate_mbps(device))
    sps2, loss = stepper.window(args.steps)
    stamps.update(load_after=loadavg(), bw_after_MBps=copy_rate_mbps(device),
                  windows_steps_per_sec=[sps1, sps2])
    print(f"# provenance: {stamps}", file=sys.stderr)
    sps = max(sps1, sps2)
    return emit({"metric": "grad_steps_per_sec", "value": sps, "unit": "steps/s",
                 "vs_baseline": sps / BASELINE_STEPS_PER_SEC, "loss_model": loss,
                 "k1_launches_per_step": {k: v / args.steps
                                          for k, v in stepper.k1_launches.items()},
                 "provenance": stamps}, device)


if __name__ == "__main__":
    main()
