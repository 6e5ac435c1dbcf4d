"""The imagination (dream) rollout alone at the flagship shape, timed.

    python -m pydreamer_tpu_torch.scripts.bench_dream [--steps 50] [--gru_type gru gru_layernorm_dv2]
    python -m pydreamer_tpu_torch.scripts.bench_dream --tiny --device cpu --steps 1

The port's counterpart of ``scripts/bench_dream.py``: ``Dreamer.dream`` from
an M = T*B*I row state (1536 at the flagship) for H = 15 steps, without
gradients, as the train step runs it, one call to warm up and then
``--steps`` calls; a call's time is the host clock over the calls up to a
``torch.cuda.synchronize()``. One JSON line per cell type:
``metric`` ``dream_rollout_ms[<gru_type>]``, ``value``, ``unit``, ``M``,
``H``, K1's launches per call by schedule (H ``wide`` launches at M=1536
under a DV2 cell on the card), the card's ``device`` and ``nvidia_smi``;
then one line of every cell's ms.

The JAX script's axis is the dream's random-number generator (``threefry``
against ``rbg``). The port has one generator, ``GeneratorNoise``, so its
axis is the cell type (``--gru_type``, default the flagship's ``gru``): the
dream under K1 is ``--gru_type gru_layernorm_dv2``.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..device import resolve_device
from ..models.dreamer import Dreamer
from ..models.noise import GeneratorNoise
from ..ops import gru_dv2
from .flagship import add_device_args, card, emit, k1_launches_since, make_conf, sync


def time_dream(conf, device, steps: int, provenance: dict) -> dict:
    torch.manual_seed(0)
    model = Dreamer(conf, device=device)
    M = conf.batch_size * conf.batch_length * conf.iwae_samples
    H = conf.imag_horizon
    state = model.init_state(M)
    noise = GeneratorNoise(device, seed=1)
    with torch.no_grad():
        model.dream(state, H, noise)  # warm up
        sync(device)
        before = dict(gru_dv2.LAUNCHES.by_schedule)
        t0 = time.perf_counter()
        for _ in range(steps):
            features, *_ = model.dream(state, H, noise)
        sync(device)
        dt = (time.perf_counter() - t0) / steps
    shape = (H + 1, M, model.features_dim)
    if tuple(features.shape) != shape or not torch.isfinite(features).all():
        raise FloatingPointError(f"dream features {tuple(features.shape)}: not finite of "
                                 f"shape {shape}")
    return emit({"metric": f"dream_rollout_ms[{conf.gru_type}]", "value": dt * 1e3, "unit": "ms",
                 "M": M, "H": H,
                 "k1_launches_per_call": {k: v / steps
                                          for k, v in k1_launches_since(before).items()}},
                device, provenance)


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_args(p)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--gru_type", nargs="+", default=["gru"])
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    provenance = card(device)
    lines = [time_dream(make_conf(args.tiny).replace(gru_type=g), device, args.steps, provenance)
             for g in args.gru_type]
    summary = {f"dream_ms_{g}": line["value"] for g, line in zip(args.gru_type, lines)}
    return lines + [emit(summary, device, provenance)]


if __name__ == "__main__":
    main()
