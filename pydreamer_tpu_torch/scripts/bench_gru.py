"""The flagship train step under each GRU cell type, one JSON line each.

    python -m pydreamer_tpu_torch.scripts.bench_gru [--quick]
    python -m pydreamer_tpu_torch.scripts.bench_gru --tiny --device cpu --warmup 1 --steps 1

The port's counterpart of ``scripts/bench_gru.py``: the flagship step under
``gru`` (one fused-GEMM cell, no kernel), ``gru_layernorm_dv2`` and
``gru_pallas_dv2`` (both the DreamerV2 late-reset cell, which runs kernel K1
on the card), ``--warmup`` steps (10) then two windows of ``--steps`` (50,
20 under ``--quick``). Each line: ``gru_type``, ``steps_per_sec`` and
``ms_per_step`` of the better window, ``loss_model``, and
``k1_launches_per_step`` by schedule as the K1 wrapper counted them in the
last window: 48 ``skinny`` (the posterior loop, M=B) and 15 ``wide`` (the
dream, M=T*B) under both DV2 cells on the card, none under ``gru`` and none
on the CPU, where K1's plain version runs.

Unlike the JAX script, a variant that fails is not reported and skipped:
the tool raises and exits non-zero.
"""

from __future__ import annotations

import argparse

from ..device import resolve_device
from .flagship import Stepper, add_device_args, card, emit, make_conf

VARIANTS = ("gru", "gru_layernorm_dv2", "gru_pallas_dv2")


def bench_variant(gru_type: str, device, warmup: int, steps: int, tiny: bool,
                  provenance: dict) -> dict:
    stepper = Stepper(make_conf(tiny).replace(gru_type=gru_type), device)
    stepper.window(warmup)
    sps1, _ = stepper.window(steps)
    sps2, loss = stepper.window(steps)
    sps = max(sps1, sps2)
    return emit({"gru_type": gru_type, "steps_per_sec": sps, "ms_per_step": 1000.0 / sps,
                 "loss_model": loss,
                 "k1_launches_per_step": {k: v / steps for k, v in stepper.k1_launches.items()}},
                device, provenance)


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_args(p)
    p.add_argument("--quick", action="store_true", help="windows of 20 steps, not 50")
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--steps", type=int, default=None, help="steps a window (overrides --quick)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    steps = args.steps or (20 if args.quick else 50)
    provenance = card(device)
    return [bench_variant(v, device, args.warmup, steps, args.tiny, provenance)
            for v in VARIANTS]


if __name__ == "__main__":
    main()
