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

With ``--cells`` it times K1 alone at the shapes given instead (``MxInxH``,
comma-separated, or ``dv3`` for DreamerV3 XL's two: ``16x1024x4096``, the
posterior loop's ``skinny``, and ``1024x1024x4096``, the dream's ``wide``):
one line a shape with the schedule, the ms of a forward and of a forward and
backward (K1's backward: its bf16 pass on bf16 operands, ``ops/gru_dv2.py::k1_backward``),
and the same of the plain version, each the median of ``--steps`` calls
after ``--warmup``, synchronized on the host's clock. bf16 operands on the
card; on the CPU both sides run the plain version in float32.

Unlike the JAX script, a variant that fails is not reported and skipped:
the tool raises and exits non-zero.
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from ..device import resolve_device
from .flagship import Stepper, add_device_args, card, emit, make_conf, sync

VARIANTS = ("gru", "gru_layernorm_dv2", "gru_pallas_dv2")
DV3_CELLS = ((16, 1024, 4096), (1024, 1024, 4096))  # DreamerV3 XL: posterior loop, dream


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


def _median_ms(fn, device, warmup: int, steps: int) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(steps):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bench_cell(M: int, In: int, H: int, device, warmup: int, steps: int,
               provenance: dict) -> dict:
    """K1 at one shape against its plain version (the module docstring)."""
    from ..ops import gru_dv2 as k1

    cuda = device.type == "cuda"
    dtype = torch.bfloat16 if cuda else torch.float32
    g = torch.Generator(device=device).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=device) * scale

    ins = (randn(M, In).to(dtype), torch.tanh(randn(M, H)).to(dtype),
           randn(In, 3 * H, scale=0.03).to(dtype), randn(H, 3 * H, scale=0.03).to(dtype),
           1.0 + randn(3 * H, scale=0.1), randn(3 * H, scale=0.1))
    proj = randn(M, H)
    fused = k1.GRUDv2Function.apply if cuda else k1.gru_dv2_reference

    def forward_backward(fn):
        leaves = [t.clone().requires_grad_() for t in ins]
        (fn(*leaves) * proj).sum().backward()

    line = {"cell": f"M={M},In={In},H={H}",
            "schedule": k1.plan(M, In, H, *(dtype,) * 4).schedule if cuda else "plain"}
    for key, fn in (("", fused), ("plain_", k1.gru_dv2_reference)):
        with torch.no_grad():
            line[f"{key}fwd_ms"] = _median_ms(lambda: fn(*ins), device, warmup, steps)
        line[f"{key}fwd_bwd_ms"] = _median_ms(lambda: forward_backward(fn), device, warmup, steps)
    return emit(line, device, provenance)


def _cells(text: str):
    if text == "dv3":
        return DV3_CELLS
    return [tuple(int(v) for v in shape.split("x")) for shape in text.split(",")]


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_args(p)
    p.add_argument("--quick", action="store_true", help="windows of 20 steps, not 50")
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--steps", type=int, default=None, help="steps a window (overrides --quick)")
    p.add_argument("--cells", default=None,
                   help="time K1 alone at these MxInxH shapes (comma-separated, or dv3)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    steps = args.steps or (20 if args.quick else 50)
    provenance = card(device)
    if args.cells:
        return [bench_cell(*shape, device, args.warmup, steps, provenance)
                for shape in _cells(args.cells)]
    return [bench_variant(v, device, args.warmup, steps, args.tiny, provenance)
            for v in VARIANTS]


if __name__ == "__main__":
    main()
