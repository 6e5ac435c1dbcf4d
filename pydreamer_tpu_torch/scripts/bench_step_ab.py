"""Two flagship train-step configurations in turns (A B A B ...).

    python -m pydreamer_tpu_torch.scripts.bench_step_ab --a auto:auto --b auto:auto:gru_type=gru_layernorm_dv2
    python -m pydreamer_tpu_torch.scripts.bench_step_ab --tiny --device cpu --rounds 1 --n 1 --warmup 1

The port's counterpart of ``scripts/bench_step_ab.py``: both models and
their optimizers stay resident and alternate timed windows of ``--n`` steps
for ``--rounds`` rounds after ``--warmup`` steps each, so the host's slow
drift falls on both sides. Spec: ``conv:deconv[:key=val,key=val...]``. The
conv segments are accepted and recorded as ``conv_impl`` and
``conv_transpose_impl``, but the port maps every conv lowering to the one
cuDNN convolution, so only the ``key=val`` overrides (values parsed as
Python literals where they parse) change the program.

Prints one JSON line, the JAX script's: ``a``, ``b``, ``a_steps_per_sec``,
``b_steps_per_sec`` (one rate a window), ``a_median``, ``b_median``,
``b_vs_a``; plus K1's launches a step by schedule on each side and the
card's ``device`` and ``nvidia_smi``.
"""

from __future__ import annotations

import argparse
import ast

import numpy as np

from ..device import resolve_device
from .flagship import Stepper, add_device_args, emit, make_conf


def parse_spec(spec: str, tiny: bool = False):
    """``conv:deconv[:key=val,...]`` -> the flagship conf with those keys."""
    parts = spec.split(":", 2)
    if len(parts) < 2:
        raise ValueError(f"spec {spec!r} is not conv:deconv[:key=val,...]")
    conf = make_conf(tiny).replace(conv_impl=parts[0], conv_transpose_impl=parts[1])
    for kv in (parts[2] if len(parts) > 2 else "").split(","):
        if not kv:
            continue
        k, v = kv.split("=", 1)
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass  # a string, e.g. gae_impl=unrolled
        conf = conf.replace(**{k: v})
    return conf


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_args(p)
    p.add_argument("--a", default="xla:xla")
    p.add_argument("--b", default="auto:auto")
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--n", type=int, default=50, help="steps a window")
    p.add_argument("--warmup", type=int, default=10)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    steppers = {}
    for label, spec in (("a", args.a), ("b", args.b)):
        steppers[label] = Stepper(parse_spec(spec, args.tiny), device)
        steppers[label].window(args.warmup)
    rates = {"a": [], "b": []}
    for _ in range(args.rounds):
        for label in ("a", "b"):
            rates[label].append(steppers[label].window(args.n)[0])
    out = {"a": args.a, "b": args.b,
           "a_steps_per_sec": rates["a"], "b_steps_per_sec": rates["b"],
           "a_median": float(np.median(rates["a"])), "b_median": float(np.median(rates["b"]))}
    out["b_vs_a"] = out["b_median"] / out["a_median"]
    out["k1_launches_per_step"] = {label: {k: v / args.n for k, v in s.k1_launches.items()}
                                   for label, s in steppers.items()}
    return emit(out, device)


if __name__ == "__main__":
    main()
