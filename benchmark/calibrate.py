"""The readings that the limits of ``correct`` are set from, on the card.

    python3 -m benchmark.calibrate --workload atari-train --seeds 1-12 [--out FILE]

Not part of a run. For each seed, in one process: the program's first three
steps against the reference (the lower readings), and three sides put in the
program's place and held against the reference the same way:

* ``control``: the reference with the operands of every product and
  convolution rounded to float8 e4m3 with one scale per tensor, the precision
  below the configuration's bfloat16 (the upper readings);
* ``half_batch``: the reference fed half of each batch's columns, its means
  taken over the rest (a fault);
* ``ac_lr``: the reference with the world model's learning rate in the
  actor's and the critic's groups (a fault of those groups alone).

Each is held against the reference with the same bfloat16 witness as a run
(``check.py``).

A state left unchanged reads 1 on ``change`` by construction and needs no
run. Prints one JSON line per seed and side, then the worst and best reading
of each number and side.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

import torch

from .check import straight_through
from .run import load_spec

__all__ = ["cast_fp8", "ac_lr", "SIDES"]

FP8_MAX = 448.0  # the largest finite float8 e4m3fn


def cast_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale per tensor (its largest
    magnitude maps to 448); the gradient passes as if unrounded."""
    with torch.no_grad():
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        rounded = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return straight_through(x, rounded)


def ac_lr(conf: dict) -> dict:
    """The actor's and the critic's groups given the world model's learning rate."""
    return {"adam_lr_actor": conf["adam_lr"], "adam_lr_critic": conf["adam_lr"]}


SIDES = {"control": dict(cast=cast_fp8), "half_batch": dict(columns="half"),
         "ac_lr": dict(override=ac_lr)}


def readings_for_seed(spec, seed: int, device, sides=SIDES) -> dict:
    import importlib

    from .check import cast_bf16, follow_program, follow_reference, make_inputs, numbers

    conf = spec.conf
    reference = importlib.import_module(f"benchmark.reference.{conf['model']}")
    program_module = importlib.import_module(f"benchmark.programs.{conf['model']}")
    weights, feed = make_inputs(reference, conf, spec.mix, seed, device)
    program = program_module.Program(conf, weights, device)
    prog, _ = follow_program(program, feed, weights, conf["batch_size"])
    del program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = follow_reference(reference, conf, weights, feed, device)
    witness = follow_reference(reference, conf, weights, feed, device, cast=cast_bf16)
    out = {"program": dict(numbers=numbers(prog, ref, witness), losses=prog["losses"],
                           leaves=leaf_table(prog, ref))}
    for side, how in sides.items():
        columns = conf["batch_size"] // 2 if how.get("columns") == "half" else None
        override = how["override"](conf) if "override" in how else None
        other = follow_reference(reference, conf, weights, feed, device, cast=how.get("cast"),
                                 columns=columns, override=override)
        out[side] = dict(numbers=numbers(other, ref, witness), losses=other["losses"],
                         leaves=leaf_table(other, ref))
    out["reference"] = dict(losses=ref["losses"])
    out["witness"] = dict(losses=witness["losses"], leaves=leaf_table(witness, ref))
    return out


def leaf_table(side: dict, ref: dict, top: int = 6) -> dict:
    """Per reading: the median leaf's gap over its own norm, and the ``top``
    leaves by the gap that ``check.numbers`` takes, each with both norms."""
    import statistics
    out = {}
    for key in ("grad", "change"):
        names = sorted(ref[key])
        floor = statistics.median(ref[key][n] for n in names)
        gaps = {n: abs(side[key][n] - ref[key][n]) / max(ref[key][n], floor) for n in names}
        own = [abs(side[key][n] - ref[key][n]) / ref[key][n] for n in names if ref[key][n] > 0]
        worst = sorted(names, key=lambda n: -gaps[n])[:top]
        by_own = sorted((n for n in names if ref[key][n] > 0),
                        key=lambda n: -abs(side[key][n] - ref[key][n]) / ref[key][n])[:top]
        out[key] = dict(median_own=statistics.median(own), median_norm=floor,
                        over_1e3=sum(x > 1e-3 for x in own) / len(own),
                        worst=[[n, gaps[n], side[key][n], ref[key][n]] for n in worst],
                        worst_own=[[n, side[key][n], ref[key][n]] for n in by_own])
    return out


def _seeds(text: str):
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out.extend(range(int(a), int(b or a) + 1))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="1-12", help="e.g. 1-12 or 3,5,7")
    p.add_argument("--base", type=int, default=0, help="added to every seed")
    p.add_argument("--out", default=None, help="also write every line to this file")
    p.add_argument("--sides", default=",".join(SIDES), help=f"of {sorted(SIDES)}")
    args = p.parse_args(argv)
    spec = load_spec(args.workload)
    if not torch.cuda.is_available():
        print("calibrate runs on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    lines, table = [], {}
    for seed in _seeds(args.seeds):
        seed += args.base
        got = readings_for_seed(spec, seed, device,
                                {k: SIDES[k] for k in args.sides.split(",")})
        for side, r in got.items():
            line = dict(workload=spec.name, seed=seed, side=side, **r)
            lines.append(line)
            print(json.dumps(line), flush=True)
            for k, v in r.get("numbers", {}).items():
                table.setdefault(side, {}).setdefault(k, []).append(v)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    for side, nums in table.items():
        print(side, {k: (min(v), max(v)) for k, v in nums.items()}, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
