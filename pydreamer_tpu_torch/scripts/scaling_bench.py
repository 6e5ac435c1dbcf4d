"""Weak scaling of the train step over data-parallel ranks.

    python -m pydreamer_tpu_torch.scripts.scaling_bench                  # NCCL over the visible cards
    python -m pydreamer_tpu_torch.scripts.scaling_bench --cpu --devices 2 --steps 2
    python -m pydreamer_tpu_torch.scripts.scaling_bench --gspmd-overhead # one card

The port's counterpart of ``scripts/scaling_bench.py``: the train step on
meshes of 1, 2, 4, ... data ranks (``mesh_data: n``) with the batch per rank
held at ``--per_replica_batch`` (weak scaling), each rank a process of its
own that steps through the port's ``DistributedContext``. With ``--cpu``
the ranks are ``--devices`` gloo processes on the CPU (the counterpart of
JAX's virtual CPU devices: they share the host's cores, so their
efficiency says only that the sharded step runs); otherwise one rank per
visible card over NCCL. ``--tiny`` is the default on the CPU. A size's
time is rank 0's host clock over ``--steps`` steps after 3 warm-up steps,
ending in a ``torch.cuda.synchronize()`` on the card. Prints one JSON line
a size (``n_devices``, ``global_batch``, ``steps_per_sec``,
``env_frames_per_sec``, ``weak_scaling_efficiency``) and a last line
(``metric: weak_scaling_efficiency``).

``--gspmd-overhead`` (JAX's name: its mesh path is GSPMD) sets the flagship
step of one process against the same step through a world-size-1
``DistributedContext`` on one card, in one rank: the mesh path's cost when
there is nothing to share.

The ranks meet through a file in a temporary directory
(``multihost.INIT_FILE_ENV``), so no port is taken.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import tempfile
from pathlib import Path

import torch

from ..device import resolve_device
from .flagship import Stepper, add_device_args, card, emit, make_batch, make_conf

RANK_TIMEOUT_S = 900


def _rank(rank: int, world: int, store: str, device_type: str, opts: dict, out: str,
          threads: int) -> None:
    """One rank: join the group, step, write its rates to ``out``."""
    from ..parallel import DistributedContext
    from ..parallel.multihost import INIT_FILE_ENV, maybe_initialize_distributed

    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), **{INIT_FILE_ENV: store})
    torch.set_num_threads(threads)
    maybe_initialize_distributed(device_type)
    device = torch.device(f"cuda:{rank}" if device_type == "cuda" else "cpu")
    result = {}
    try:
        for mode in opts["modes"]:
            conf = make_conf(opts["tiny"])
            if mode == "plain":
                ctx, batch = None, None
            else:
                conf = conf.replace(mesh_data=world, mesh_model=1,
                                    batch_size=opts["per_replica_batch"] * world,
                                    batch_length=opts["batch_length"] or conf.batch_length)
                ctx = DistributedContext(conf, device)
                b = conf.batch_size // world
                batch = {k: v[:, rank * b:(rank + 1) * b].contiguous()
                         for k, v in make_batch(conf, device=device).items()}
            stepper = Stepper(conf, device, ctx=ctx, batch=batch)
            stepper.window(opts["warmup"])
            result[mode] = dict(steps_per_sec=stepper.window(opts["steps"])[0],
                                global_batch=conf.batch_size, batch_length=conf.batch_length)
            del stepper
    finally:
        torch.distributed.destroy_process_group()
    Path(out).write_text(json.dumps(result))


def run_ranks(world: int, device_type: str, opts: dict) -> list:
    """Spawn ``world`` ranks, wait for all of them (each within
    ``RANK_TIMEOUT_S``), and return their results. The ranks share this
    process's torch threads."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="scaling_bench_") as tmp:
        store = str(Path(tmp) / "dist_store")
        outs = [str(Path(tmp) / f"rank{r}.json") for r in range(world)]
        threads = max(1, torch.get_num_threads() // world)
        procs = [ctx.Process(target=_rank,
                             args=(r, world, store, device_type, opts, outs[r], threads))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(RANK_TIMEOUT_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks failed or timed out (rank, exit code): {bad}")
        return [json.loads(Path(o).read_text()) for o in outs]


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_args(p)
    p.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU (--device cpu)")
    p.add_argument("--devices", type=int, default=8, help="ranks at most, with --cpu")
    p.add_argument("--per_replica_batch", type=int, default=4)
    p.add_argument("--batch_length", type=int, default=8)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--gspmd-overhead", action="store_true",
                   help="one card: the plain step against the step through a 1-rank mesh")
    args = p.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else args.device)
    provenance = card(device)
    tiny = args.tiny or device.type == "cpu"
    opts = dict(tiny=tiny, per_replica_batch=args.per_replica_batch,
                batch_length=args.batch_length, steps=args.steps, warmup=args.warmup)

    if args.gspmd_overhead:
        # The flagship's own batch on both sides: the mesh of one holds it whole.
        conf = make_conf(tiny)
        opts.update(modes=["plain", "gspmd_1dev"], per_replica_batch=conf.batch_size,
                    batch_length=conf.batch_length)
        res = run_ranks(1, device.type, opts)[0]
        lines = [emit({"mode": m, "steps_per_sec": res[m]["steps_per_sec"]}, device, provenance)
                 for m in opts["modes"]]
        out = {m: res[m]["steps_per_sec"] for m in opts["modes"]}
        out["gspmd_overhead_pct"] = 100 * (1 - out["gspmd_1dev"] / out["plain"])
        return lines + [emit(out, device, provenance)]

    n_total = args.devices if device.type == "cpu" else torch.cuda.device_count()
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_total]
    opts["modes"] = ["mesh"]
    lines, base = [], None
    for n in sizes:
        res = run_ranks(n, device.type, opts)[0]["mesh"]
        sps = res["steps_per_sec"]
        base = base or sps
        lines.append(emit({"n_devices": n, "global_batch": res["global_batch"],
                           "steps_per_sec": sps,
                           "env_frames_per_sec": sps * res["global_batch"] * res["batch_length"],
                           "weak_scaling_efficiency": sps / base}, device, provenance))
    return lines + [emit({"metric": "weak_scaling_efficiency",
                          "value": lines[-1]["weak_scaling_efficiency"], "unit": "ratio",
                          "sizes": sizes}, device, provenance)]


if __name__ == "__main__":
    main()
