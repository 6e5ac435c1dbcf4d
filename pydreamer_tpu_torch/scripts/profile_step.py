"""Profile the flagship train step: device time by kernel, busy beside wall.

    python -m pydreamer_tpu_torch.scripts.profile_step [--steps 5] [--top 25] [--gru_type gru_layernorm_dv2]
    python -m pydreamer_tpu_torch.scripts.profile_step --tiny --device cpu --warmup 1 --steps 1

The port's counterpart of ``scripts/profile_step.py``: ``torch.profiler``
(CPU and CUDA activities) over ``--steps`` warm flagship steps, after
``--warmup`` steps. Prints the top ``--top`` rows by self device time per
step (``ms/step``, share of the busy time, calls per step, kernel), then one
JSON line: wall and device-busy ms per step, the table's rows, and K1's
rows by schedule (launches per step as the K1 wrapper counted them, kernel
records the profiler saw, device ms per step; the LayerNorm pass of the
``skinny`` schedules is its own row, ``ln_gate_kernel``).

The JAX tool attributes the sequential scans to XLA's ``while.*`` ops.
Eager PyTorch runs the posterior (T steps) and dream (H steps) loops as
Python loops, so no op stands for a loop: under a DV2 cell
(``--gru_type gru_layernorm_dv2``) K1's rows, one launch per loop step,
stand for the loops' cell; the flagship's ``gru`` runs no kernel of the
port's own. On the CPU (``--device cpu``) the table holds CPU self time
and the device-busy time is None.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..device import resolve_device
from ..ops import gru_dv2
from .flagship import Stepper, add_device_args, emit, k1_launches_since, make_conf, sync

# Substrings of K1's kernel names in the profiler's records (the .cu's namespaces).
K1_KINDS = ("skinny::gates_kernel", "wide::gates_kernel", "generic::", "f32::")


def on_device(event) -> bool:
    """A kernel (or memcpy/memset) event, as opposed to the CPU op that launched it."""
    return str(event.device_type).endswith("CUDA")


def profile_step(ts, obs, state, step: int, n: int = 1):
    """``n`` TrainStep calls from ``step`` under torch.profiler: (state,
    report, key_averages). The report's times and counts are totals over the
    ``n`` steps; it holds K1's launches by the wrapper's count (``launched``)
    and by the profiler's kernel records (``k1_launches``)."""
    from torch.profiler import ProfilerActivity, profile
    before = dict(gru_dv2.LAUNCHES.by_schedule)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            state, _, _, _ = ts(obs, state, step + i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launched = k1_launches_since(before)
    events = prof.key_averages()
    attr = "self_device_time_total"
    dev_events = [e for e in events if on_device(e)]
    busy_us = sum(getattr(e, attr) for e in dev_events)
    k1_events = [e for e in dev_events if "k1::" in e.key]
    k1_rows = [(e.key, e.count, getattr(e, attr)) for e in k1_events]
    n_by_kernel = {kind: sum(e.count for e in k1_events if kind in e.key) for kind in K1_KINDS}
    ms_by_kernel = {kind: sum(getattr(e, attr) for e in k1_events if kind in e.key) / 1e3
                    for kind in ("skinny::gates_kernel", "wide::gates_kernel", "ln_gate_kernel")}
    by_schedule = {}
    for sched in gru_dv2.SCHEDULES:
        evs = [e for e in k1_events if f"k1::{sched}::" in e.key]
        by_schedule[sched] = dict(launched=launched.get(sched, 0),
                                  recorded=sum(e.count for e in evs),
                                  ms=sum(getattr(e, attr) for e in evs) / 1e3)
    ln = [e for e in k1_events if "ln_gate_kernel" in e.key]
    by_schedule["ln_gate_kernel"] = dict(recorded=sum(e.count for e in ln),
                                         ms=sum(getattr(e, attr) for e in ln) / 1e3)
    # K1's backward recomputes the cell through the plain version in float32:
    # its products are the step's only float32 GEMMs (the model's run in bf16).
    f32_gemms = [e for e in dev_events if "gemm" in e.key.lower() and "k1::" not in e.key
                 and ("f32f32" in e.key or "sgemm" in e.key)]
    report = dict(wall_ms=wall_ms, device_busy_ms=busy_us / 1e3, k1_kernels=k1_rows,
                  k1_ms=sum(r[2] for r in k1_rows) / 1e3, launched=launched,
                  k1_launches=n_by_kernel, k1_ms_by_kernel=ms_by_kernel,
                  k1_by_schedule=by_schedule,
                  f32_gemm_ms=sum(getattr(e, attr) for e in f32_gemms) / 1e3,
                  f32_gemm_calls=sum(e.count for e in f32_gemms),
                  f32_gemm_kernels=sorted({e.key for e in f32_gemms}))
    return state, report, events


def profile_cpu_steps(ts, obs, state, step: int, n: int):
    """The CPU run of ``profile_step``: CPU activity only; (state, wall ms,
    key_averages)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            state, _, _, _ = ts(obs, state, step + i)
        wall_ms = (time.perf_counter() - t0) * 1e3
    return state, wall_ms, prof.key_averages()


def op_rows(events, n: int, cuda: bool, top: int):
    """The top rows by self time per step: device time of kernels on the
    card, CPU self time of ops on the CPU. -> (total ms per step, rows)."""
    attr = "self_device_time_total" if cuda else "self_cpu_time_total"
    evs = [e for e in events if on_device(e)] if cuda else list(events)
    total = sum(getattr(e, attr) for e in evs)
    evs.sort(key=lambda e: getattr(e, attr), reverse=True)
    rows = [dict(ms_per_step=getattr(e, attr) / 1e3 / n,
                 pct=100 * getattr(e, attr) / max(total, 1e-9),
                 calls_per_step=e.count / n, op=e.key) for e in evs[:top]]
    return total / 1e3 / n, rows


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                formatter_class=argparse.RawDescriptionHelpFormatter,
                                epilog=__doc__.split("\n\n", 2)[2])
    add_device_args(p)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--gru_type", default=None, help="the flagship's gru unless given")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    conf = make_conf(args.tiny)
    if args.gru_type:
        conf = conf.replace(gru_type=args.gru_type)
    stepper = Stepper(conf, device)
    stepper.window(args.warmup)
    n, cuda = args.steps, device.type == "cuda"
    if cuda:
        stepper.state, report, events = profile_step(stepper.trainstep, stepper.batch,
                                                     stepper.state, stepper.step + 1, n)
        wall_ms = report["wall_ms"]
        k1 = {sched: {"launches_per_step": r.get("launched", 0) / n,
                      "recorded_per_step": r["recorded"] / n, "ms_per_step": r["ms"] / n}
              for sched, r in report["k1_by_schedule"].items()
              if r["recorded"] or r.get("launched")}
    else:
        stepper.state, wall_ms, events = profile_cpu_steps(stepper.trainstep, stepper.batch,
                                                           stepper.state, stepper.step + 1, n)
        k1 = {}
    sync(device)
    stepper.step += n
    total, rows = op_rows(events, n, cuda, args.top)
    busy = total if cuda else None
    print(f"# wall {wall_ms / n:.2f} ms/step; {'device busy' if cuda else 'CPU op self time'} "
          f"{total:.2f} ms/step over {n} steps ({conf.gru_type})")
    print(f"{'ms/step':>9}  {'%':>5}  {'calls':>6}  op")
    for r in rows:
        print(f"{r['ms_per_step']:9.3f}  {r['pct']:5.1f}  {r['calls_per_step']:6.1f}  "
              f"{r['op'][:100]}")
    return emit({"gru_type": conf.gru_type, "steps": n, "wall_ms_per_step": wall_ms / n,
                 "device_busy_ms_per_step": busy,
                 "busy_share": busy / (wall_ms / n) if cuda else None,
                 "time_source": "cuda" if cuda else "cpu", "rows": rows, "k1": k1}, device)


if __name__ == "__main__":
    main()
