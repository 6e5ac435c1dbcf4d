"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload atari-train --seed 7 --seconds 51 --trace 0

From the root of a checkout. ``BENCHMARK.json`` names the cell's
configuration (``benchmark/configs/<config>.json``) and traffic mix
(``benchmark/traffic/<traffic>.json``); the configuration's ``model`` names
the program adapter (``benchmark/programs/<model>.py``), the plain reference
(``benchmark/reference/<model>.py``) and the FLOP count
(``benchmark/flops/<model>.py``); each per-layer metric is read by
``benchmark/metrics/<metric>.py``. So a new configuration, mix or metric is
new files and entries, and no edit here.

A run: set-up builds the program (the port's ``TrainStep`` on a model loaded
with weights made from the seed), hands it the first three batches with the
feed's keyed noise (which the reference follows after the window), and warms
up; then a closed loop of train steps for ``--seconds``, which from the
warm-up on sample with the program's own noise seeded from the run's seed,
as a training run does; then, with ``--trace 1``, a few steps under
``torch.profiler`` that the per-layer metrics read; then the program is
freed and the reference runs its three steps, in float32 and once more with
bfloat16 operands as the witness of what rounding costs on this seed. The last stdout line is the
result; the last stderr lines are the numbers compared, each beside its
limit.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, Optional

T_IMPORT = time.perf_counter()
ROOT = Path(__file__).resolve().parent
CACHE = ROOT / "_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "pydreamer_tpu")  # top-level names, compared whole
WARM_STEPS = 2       # set-up steps after the three that the reference follows
PROFILED_STEPS = 3   # steps under the profiler in a --trace 1 run


def process_age() -> float:
    """Seconds since this process started (``/proc``), or since this module
    was imported where ``/proc`` says nothing sensible."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        if 0.0 <= age < 3600.0:
            return age
    except (OSError, ValueError, IndexError):
        pass
    return time.perf_counter() - T_IMPORT


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_spec(workload: str, bench: Optional[Dict] = None, root: Path = ROOT) -> SimpleNamespace:
    """The cell ``workload`` with its configuration, mix and metrics."""
    if bench is None:
        bench = json.loads((root.parent / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r}; options: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root.parent / configs[cell["config"]]["file"]).read_text())
    mix = json.loads((root / "traffic" / f"{cell['traffic']}.json").read_text())
    return SimpleNamespace(name=workload, chips=cell["chips"], config=config, conf=config["conf"],
                           mix=mix, end_to_end=bench["end_to_end"], per_layer=bench["per_layer"],
                           root=root)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class StepClock:
    """Per-step times: CUDA events recorded after each step on the card (no
    synchronize between steps), the host clock on the CPU."""

    def __init__(self, torch, device):
        self.torch, self.cuda = torch, device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self):
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "not read"


def run_cell(spec: SimpleNamespace, seed: int, seconds: float, trace: bool, device,
             adapt: Optional[Callable] = None, log=print) -> Dict:
    """One run of the cell -> the result line as a dict. ``adapt`` wraps the
    program before set-up (the tests break it with it)."""
    import torch

    from .check import (COMPARED, STEPS, cast_bf16, follow_program, follow_reference, make_inputs,
                        numbers, subseed)

    conf, kind = spec.conf, spec.conf["model"]
    reference = importlib.import_module(f"benchmark.reference.{kind}")
    program_module = importlib.import_module(f"benchmark.programs.{kind}")
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    # -- set-up ---------------------------------------------------------------
    phases = [("before the harness", process_age())]
    weights, feed = make_inputs(reference, conf, spec.mix, seed, device)
    sync()
    phases.append(("weights and batches", process_age()))
    program = program_module.Program(conf, weights, device)
    if adapt is not None:
        program = adapt(program)
    sync()
    phases.append(("the program's model and optimizer", process_age()))
    B = conf["batch_size"]
    prog_readings, state = follow_program(program, feed, weights, B)
    phases.append((f"steps 1-{STEPS}, read for the comparison", process_age()))
    own_seed = subseed(seed, "window") >> 31  # the program's own noise from here on
    step = STEPS
    for _ in range(WARM_STEPS):
        step += 1
        state, metrics = program.step(feed.batch(step), state, step, seed=own_seed)
    sync()
    phases.append((f"{WARM_STEPS} more warm-up steps", process_age()))
    log("set-up, seconds since the process started: " + "; ".join(
        f"{name} {t:.2f}" for name, t in phases), file=sys.stderr)

    # -- the measured window --------------------------------------------------
    setup_s = process_age()
    clock = StepClock(torch, device)
    health = []
    t0 = time.perf_counter()
    clock.mark()
    while True:
        step += 1
        state, metrics = program.step(feed.batch(step), state, step, seed=own_seed)
        clock.mark()
        health.append(program.health(metrics))
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    steps = len(health)
    step_ms = clock.step_ms()
    failed = int((~torch.isfinite(torch.stack(health))).sum())

    # -- the traced steps -------------------------------------------------------
    traced = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        from .trace import summarize
        before = program.counters()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=activities) as prof:
            t1 = time.perf_counter()
            for _ in range(PROFILED_STEPS):
                step += 1
                state, metrics = program.step(feed.batch(step), state, step, seed=own_seed)
            sync()
            traced_s = time.perf_counter() - t1
        after = program.counters()
        counters = {k: {m: after[k].get(m, 0) - before[k].get(m, 0) for m in after[k]
                        if after[k].get(m, 0) != before[k].get(m, 0)} for k in after}
        traced = SimpleNamespace(trace=summarize(prof, PROFILED_STEPS, traced_s), counters=counters)
        del prof

    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del program, state, metrics, health
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- the comparison -------------------------------------------------------
    ref_readings = follow_reference(reference, conf, weights, feed, device)
    witness = follow_reference(reference, conf, weights, feed, device, cast=cast_bf16)
    compared = numbers(prog_readings, ref_readings, witness)
    limits = spec.config["limits"]
    if set(limits) != set(COMPARED):
        raise ValueError(f"the configuration's limits {sorted(limits)} are not {COMPARED}")
    correct = failed == 0 and all(compared[k] <= limits[k] for k in COMPARED)  # NaN fails
    log("read, not compared: " + ", ".join(f"{k} {v!r}" for k, v in compared.items()
                                             if k not in COMPARED), file=sys.stderr)

    # -- the result line --------------------------------------------------------
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    result = {"correct": bool(correct), "attempted": steps, "failed": failed}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name, "count": 1,
           "memory_peak_bytes": int(memory_peak)}
    ms_per_step = window_s * 1e3 / steps
    card = power_limit() if cuda else "cpu"
    log(f"steps in the window: {steps}; {ms_per_step:.4f} ms a step on the host's clock; "
        f"card: {card}", file=sys.stderr)
    if not trace:
        e2e = {"train_steps_per_s": (steps / window_s, "steps/s"),
               "train_step_ms.p90": (statistics.quantiles(step_ms, n=10, method="inclusive")[8]
                                     if len(step_ms) > 1 else step_ms[0], "ms"),
               "setup_s": (setup_s, "s")}
        metrics_out = {m["name"]: {"value": e2e[m["name"]][0], "unit": m["unit"]}
                       for m in spec.end_to_end}
    else:
        run = SimpleNamespace(conf=conf, ms_per_step=ms_per_step, trace=traced.trace,
                              counters=traced.counters, device_name=name, card=card,
                              flops_per_step=importlib.import_module(
                                  f"benchmark.flops.{kind}").count(conf))
        metrics_out = {}
        for m in spec.per_layer:
            reader = load_file(spec.root / "metrics" / f"{m['name']}.py",
                               f"benchmark_metric_{m['name'].replace('.', '_')}")
            value = reader.read(run)
            if value is not None:
                metrics_out[m["name"]] = {"value": value, "unit": m["unit"]}
                log(f"{m['name']}: {value} {m['unit']}", file=sys.stderr)
        t = traced.trace
        dev.update(busy_s=t.busy_s(), window_s=t.window_s)
        result["breakdown"] = {"device_ops": t.top_ops(10), "idle_gaps": t.idle_gaps(10)}
        log(f"traced: {t.steps} steps in {t.window_s:.4f} s, device busy {t.busy_s():.4f} s, "
            f"{t.launch_count()} launches {t.launch_names}, {t.annotations} annotations left out; "
            f"counters {traced.counters}", file=sys.stderr)
    result["metrics"] = metrics_out
    result["device"] = dev
    result["compared"] = {k: {"value": compared[k] if math.isfinite(compared[k]) else None,
                              "limit": limits[k]} for k in limits}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # The program's kernel caches live in the checkout, at fixed paths.
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    spec = load_spec(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"this cell needs {spec.chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    # The thread share the launcher gives a learner rank beside the preset's one generator.
    torch.set_num_threads(max(1, torch.get_num_threads() // 2))
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                      log=print)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}", file=sys.stderr)
        return 3
    lines = [f"compared {k}: {v['value']!r} limit {v['limit']!r}"
             for k, v in result["compared"].items()]
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
