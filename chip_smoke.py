#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``pydreamer_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--learning-only | --tools-only | --graph-only | --dv3-only |
                           --backward-only | --copies-only | --k2-only | --dw-only]

Runs the phases of ``PHASES`` in order, or with a flag the phases that
``ONLY`` lists for it. Each phase is a function whose docstring says what it
runs and holds; any failure exits non-zero, and nothing is caught to carry
on. Without a card it exits 1 at once; with any other argument, 2.

Prints one JSON line of per-kernel numbers (``launches``: the count on the
path that runs the shape, ``launches_per_step``: per train step or acting
call, both as the phases that ran credited them; K1's backward has a row per
shape and gradient set of phase 20, its calls counted in phases 4, 9 and
19b; K2 a row per shape of phase 22, its calls counted in phase 23), then
the nvidia-smi line, then as the last line
``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json`` (``phase_s``: seconds by phase),
``chiprun_out/chip_smoke_profile.txt`` (phases 5 and 9),
``chiprun_out/learner_metrics.jsonl`` (phase 11's metrics),
``chiprun_out/launch_log.txt`` and ``chiprun_out/launch_metrics.jsonl``
(phase 12's launcher run), ``chiprun_out/probe_phase.json`` (phase 13),
``chiprun_out/phase14_*_rank*.json`` (phase 14's ranks),
``chiprun_out/live_log.txt`` and ``chiprun_out/live_run/`` (phase 15c),
``chiprun_out/tools_phase.json`` (phase 16),
``chiprun_out/k1_backward_phase.json`` (phase 20) and ``chip_smoke.json``'s
``copies`` (phase 21), ``k2`` (phase 22), ``graphs_dv3_200m`` (phase 23),
``dw_batch`` and ``graphs_dw`` (phase 24);
phase 11's episode files
stay in ``chiprun_out/learner_episodes/`` and the run directories (under
``runs/``, git-ignored) are removed at the end.
This script imports nothing of JAX or of the JAX package; its presets are
``config/*.yaml`` as the port's ``build_conf`` reads them.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from pydreamer_tpu_torch.conf import Conf, build_conf, parse_args
from pydreamer_tpu_torch.models.dreamer import Dreamer
from pydreamer_tpu_torch.models.modules import layer_norm
from pydreamer_tpu_torch.models.noise import GeneratorNoise
from pydreamer_tpu_torch.ops import gru_dv2 as k1
from pydreamer_tpu_torch.scripts.profile_step import profile_step
from pydreamer_tpu_torch.scripts.roofline import k1_bound_ms, peaks_for
from pydreamer_tpu_torch.training.train_step import TrainStep

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
DV2 = "gru_layernorm_dv2"


def preset(*names: str, **overrides) -> dict:
    """``--configs defaults <names>`` as the port reads ``config/*.yaml``,
    with ``overrides``."""
    return dict(build_conf(str(ROOT / "config"), ["defaults", *names]), **overrides)


def flagship_conf() -> dict:
    """Dreamer/Atari (``defaults`` + ``atari``) with the DreamerV2 late-reset
    GRU cell, so the train step runs kernel K1: the benchmark's ``atari_dv2``."""
    return preset("atari", gru_type=DV2)


def dmc_conf() -> dict:
    """``defaults`` + ``dmc`` with the K1 cell: deter 2048, 12 continuous
    actions, the dynamics gradient through the dream, the truncated-normal
    head. The benchmark's ``dmc_dv2``."""
    return preset("dmc", gru_type=DV2)


def dv3_conf() -> dict:
    """DreamerV3 XL as the normal path reads it: ``--configs defaults atari
    dreamerv3_xl``, the benchmark's ``atari_dv3_xl``."""
    return preset("atari", "dreamerv3_xl")


def dv3_200m_conf() -> dict:
    """DreamerV3's second release at size200m: ``--configs defaults atari
    dreamerv3_200m``, the benchmark's ``atari_dv3_200m`` (kernel K2)."""
    return preset("atari", "dreamerv3_200m")


FWD_TOL = 2e-3      # max-abs on h' (|h'| <= ~1), bf16 operands: f32 sums in another order, amplified by LayerNorm
FWD_TOL_F32 = 1e-4  # max-abs on h', f32 operands: both sides full f32 (TF32 off), sums in another order
GRAD_TOL = 1e-3     # relative to each gradient's max-abs: float32's backward is the same plain recompute
BWD_WITNESS_FACTOR = 2.0  # bf16's backward rounds the gate gradient dG to bf16: each gradient may
                          # differ from the float32 recompute's by twice what that rounding alone
                          # costs there (the witness, backward_witness), or by GRAD_TOL
BWD_LIMIT_CAP = 2e-2  # ... but never by more than this: the witnesses read 3.3e-3 to 7.6e-3 on the
                      # H100 at phase 20's shapes, so a witness that drifts fails the check
LOSS_RTOL = 2e-2    # fused vs unfused cell in bf16 over a 48-step loop and a 15-step dream
LOSS_ATOL = 1e-3    # ... for losses near 0 (the dummy probe)
AC_LOSS_RTOL = 1e-1  # actor/critic losses: small means over a 15-step bf16 dream (the unfused
                     # cell rounds its gates to bf16); the flagship's differed by 3.6% in phase 3
GRAD_NORM_RTOL = 5e-2  # the actor's gradient norm, fused vs unfused, through the 15-step dream

K1_SOURCE = "pydreamer_tpu_torch/ops/csrc/gru_dv2.cu"
K1_REPLACES = "pydreamer_tpu/ops/gru_pallas.py:78"
K1_BWD_REPLACES = "pydreamer_tpu/ops/gru_pallas.py:114"  # JAX's _bwd: the recompute in plain XLA
TIMED_STEPS = 5  # train steps a timed window in phases 4, 6 and 9


class RunState:
    """What the phases share: the card (its name, nvidia-smi line and peaks,
    set by phase 1), the device and one generator for every random input,
    the flagship conf, ``report`` (``chiprun_out/chip_smoke.json``), ``path``
    (K1's launches on the paths that ran, by shape, with the train steps or
    calls that made them) and ``held`` (the models and batches a phase hands
    to the next: 3 to 6, 8 to 10)."""

    def __init__(self):
        self.device = torch.device("cuda:0")
        self.gen = torch.Generator(device=self.device).manual_seed(0)
        self.conf = Conf(flagship_conf())
        self.smi = self.name = self.peaks = None
        self.report = {"k1": []}
        self.path = {}
        self.held = {}

    def credit(self, schedule: str, M: int, H: int, launches: int, calls: int) -> None:
        """Add ``launches`` of K1's ``schedule`` at M rows and width H, made by
        ``calls`` train steps or acting calls, to the kernels line's row."""
        n, c = self.path.get((schedule, M, H), (0, 0))
        self.path[(schedule, M, H)] = (n + launches, c + calls)

    def k1_row(self, where: str, M: int, In: int, H: int, dtype, want: str) -> None:
        """One timed ``check_k1`` row: kept for the kernels line, printed."""
        res = check_k1(self, M, In, H, dtype, want, timed=True)
        self.report["k1"].append(res)
        print(f"{where}: {k1_summary(res)}")


def time_ms(fn, iters: int, flush=None) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph, so the
    host's launch cost does not enter; the median of 3 replays. With
    ``flush``, each call follows a flush of the L2 and the flushes' own time
    (a graph of flushes alone) is subtracted."""
    def graph_ms(body):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                body()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                body()
        graph.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / iters)
        return sorted(times)[1]

    if flush is None:
        return graph_ms(fn)
    return graph_ms(lambda: (flush(), fn())) - graph_ms(flush)


def call_us(fn, n: int = 200) -> float:
    """Host-clock microseconds per call over ``n`` back-to-back eager calls
    (then one synchronize): the launch path's host cost where it exceeds the
    device time, as it does inside the host-bound train step."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def k1_inputs(M, In, H, gen, device, dtype):
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)
    return (randn(M, In).to(dtype), torch.tanh(randn(M, H)).to(dtype),
            (0.03 * randn(In, 3 * H)).to(dtype), (0.03 * randn(H, 3 * H)).to(dtype),
            1.0 + 0.1 * randn(3 * H), 0.1 * randn(3 * H))


def unfused_cell(x, h, w_ih, w_hh, scale, bias):
    """The composition NormGRUCellLateReset.forward runs, on operands already
    in its compute dtype: two products, LayerNorm in f32, the gate ops."""
    gates = layer_norm(x @ w_ih + h @ w_hh, scale, bias, x.dtype)
    r, u, n = gates.chunk(3, -1)
    update = torch.sigmoid(u - 1.0)
    return update * torch.tanh(torch.sigmoid(r) * n) + (1.0 - update) * h


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def check_k1(rs: RunState, M, In, H, dtype, want, timed: bool) -> dict:
    """K1 at one shape against its plain version, forward and six gradients;
    ``timed``: its times beside the yardsticks and its bound."""
    gen, device = rs.gen, rs.device
    ins = k1_inputs(M, In, H, gen, device, dtype)
    got = k1.plan(M, In, H, dtype).schedule
    if got != want:
        raise AssertionError(f"K1 M={M} In={In} H={H} {dtype}: schedule {got}, expected {want}")
    tol = FWD_TOL if dtype == torch.bfloat16 else FWD_TOL_F32
    out_k = k1.gru_dv2_cuda(*ins)
    out_p = k1.gru_dv2_reference(*ins)
    torch.cuda.synchronize()
    fwd_err = (out_k - out_p).abs().max().item()
    if not math.isfinite(fwd_err) or fwd_err > tol:
        raise AssertionError(f"K1 {got} M={M} In={In} H={H}: forward max-abs err {fwd_err} > {tol}")

    proj = torch.randn(M, H, generator=gen, device=device)
    leaves_k = [t.clone().requires_grad_() for t in ins]
    (k1.GRUDv2Function.apply(*leaves_k) * proj).sum().backward()
    leaves_p = [t.clone().requires_grad_() for t in ins]
    (k1.gru_dv2_reference(*leaves_p) * proj).sum().backward()
    witness = backward_witness(ins, proj) if dtype == torch.bfloat16 else None
    grad_errs = {}
    for i, (name, a, b) in enumerate(zip(GRAD_NAMES, leaves_k, leaves_p)):
        err = rel_err(a.grad, b.grad)
        grad_errs[name] = err
        limit = GRAD_TOL if witness is None else bwd_limit(rel_err(witness[i], b.grad))
        if not math.isfinite(err) or err > limit:
            raise AssertionError(f"K1 {got} M={M}: grad {name} rel err {err} > {limit}")
    result = dict(schedule=got, M=M, In=In, H=H, dtype=dtype_name(dtype),
                  max_abs_err=fwd_err, tol=tol, grad_rel_err=grad_errs)
    if timed:
        flush_buf = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=device)  # 128 MB > L2
        flush = flush_buf.zero_
        iters = 50
        xh, w = torch.cat(ins[:2], 1), torch.cat(ins[2:4], 0)
        result["ms"] = time_ms(lambda: k1.gru_dv2_cuda(*ins), iters, flush)
        result["ms_l2_warm"] = time_ms(lambda: k1.gru_dv2_cuda(*ins), iters)
        result["plain_ms"] = time_ms(lambda: k1.gru_dv2_reference(*ins), iters, flush)
        result["gemm_library_ms"] = time_ms(lambda: torch.mm(xh, w), iters, flush)
        result["unfused_ms"] = time_ms(lambda: unfused_cell(*ins), iters, flush)
        result["call_us"] = call_us(lambda: k1.gru_dv2_cuda(*ins))
        result["unfused_call_us"] = call_us(lambda: unfused_cell(*ins))
        if H == 1024:  # the dtype's first design at the same shape, as generic_ms / f32_ffma_ms
            sched, key = ("generic", "generic") if dtype == torch.bfloat16 else ("f32", "f32_ffma")
            first = k1.Plan(sched, workspace=M * 3 * H)
            result[f"{key}_ms"] = time_ms(lambda: k1._launch(first, *ins), iters, flush)
            out_f = k1._launch(first, *ins)
            torch.cuda.synchronize()
            result[f"{key}_max_abs_err"] = err = (out_f - out_p).abs().max().item()
            if not math.isfinite(err) or err > tol:
                raise AssertionError(f"K1 {sched} M={M} H={H}: forward max-abs err {err} > {tol}")
        result["bound_ms"], result["bound_by"], result["bound_route"] = k1_bound_ms(
            M, In, H, rs.peaks, dtype == torch.bfloat16)
        result["bound_share"] = result["bound_ms"] / result["ms"]
    return result


GRAD_NAMES = ("x", "h", "w_ih", "w_hh", "scale", "bias")


def rel_err(a, b) -> float:
    """max |a - b| over max |b|, in float32."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def bwd_limit(witness: float) -> float:
    """The limit of a bf16 gradient of K1's backward, relative to its max:
    ``BWD_WITNESS_FACTOR`` times the witness's distance, at least
    ``GRAD_TOL``, at most ``BWD_LIMIT_CAP``."""
    return min(max(BWD_WITNESS_FACTOR * witness, GRAD_TOL), BWD_LIMIT_CAP)


def k1_backward_rows(T: int, B: int, H_imag: int, dynamics: bool, steps: int = 1) -> dict:
    """K1 backward calls by rows that ``steps`` train steps make: T at M=B
    (the posterior loop) and, under ``actor_grad: dynamics`` (the only mode
    whose actor loss reaches the dream's cell), H_imag at M=T*B."""
    return {B: steps * T, **({T * B: steps * H_imag} if dynamics else {})}


def check_k1_backwards(report, where: str, want: dict, H: int, steps: int,
                       credit: bool = True) -> None:
    """The K1 backward calls counted since ``K1_BACKWARDS.reset()`` on a
    main-path run: ``want`` by rows, every one on the bf16 pass (route
    ``kernel``). With ``credit``, add them to the kernels line's K1-backward
    rows (``report["k1_backward_path"]``, launches and steps by shape)."""
    route, rows = dict(k1.K1_BACKWARDS.by_route), dict(k1.K1_BACKWARDS.by_rows)
    if credit:
        print(f"[{where}] K1 backward calls by route {route}, by rows {rows}", flush=True)
    if route != {"kernel": sum(want.values())} or rows != want:
        raise AssertionError(f"[{where}] K1 backward calls by route {route}, by rows {rows}; "
                             f"expected {sum(want.values())} on the kernel route, {want}")
    if credit:
        path = report.setdefault("k1_backward_path", {})
        for M, n in want.items():
            launches, n_steps = path.get(f"M={M},H={H}", (0, 0))
            path[f"M={M},H={H}"] = (launches + n, n_steps + steps)


def backward_witness(ins, grad_out, needs=(True,) * 6) -> list:
    """The bf16 witness of K1's backward: the float32 recompute's arithmetic
    (f32 copies of the operands, the plain LayerNorm/gate backward) with the
    bf16 pass's one new rounding, dG to bf16, before three f32 products; each
    gradient rounded to its input's dtype. Its distance from the float32
    recompute is what that rounding costs."""
    x, h, w_ih, w_hh, scale, bias = ins
    gates = x.float() @ w_ih.float() + h.float() @ w_hh.float()
    dG, dh_term, d_scale, d_bias = k1.ln_gate_backward_reference(gates, h, scale, bias, grad_out)
    dG = dG.to(x.dtype).float()
    out = (dG @ w_ih.float().t(), dG @ w_hh.float().t() + dh_term, x.float().t() @ dG,
           h.float().t() @ dG, d_scale, d_bias)
    return [g.to(t.dtype) if need else None for g, t, need in zip(out, ins, needs)]


def k1_summary(res) -> str:
    """One timed ``check_k1`` result on a line."""
    first = "".join(f", {k} {res[f'{k}_ms']:.5f} (err {res[f'{k}_max_abs_err']:.3e})"
                    for k in ("generic", "f32_ffma") if f"{k}_ms" in res)
    return (f"max_abs_err {res['max_abs_err']:.3e}, grads ok, {res['ms']:.5f} ms (L2 warm "
            f"{res['ms_l2_warm']:.5f}), bound {res['bound_ms']:.5f} ms ({res['bound_by']}, "
            f"{res['bound_route']}, {100 * res['bound_share']:.1f}%), plain {res['plain_ms']:.5f}, "
            f"gemm_library {res['gemm_library_ms']:.5f}, unfused {res['unfused_ms']:.5f}{first} "
            f"ms; host {res['call_us']:.1f} us/call (unfused {res['unfused_call_us']:.1f})")


def timed_steps(ts, obs, state, step: int, n: int):
    """Run n TrainStep calls from ``step + 1``; host-clock ms per step, synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        state, metrics, _, _ = ts(obs, state, step + 1 + i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3, state, metrics


def make_obs(conf, gen, device, T=None, B=None):
    T, B, A = T or conf.batch_length, B or conf.batch_size, conf.action_dim
    reset = torch.zeros(T, B, dtype=torch.bool, device=device)
    reset[0] = True
    if conf.actor_dist == "onehot":
        action_idx = torch.randint(0, A, (T, B), generator=gen, device=device)
        action = torch.nn.functional.one_hot(action_idx, A).float()
    else:
        action = torch.rand(T, B, A, generator=gen, device=device) * 2 - 1
    return dict(
        action=action,
        reward=torch.rand(T, B, generator=gen, device=device),
        terminal=torch.zeros(T, B, device=device),
        reset=reset,
        image=torch.randint(0, 256, (T, B, conf.image_size, conf.image_size, conf.image_channels),
                            generator=gen, device=device, dtype=torch.uint8),
    )


def check_profiled_k1(prof, T: int, H_imag: int, what: str) -> None:
    """The profiled step launched T ``skinny`` and H_imag ``wide`` K1 kernels
    (the wrapper's count), and the profiler recorded kernels of both and none
    of the other schedules. CUPTI may drop a kernel record in a step of
    ~10,000 kernels (one of 48 skinny records was seen missing once on an
    H100), so its counts are held to at most the launches, and reported."""
    seen = prof["k1_launches"]
    if prof["launched"] != {"skinny": T, "wide": H_imag}:
        raise AssertionError(f"{what}: K1 launches {prof['launched']}, expected {T} skinny + "
                             f"{H_imag} wide")
    if not (0 < seen["skinny::gates_kernel"] <= T and 0 < seen["wide::gates_kernel"] <= H_imag
            and seen["generic::"] == 0 and seen["f32::"] == 0):
        raise AssertionError(f"{what}: the profiler recorded K1 kernels {seen}, launched "
                             f"{prof['launched']}: {prof['k1_kernels']}")


def unfused_state_dict(sd):
    """The K1 cell's weights under the unfused cell's names."""
    return {k.replace("cell_0.ln_scale", "cell_0.lnorm.weight")
             .replace("cell_0.ln_bias", "cell_0.lnorm.bias"): v for k, v in sd.items()}


def actor_grad_norm(model):
    return torch.sqrt(sum(p.grad.float().square().sum() for p in model.ac.actor.parameters()
                          if p.grad is not None)).item()


def build_phase(rs: RunState) -> None:
    """1. Build kernel K1 (``ops/csrc/gru_dv2.cu``, nvcc for sm_90a) and print
    the card's name and power limit as nvidia-smi reports them."""
    report = rs.report
    t0 = time.time()
    lib_path = k1.build()
    report["build_s"] = time.time() - t0
    ptxas = [ln for ln in lib_path.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln or "smem" in ln]
    print(f"[1] built {lib_path.name} in {report['build_s']:.1f} s", *ptxas, sep="\n    ")
    rs.smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True,
                            check=True).stdout.strip().splitlines()[0]
    rs.name = torch.cuda.get_device_name(0)
    peak_key, rs.peaks = peaks_for(rs.name)
    report.update(card=rs.name, nvidia_smi=rs.smi, peaks_of=peak_key, torch=torch.__version__,
                  cuda=torch.version.cuda)
    print(f"    card {rs.smi}; torch {torch.__version__} cuda {torch.version.cuda}")


def schedules_phase(rs: RunState, flagship_only: bool = False) -> None:
    """2. Hold every K1 schedule against its plain PyTorch version: forward
    max-abs error and the gradients of all six inputs (float32: the same plain
    recompute, within ``GRAD_TOL``; bf16: K1's bf16 backward pass, within
    ``BWD_WITNESS_FACTOR`` times what rounding dG to bf16 alone costs, at most
    ``BWD_LIMIT_CAP``, as phase 20). ``skinny`` and ``wide`` at the two
    main-path shapes (M=32 and M=1536 rows, In=1000, H=1024, bf16) and at
    H=2048 (the ``defaults`` width), ``skinny_f32`` and ``wide_f32`` at the
    same four shapes in float32 (3xTF32 on the tensor cores, held to the f32
    tolerance with TF32 off in the plain version), ``generic`` and ``f32`` at
    small ragged shapes. Time each (CUDA graphs of many launches, cold and
    warm L2) beside its bound (for f32 operands the faster of FFMA and 3xTF32,
    the route named), the plain version, the cuBLAS product of the
    concatenated operands (``gemm_library_ms``), the unfused composition the
    ``gru_layernorm_dv2_xla`` cell runs (``unfused_ms``), and, at H=1024, the
    first design of the dtype at the same shape: ``generic`` (the first,
    unpipelined bf16 design) or ``f32`` (the FFMA design, ``f32_ffma_ms``),
    each held to the same tolerance. The port calls none of these
    yardsticks. Then the fused cell under ``precision: float32`` on the card:
    it must take ``skinny_f32``. ``flagship_only``: the two flagship rows
    alone."""
    from pydreamer_tpu_torch.models.rnn import make_gru_cell

    conf, gen, device = rs.conf, rs.gen, rs.device
    T, B, In, H = conf.batch_length, conf.batch_size, conf.hidden_dim, conf.deter_dim
    bf16, f32 = torch.bfloat16, torch.float32
    rows = ((B, H, bf16, "skinny"), (T * B, H, bf16, "wide"),
            (B, 2048, bf16, "skinny"), (T * B, 2048, bf16, "wide"),
            (B, H, f32, "skinny_f32"), (T * B, H, f32, "wide_f32"),
            (B, 2048, f32, "skinny_f32"), (T * B, 2048, f32, "wide_f32"))
    for M, H_s, dtype, want in rows[:2] if flagship_only else rows:
        rs.k1_row(f"[2] K1 {want} M={M} H={H_s} {dtype_name(dtype)}", M, In, H_s, dtype, want)
    if flagship_only:
        return
    for M, In_s, H_s, dtype, want in ((5, 37, 50, bf16, "generic"), (70, 129, 67, bf16, "generic"),
                                      (1, 8, 16, bf16, "generic"), (5, 37, 50, f32, "f32"),
                                      (70, 129, 67, f32, "f32")):
        res = check_k1(rs, M, In_s, H_s, dtype, want, timed=False)
        print(f"[2] K1 {want} M={M} In={In_s} H={H_s} {res['dtype']}: max_abs_err "
              f"{res['max_abs_err']:.3e}, grads ok")
    # The fused cell under precision: float32 runs K1's skinny_f32 schedule at M=B.
    cell = make_gru_cell(DV2, In, H, dtype=f32).to(device)
    x32, h32 = k1_inputs(B, In, H, gen, device, f32)[:2]
    k1.LAUNCHES.reset()
    with torch.no_grad():
        out32 = cell(x32, h32)
        ref32 = k1.gru_dv2_reference(x32, h32, cell.weight_ih, cell.weight_hh, cell.ln_scale,
                                     cell.ln_bias)
    err32 = (out32 - ref32).abs().max().item()
    rs.report["f32_cell"] = dict(max_abs_err=err32, launches=dict(k1.LAUNCHES.by_schedule))
    print(f"[2] gru_layernorm_dv2 cell in float32: {k1.LAUNCHES.by_schedule}, max_abs_err {err32:.3e}")
    if (out32.dtype != f32 or k1.LAUNCHES.by_schedule != {"skinny_f32": 1}
            or not err32 <= FWD_TOL_F32):
        raise AssertionError(f"float32 cell: {out32.dtype}, {k1.LAUNCHES.by_schedule}, err {err32}")


def fused_forward_phase(rs: RunState) -> None:
    """3. Check the train step's forward at full width with the K1 cell
    against the unfused ``gru_layernorm_dv2_xla`` cell (same weights, same
    noise). Hands both models and the batch to phases 4-6."""
    conf, device = rs.conf, rs.device
    B = conf.batch_size
    torch.manual_seed(0)
    model = Dreamer(conf, device=device)
    obs = make_obs(conf, rs.gen, device)
    xla = Dreamer(conf.replace(gru_type="gru_layernorm_dv2_xla"), device=device)
    xla.load_state_dict(unfused_state_dict(model.state_dict()))
    with torch.no_grad():
        lf, *_ = model.training_step(obs, model.init_state(B), GeneratorNoise(device, seed=7))
        lx, *_ = xla.training_step(obs, xla.init_state(B), GeneratorNoise(device, seed=7))
    cmp = {k: (lf[k].item(), lx[k].item()) for k in lf}
    rs.report["fused_vs_unfused"] = cmp
    print("[3] fused vs unfused losses:", {k: f"{a:.5f}/{b:.5f}" for k, (a, b) in cmp.items()})
    rel = abs(cmp["loss_model"][0] - cmp["loss_model"][1]) / abs(cmp["loss_model"][1])
    if not rel <= LOSS_RTOL:
        raise AssertionError(f"fused vs unfused loss_model rel diff {rel} > {LOSS_RTOL}")
    rs.held = dict(model=model, xla=xla, obs=obs)


def train_step_phase(rs: RunState) -> None:
    """4. Drive the main path: the flagship Dreamer/Atari train step (T=48,
    B=32, deter 1024, stoch 32x32, hidden 1000, cnn_depth 48, H=15, bf16
    compute, uint8 images, gru_type gru_layernorm_dv2) from random weights
    made from a seed: 2 warm-up and 5 timed TrainStep calls. The K1 launch
    counter is set to 0 just before and read just after: T launches a step
    must have taken ``skinny`` and H ``wide``, none ``generic``; so is K1's
    backward tally (``K1_BACKWARDS``): T calls a step at M=B (the dream is not
    differentiated under ``actor_grad: reinforce``), every one on the bf16
    pass (route ``kernel``)."""
    conf, report, held = rs.conf, rs.report, rs.held
    T, B, H_imag, H = conf.batch_length, conf.batch_size, conf.imag_horizon, conf.deter_dim
    model, obs, n_steps = held["model"], held["obs"], TIMED_STEPS
    ts = TrainStep(model, conf, device=rs.device)
    _, state, _ = timed_steps(ts, obs, model.init_state(B), 0, 2)
    torch.cuda.reset_peak_memory_stats()
    k1.LAUNCHES.reset()
    k1.K1_BACKWARDS.reset()
    step_ms, state, metrics = timed_steps(ts, obs, state, 2, n_steps)
    launches, by_rows = k1.LAUNCHES.count, dict(k1.LAUNCHES.by_rows)
    by_schedule = dict(k1.LAUNCHES.by_schedule)
    losses = {k: metrics[k].item() for k in ("loss_model", "loss_probe", "loss_actor", "loss_critic")}
    report.update(step_ms=step_ms, launches=launches, launches_by_rows=by_rows,
                  launches_by_schedule=by_schedule, losses=losses,
                  metrics={k: v.item() for k, v in metrics.items()},
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[4] train step: {step_ms:.2f} ms/step over {n_steps} steps, losses {losses}, "
          f"K1 launches {launches} {by_rows} {by_schedule}, peak mem {report['peak_mem_gb']:.2f} GB")
    if not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"non-finite losses {losses}")
    want = n_steps * (T + H_imag)
    if (launches != want or by_rows != {B: n_steps * T, T * B: n_steps * H_imag}
            or by_schedule != {"skinny": n_steps * T, "wide": n_steps * H_imag}):
        raise AssertionError(f"K1 launches {launches} {by_rows} {by_schedule}, expected {want}: "
                             f"{n_steps * T} skinny and {n_steps * H_imag} wide")
    check_k1_backwards(report, "4", k1_backward_rows(
        T, B, H_imag, conf.actor_grad == "dynamics", n_steps), H, n_steps)
    if tuple(state[0].shape) != (B, H) or not torch.isfinite(state[0]).all():
        raise AssertionError("out_state h is not finite of shape (B, deter)")
    rs.credit("skinny", B, H, by_schedule["skinny"], n_steps)
    rs.credit("wide", T * B, H, by_schedule["wide"], n_steps)
    held.update(ts=ts, state=state, step=2 + n_steps)


def profile_phase(rs: RunState) -> None:
    """5. Profile one more step with torch.profiler: K1's kernels, device time
    and launches, and the device's busy time in the step."""
    held, conf = rs.held, rs.conf
    state, prof5, events = profile_step(held["ts"], held["obs"], held["state"], held["step"] + 1)
    held.update(state=state, step=held["step"] + 1)
    rs.report["profile"] = prof5
    table = events.table(sort_by="self_device_time_total", row_limit=30)
    print(f"[5] profiled step: wall {prof5['wall_ms']:.2f} ms, device busy "
          f"{prof5['device_busy_ms']:.2f} ms; K1 {prof5['k1_ms']:.3f} ms in {prof5['k1_kernels']}; "
          f"launched {prof5['launched']}, recorded {prof5['k1_launches']}")
    check_profiled_k1(prof5, conf.batch_length, conf.imag_horizon, "[5] profiled step")
    (OUT_DIR / "chip_smoke_profile.txt").write_text(f"{rs.smi}\n[5] flagship step\n{table}\n")


def turns_phase(rs: RunState) -> None:
    """6. Time the train step with the K1 cell against the unfused cell, in
    turns (unfused, K1, K1, unfused; 5 steps per window after 2 warm-up
    steps). Lets go of phase 3's models."""
    held, n_steps = rs.held, TIMED_STEPS
    ts, obs, state, step, xla = (held.pop(k) for k in ("ts", "obs", "state", "step", "xla"))
    ts_xla = TrainStep(xla, rs.conf, device=rs.device)
    _, state_xla, _ = timed_steps(ts_xla, obs, xla.init_state(rs.conf.batch_size), 0, 2)
    windows = {"unfused": [], "k1": []}
    for variant in ("unfused", "k1", "k1", "unfused"):
        if variant == "k1":
            ms, state, _ = timed_steps(ts, obs, state, step, n_steps)
            step += n_steps
        else:
            ms, state_xla, _ = timed_steps(ts_xla, obs, state_xla, 2 + len(windows["unfused"]) * n_steps, n_steps)
        windows[variant].append(ms)
    rs.report["step_ms_ab"] = windows
    print(f"[6] ms/step in turns: K1 cell {windows['k1']}, unfused cell {windows['unfused']}")
    del xla, ts, ts_xla, state, state_xla, obs
    held.clear()
    torch.cuda.empty_cache()


def acting_shapes_phase(rs: RunState) -> None:
    """7. Inference shapes: hold ``skinny`` at M=1 and M=8 (In=1000, H=2048,
    bf16) against its plain version, forward and six gradients, timed as in 2."""
    for M in (1, 8):
        rs.k1_row(f"[7] K1 skinny M={M} H=2048", M, rs.conf.hidden_dim, 2048, torch.bfloat16,
                  "skinny")


def dmc_fused_phase(rs: RunState) -> None:
    """8. The DMC path (``dmc_conf``: deter 2048, action_dim 12, ``actor_grad:
    dynamics``, ``actor_dist: trunc_normal``): one forward and backward with
    the K1 cell and with the unfused cell from the same weights and noise;
    the four losses and the actor's gradient norm must agree. K1's backward
    runs at M=1536, H=2048 here. Hands the K1 model and its batch to phases 9
    and 10."""
    device = rs.device
    dconf = Conf(dmc_conf())
    T, B, H_imag = dconf.batch_length, dconf.batch_size, dconf.imag_horizon
    torch.manual_seed(1)
    dmodel = Dreamer(dconf, device=device)
    dxla = Dreamer(dconf.replace(gru_type="gru_layernorm_dv2_xla"), device=device)
    dxla.load_state_dict(unfused_state_dict(dmodel.state_dict()))
    dobs = make_obs(dconf, rs.gen, device)
    cmp8 = {}
    for tag, m in (("k1", dmodel), ("unfused", dxla)):
        k1.LAUNCHES.reset()
        losses, *_ = m.training_step(dobs, m.init_state(B), GeneratorNoise(device, seed=8))
        sum(losses.values()).backward()
        torch.cuda.synchronize()
        cmp8[tag] = dict({k: v.item() for k, v in losses.items()},
                         grad_norm_actor=actor_grad_norm(m),
                         launches=dict(k1.LAUNCHES.by_schedule))
        m.zero_grad(set_to_none=True)
    rs.report["dmc_fused_vs_unfused"] = cmp8
    print("[8] DMC fused vs unfused:", {k: f"{cmp8['k1'][k]:.5f}/{cmp8['unfused'][k]:.5f}"
                                        for k in cmp8["k1"] if k != "launches"},
          "K1 launches", cmp8["k1"]["launches"])
    if cmp8["k1"]["launches"] != {"skinny": T, "wide": H_imag} or cmp8["unfused"]["launches"]:
        raise AssertionError(f"phase 8 K1 launches {cmp8['k1']['launches']} / "
                             f"{cmp8['unfused']['launches']}, expected {T} skinny + {H_imag} wide / none")
    for k, rtol in (("loss_model", LOSS_RTOL), ("loss_probe", LOSS_RTOL),
                    ("loss_actor", AC_LOSS_RTOL), ("loss_critic", AC_LOSS_RTOL)):
        a, b = cmp8["k1"][k], cmp8["unfused"][k]
        if not abs(a - b) <= rtol * max(abs(a), abs(b)) + LOSS_ATOL:
            raise AssertionError(f"DMC fused vs unfused {k}: {a} vs {b}")
    a, b = cmp8["k1"]["grad_norm_actor"], cmp8["unfused"]["grad_norm_actor"]
    if not (math.isfinite(a) and a > 0 and abs(a - b) <= GRAD_NORM_RTOL * b):
        raise AssertionError(f"DMC fused vs unfused actor gradient norm: {a} vs {b}")
    del m, dxla
    torch.cuda.empty_cache()
    rs.held = dict(conf=dconf, model=dmodel, obs=dobs)


def dmc_step_phase(rs: RunState) -> None:
    """9. Drive the DMC train step: 2 warm-up and 5 timed TrainStep calls,
    counts set to 0 just before and read just after (48 ``skinny`` and 15
    ``wide`` a step, none ``generic``; 48 K1 backward calls at M=32 and 15 at
    M=1536 a step, all on the bf16 pass), a finite non-zero actor gradient
    norm, and no world-model gradient from the actor loss alone. Then one log
    step (``do_image_pred``, ``do_dream_tensors``: 48 + 47 skinny, 15 wide,
    finite dream tensors of JAX's shapes) and one profiled step: busy time,
    K1's kernels and the step's f32 GEMMs (K1's backward runs bf16
    products)."""
    report, device = rs.report, rs.device
    dconf, dmodel, dobs = rs.held["conf"], rs.held["model"], rs.held["obs"]
    T, B, H_imag = dconf.batch_length, dconf.batch_size, dconf.imag_horizon
    Hd, A, n_steps = dconf.deter_dim, dconf.action_dim, TIMED_STEPS
    dts = TrainStep(dmodel, dconf, device=device)
    _, dstate, _ = timed_steps(dts, dobs, dmodel.init_state(B), 0, 2)
    torch.cuda.reset_peak_memory_stats()
    k1.LAUNCHES.reset()
    k1.K1_BACKWARDS.reset()
    dstep_ms, dstate, dmetrics = timed_steps(dts, dobs, dstate, 2, n_steps)
    d_rows, d_sched = dict(k1.LAUNCHES.by_rows), dict(k1.LAUNCHES.by_schedule)
    dstep = 2 + n_steps
    dlosses = {k: dmetrics[k].item() for k in ("loss_model", "loss_probe", "loss_actor", "loss_critic")}
    gna = dmetrics["grad_norm_actor"].item()
    report["dmc"] = dict(step_ms=dstep_ms, launches_by_rows=d_rows, launches_by_schedule=d_sched,
                         losses=dlosses, metrics={k: v.item() for k, v in dmetrics.items()},
                         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[9] DMC train step: {dstep_ms:.2f} ms/step over {n_steps} steps, losses {dlosses}, "
          f"grad_norm_actor {gna:.5g}, K1 launches {d_rows} {d_sched}, "
          f"peak mem {report['dmc']['peak_mem_gb']:.2f} GB")
    if d_rows != {B: n_steps * T, T * B: n_steps * H_imag} or \
            d_sched != {"skinny": n_steps * T, "wide": n_steps * H_imag}:
        raise AssertionError(f"DMC K1 launches {d_rows} {d_sched}, expected {n_steps * T} skinny "
                             f"[M={B}] and {n_steps * H_imag} wide [M={T * B}], no generic")
    if not all(math.isfinite(v) for v in dlosses.values()) or not (math.isfinite(gna) and gna > 0):
        raise AssertionError(f"DMC step: losses {dlosses}, grad_norm_actor {gna}")
    rs.credit("skinny", B, Hd, d_sched["skinny"], n_steps)
    rs.credit("wide", T * B, Hd, d_sched["wide"], n_steps)
    check_k1_backwards(report, "9", k1_backward_rows(
        T, B, H_imag, dconf.actor_grad == "dynamics", n_steps), Hd, n_steps)

    # The actor loss alone reaches the actor and leaves the world model alone.
    dmodel.zero_grad(set_to_none=True)  # TrainStep leaves its step's gradients behind
    losses, *_ = dmodel.training_step(dobs, dstate, GeneratorNoise(device, seed=9))
    losses["loss_actor"].backward()
    leaked = [n for n, p in dmodel.wm.named_parameters() if p.grad is not None and p.grad.any()]
    only_actor = actor_grad_norm(dmodel)
    dmodel.zero_grad(set_to_none=True)
    report["dmc"]["actor_loss_only"] = dict(wm_params_with_grad=leaked, grad_norm_actor=only_actor)
    print(f"[9] actor loss alone: actor grad norm {only_actor:.5g}, wm parameters with a "
          f"gradient: {leaked}")
    if leaked or not only_actor > 0:
        raise AssertionError(f"actor loss alone: wm gradients {leaked}, actor norm {only_actor}")

    # One log step with both flags.
    k1.LAUNCHES.reset()
    t0 = time.perf_counter()
    dstate, lmetrics, _, dream = dts(dobs, dstate, dstep + 1, do_image_pred=True,
                                     do_dream_tensors=True)
    torch.cuda.synchronize()
    log_ms = (time.perf_counter() - t0) * 1e3
    dstep += 1
    l_rows, l_sched = dict(k1.LAUNCHES.by_rows), dict(k1.LAUNCHES.by_schedule)
    shapes = {k: tuple(v.shape) for k, v in dream.items()}
    report["dmc"]["log_step"] = dict(ms=log_ms, launches_by_rows=l_rows, launches_by_schedule=l_sched,
                                     dream_shapes=shapes,
                                     logprob={k: v.item() for k, v in lmetrics.items()
                                              if k.startswith("logprob_")})
    print(f"[9] log step: {log_ms:.2f} ms, K1 launches {l_rows} {l_sched}, dream tensors {shapes}")
    if l_sched != {"skinny": 2 * T - 1, "wide": H_imag} or l_rows != {B: 2 * T - 1, T * B: H_imag}:
        raise AssertionError(f"log step K1 launches {l_rows} {l_sched}, expected {T}+{T - 1} "
                             f"skinny and {H_imag} wide")
    if shapes.get("image_pred") != (T, B, 64, 64, 3) or shapes.get("action_pred") != (T, B, A):
        raise AssertionError(f"dream tensor shapes {shapes}")
    if not all(torch.isfinite(v).all() for v in dream.values()) or \
            not all(math.isfinite(v.item()) for v in lmetrics.values()):
        raise AssertionError("log step: non-finite dream tensors or metrics")

    # Profile one step.
    dstate, prof9, events9 = profile_step(dts, dobs, dstate, dstep + 1)
    report["dmc"]["profile"] = prof9
    print(f"[9] profiled DMC step: wall {prof9['wall_ms']:.2f} ms, device busy "
          f"{prof9['device_busy_ms']:.2f} ms; K1 {prof9['k1_ms']:.3f} ms {prof9['k1_ms_by_kernel']}; "
          f"f32 GEMMs {prof9['f32_gemm_ms']:.3f} ms in "
          f"{prof9['f32_gemm_calls']} calls; K1 launched {prof9['launched']}, recorded "
          f"{prof9['k1_launches']}")
    check_profiled_k1(prof9, T, H_imag, "[9] profiled DMC step")
    with open(OUT_DIR / "chip_smoke_profile.txt", "a") as f:
        f.write(f"[9] DMC step\n{events9.table(sort_by='self_device_time_total', row_limit=40)}\n")


def inference_phase(rs: RunState) -> None:
    """10. ``Dreamer.inference`` on the DMC model at B=1 and B=8, the
    generators' acting step: one ``skinny`` launch a call, finite actions in
    [-1, 1], host microseconds per call. Lets go of phase 8's model."""
    dconf, dmodel = rs.held.pop("conf"), rs.held.pop("model")
    Hd, A, device = dconf.deter_dim, dconf.action_dim, rs.device
    report = rs.report["inference"] = {}
    n_calls = 50
    for Bi in (1, 8):
        iobs = make_obs(dconf, rs.gen, device, T=1, B=Bi)
        istate, inoise = dmodel.init_state(Bi), GeneratorNoise(device, seed=10)
        for _ in range(3):
            action, istate, imetrics = dmodel.inference(iobs, istate, inoise)
        iobs["reset"][:] = False
        torch.cuda.synchronize()
        k1.LAUNCHES.reset()
        t0 = time.perf_counter()
        for _ in range(n_calls):
            action, istate, imetrics = dmodel.inference(iobs, istate, inoise)
            action_host = action.cpu()  # the generator steps its envs with it
        call_us_i = (time.perf_counter() - t0) / n_calls * 1e6
        i_rows, i_sched = dict(k1.LAUNCHES.by_rows), dict(k1.LAUNCHES.by_schedule)
        report[Bi] = dict(us_per_call=call_us_i, launches_by_rows=i_rows,
                          launches_by_schedule=i_sched,
                          metrics={k: v.tolist() for k, v in imetrics.items()})
        print(f"[10] inference B={Bi}: {call_us_i:.1f} us/call (host clock, action to host), "
              f"K1 launches {i_rows} {i_sched}")
        if i_sched != {"skinny": n_calls} or i_rows != {Bi: n_calls}:
            raise AssertionError(f"inference B={Bi}: K1 launches {i_rows} {i_sched}, expected "
                                 f"{n_calls} skinny [M={Bi}]")
        if (tuple(action_host.shape) != (1, Bi, A) or not torch.isfinite(action_host).all()
                or action_host.abs().max() > 1.0):
            raise AssertionError(f"inference B={Bi}: action {action_host}")
        if not all(tuple(v.shape) == (Bi,) and torch.isfinite(v).all() for v in imetrics.values()):
            raise AssertionError(f"inference B={Bi}: metrics {imetrics}")
        rs.credit("skinny", Bi, Hd, n_calls, n_calls)
    del dmodel, istate
    rs.held.clear()
    torch.cuda.empty_cache()


def _bounce(p, span):
    """Positions p folded into [0, span] (a block bouncing between walls)."""
    p = p % (2 * span)
    return span - abs(p - span)


def write_episodes(repo, n_files: int, length: int, action_dim: int, seed: int) -> None:
    """Episode files in the generators' format (``image_t`` HWCT uint8, one-hot
    float64 actions, float64 rewards, bool terminal/reset), one episode of
    ``length`` steps each. Frames are a flat background with three moving
    blocks, so zlib works on them as on game frames, not on noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(length)
    for i in range(n_files):
        frames = np.empty((length, 64, 64, 3), np.uint8)
        frames[:] = rng.integers(0, 256, 3, dtype=np.uint8)
        for _ in range(3):
            size = int(rng.integers(4, 12))
            color = rng.integers(0, 256, 3, dtype=np.uint8)
            ys = _bounce(int(rng.integers(0, 64)) + int(rng.integers(-3, 4)) * t, 64 - size)
            xs = _bounce(int(rng.integers(0, 64)) + int(rng.integers(-3, 4)) * t, 64 - size)
            for k in range(length):
                frames[k, ys[k]:ys[k] + size, xs[k]:xs[k] + size] = color
        reset = np.zeros(length, bool)
        reset[0] = True
        terminal = np.zeros(length, bool)
        terminal[-1] = True
        reward = np.where(rng.random(length) < 0.02, rng.choice([-1.0, 1.0], length), 0.0)
        repo.save_data(dict(image_t=frames.transpose(1, 2, 3, 0),
                            action=np.eye(action_dim)[rng.integers(0, action_dim, length)],
                            reward=reward, terminal=terminal, reset=reset), i, i)


# Phase 11's short run from episode files on disk, over the preset's learner
# keys: no prefill, 12 steps, 2 test and eval batches.
LEARNER_OVERRIDES = dict(
    n_env_steps=10**9, generator_prefill_steps=0, n_steps=12, log_interval=4, save_interval=6,
    # The loop stops at n_steps before its eval (as the JAX loop does), so an
    # eval_interval of 12 would never evaluate in a 12-step run.
    eval_interval=6, test_batches=2, eval_batches=2,
)


def check_prefetch(batches, device, n: int):
    """Copy ``n`` preprocessed batches through ``prefetch_iterator`` onto the
    card and hold each device tensor against its numpy source, with a long
    matmul queued on the consumer's stream before each check. -> (batches
    checked, the last batch on the card)."""
    from pydreamer_tpu_torch.data import prefetch_iterator
    sources = []

    def keep(batch):
        sources.append({k: v.copy() for k, v in batch.items()})
        return batch

    x = torch.randn(4096, 4096, device=device)
    checked = 0
    it = prefetch_iterator(batches, device, size=2, transform=keep)
    for i, got in zip(range(n), it):
        y = x @ x  # keeps the current stream busy while the copies land
        for k, v in sources[i].items():
            if not torch.equal(got[k], torch.from_numpy(v).to(device)):
                raise AssertionError(f"prefetched batch {i} key {k} differs from its numpy source")
        del y
        checked += 1
        last = got
    it.close()
    return checked, last


def rss_gb() -> float:
    """This process's resident set size now, from /proc/self/status."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) * 1024 / 1e9
    raise RuntimeError("no VmRSS in /proc/self/status")


class RssPeak:
    """Samples the process's resident set every 50 ms on a thread while the
    block runs; ``peak_gb`` is the largest sample."""

    def __enter__(self):
        import threading
        self.peak_gb, self._stop = rss_gb(), threading.Event()

        def sample():
            while not self._stop.wait(0.05):
                self.peak_gb = max(self.peak_gb, rss_gb())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak_gb = max(self.peak_gb, rss_gb())
        return False


def learner_phase(rs: RunState) -> None:
    """11. The learner loop on the flagship model. K1 at the eval protocol's
    shapes (``skinny`` M=10, ``wide`` M=480) against its plain version and
    timed as in 2. Then 8 train and 2 eval episode files of 1000 steps
    (generator format, compressible frames) written with the port's
    repository; the npz reader in use and one file's decode time; six
    prefetched batches held against their numpy sources on the card. Then
    ``trainer.run`` (``data_workers: 4``, 12 steps, step 1 a log step,
    checkpoints at 6 and 12, the eval protocol at 6), counts set to 0 just
    before and read just after: K1's launches by rows must match the train
    steps, the log step's rollout and the eval calls, none ``generic``;
    finite ``train/`` losses, ``test/`` and ``eval/`` rows with open-loop
    metrics, npz dumps, a checkpoint at 12. Then a resume to 18: the weights
    and optimizer state at its first step equal the checkpoint bit for bit,
    and it takes steps 13-18 (90 ``wide`` launches at M=1536). Reports the
    loop's ms/step (steps 9-12, from ``train/fps``) beside phase 4's bare
    step, ``timer_*``, peak host RSS and peak device memory."""
    import resource
    import shutil

    from pydreamer_tpu_torch import native
    from pydreamer_tpu_torch.data import (NpzEpisodeRepository, Preprocessor, SequentialDataset,
                                          make_repository)
    from pydreamer_tpu_torch.tracking import Run, load_checkpoint_file
    from pydreamer_tpu_torch.training import trainer

    conf, report, device = rs.conf, rs.report, rs.device
    T, B, H_imag = conf.batch_length, conf.batch_size, conf.imag_horizon
    In, H = conf.hidden_dim, conf.deter_dim
    TB = conf.test_batch_size
    out = report["learner"] = {}

    # K1 at the eval protocol's shapes: skinny at M=10 (posterior, open loop),
    # wide at M=T*10=480 (the dream of a test batch).
    for M, want in ((TB, "skinny"), (T * TB, "wide")):
        rs.k1_row(f"[11] K1 {want} M={M} H={H}", M, In, H, torch.bfloat16, want)

    # Episode files: 8 train and 2 eval files of 1000 steps, written by the
    # port's repository as the generators write them.
    episodes = OUT_DIR / "learner_episodes"
    shutil.rmtree(episodes, ignore_errors=True)
    t0 = time.perf_counter()
    write_episodes(NpzEpisodeRepository(episodes / "train"), 8, 1000, conf.action_dim, seed=11)
    write_episodes(NpzEpisodeRepository(episodes / "eval"), 2, 1000, conf.action_dim, seed=12)
    write_s = time.perf_counter() - t0
    files = sorted((episodes / "train").glob("*.npz"))
    t0 = time.perf_counter()
    reader = native.reader_name()  # builds the native reader in a fresh checkout
    reader_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoded = native.load_npz(files[0])
    decode_ms = (time.perf_counter() - t0) * 1e3
    mb = sum(f.stat().st_size for f in (episodes / "train").glob("*.npz")) / 1e6
    out.update(reader=reader, reader_build_s=reader_build_s, decode_ms=decode_ms, write_s=write_s,
               train_files_mb=mb, decoded_shapes={k: list(v.shape) for k, v in decoded.items()})
    print(f"[11] npz reader: {reader} (ready in {reader_build_s:.2f} s); one 1000-step file decoded "
          f"in {decode_ms:.2f} ms; 8 train files {mb:.2f} MB written in {write_s:.2f} s")

    lconf = conf.replace(offline_data_dir=str(episodes / "train"),
                         offline_eval_dir=str(episodes / "eval"), **LEARNER_OVERRIDES)
    # The prefetch's device copies against their numpy sources.
    batches = Preprocessor.from_conf(lconf)(iter(SequentialDataset(
        make_repository(str(episodes / "train")), T, B, reset_interval=200, seed=3)))
    out["prefetch_batches_equal"], obs = check_prefetch(batches, device, 6)
    print(f"[11] prefetch: {out['prefetch_batches_equal']} batches on the card equal their numpy sources")

    def bare_step_ms():
        """The bare TrainStep on a batch from these files: 2 warm-up and 5
        timed steps of a fresh flagship model (a turn beside the loop's)."""
        torch.manual_seed(0)
        model = Dreamer(conf, device=device)
        ts = TrainStep(model, conf, device=device)
        _, state, _ = timed_steps(ts, obs, model.init_state(B), 0, 2)
        ms, _, _ = timed_steps(ts, obs, state, 2, 5)
        del model, ts, state
        torch.cuda.empty_cache()
        return ms

    out["bare_step_ms_turns"] = [bare_step_ms()]
    run_dir = ROOT / "runs" / "chip_smoke_learner"
    shutil.rmtree(run_dir, ignore_errors=True)
    out["host_rss_before_gb"] = rss_gb()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.LAUNCHES.reset()
    t0 = time.perf_counter()
    with RssPeak() as rss:
        trainer.run(lconf, run_dir=str(run_dir), device=device)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    rows, sched = dict(k1.LAUNCHES.by_rows), dict(k1.LAUNCHES.by_schedule)
    n_steps = lconf.n_steps
    # 12 train steps (the first a log step: T-1 more skinny launches for the
    # dream rollout), the eval at step 6: the test protocol's closed loops at
    # B=10 (and an open loop where a batch continues its episodes), the eval
    # protocol's closed loop on batch 0 and open + closed loop on batch 1 at B=32.
    n_test = rows.get(TB, 0) // T
    n_eval, EB = 3, lconf.eval_batch_size
    want_rows = {}
    for M, n in ((B, n_steps * T + T - 1), (T * B, n_steps * H_imag), (TB, n_test * T),
                 (T * TB, n_test * H_imag), (EB, n_eval * T), (T * EB, n_eval * H_imag)):
        want_rows[M] = want_rows.get(M, 0) + n
    out.update(run_s=run_s, launches_by_rows=rows, launches_by_schedule=sched,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, peak_host_rss_gb=rss.peak_gb)
    print(f"[11] trainer.run: {n_steps} steps + eval in {run_s:.1f} s, K1 launches {rows} {sched}, "
          f"peak device memory {out['peak_mem_gb']:.2f} GB")
    if n_test not in (2, 3) or rows != want_rows or set(sched) != {"skinny", "wide"}:
        raise AssertionError(f"learner K1 launches {rows} {sched}, expected {want_rows} "
                             f"(test protocol calls {n_test}, none generic)")

    metrics = Run(run_dir).read_metrics()
    train = [m for m in metrics if "train/loss_model" in m]
    test = [m for m in metrics if "test/loss_model" in m]
    evals = [m for m in metrics if "eval/loss_model" in m]
    if [m["_step"] for m in train] != [8, 12] or not test or not evals:
        raise AssertionError(f"metrics rows: train {[m['_step'] for m in train]}, "
                             f"test {len(test)}, eval {len(evals)}")
    for m in train:
        for k in ("loss_model", "loss_actor", "loss_critic", "grad_norm"):
            if not math.isfinite(m.get(f"train/{k}", float("nan"))):
                raise AssertionError(f"train/{k} at step {m['_step']}: {m.get(f'train/{k}')}")
    if not any(k.endswith("_open") for k in test[0]) or not any(k.endswith("_open") for k in evals[0]):
        raise AssertionError(f"no open-loop metrics: {sorted(test[0])} {sorted(evals[0])}")
    for sub in ("d2_wm_closed", "d2_wm_dream"):
        if not list((run_dir / sub).glob("*.npz")):
            raise AssertionError(f"no npz dumps in {sub}/")
    ckpt_path = run_dir / "checkpoints" / "latest.ckpt"
    saved, saved_step = load_checkpoint_file(ckpt_path, "cpu")
    if saved_step != n_steps:
        raise AssertionError(f"checkpoint holds step {saved_step}, expected {n_steps}")
    steady = train[-1]  # steps 9-12: no checkpoint, eval or log step inside
    out.update(loop_ms_per_step=1e3 / steady["train/fps"],
               timers_ms={k[len("train/timer_"):]: v * 1e3 for k, v in steady.items()
                          if k.startswith("train/timer_")},
               losses={k: steady[f"train/{k}"] for k in ("loss_model", "loss_actor", "loss_critic")},
               test_open_keys=sorted(k for k in test[0] if k.endswith("_open")),
               checkpoint_mb=ckpt_path.stat().st_size / 1e6)

    # Resume to 18: the run must load step 12 with the saved weights and
    # optimizer state, bit for bit, and take steps 13-18.
    calls = []

    class FirstCallCheck(trainer.TrainStep):
        def __call__(self, obs, in_state, step, **kw):
            if not calls:
                for k, v in self.model.state_dict().items():
                    if not torch.equal(v.cpu(), saved["model"][k]):
                        raise AssertionError(f"resumed parameter {k} differs from the checkpoint")
                for i, s in self.optimizer.state_dict()["state"].items():
                    for name, v in s.items():
                        if not torch.equal(v.cpu(), saved["optimizer"]["state"][i][name]):
                            raise AssertionError(f"resumed optimizer state {i}/{name} differs")
            calls.append(step)
            return super().__call__(obs, in_state, step, **kw)

    plain_train_step, trainer.TrainStep = trainer.TrainStep, FirstCallCheck
    k1.LAUNCHES.reset()
    try:
        trainer.run(lconf.replace(n_steps=18), run_dir=str(run_dir), device=device)
    finally:
        trainer.TrainStep = plain_train_step
    rrows = dict(k1.LAUNCHES.by_rows)
    resumed = [m for m in Run(run_dir).read_metrics() if "train/loss_model" in m and m["_step"] > 12]
    out["bare_step_ms_turns"].append(bare_step_ms())
    out.update(resume_steps=calls, resume_launches_by_rows=rrows,
               resume_loop_ms_per_step=1e3 / resumed[0]["train/fps"] if resumed else None,
               script_peak_host_rss_gb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
               peak_mem_gb_both_runs=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[11] resume: steps {calls}, K1 launches {rrows}; parameters and optimizer state "
          f"right after the load equal the step-{saved_step} checkpoint bit for bit")
    if calls != list(range(13, 19)) or rrows.get(T * B) != 6 * H_imag or rrows.get(B) != 6 * T:
        raise AssertionError(f"resume took steps {calls} with K1 launches {rrows}, expected 13-18 "
                             f"and {6 * H_imag} wide at M={T * B}")
    print(f"[11] learner loop {out['loop_ms_per_step']:.2f} ms/step (steps 9-12, from train/fps; "
          f"resumed run {out['resume_loop_ms_per_step']:.2f} over 13-16, its start included) vs "
          f"bare TrainStep {report['step_ms']:.2f} ms/step (phase 4) and "
          f"{'/'.join(f'{v:.2f}' for v in out['bare_step_ms_turns'])} (before / after the loop); "
          "timers ms " + ", ".join(f"{k} {v:.2f}" for k, v in out["timers_ms"].items())
          + f"; host RSS {out['host_rss_before_gb']:.2f} GB before, peak {out['peak_host_rss_gb']:.2f} "
          f"GB in trainer.run; peak device memory {out['peak_mem_gb']:.2f} GB")
    shutil.copy(run_dir / "metrics.jsonl", OUT_DIR / "learner_metrics.jsonl")
    shutil.rmtree(run_dir)
    rs.credit("skinny", TB, H, rows[TB], n_test)
    rs.credit("wide", T * TB, H, rows[T * TB], n_test)


def policy_columns_ok(data) -> bool:
    """Within each episode of a generator file (episodes start at ``reset``),
    ``policy_value``/``policy_entropy`` are finite but on the last row and
    ``action_prob`` finite but on the first, as the JAX generator writes them."""
    starts = list(np.flatnonzero(data["reset"])) + [len(data["reset"])]
    if starts[0] != 0:
        return False
    for a, b in zip(starts[:-1], starts[1:]):
        for k in ("policy_value", "policy_entropy"):
            if not (np.isfinite(data[k][a:b - 1]).all() and np.isnan(data[k][b - 1])):
                return False
        if not (np.isnan(data["action_prob"][a]) and np.isfinite(data["action_prob"][a + 1:b]).all()):
            return False
    return True


GEN_KEYS = {"image_t", "action", "reward", "terminal", "reset", "policy_value", "policy_entropy",
            "action_prob"}

# The launcher run of phase 12c: the flagship learner (`defaults` + `atari`,
# with the K1 cell) fed by two CPU generators on the one image env that needs
# no SDK. 80 steps outlive two of the generators' 10 s checkpoint polls.
LAUNCH_STEPS = 80
LAUNCH_ARGS = ["--configs", "defaults", "atari", "--env_id", "Grid-8x64", "--action_dim", "4",
               "--env_time_limit", "50", "--gru_type", "gru_layernorm_dv2",
               "--generator_workers", "2", "--generator_prefill_steps", "2000",
               "--generator_log_every", "1", "--eval_interval", "0", "--save_interval", "4",
               "--log_interval", "10", "--n_steps", str(LAUNCH_STEPS)]
LAUNCH_TIMEOUT_S = 420


def session_processes(sid: int) -> list:
    """Pids of the live (not zombie) processes in session ``sid``, from /proc."""
    import os
    pids = []
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            stat = (d / "stat").read_text()
            state = stat[stat.rindex(")") + 2]
            if os.getsid(int(d.name)) == sid and state != "Z":
                pids.append(int(d.name))
        except (OSError, ValueError):
            continue  # the process ended while we looked
    return pids


def generator_phase(rs: RunState) -> None:
    """12. The actors at the flagship width (action_dim 4, ``Grid-8x64``, the
    one image env that needs no SDK). 12a: K1 ``skinny`` at M=1 and M=8
    (H=1024) against its plain version, timed as in 2. 12b: ``generator.main``
    on the card with the network policy from a checkpoint of a seeded model,
    at B=1 and B=8 (``envs_per_worker``): counts set to 0 just before and read
    just after each run, one ``skinny`` launch per acting call and none
    other; at least two episode files each, read back through the repository
    and ``SequentialDataset`` with the JAX generator's keys, shapes and policy
    columns; host microseconds per env step. 12c: ``python -m
    pydreamer_tpu_torch.launch --configs defaults atari`` (two CPU generators,
    the learner on the card, 80 steps) under ``timeout`` in a session of its
    own: exit 0, no process of that session left, episodes from both
    generators, each generator loading the learner's checkpoint, finite
    ``train/`` losses, a checkpoint at step 80, and the learner's own log line
    of K1 launches (48 ``skinny`` + 15 ``wide`` a step plus the log step's 47,
    none ``generic``); the loop's ms/step beside phase 11's and the CPU
    generators' ``agent/fps``."""
    import os
    import re
    import shutil

    from pydreamer_tpu_torch import generator
    from pydreamer_tpu_torch.data import SequentialDataset, make_repository
    from pydreamer_tpu_torch.tracking import Run, load_checkpoint_model, save_checkpoint_file

    conf, report, device = rs.conf, rs.report, rs.device
    In, H = conf.hidden_dim, conf.deter_dim
    out = report["generator"] = {}

    # 12a. K1 skinny at the acting shapes, M=1 (NetworkPolicy) and M=8
    # (VectorNetworkPolicy over 8 envs), at the flagship's H=1024.
    for M in (1, 8):
        rs.k1_row(f"[12] K1 skinny M={M} H={H}", M, In, H, torch.bfloat16, "skinny")

    # 12b. generator.main on the card with the network policy from a
    # checkpoint of a flagship model with 4 actions, at B=1 and B=8.
    gconf = conf.replace(action_dim=4)
    run_dir = ROOT / "runs" / "chip_smoke_generator"
    shutil.rmtree(run_dir, ignore_errors=True)
    torch.manual_seed(12)
    save_checkpoint_file(run_dir / "checkpoints" / "latest.ckpt",
                         {"model": Dreamer(gconf, device=device).state_dict()}, 0)
    torch.cuda.empty_cache()
    calls = {1: 0, 8: 0}

    class CountedPolicy(generator.NetworkPolicy):
        def __call__(self, obs):
            calls[1] += 1
            return super().__call__(obs)

    class CountedVectorPolicy(generator.VectorNetworkPolicy):
        def __call__(self, obs_list):
            calls[8] += 1
            return super().__call__(obs_list)

    plain_policies = generator.NetworkPolicy, generator.VectorNetworkPolicy
    generator.NetworkPolicy, generator.VectorNetworkPolicy = CountedPolicy, CountedVectorPolicy
    os.environ["PYDREAMER_RUN_DIR"] = str(run_dir)
    try:
        for B, num_steps in ((1, 250), (8, 400)):
            save_dir = run_dir / f"episodes_b{B}"
            torch.cuda.synchronize()
            k1.LAUNCHES.reset()
            t0 = time.perf_counter()
            generator.main(env_id="Grid-8x64", save_uri=str(save_dir), policy_main="network",
                           num_steps=num_steps, env_time_limit=50, steps_per_npz=100,
                           model_conf=gconf, envs_per_worker=B, log_every=1,
                           metrics_prefix=f"agent_b{B}", device=device)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            rows, sched = dict(k1.LAUNCHES.by_rows), dict(k1.LAUNCHES.by_schedule)
            files = sorted(make_repository(str(save_dir)).list_files(), key=lambda f: f.path)
            datas = [f.load_data() for f in files]
            fps = [m[f"agent_b{B}/fps"] for m in Run(run_dir).read_metrics()
                   if f"agent_b{B}/fps" in m]
            us_per_env_step = 1e6 / (B * float(np.median(fps[1:] or fps)))
            out[B] = dict(calls=calls[B], launches_by_rows=rows, launches_by_schedule=sched,
                          files=len(files), steps=sum(len(d["reset"]) for d in datas),
                          wall_s=wall_s, episodes_logged=len(fps), us_per_env_step=us_per_env_step)
            print(f"[12] generator B={B}: {calls[B]} acting calls, K1 launches {rows} {sched}, "
                  f"{len(files)} files of {out[B]['steps']} steps in {wall_s:.1f} s; "
                  f"{us_per_env_step:.1f} us per env step (acting + env, median of "
                  f"{len(fps)} episodes' agent fps)")
            if calls[B] == 0 or rows != {B: calls[B]} or sched != {"skinny": calls[B]}:
                raise AssertionError(f"generator B={B}: K1 launches {rows} {sched}, expected one "
                                     f"skinny [M={B}] per acting call ({calls[B]})")
            if len(files) < 2:
                raise AssertionError(f"generator B={B} wrote {len(files)} files, expected >= 2")
            data = {k: np.concatenate([d[k] for d in datas], -1 if k == "image_t" else 0)
                    for k in datas[0]}
            n = len(data["reset"])
            shapes = {k: v.shape for k, v in data.items()}
            if (set(data) != GEN_KEYS or shapes["image_t"] != (64, 64, 3, n)
                    or shapes["action"] != (n, 4) or data["image_t"].dtype != np.uint8
                    or any(shapes[k] != (n,) for k in GEN_KEYS - {"image_t", "action"})
                    or not policy_columns_ok(data)):
                raise AssertionError(f"generator B={B} files: {shapes}")
            batch = next(iter(SequentialDataset(make_repository(str(save_dir)), 16, 4, seed=0)))
            if batch["image"].shape != (16, 4, 64, 64, 3) or batch["policy_value"].shape != (16, 4):
                raise AssertionError(f"generator B={B}: dataset batch "
                                     f"{ {k: v.shape for k, v in batch.items()} }")
    finally:
        generator.NetworkPolicy, generator.VectorNetworkPolicy = plain_policies
        os.environ.pop("PYDREAMER_RUN_DIR", None)
    for B in (1, 8):
        rs.credit("skinny", B, H, calls[B], calls[B])
    shutil.rmtree(run_dir)
    torch.cuda.empty_cache()

    # 12c. The launcher: two CPU generators feed the flagship learner on the card.
    run_dir = ROOT / "runs" / "chip_smoke_launch"
    shutil.rmtree(run_dir, ignore_errors=True)
    env = {k: v for k, v in os.environ.items() if k != "PYDREAMER_RUN_DIR"}
    env["PYTHONPATH"] = str(ROOT)
    cmd = ["timeout", "-k", "10", str(LAUNCH_TIMEOUT_S), sys.executable, "-m",
           "pydreamer_tpu_torch.launch", *LAUNCH_ARGS, "--run_dir", str(run_dir)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, start_new_session=True, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    log, _ = proc.communicate()
    launch_s = time.perf_counter() - t0
    (OUT_DIR / "launch_log.txt").write_text(log)
    left = session_processes(proc.pid)
    for pid in left:
        os.kill(pid, 9)
    out["launch"] = dict(rc=proc.returncode, wall_s=launch_s, processes_left=left)
    print(f"[12] launcher: exit {proc.returncode} after {launch_s:.1f} s, "
          f"processes left {left} (log: chiprun_out/launch_log.txt)")
    if proc.returncode != 0 or left:
        raise AssertionError(f"launcher exit {proc.returncode}, processes left {left}:\n{log[-3000:]}")
    k1_line = re.search(r"Learner K1 launches: by schedule (\{.*?\}), by rows (\{.*?\})", log)
    loaded = {w: any(f"[GEN {w}]" in ln and "Generator loaded model checkpoint" in ln
                     for ln in log.splitlines()) for w in (0, 1)}
    checks = {"Done prefilling": "Done prefilling" in log,
              "Learner device: cuda": "Learner device: cuda" in log,
              "Learner finished; shutting down generators.":
                  "Learner finished; shutting down generators." in log,
              "each generator loaded the checkpoint": all(loaded.values()),
              "episodes in episodes/0 and episodes/1": all(
                  list((run_dir / "episodes" / str(w)).glob("*.npz")) for w in (0, 1)),
              "the learner's K1 launch line": k1_line is not None}
    if not all(checks.values()):
        raise AssertionError(f"launcher run: {checks}:\n{log[-3000:]}")
    sched = json.loads(k1_line.group(1))
    lrows = {int(k): v for k, v in json.loads(k1_line.group(2)).items()}
    T, B, H_imag = conf.batch_length, conf.batch_size, conf.imag_horizon
    n = LAUNCH_STEPS  # step 1 is the only log step (logbatch_interval 1000): T-1 more skinny
    want_sched = {"skinny": n * T + T - 1, "wide": n * H_imag}
    metrics = Run(run_dir).read_metrics()
    train = [m for m in metrics if "train/loss_model" in m]
    acting = [m for m in metrics if "agent/policy_value" in m]
    _, ckpt_step = load_checkpoint_model(run_dir / "checkpoints" / "latest.ckpt")
    out["launch"].update(
        launches_by_schedule=sched, launches_by_rows=lrows, checkpoint_step=ckpt_step,
        train_steps_logged=[m["_step"] for m in train],
        loop_ms_per_step=[1e3 / m["train/fps"] for m in train],
        timers_ms=[{k[len("train/timer_"):]: v * 1e3 for k, v in m.items()
                    if k.startswith("train/timer_")} for m in train],
        cpu_generator_fps=[m["agent/fps"] for m in acting],
        cpu_generator_episodes=len(acting),
        files={w: len(list((run_dir / "episodes" / str(w)).glob("*.npz"))) for w in (0, 1)})
    print(f"[12] launcher learner: K1 launches {sched} {lrows}; loop ms/step by window "
          f"{[round(x, 2) for x in out['launch']['loop_ms_per_step']]} (phase 11 from files: "
          f"{report['learner']['loop_ms_per_step']:.2f}); timer_step/data/other ms of the last "
          f"window {[round(train[-1].get(f'train/timer_{k}', float('nan')) * 1e3, 2) for k in ('step', 'data', 'other')]}; "
          f"CPU generators' agent fps (network policy) {[round(x, 1) for x in out['launch']['cpu_generator_fps']]}")
    if sched != want_sched or lrows != {B: want_sched["skinny"], T * B: want_sched["wide"]}:
        raise AssertionError(f"launcher learner K1 launches {sched} {lrows}, expected {want_sched}, "
                             "none generic")
    if ckpt_step != n or len(train) < 2:
        raise AssertionError(f"checkpoint at {ckpt_step}, train rows {[m['_step'] for m in train]}")
    for m in train:
        for k in ("loss_model", "loss_actor", "loss_critic"):
            if not math.isfinite(m.get(f"train/{k}", float("nan"))):
                raise AssertionError(f"launcher train/{k} at step {m['_step']}: {m.get(f'train/{k}')}")
    shutil.copy(run_dir / "metrics.jsonl", OUT_DIR / "launch_metrics.jsonl")
    shutil.rmtree(run_dir)


# Phase 13: the MiniWorld preset (config/defaults.yaml `defaults` + `miniworld`,
# goals_size as its note asks) with both probes, read by the port's parse_args.
MINIWORLD_ARGS = ["--configs", "defaults", "miniworld", "--goals_size", "4",
                  "--probe_model", "map+goals", "--gru_type", "gru_layernorm_dv2"]
BASELINES = ("vae", "gru_vae", "transformer_vae", "gru_probe")
PROBE_METRICS = ("loss_map", "acc_map", "acc_map_seen", "mse_goals", "grad_norm_probe")


def make_probe_obs(conf, gen, device):
    """A MiniWorld-shaped batch with the keys the Preprocessor makes for the
    probes (config/defaults.yaml:206-221) and ``action_next``; half the
    streams go on from the previous batch (no reset at t=0)."""
    obs = make_obs(conf, gen, device)
    T, B = obs["reward"].shape
    S, G = conf.map_size, conf.goals_size

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=device)

    obs["reset"][0, ::2] = False
    obs["action_next"] = torch.cat([obs["action"][1:], torch.zeros_like(obs["action"][:1])])
    obs.update(map=torch.randint(0, conf.map_channels, (T, B, S, S), generator=gen, device=device,
                                 dtype=torch.int32),
               map_coord=rand(T, B, 4) * 2 - 1,
               map_seen_mask=(rand(T, B, S, S) < 0.5).float(),
               goal_direction=torch.randn(T, B, 2, generator=gen, device=device),
               goals_direction=torch.randn(T, B, 2 * G, generator=gen, device=device),
               goals_visage=torch.randint(0, 1000, (T, B, G), generator=gen,
                                          device=device).float())
    return obs


def step_times(ts, obs, state, n: int, first_step: int = 1):
    """n TrainStep calls, each timed alone (host clock, synchronized), the
    TBTT state carried. -> (ms of each, state, last metrics)."""
    times = []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics, _, _ = ts(obs, state, first_step + i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, state, metrics


def finite_metrics(metrics, names, what):
    vals = {k: metrics[k].item() for k in names}
    if not all(math.isfinite(v) for v in vals.values()):
        raise AssertionError(f"{what}: metrics {vals}")
    return vals


def probe_phase(rs: RunState) -> None:
    """13. The probes and the baseline world models at the MiniWorld width
    (``--configs defaults miniworld --goals_size 4 --probe_model map+goals``
    through the port's ``parse_args``: deter 2048, 64x64x3 images with the
    reward planes, cnn_depth 32, a 9x9x14 map, 3 actions; T=48, B=32, bf16)
    on synthetic batches with the probes' targets. 13a: Dreamer with
    ``gru_layernorm_dv2``, three TrainStep calls, then a counted one (48
    ``skinny`` + 15 ``wide``, none ``generic``), an eval-style call with
    ``do_image_pred`` (48 + 15 more); a profiled step (busy time); finite
    probe metrics, the probe's weights moved, and the probe's loss alone
    gives the world model no gradient. 13b: ``vae``, ``gru_vae``,
    ``transformer_vae`` and ``gru_probe`` (under ``probe_gradients``), three
    TrainStep calls each with the TBTT state carried and a profiled fourth,
    finite losses and both gradient norms, no K1 launch, the median ms per
    step and the busy time; for the two GRU models a step from the carried
    state differs from one from zeros on the streams that go on, and only
    there. 13c: ``gru_vae`` at ``iwae_samples: 3`` for one step."""
    from pydreamer_tpu_torch.models.baselines import WorldModelProbe

    report, device = rs.report, rs.device
    config_dir = str(ROOT / "config")
    conf = parse_args(MINIWORLD_ARGS, config_dir=config_dir)
    T, B, H_imag, H = conf.batch_length, conf.batch_size, conf.imag_horizon, conf.deter_dim
    out = report["probes"] = {}
    obs = make_probe_obs(conf, rs.gen, device)

    # 13a. Dreamer with the map and goals probes, K1 in both loops.
    torch.manual_seed(13)
    model = Dreamer(conf, device=device)
    ts = TrainStep(model, conf, device=device)
    probe_before = [p.detach().clone() for p in model.probe.parameters()]
    torch.cuda.reset_peak_memory_stats()
    times, state, _ = step_times(ts, obs, model.init_state(B), 3)
    k1.LAUNCHES.reset()
    counted, state, metrics = step_times(ts, obs, state, 1, first_step=4)
    rows, sched = dict(k1.LAUNCHES.by_rows), dict(k1.LAUNCHES.by_schedule)
    state, prof, _ = profile_step(ts, obs, state, 5)
    check_profiled_k1(prof, T, H_imag, "[13a] profiled step")
    vals = finite_metrics(metrics, PROBE_METRICS + ("loss_model", "loss_probe", "grad_norm"),
                          "[13a] Dreamer map+goals")
    moved = sum(not torch.equal(p, q) for p, q in zip(model.probe.parameters(), probe_before))
    k1.LAUNCHES.reset()
    with torch.no_grad():
        _, _, emetrics, etensors, _ = model.training_step(
            obs, state, GeneratorNoise(device, seed=13), iwae_samples=1, do_image_pred=True)
    eval_sched = dict(k1.LAUNCHES.by_schedule)
    logprob = finite_metrics(emetrics, [k for k in emetrics if k.startswith("logprob_")],
                             "[13a] eval call")
    model.zero_grad(set_to_none=True)
    losses, *_ = model.training_step(obs, state, GeneratorNoise(device, seed=14))
    losses["loss_probe"].backward()
    leaked = [n for n, p in model.wm.named_parameters() if p.grad is not None and p.grad.any()]
    probe_grad = any(p.grad is not None and p.grad.any() for p in model.probe.parameters())
    out["dreamer"] = dict(ms=times + counted, launches_by_rows=rows, launches_by_schedule=sched,
                          profiled_wall_ms=prof["wall_ms"], device_busy_ms=prof["device_busy_ms"],
                          k1_ms=prof["k1_ms"], metrics=vals, probe_tensors_moved=moved, eval_launches=eval_sched,
                          eval_logprob=logprob, wm_params_with_probe_grad=leaked,
                          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[13a] Dreamer map+goals: ms per step {[round(t, 2) for t in times + counted]}, "
          f"counted step K1 launches {rows} {sched}, eval call {eval_sched}; profiled step: "
          f"wall {prof['wall_ms']:.2f} ms, device busy {prof['device_busy_ms']:.2f} ms, K1 "
          f"{prof['k1_ms']:.3f} ms; "
          + ", ".join(f"{k} {v:.5g}" for k, v in vals.items())
          + f"; {moved}/{len(probe_before)} probe tensors moved; wm tensors with a gradient "
          f"from loss_probe alone: {leaked}; peak mem {out['dreamer']['peak_mem_gb']:.2f} GB")
    want = {"skinny": T, "wide": H_imag}
    if sched != want or rows != {B: T, T * B: H_imag} or eval_sched != want:
        raise AssertionError(f"[13a] K1 launches {rows} {sched} / eval {eval_sched}, expected "
                             f"{T} skinny [M={B}] + {H_imag} wide [M={T * B}], none generic")
    if moved != len(probe_before) or leaked or not probe_grad:
        raise AssertionError(f"[13a] probe tensors moved {moved}/{len(probe_before)}, wm "
                             f"gradients from loss_probe {leaked}, probe gradient {probe_grad}")
    for k in ("map_rec", "goals_direction_pred", "image_pred"):
        if k not in etensors or not torch.isfinite(etensors[k]).all():
            raise AssertionError(f"[13a] eval call tensor {k}: {sorted(etensors)}")
    del model, ts, state, losses
    torch.cuda.empty_cache()
    for kind, M in (("skinny", B), ("wide", T * B)):
        rs.credit(kind, M, H, sched[kind] + eval_sched[kind], 2)  # a step and an eval call

    # 13b. The four baselines: no K1, the TBTT state carried.
    for name in BASELINES:
        extra = ["--probe_gradients", "True"] if name == "gru_probe" else []
        bconf = parse_args(MINIWORLD_ARGS + ["--model", name] + extra, config_dir=config_dir)
        torch.manual_seed(13)
        bmodel = WorldModelProbe(bconf, device=device)
        bts = TrainStep(bmodel, bconf, device=device)
        torch.cuda.reset_peak_memory_stats()
        k1.LAUNCHES.reset()
        state0 = bmodel.init_state(B)
        times, state, metrics = step_times(bts, obs, state0, 3)
        n_k1 = k1.LAUNCHES.count
        state, prof, _ = profile_step(bts, obs, state, 4)
        vals = finite_metrics(metrics, ("loss_model", "loss_probe", "grad_norm", "grad_norm_probe")
                              + PROBE_METRICS[:4], f"[13b] {name}")
        res = out[name] = dict(ms=times, median_ms=sorted(times)[1], k1_launches=n_k1,
                               profiled_wall_ms=prof["wall_ms"],
                               device_busy_ms=prof["device_busy_ms"], metrics=vals,
                               state_shape=list(state.shape), params=sum(
                                   p.numel() for p in bmodel.parameters()),
                               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        if name in ("gru_vae", "gru_probe"):
            # A step from the carried state against one from zeros, same noise.
            with torch.no_grad():
                _, s_carry, *_ = bmodel.training_step(obs, state, GeneratorNoise(device, seed=15))
                _, s_zero, *_ = bmodel.training_step(obs, torch.zeros_like(state),
                                                     GeneratorNoise(device, seed=15))
            goes_on = ~obs["reset"][0]
            res["carry_diff"] = (s_carry[goes_on] - s_zero[goes_on]).abs().max().item()
            res["reset_diff"] = (s_carry[~goes_on] - s_zero[~goes_on]).abs().max().item()
            if (tuple(state.shape) != (B, H) or not torch.isfinite(state).all()
                    or not res["carry_diff"] > 0 or res["reset_diff"] > 1e-5):
                raise AssertionError(f"[13b] {name} TBTT state {tuple(state.shape)}: carried vs "
                                     f"zeros differ by {res['carry_diff']} where streams go on, "
                                     f"{res['reset_diff']} where they reset")
        print(f"[13b] {name}: median {res['median_ms']:.2f} ms/step of {[round(t, 2) for t in times]}"
              f" (MiniWorld width, T={T}, B={B}, {bconf.precision}), profiled step: wall "
              f"{prof['wall_ms']:.2f} ms, device busy {prof['device_busy_ms']:.2f} ms; K1 "
              f"launches {n_k1 + sum(prof['launched'].values())}, "
              + ", ".join(f"{k} {v:.5g}" for k, v in vals.items())
              + (f", state carried (diff {res['carry_diff']:.3g} vs 0 on reset streams "
                 f"{res['reset_diff']:.3g})" if "carry_diff" in res else "")
              + f", peak mem {res['peak_mem_gb']:.2f} GB")
        if n_k1 or prof["launched"]:
            raise AssertionError(f"[13b] {name} launched K1 {n_k1} times, {prof['launched']} "
                                 "in its profiled step")
        del bmodel, bts, state
        torch.cuda.empty_cache()

    # 13c. gru_vae with 3 IWAE samples: each stream's samples side by side.
    iconf = parse_args(MINIWORLD_ARGS + ["--model", "gru_vae", "--iwae_samples", "3"],
                       config_dir=config_dir)
    imodel = WorldModelProbe(iconf, device=device)
    times, state, metrics = step_times(TrainStep(imodel, iconf, device=device), obs,
                                       imodel.init_state(3 * B), 1)
    vals = finite_metrics(metrics, ("loss_model", "loss_dyn", "loss_probe", "grad_norm"),
                          "[13c] gru_vae I=3")
    out["gru_vae_iwae3"] = dict(ms=times, metrics=vals, state_shape=list(state.shape))
    print(f"[13c] gru_vae iwae_samples 3: {times[0]:.2f} ms, state {tuple(state.shape)}, "
          + ", ".join(f"{k} {v:.5g}" for k, v in vals.items()))
    if tuple(state.shape) != (3 * B, H):
        raise AssertionError(f"[13c] state {tuple(state.shape)}, expected {(3 * B, H)}")
    del imodel, state
    torch.cuda.empty_cache()
    (OUT_DIR / "probe_phase.json").write_text(json.dumps(out, indent=1))


# Phase 14: the learner on a mesh of ranks. 14a runs the production backend
# (cpu:gloo,cuda:nccl) at world size 1; 14b and 14c put two ranks on the one
# card over gloo (NCCL refuses two ranks on one device), which takes device
# tensors.
MESH_STEPS = 3
AB_STEPS = 5          # steps a window of the float32 step's A/B in turns (14b)
MESH_RTOL = 2e-2      # bf16: one rounding can flip an argmax sample (ROADMAP.md §2 item 11)
MESH_RTOL_F32 = 1e-4  # float32, TF32 off: sums in another order only
WM_METRICS = ("loss_model", "loss_image", "loss_reward", "loss_terminal", "loss_kl", "grad_norm")
# Step 1 starts from the same weights. After it, in bf16, the ranks' weights
# differ from the single process's by the order of the gradient sums, and
# bf16 roundings and argmax samples in the next forward amplify that (2e-3 to
# 4e-2 in the reward head, the KL and grad_norm by step 3 on the H100): from
# step 2 only the world model's totals are held to MESH_RTOL in bf16, the
# rest reported. The float32 steps hold every world-model metric at every
# step to MESH_RTOL_F32.
WM_TOTALS = ("loss_model", "loss_image")
RANK_TIMEOUT_S = 420
TP_MIN_SIZE = 1024    # 14c: the GRU gate kernels (3H = 3072) and each Dense with out >= 1024


def mesh_rank(rank: int, store: str, mode: str, out_path: str, device: str = "cuda:0") -> None:
    """One of two ranks on ``device`` (the one card), meeting through the new
    file ``store``: 3 flagship steps on its rows of one global batch
    (``mode`` "dp": data 2; "tp": model 2, ``TP_MIN_SIZE``), then for "dp" 3
    float32 steps; K1's launches by rows each step, the rank's parameter and
    AdamW bytes. Writes its report to ``out_path``."""
    import torch.distributed as dist

    from pydreamer_tpu_torch.parallel import DistributedContext, batch_sharding
    from pydreamer_tpu_torch.parallel.multihost import COLLECTIVE_TIMEOUT

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=2,
                            rank=rank, timeout=COLLECTIVE_TIMEOUT)
    mesh = dict(mesh_data=2, mesh_model=1) if mode == "dp" else dict(mesh_data=1, mesh_model=2,
                                                                      tp_min_size=TP_MIN_SIZE)
    out = {"rank": rank, "steps": []}

    def run(conf, n):
        ctx = DistributedContext(conf, device)
        torch.manual_seed(0)
        model = Dreamer(conf, device=device)
        whole = sum(p.numel() * p.element_size() for p in model.parameters())
        whole_trainable = sum(p.numel() * p.element_size() for p in model.parameters()
                              if p.requires_grad)
        ts = TrainStep(model, conf, device=device, ctx=ctx)
        sharded = sorted(n_ for n_, s in ctx.shardings.items() if s.axis == "model")
        gen = torch.Generator(device=device).manual_seed(14)
        obs = {k: batch_sharding(ctx.mesh).local(ctx.mesh, v).contiguous()
               for k, v in make_obs(conf, gen, device).items()}
        state = model.init_state(obs["action"].shape[1])
        steps = []
        for step in range(1, n + 1):
            k1.LAUNCHES.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics, _, _ = ts(obs, state, step)
            torch.cuda.synchronize()
            steps.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                              metrics={k: v.item() for k, v in metrics.items()},
                              by_rows=dict(k1.LAUNCHES.by_rows),
                              by_schedule=dict(k1.LAUNCHES.by_schedule)))
        moments = sum(v.numel() * v.element_size() for s in ts.optimizer.state.values()
                      for k, v in s.items() if k in ("exp_avg", "exp_avg_sq"))
        info = dict(steps=steps, sharded=sharded, whole_param_bytes=whole,
                    whole_trainable_bytes=whole_trainable,
                    param_bytes=sum(p.numel() * p.element_size() for p in model.parameters()),
                    sharded_whole_bytes={n_: p.numel() * ctx.mesh.n_model * p.element_size()
                                         for n_, p in model.named_parameters() if n_ in sharded},
                    trainable_sharded=[n_ for n_, p in model.named_parameters()
                                       if n_ in sharded and p.requires_grad],
                    adam_bytes=moments, state_rows=int(state[0].shape[0]),
                    state_finite=bool(torch.isfinite(state[0]).all()))
        del model, ts
        torch.cuda.empty_cache()
        return info

    out["bf16"] = run(Conf(dict(flagship_conf(), **mesh)), MESH_STEPS)
    if mode == "dp":
        out["f32"] = run(Conf(dict(flagship_conf(), precision="float32", **mesh)), MESH_STEPS)
    dist.destroy_process_group()
    Path(out_path).write_text(json.dumps(out))


def spawn_mesh(mode: str, device: str = "cuda:0") -> list:
    """Two ``mesh_rank`` processes to their end; either failing or outliving
    ``RANK_TIMEOUT_S`` fails the phase. -> their reports."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    store = OUT_DIR / f"phase14_{mode}_store"  # the ranks' rendezvous: no port to be taken first
    paths = [OUT_DIR / f"phase14_{mode}_rank{r}.json" for r in range(2)]
    for p in (store, *paths):
        p.unlink(missing_ok=True)
    procs = [ctx.Process(target=mesh_rank, args=(r, str(store), mode, str(paths[r]), device))
             for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.time() + RANK_TIMEOUT_S
    try:
        for p in procs:
            p.join(timeout=max(deadline - time.time(), 1))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        store.unlink(missing_ok=True)
    codes = [p.exitcode for p in procs]
    if alive or codes != [0, 0]:
        raise AssertionError(f"[14] {mode} ranks: exit codes {codes}, "
                             f"{len(alive)} killed at the {RANK_TIMEOUT_S} s limit")
    reports = [json.loads(p.read_text()) for p in paths]
    for r in reports:  # JSON keys are strings; the launch counts key by rows
        for part in ("bf16", "f32"):
            for step in r.get(part, {}).get("steps", []):
                step["by_rows"] = {int(k): v for k, v in step["by_rows"].items()}
    return reports


def single_steps(conf, n: int, device):
    """The reference: one process, the whole batch, the same seeds; K1's
    launches counted each step."""
    torch.manual_seed(0)
    model = Dreamer(conf, device=device)
    ts = TrainStep(model, conf, device=device)
    gen = torch.Generator(device=device).manual_seed(14)
    obs = make_obs(conf, gen, device)
    state = model.init_state(conf.batch_size)
    steps = []
    for step in range(1, n + 1):
        k1.LAUNCHES.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics, _, _ = ts(obs, state, step)
        torch.cuda.synchronize()
        steps.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                          metrics={k: v.item() for k, v in metrics.items()},
                          by_rows=dict(k1.LAUNCHES.by_rows),
                          by_schedule=dict(k1.LAUNCHES.by_schedule)))
    del model, ts
    torch.cuda.empty_cache()
    return steps


def f32_step_ab(conf, device, n: int) -> dict:
    """The float32 flagship step as the port runs it (K1 on ``skinny_f32`` /
    ``wide_f32``) against the same step with K1's launches put on the first
    f32 design (the FFMA schedule ``f32``), in turns (ffma, 3xtf32, 3xtf32,
    ffma), ``n`` steps a window after 2 warm-up steps. -> ms per step by
    variant and each window's launches by schedule."""
    from pydreamer_tpu_torch.training.train_step import CudaGraphs, StepGraphs
    plan = k1.plan

    def ffma_plan(M, In, H, *dtypes):
        return k1.Plan("f32", workspace=M * 3 * H)

    torch.manual_seed(0)
    model = Dreamer(conf, device=device)
    ts = TrainStep(model, conf, device=device)
    gen = torch.Generator(device=device).manual_seed(14)
    obs = make_obs(conf, gen, device)
    state, step = model.init_state(conf.batch_size), 0
    out = {"ffma": [], "3xtf32": [], "launches": []}
    # A replay runs the schedules its capture planned: each variant replays
    # its own capture, warmed and captured before its first window.
    graphs = {variant: StepGraphs(CudaGraphs(device)) for variant in ("ffma", "3xtf32")}
    try:
        for variant in ("ffma", "3xtf32", "3xtf32", "ffma"):
            k1.plan = ffma_plan if variant == "ffma" else plan
            ts.graphs = graphs[variant]
            if not ts.graphs.captured:
                _, state, _ = timed_steps(ts, obs, state, step, 2)
                step += 2
            k1.LAUNCHES.reset()
            ms, state, _ = timed_steps(ts, obs, state, step, n)
            step += n
            out[variant].append(ms)
            out["launches"].append((variant, dict(k1.LAUNCHES.by_schedule)))
    finally:
        k1.plan = plan
    del model, ts
    torch.cuda.empty_cache()
    return out


def compare_steps(got, want, rtol: float, what: str, later=WM_TOTALS) -> list:
    """The relative difference of every metric of every step from the
    reference, printed; then each world-model metric of step 1 (the same
    weights) and ``later`` of every later step held within ``rtol``. -> the
    differences by step."""
    rels = [{k: abs(g["metrics"][k] - v) / max(abs(v), 1e-6) for k, v in w["metrics"].items()}
            for g, w in zip(got, want)]
    print(f"{what}: rel diff from one process by step "
          + "; ".join(", ".join(f"{k} {r[k]:.2e}" for k in WM_METRICS) for r in rels))
    for i, r in enumerate(rels):
        for k in WM_METRICS if i == 0 else later:
            if not r[k] <= rtol:
                raise AssertionError(f"{what} step {i + 1} {k}: {got[i]['metrics'][k]} vs one "
                                     f"process {want[i]['metrics'][k]} (rel {r[k]:.3g} > {rtol})")
    return rels


def mesh_phase(rs: RunState) -> None:
    """14. The learner on a mesh of ranks (``parallel/``). 14a: ``trainer.run``
    on the flagship model from phase 11's files (``data_workers: 1``, 8 steps,
    step 1 a log step, a checkpoint at 8) at world size 1 under the
    production backend ``cpu:gloo,cuda:nccl``, then the same 8 steps with no
    group: the ``train/`` losses and the final weights agree (cuDNN held
    deterministic; bit for bit is reported, within 1e-4 relative / 1e-3
    absolute is required), K1's launches by rows match the steps. 14b: K1
    ``skinny`` at M=16 and ``wide`` at M=768 (the data ranks' shapes) against
    its plain version, timed as in 2; then two ranks on the one card over gloo
    (NCCL refuses two ranks on one device), ``mesh_data: 2``, each stepping on
    B=16 of one B=32 batch from the same weights with its rows of the global
    noise: 3 bf16 steps against one process at B=32 (step 1, from the same
    weights: every world-model loss and ``grad_norm`` within 2e-2 relative;
    steps 2-3: ``loss_model`` and ``loss_image`` within 2e-2, the rest
    reported, see ``WM_TOTALS``), 3 float32 steps (TF32 off) with every
    world-model metric within 1e-4 at every step, and per rank per step 48
    ``skinny`` [M=16] and 15 ``wide`` [M=768] launches in bf16, 48
    ``skinny_f32`` [M=16] and 15 ``wide_f32`` [M=768] in float32, none
    ``generic`` or ``f32``. The float32 reference (one process, B=32) takes 48
    ``skinny_f32`` + 15 ``wide_f32`` a step; its step is then timed in turns
    against the same step with K1 put on the FFMA schedule ``f32``
    (``f32_step_ab``). K1 ``skinny_f32`` / ``wide_f32`` at M=16 / M=768 are
    held and timed beside the bf16 rows. 14c: ``mesh_model: 2``,
    ``tp_min_size: 1024`` on two ranks: the sharded parameters listed, each
    rank's parameter and AdamW bytes smaller by half of the sharded bytes, 3
    steps against one process as in 14b, K1 at M=32 / M=1536 on the gathered
    gate kernels. The ranks' ms per step are printed beside phase 4's: two
    ranks share one card and one host, so they are no multi-GPU number. Every
    group meets through a new file (torch's ``file://`` rendezvous), never a
    port chosen in advance."""
    import os
    import shutil

    import torch.distributed as dist

    from pydreamer_tpu_torch.parallel.multihost import INIT_FILE_ENV
    from pydreamer_tpu_torch.tracking import Run, load_checkpoint_file
    from pydreamer_tpu_torch.training import trainer

    conf, report, device = rs.conf, rs.report, rs.device
    T, B, H_imag = conf.batch_length, conf.batch_size, conf.imag_horizon
    In, H = conf.hidden_dim, conf.deter_dim
    out = report["mesh"] = {}

    # 14a. trainer.run at world size 1 under the production backend, then the
    # same 8 steps with no group. cuDNN is held deterministic for both runs.
    episodes = OUT_DIR / "learner_episodes"
    aconf = conf.replace(offline_data_dir=str(episodes / "train"),
                         offline_eval_dir=str(episodes / "eval"),
                         **dict(LEARNER_OVERRIDES, data_workers=1, n_steps=8, save_interval=8,
                                eval_interval=0, log_interval=4))
    runs = ROOT / "runs"
    cudnn_flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    store = OUT_DIR / "phase14a_store"
    store.unlink(missing_ok=True)
    env = {INIT_FILE_ENV: str(store), "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
           "LOCAL_WORLD_SIZE": "1"}
    results = {}
    try:
        for tag in ("group", "plain"):
            run_dir = runs / f"chip_smoke_mesh_{tag}"
            shutil.rmtree(run_dir, ignore_errors=True)
            if tag == "group":
                os.environ.update(env)
            k1.LAUNCHES.reset()
            t0 = time.perf_counter()
            try:
                trainer.run(aconf, run_dir=str(run_dir), device="cuda")
                backend = str(dist.get_backend()) if dist.is_initialized() else None
            finally:
                if dist.is_initialized():
                    dist.destroy_process_group()
                for k in env:
                    os.environ.pop(k, None)
            rows = [m for m in Run(run_dir).read_metrics() if "train/loss_model" in m]
            saved, step = load_checkpoint_file(run_dir / "checkpoints" / "latest.ckpt", "cpu")
            results[tag] = dict(s=time.perf_counter() - t0, backend=backend, rows=rows, step=step,
                                model=saved["model"], by_rows=dict(k1.LAUNCHES.by_rows),
                                dumps=len(list((run_dir / "d2_wm_closed").glob("*.npz"))))
            shutil.rmtree(run_dir)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn_flags
        store.unlink(missing_ok=True)
    g, p = results["group"], results["plain"]
    want_rows = {B: 8 * T + T - 1, T * B: 8 * H_imag}  # step 1 logs: T-1 more skinny
    losses = {k: (g["rows"][-1][k], p["rows"][-1][k]) for k in g["rows"][-1]
              if k.startswith("train/loss_")}
    loss_rel = max(abs(a - b) / max(abs(b), 1e-6) for a, b in losses.values())
    weight_diff = max((g["model"][k].float() - v.float()).abs().max().item()
                      for k, v in p["model"].items())
    out["14a"] = dict(backend=g["backend"], seconds=[g["s"], p["s"]], losses=losses,
                      loss_max_rel=loss_rel, weight_max_abs_diff=weight_diff,
                      bitwise=loss_rel == 0.0 and weight_diff == 0.0,
                      launches_by_rows=[g["by_rows"], p["by_rows"]], dumps=g["dumps"])
    print(f"[14a] trainer.run under {g['backend']} at world size 1 ({g['s']:.1f} s) vs no group "
          f"({p['s']:.1f} s): train losses max rel diff {loss_rel:.3g}, weights max abs diff "
          f"{weight_diff:.3g} ({'bit for bit' if out['14a']['bitwise'] else 'not bitwise'}); "
          f"K1 launches {g['by_rows']} / {p['by_rows']}")
    if g["backend"] is None or "nccl" not in g["backend"] or g["step"] != 8 or p["step"] != 8:
        raise AssertionError(f"[14a] backend {g['backend']}, checkpoints at {g['step']}/{p['step']}")
    if g["by_rows"] != want_rows or p["by_rows"] != want_rows or g["dumps"] != 1:
        raise AssertionError(f"[14a] K1 launches {g['by_rows']} / {p['by_rows']}, expected "
                             f"{want_rows}; d2_wm_closed dumps {g['dumps']}")
    if not (loss_rel <= MESH_RTOL_F32 and weight_diff <= 1e-3):
        raise AssertionError(f"[14a] the group's run left the plain one: losses {losses}, "
                             f"weights max abs diff {weight_diff}")

    # The reference for 14b and 14c: one process, B=32, the same seeds.
    ref = single_steps(conf, MESH_STEPS, device)
    conf32 = conf.replace(precision="float32")
    ref32 = single_steps(conf32, MESH_STEPS, device)
    want_f32 = ({B: T, T * B: H_imag}, {"skinny_f32": T, "wide_f32": H_imag})
    for i, s in enumerate(ref32):
        if (s["by_rows"], s["by_schedule"]) != want_f32:
            raise AssertionError(f"[14b] one process, float32 step {i + 1}: K1 launches "
                                 f"{s['by_rows']} {s['by_schedule']}, expected {want_f32}")
    ab = f32_step_ab(conf32, device, AB_STEPS)
    n_ab = len(ab["3xtf32"]) * AB_STEPS
    for variant, sched in ab["launches"]:
        want = ({"f32": AB_STEPS * (T + H_imag)} if variant == "ffma"
                else {"skinny_f32": AB_STEPS * T, "wide_f32": AB_STEPS * H_imag})
        if sched != want:
            raise AssertionError(f"[14b] float32 step ({variant}): K1 launches {sched}, "
                                 f"expected {want}")
    print(f"[14b] one process, float32 flagship step: single_f32_ms "
          f"{[round(s['ms'], 2) for s in ref32]} (steps 1-3); in turns "
          f"after 2 warm-up steps, {AB_STEPS} steps a window: K1 on skinny_f32 / wide_f32 "
          f"{[round(x, 2) for x in ab['3xtf32']]} ms/step, on the FFMA schedule f32 "
          f"{[round(x, 2) for x in ab['ffma']]}")
    rs.credit("skinny_f32", B, H, MESH_STEPS * T + n_ab * T, MESH_STEPS + n_ab)
    rs.credit("wide_f32", T * B, H, MESH_STEPS * H_imag + n_ab * H_imag, MESH_STEPS + n_ab)

    # 14b. Data parallel: two ranks, B=16 each.
    for M, want, dtype in ((B // 2, "skinny", torch.bfloat16), (T * B // 2, "wide", torch.bfloat16),
                           (B // 2, "skinny_f32", torch.float32),
                           (T * B // 2, "wide_f32", torch.float32)):
        rs.k1_row(f"[14b] K1 {want} M={M} H={H}", M, In, H, dtype, want)
    dp = spawn_mesh("dp", str(device))
    worst = [compare_steps(r["bf16"]["steps"], ref, MESH_RTOL, f"[14b] rank {r['rank']}")
             for r in dp]
    worst32 = [compare_steps(r["f32"]["steps"], ref32, MESH_RTOL_F32,
                             f"[14b] float32 rank {r['rank']}", later=WM_METRICS) for r in dp]
    want_dp = ({B // 2: T, T * B // 2: H_imag}, {"skinny": T, "wide": H_imag})
    want_dp32 = ({B // 2: T, T * B // 2: H_imag}, {"skinny_f32": T, "wide_f32": H_imag})
    for r in dp:
        for part, want in (("bf16", want_dp), ("f32", want_dp32)):
            for s in r[part]["steps"]:
                if (s["by_rows"], s["by_schedule"]) != want:
                    raise AssertionError(f"[14b] rank {r['rank']} {part} K1 launches "
                                         f"{s['by_rows']} {s['by_schedule']}, expected {want}")
        if r["bf16"]["state_rows"] != B // 2 or not r["bf16"]["state_finite"]:
            raise AssertionError(f"[14b] rank {r['rank']} out_state rows {r['bf16']['state_rows']}")
    out["14b"] = dict(ms_per_step=[[s["ms"] for s in r["bf16"]["steps"]] for r in dp],
                      f32_ms=[[s["ms"] for s in r["f32"]["steps"]] for r in dp],
                      single_ms=[s["ms"] for s in ref], single_f32_ms=[s["ms"] for s in ref32],
                      f32_step_ab=ab,
                      rel_diff=worst, rel_diff_f32=worst32,
                      launches=[[s["by_rows"] for s in r["bf16"]["steps"]] for r in dp])
    print(f"[14b] data parallel, 2 ranks on one card: ms/step {out['14b']['ms_per_step']} "
          f"(one process {[round(s['ms'], 2) for s in ref]}; phase 4 {report['step_ms']:.2f}); "
          f"world-model metrics within {MESH_RTOL} (bf16) and {MESH_RTOL_F32} (f32) of one "
          f"process, step 1 max rel {max(w[0][k] for w in worst for k in WM_METRICS):.3g} / "
          f"{max(w[0][k] for w in worst32 for k in WM_METRICS):.3g}; K1 per rank per step "
          f"{dp[0]['bf16']['steps'][0]['by_rows']}")
    for part, sched, M in (("bf16", "skinny", B // 2), ("bf16", "wide", T * B // 2),
                           ("f32", "skinny_f32", B // 2), ("f32", "wide_f32", T * B // 2)):
        rs.credit(sched, M, H, sum(s["by_schedule"][sched] for r in dp for s in r[part]["steps"]),
                  2 * MESH_STEPS)  # rank-steps

    # 14c. Tensor parallel: two ranks, the wide kernels split.
    tp = spawn_mesh("tp", str(device))
    worst_tp = [compare_steps(r["bf16"]["steps"], ref, MESH_RTOL, f"[14c] rank {r['rank']}")
                for r in tp]
    want_tp = ({B: T, T * B: H_imag}, {"skinny": T, "wide": H_imag})
    for r in tp:
        b = r["bf16"]
        shard_bytes = sum(b["sharded_whole_bytes"].values())
        shard_trainable = sum(v for k, v in b["sharded_whole_bytes"].items()
                              if k in b["trainable_sharded"])
        if b["param_bytes"] != b["whole_param_bytes"] - shard_bytes // 2:
            raise AssertionError(f"[14c] rank {r['rank']}: {b['param_bytes']} parameter bytes, "
                                 f"expected {b['whole_param_bytes']} - {shard_bytes} / 2")
        if b["adam_bytes"] != 2 * (b["whole_trainable_bytes"] - shard_trainable // 2):
            raise AssertionError(f"[14c] rank {r['rank']}: AdamW {b['adam_bytes']} bytes, "
                                 f"expected 2 x ({b['whole_trainable_bytes']} - "
                                 f"{shard_trainable} / 2)")
        for s in b["steps"]:
            if (s["by_rows"], s["by_schedule"]) != want_tp:
                raise AssertionError(f"[14c] rank {r['rank']} K1 launches {s['by_rows']} "
                                     f"{s['by_schedule']}, expected {want_tp}")
    t0 = tp[0]["bf16"]
    if not any(n.endswith("weight_ih") for n in t0["sharded"]):
        raise AssertionError(f"[14c] the GRU gate kernels are not sharded: {t0['sharded']}")
    out["14c"] = dict(sharded=t0["sharded"], sharded_whole_bytes=t0["sharded_whole_bytes"],
                      whole_param_bytes=t0["whole_param_bytes"], param_bytes=t0["param_bytes"],
                      adam_bytes=[r["bf16"]["adam_bytes"] for r in tp],
                      ms_per_step=[[s["ms"] for s in r["bf16"]["steps"]] for r in tp],
                      rel_diff=worst_tp, launches=[[s["by_rows"] for s in r["bf16"]["steps"]]
                                                  for r in tp])
    print(f"[14c] tensor parallel, 2 ranks on one card: sharded {len(t0['sharded'])} parameters "
          f"{t0['sharded']}; per-rank parameter bytes {t0['param_bytes']} of "
          f"{t0['whole_param_bytes']} (half of {sum(t0['sharded_whole_bytes'].values())} sharded "
          f"bytes saved), AdamW {out['14c']['adam_bytes']}; ms/step {out['14c']['ms_per_step']} "
          f"(phase 4 {report['step_ms']:.2f}); world-model metrics step 1 max rel "
          f"{max(w[0][k] for w in worst_tp for k in WM_METRICS):.3g}; K1 per rank per step "
          f"{t0['steps'][0]['by_rows']}")
    for sched, M in (("skinny", B), ("wide", T * B)):
        rs.credit(sched, M, H, sum(s["by_schedule"][sched] for r in tp for s in r["bf16"]["steps"]),
                  2 * MESH_STEPS)


# Phase 15: learning on the card. The canaries of tests/test_learning.py
# (pydreamer_tpu_torch/scripts/canaries.py) under gru_layernorm_dv2, each held
# to the JAX test's own gate; then a live run of the launcher at the
# `gridworld` preset's width, and the run tools on its directory.
EP_LEN = 8  # the bandit's episode length: its optimal return


def bandit_gate(r) -> bool:
    """test_return_improves_on_bandit: not vacuous, near optimal, a large gain."""
    return (r["before"] < 0.75 * EP_LEN and r["after"] > 0.75 * EP_LEN
            and r["after"] > r["before"] + 0.25 * EP_LEN)


def pixel_until(early: float, late: float) -> bool:
    """test_policy_return_improves_on_gridworld_pixels: the rolling gate."""
    return late > early + 0.08 and late > 0.05


GATES = {
    "bandit": bandit_gate,
    "gridworld_wm": lambda r: r["after"] < 0.5 * r["before"],
    "gridworld_pixels": lambda r: r["passed"],
    "point": lambda r: r["after"] > r["before"] + 4.0 and r["after"] > 12.0,
}

# The live run of 15c: `defaults gridworld` with the K1 cell, one CPU generator
# that reloads the learner's checkpoint every 15 s, limit_step_ratio as
# demo_gridworld.sh has it. log_interval 10: the first logged window is steps
# 11-20 (the trainer logs no first window); on the H100 loss_model halved from
# there by step 40. It runs beside 15a and 15b: the learner and the generator
# are processes of their own, and the card has room for both. 480 steps: the
# graphed step takes ~65 ms (120 eager ones took ~40 s), so the run lasts
# long enough for the generator to load a checkpoint and act from it.
LIVE_STEPS = 480
LIVE_ARGS = ["--configs", "defaults", "gridworld", "--gru_type", "gru_layernorm_dv2",
             "--limit_step_ratio", "200", "--model_reload_interval", "15",
             "--generator_log_every", "2", "--eval_interval", "0", "--save_interval", "40",
             "--log_interval", "10", "--data_workers", "2", "--n_steps", str(LIVE_STEPS)]
LIVE_TIMEOUT_S = 420


def run_tool(tool: str, *args) -> str:
    """``python -m pydreamer_tpu_torch.scripts.<tool> args`` -> its last line."""
    proc = subprocess.run([sys.executable, "-m", f"pydreamer_tpu_torch.scripts.{tool}",
                           *map(str, args)], cwd=ROOT, capture_output=True, text=True)
    if proc.returncode != 0:
        raise AssertionError(f"{tool} exit {proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout.strip().splitlines()[-1]


def learning_phase(rs: RunState) -> None:
    """15. Learning on the card. 15c, the live run, starts first: ``python -m
    pydreamer_tpu_torch.launch --configs defaults gridworld --gru_type
    gru_layernorm_dv2`` (deter 256, T=48, B=32, bf16, ``Grid-8x64``, one CPU
    generator reloading the checkpoint every 15 s) for 480 steps under
    ``timeout`` in a session of its own, running beside 15a and 15b (its own
    processes; its log goes to a file). 15a: K1 at the shapes no earlier
    phase launched, against its plain version and timed as in 2:
    ``skinny_f32`` at each canary's posterior (M=B) and acting (M=1) rows,
    ``wide_f32`` at its dream (M=T*B) rows (H=32 and 64), and ``skinny`` M=32
    and ``wide`` M=1536 at the ``gridworld`` preset's In=H=256 in bf16. 15b:
    the four learning canaries of ``tests/test_learning.py``
    (``pydreamer_tpu_torch/scripts/canaries.py``) on the card with
    ``gru_type: gru_layernorm_dv2``, each held to the JAX test's own gate
    (bandit: after > 6 and after > before + 2; GridWorld world model:
    ``loss_model`` at step 60 under half of step 5's; pixel policy: the
    rolling 80-episode gate clears by step 4000; point: after > before + 4 and
    after > 12), counts set to 0 just before and read just after each: T
    posterior launches a train step on ``skinny_f32``, H dream launches on
    ``wide_f32`` and one ``skinny_f32`` launch a policy call, exact per
    schedule. Then 15c's checks: exit 0, no process left, ``loss_model`` at
    the last log step under half its first logged value, the generator's
    ``agent/`` rows both before and after its first checkpoint load, the
    learner's K1 line (48 ``skinny`` [M=32] + 10 ``wide`` [M=1536] a step plus
    the log step's 47, none ``generic``). Then the run tools on its
    directory, as ``python -m pydreamer_tpu_torch.scripts.<tool>``:
    ``export_metrics`` (a CSV whose first column is ``_step``),
    ``plot_curves`` (a PNG) where matplotlib is installed and ``make_gif`` (a
    GIF of the run's ``d2_wm_dream`` dump) where PIL is; what a tool would
    read is kept in ``chiprun_out/live_run/`` beside what they wrote."""
    import importlib.util
    import os
    import re
    import shutil
    import tempfile

    from pydreamer_tpu_torch.scripts import canaries
    from pydreamer_tpu_torch.tracking import Run

    t_phase = time.perf_counter()
    device = rs.device
    out = rs.report["learning"] = {}
    confs = {name: make("gru_layernorm_dv2") for name, make in canaries.CONFS.items()}
    live_conf = parse_args(LIVE_ARGS[:5], config_dir=str(ROOT / "config"))

    # 15c, started: the launcher in a session of its own, its log to a file.
    run_dir = ROOT / "runs" / "chip_smoke_live"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.parent.mkdir(exist_ok=True)
    env = {k: v for k, v in os.environ.items() if k != "PYDREAMER_RUN_DIR"}
    env["PYTHONPATH"] = str(ROOT)
    cmd = ["timeout", "-k", "10", str(LIVE_TIMEOUT_S), sys.executable, "-m",
           "pydreamer_tpu_torch.launch", *LIVE_ARGS, "--run_dir", str(run_dir)]
    log_path = OUT_DIR / "live_log.txt"
    t_live = time.time()
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, start_new_session=True,
                                stdout=log_file, stderr=subprocess.STDOUT)

    # 15a. K1 at the new shapes: float32 at each canary's posterior (M=B,
    # skinny_f32), dream (M=T*B, wide_f32) and acting (M=1, skinny_f32) rows;
    # bf16 at the live run's M=32 and M=1536.
    shapes = {}
    for name, c in confs.items():
        rows = [c.batch_size, c.batch_length * c.batch_size]
        rows += [1] if name != "gridworld_wm" else []
        for M in rows:
            want = "skinny_f32" if M <= k1.SKINNY_MAX_ROWS else "wide_f32"
            shapes[(want, M, c.hidden_dim, c.deter_dim)] = torch.float32
    T, B = live_conf.batch_length, live_conf.batch_size
    In, H = live_conf.hidden_dim, live_conf.deter_dim
    shapes[("skinny", B, In, H)] = torch.bfloat16
    shapes[("wide", T * B, In, H)] = torch.bfloat16
    for (want, M, In_s, H_s), dtype in shapes.items():
        rs.k1_row(f"[15a] K1 {want} M={M} In={In_s} H={H_s}", M, In_s, H_s, dtype, want)

    # 15b. The canaries on the card, each launch of K1 counted.
    scratch = Path(tempfile.mkdtemp(prefix="canaries_", dir=ROOT / "runs"))
    runners = {"bandit": canaries.bandit, "gridworld_wm": canaries.gridworld_wm,
               "gridworld_pixels": lambda d, **kw: canaries.gridworld_pixels(d, pixel_until, **kw),
               "point": canaries.point}
    out["canaries"] = {}
    for name, runner in runners.items():
        c = confs[name]
        torch.cuda.synchronize()
        k1.LAUNCHES.reset()
        r = runner(scratch / name, device=device, gru_type="gru_layernorm_dv2")
        torch.cuda.synchronize()
        rows, sched = dict(k1.LAUNCHES.by_rows), dict(k1.LAUNCHES.by_schedule)
        Tc, Bc, Hc = c.batch_length, c.batch_size, c.imag_horizon
        want_rows = {Bc: r["steps"] * Tc, Tc * Bc: r["steps"] * Hc, 1: r["policy_calls"]}
        want_rows = {m: n for m, n in want_rows.items() if n}
        sched_of = {M: k1.plan(M, c.hidden_dim, c.deter_dim, torch.float32).schedule
                    for M in want_rows}
        want_sched = {}
        for M, n in want_rows.items():
            want_sched[sched_of[M]] = want_sched.get(sched_of[M], 0) + n
        r.update(launches_by_rows=rows, launches_by_schedule=sched, ok=GATES[name](r))
        out["canaries"][name] = r
        print(f"[15b] {name}: before {r['before']:.4f}, after {r['after']:.4f}, "
              f"{r['steps']} steps, {r['seconds']:.1f} s, {r['policy_calls']} acting calls; "
              f"K1 launches {rows} {sched}; gate {'passed' if r['ok'] else 'FAILED'}")
        if sched != want_sched or rows != want_rows:
            raise AssertionError(f"[15b] {name}: K1 launches {rows} {sched}, expected "
                                 f"{want_rows} {want_sched}")
        if not math.isfinite(r["metrics"]["loss_model"]) or not r["ok"]:
            raise AssertionError(f"[15b] {name} failed the JAX test's gate: {r}")
        for M, n in rows.items():
            rs.credit(sched_of[M], M, c.deter_dim, n, r["policy_calls"] if M == 1 else r["steps"])
    shutil.rmtree(scratch)
    torch.cuda.empty_cache()

    # 15c. The live run's end and its checks.
    rc = proc.wait()
    live_s = log_path.stat().st_mtime - t_live  # to the launcher's last line
    log = log_path.read_text()
    # A process of the session that is exiting as the launcher exits (its
    # multiprocessing resource tracker) gets the few seconds that 12c's
    # communicate() gives it by waiting for the pipe to close.
    deadline = time.perf_counter() + 10.0
    left = session_processes(proc.pid)
    while left and time.perf_counter() < deadline:
        time.sleep(0.5)
        left = session_processes(proc.pid)
    for pid in left:
        os.kill(pid, 9)
    live = out["live"] = dict(rc=rc, wall_s=live_s, processes_left=left)
    print(f"[15c] launcher (gridworld width): exit {rc} after {live_s:.1f} s, processes left "
          f"{left} (log: chiprun_out/live_log.txt)")
    if rc != 0 or left:
        raise AssertionError(f"live run exit {rc}, processes left {left}:\n{log[-3000:]}")
    k1_line = re.search(r"Learner K1 launches: by schedule (\{.*?\}), by rows (\{.*?\})", log)
    if k1_line is None or "Learner device: cuda" not in log:
        raise AssertionError(f"live run: no K1 launch line or not on the card:\n{log[-3000:]}")
    sched = json.loads(k1_line.group(1))
    lrows = {int(k): v for k, v in json.loads(k1_line.group(2)).items()}
    H_imag, n = live_conf.imag_horizon, LIVE_STEPS
    want_sched = {"skinny": n * T + T - 1, "wide": n * H_imag}  # step 1 logs the dream: T-1 more
    metrics = Run(run_dir).read_metrics()
    train = [m for m in metrics if "train/loss_model" in m]
    agent = [m for m in metrics if "agent/return" in m]
    # The generator logs at the step of the checkpoint it acts from: 0 before its first load.
    before_load = [m for m in agent if m["_step"] == 0]
    after_load = [m for m in agent if m["_step"] > 0]
    loads = [int(x) for x in re.findall(r"Generator loaded model checkpoint (\d+)", log)]
    live.update(
        launches_by_schedule=sched, launches_by_rows=lrows, checkpoint_loads=loads,
        loss_model=[(m["_step"], m["train/loss_model"]) for m in train],
        loop_ms_per_step=[1e3 / m["train/fps"] for m in train],
        timers_ms=[{k[len("train/timer_"):]: v * 1e3 for k, v in m.items()
                    if k.startswith("train/timer_")} for m in train],
        agent_rows_before_load=len(before_load), agent_rows_after_load=len(after_load),
        return_cum=[(m["_step"], m["agent/return_cum"]) for m in agent],
        env_steps=agent[-1]["agent/env_steps"] if agent else 0)
    if len(train) < 2 or not agent:
        raise AssertionError(f"live run: {len(train)} train rows, {len(agent)} agent rows")
    first, last = train[0]["train/loss_model"], train[-1]["train/loss_model"]
    print(f"[15c] learner: K1 launches {sched} {lrows}; loss_model {first:.2f} (step "
          f"{train[0]['_step']}) -> {last:.2f} (step {train[-1]['_step']}); loop ms/step by "
          f"window {[round(x, 2) for x in live['loop_ms_per_step']]}; timer_step/data/other ms "
          f"of the last window "
          f"{[round(train[-1].get(f'train/timer_{k}', float('nan')) * 1e3, 2) for k in ('step', 'data', 'other')]}")
    print(f"[15c] generator: {len(before_load)} agent rows before its first checkpoint load, "
          f"{len(after_load)} after (loads at steps {loads}); agent/return_cum "
          f"{agent[0]['agent/return_cum']:.4f} at the start, {agent[-1]['agent/return_cum']:.4f} "
          f"at the end ({live['env_steps']} env steps)")
    if sched != want_sched or lrows != {B: want_sched["skinny"], T * B: want_sched["wide"]}:
        raise AssertionError(f"live run K1 launches {sched} {lrows}, expected {want_sched}, "
                             "none generic")
    if not last < 0.5 * first:
        raise AssertionError(f"live run loss_model {live['loss_model']}: not halved")
    if not before_load or not after_load or not loads:
        raise AssertionError(f"live run agent rows: {len(before_load)} before the first "
                             f"checkpoint load, {len(after_load)} after; loads {loads}")
    rs.credit("skinny", B, H, sched["skinny"], n)
    rs.credit("wide", T * B, H, sched["wide"], n)

    # The run tools on the run directory. plot_curves draws with matplotlib and
    # make_gif with PIL: where one is not installed that tool is not run, and
    # the metrics and the dump it would read are kept in chiprun_out/live_run/.
    tools_dir = OUT_DIR / "live_run"
    shutil.rmtree(tools_dir, ignore_errors=True)
    tools_dir.mkdir()
    dumps = sorted(run_dir.rglob("d2_wm_dream/*.npz"))
    if not dumps:
        raise AssertionError("live run: no d2_wm_dream dump")
    shutil.copy(run_dir / "metrics.jsonl", tools_dir / "metrics.jsonl")
    shutil.copy(dumps[-1], tools_dir / dumps[-1].name)
    csv_path = tools_dir / "metrics.csv"
    said = {"export_metrics": run_tool("export_metrics", run_dir, csv_path)}
    header = csv_path.read_text().splitlines()[0].split(",")
    if header[0] != "_step":
        raise AssertionError(f"export_metrics: CSV header {header[:3]}")
    drawn = {"plot_curves": ("matplotlib", ("plot_curves", run_dir, "--metric",
                                            "agent/return_cum", "--out",
                                            tools_dir / "return_curve.png")),
             "make_gif": ("PIL", ("make_gif", dumps[-1], tools_dir / "dream.gif"))}
    for tool, (package, args) in drawn.items():
        if importlib.util.find_spec(package) is None:
            said[tool] = f"not run: {package} is not installed here"
            continue
        said[tool] = run_tool(*args)
        if not Path(args[-1]).stat().st_size:
            raise AssertionError(f"{tool} wrote an empty {args[-1]}")
    live["tools"] = said
    print(f"[15c] tools on the run directory: {said}; CSV columns start {header[:3]}")
    shutil.rmtree(run_dir)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[15] phase 15 took {out['seconds']:.1f} s (15c ran beside 15a and 15b)")


# Phase 16's short step counts: the tools' defaults (bench's 10 + 2 x 50
# steps, bench_gru's three cells, ...) would take minutes at the flagship width,
# and the phase must leave the whole script well inside its 1200 s.
TOOL_STEPS = dict(warmup=2, steps=3)


def _finite(x) -> bool:
    """Every number in a tool's line finite (None: not measured on this path)."""
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, list):
        return all(_finite(v) for v in x)
    return x is None or isinstance(x, str) or math.isfinite(x)


def tools_phase(rs: RunState, with_e2e: bool = False) -> None:
    """16. The measurement tools of ``pydreamer_tpu_torch/scripts/``, each
    ``main(argv)`` in-process on the card at the flagship width with short
    step counts (2 warm-up steps, windows of 1-5): ``bench`` (``gru``),
    ``bench_gru`` (three cells), ``bench_step_ab`` (``gru`` against
    ``gru_layernorm_dv2`` in turns), ``profile_step`` under
    ``gru_layernorm_dv2``, ``bench_dream`` (both cells at M=1536),
    ``roofline`` at the card's peaks, ``bench_conv --all``, ``scaling_bench``
    (one NCCL rank a card). Each line must carry the JAX tool's keys, finite
    values and the card's name and nvidia-smi line; K1's launches in each
    tool are set to 0 before it and read after, T ``skinny`` [M=B] a DV2
    train step and H ``wide`` [M=T*B] a DV2 train step or dream call, exact;
    ``bench_gru`` reports 48 + 15 a step under both DV2 cells and none under
    ``gru``; ``profile_step`` saw kernel records of both schedules;
    ``roofline``'s K1 bound equals phase 2's (so phase 2's flagship rows run
    first). One ``[16] tools summary`` line; details in
    ``chiprun_out/tools_phase.json``. ``with_e2e`` (``--tools-only``) adds
    ``bench_e2e --quick`` (six CPU generator processes: 139 s on an H100's
    host) and ``scaling_bench --gspmd-overhead`` (a second rank process); the
    whole run has no room for them."""
    from pydreamer_tpu_torch.scripts import (bench, bench_conv, bench_dream, bench_e2e, bench_gru,
                                             bench_step_ab, flagship, roofline, scaling_bench)
    from pydreamer_tpu_torch.scripts import profile_step as profile_tool

    conf, report, smi, name = flagship.make_conf(), rs.report, rs.smi, rs.name
    T, B, H_imag, In, H = (conf.batch_length, conf.batch_size, conf.imag_horizon,
                           conf.hidden_dim, conf.deter_dim)
    w, n = TOOL_STEPS["warmup"], TOOL_STEPS["steps"]
    out = report["tools"] = {"seconds": {}}
    dv2_steps = dream_calls = 0

    def run(tool, argv, keys, steps=0, dreams=0, label=None):
        """One tool's main(argv): its lines checked, K1's launches in it
        exactly T a train step under a DV2 cell at M=B and H a train step or
        dream call at M=T*B."""
        nonlocal dv2_steps, dream_calls
        k1.LAUNCHES.reset()
        t0 = time.perf_counter()
        argv = [str(a) for a in argv]
        got = tool.main(["--device", "cuda", *argv] if tool is not roofline else argv)
        out["seconds"][label or tool.__name__.rsplit(".", 1)[-1]] = time.perf_counter() - t0
        lines = got if isinstance(got, list) else [got]
        for line, want in zip(lines, keys):
            if not want <= set(line) or not _finite(line):
                raise AssertionError(f"{tool.__name__}: line {line} lacks {want - set(line)} "
                                     "or holds a non-finite number")
            if tool is not roofline and (line["device"] != name or line["nvidia_smi"] != smi):
                raise AssertionError(f"{tool.__name__}: provenance {line['device']!r} "
                                     f"{line['nvidia_smi']!r}, the card is {smi!r}")
        want_rows = {m: c for m, c in ((B, T * steps), (T * B, H_imag * (steps + dreams))) if c}
        if dict(k1.LAUNCHES.by_rows) != want_rows or k1.LAUNCHES.count != sum(want_rows.values()):
            raise AssertionError(f"{tool.__name__}: K1 launches {k1.LAUNCHES.by_rows} "
                                 f"{k1.LAUNCHES.by_schedule}, expected {want_rows}")
        dv2_steps += steps
        dream_calls += dreams
        return got

    line = run(bench, ["--warmup", w, "--steps", 5],
               [{"metric", "value", "unit", "vs_baseline", "provenance"}])
    out["bench"] = line
    print(f"[16] bench (gru): {line['value']:.4f} steps/s, {1e3 / line['value']:.2f} ms/step; "
          f"provenance {line['provenance']}")

    gru_lines = run(bench_gru, ["--warmup", w, "--steps", 2],
                    [{"gru_type", "steps_per_sec", "ms_per_step", "loss_model"}] * 3,
                    steps=2 * (w + 2 * 2))
    out["bench_gru"] = gru_lines
    for line in gru_lines:
        want = {} if line["gru_type"] == "gru" else {"skinny": T, "wide": H_imag}
        if line["k1_launches_per_step"] != want:
            raise AssertionError(f"bench_gru {line['gru_type']}: K1 launches a step "
                                 f"{line['k1_launches_per_step']}, expected {want}")
    print("[16] bench_gru: " + "; ".join(
        f"{x['gru_type']} {x['ms_per_step']:.2f} ms/step, K1 a step {x['k1_launches_per_step']}"
        for x in gru_lines))

    line = run(bench_step_ab, ["--a", "auto:auto", "--b", f"auto:auto:gru_type={DV2}",
                               "--rounds", 2, "--n", n, "--warmup", w],
               [{"a", "b", "a_steps_per_sec", "b_steps_per_sec", "a_median", "b_median",
                 "b_vs_a"}], steps=w + 2 * n)
    out["bench_step_ab"] = line
    print(f"[16] bench_step_ab gru / {DV2} in turns: {line['a_steps_per_sec']} / "
          f"{line['b_steps_per_sec']} steps/s, b_vs_a {line['b_vs_a']:.4f}")

    line = run(profile_tool, ["--gru_type", DV2, "--warmup", w, "--steps", 1, "--top", 15],
               [{"wall_ms_per_step", "device_busy_ms_per_step", "rows", "k1"}], steps=w + 1)
    out["profile_step"] = line
    seen = line["k1"]
    for sched, per in (("skinny", T), ("wide", H_imag)):
        r = seen.get(sched, {})
        if r.get("launches_per_step") != per or not 0 < r.get("recorded_per_step", 0) <= per:
            raise AssertionError(f"profile_step: K1 {sched} {r}, expected {per} launches a step "
                                 "and kernel records of it")
    print(f"[16] profile_step ({DV2}): wall {line['wall_ms_per_step']:.2f} ms/step, busy "
          f"{line['device_busy_ms_per_step']:.2f} ({100 * line['busy_share']:.1f}%); K1 {seen}")

    lines = run(bench_dream, ["--steps", 10, "--gru_type", "gru", DV2],
                [{"metric", "value", "unit", "M", "H"}] * 2, dreams=1 + 10)
    out["bench_dream"] = lines
    if lines[1]["k1_launches_per_call"] != {"wide": H_imag} or lines[0]["k1_launches_per_call"]:
        raise AssertionError(f"bench_dream K1 launches a call: {lines[0]['k1_launches_per_call']}, "
                             f"{lines[1]['k1_launches_per_call']}")
    print(f"[16] bench_dream M={lines[0]['M']} H={lines[0]['H']}: gru {lines[0]['value']:.3f} ms, "
          f"{DV2} {lines[1]['value']:.3f} ms (K1 {lines[1]['k1_launches_per_call']} a call)")

    rows = run(roofline, [], [{"conv_pair", "dream_scan", "rssm_fwd_scan", "dims"}])
    out["roofline"] = rows
    for M, sched in ((B, "skinny"), (T * B, "wide")):
        bound = roofline.k1_bound_ms(M, In, H, rs.peaks, True)[0]
        used = [r["bound_ms"] for r in report["k1"] if (r["schedule"], r["M"], r["H"], r["dtype"])
                == (sched, M, H, "bfloat16")]
        if used != [bound]:
            raise AssertionError(f"roofline K1 bound {sched} M={M}: {bound} ms, phase 2: {used}")
    print(f"[16] roofline at the card's peaks: dream scan {rows['dream_scan']}, conv totals "
          f"{rows['conv_pair']['totals']}; K1 bounds as phase 2's")

    line = run(bench_conv, ["--all", "--n", 10, "--warmup", 3], [{"M", "cnn_depth", "layers",
                                                                  "stacks"}])
    out["bench_conv"] = line
    print("[16] bench_conv fwd+bwd ms (floor): " + ", ".join(
        f"{k} {v['fwdbwd_ms']:.3f} ({v['floor_fwdbwd_ms']:.3f})" for k, v in line["layers"].items())
        + "; stacks " + ", ".join(f"{k} {v['fwdbwd_ms']:.3f}" for k, v in line["stacks"].items()))

    lines = run(scaling_bench, ["--steps", n, "--warmup", w],
                [{"n_devices", "global_batch", "steps_per_sec", "weak_scaling_efficiency"},
                 {"metric", "value", "unit", "sizes"}])
    out["scaling_bench"] = lines
    print(f"[16] scaling_bench: {lines[0]['steps_per_sec']:.4f} steps/s on 1 rank (sizes "
          f"{lines[-1]['sizes']})")

    if with_e2e:
        over = run(scaling_bench, ["--gspmd-overhead", "--steps", n, "--warmup", w],
                   [{"mode", "steps_per_sec"}] * 2
                   + [{"plain", "gspmd_1dev", "gspmd_overhead_pct"}],
                   label="scaling_bench_overhead")
        out["scaling_bench_overhead"] = over
        print(f"[16] scaling_bench --gspmd-overhead: plain {over[-1]['plain']:.4f} vs 1-rank "
              f"mesh {over[-1]['gspmd_1dev']:.4f} steps/s ({over[-1]['gspmd_overhead_pct']:.2f}%)")
        line = run(bench_e2e, ["--quick", "--warmup", w, "--steps", 5],
                   [{"metric", "value", "unit", "vs_baseline", "extra", "host_breakdown"}])
        out["bench_e2e"] = line
        print(f"[16] bench_e2e --quick: pipeline {line['value']:.4f} steps/s; extra "
              f"{line['extra']}; host {line['host_breakdown']}")

    rs.credit("skinny", B, H, T * dv2_steps, dv2_steps)
    rs.credit("wide", T * B, H, H_imag * (dv2_steps + dream_calls), dv2_steps + dream_calls)
    (OUT_DIR / "tools_phase.json").write_text(json.dumps(out, indent=1))
    summary = dict(card=smi, seconds=out["seconds"], bench_steps_per_sec=out["bench"]["value"],
                   bench_gru_ms_per_step={x["gru_type"]: x["ms_per_step"] for x in gru_lines},
                   step_ab_b_vs_a=out["bench_step_ab"]["b_vs_a"],
                   profile_busy_share=out["profile_step"]["busy_share"],
                   dream_ms={x["metric"]: x["value"] for x in out["bench_dream"][:2]},
                   k1_train_steps=dv2_steps, k1_dream_calls=dream_calls)
    if with_e2e:
        summary.update(gspmd_overhead_pct=out["scaling_bench_overhead"][-1]["gspmd_overhead_pct"],
                       e2e_pipeline_steps_per_sec=out["bench_e2e"]["value"])
    print("[16] tools summary: " + json.dumps(summary))



DV3_IN, DV3_H = 1024, 4096  # K1's In and H in DreamerV3 XL (hidden_dim, deter_dim)


def k1_backward_ms(M, In, H, gen, device, iters: int = 10) -> dict:
    """ms of a forward and backward (all six gradients) through K1's autograd
    function (the bf16 backward pass) and through the plain version, bf16
    operands, timed with CUDA events over ``iters`` calls after two warm ones
    (autograd's backward is not captured in a graph here)."""
    ins = k1_inputs(M, In, H, gen, device, torch.bfloat16)
    proj = torch.randn(M, H, generator=gen, device=device)

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in ins]
        (fn(*leaves) * proj).sum().backward()

    out = {}
    for key, fn in (("k1_fwd_bwd_ms", k1.GRUDv2Function.apply),
                    ("plain_fwd_bwd_ms", k1.gru_dv2_reference)):
        for _ in range(2):
            run(fn)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            run(fn)
        end.record()
        torch.cuda.synchronize()
        out[key] = start.elapsed_time(end) / iters
    return out


def dv3_k1_phase(rs: RunState) -> None:
    """18. K1 at DreamerV3 XL's shapes (In=1024, H=4096, bf16): ``skinny`` at
    M=16 (the posterior loop) and ``wide`` at M=1024 (the dream) against the
    plain version, forward and six gradients, timed as in 2; then ms of a
    forward and backward (K1's bf16 backward pass) through K1's autograd
    function at both shapes beside the same through the plain version; then
    ``bench_gru --cells dv3``, the tool's lines at the same two shapes."""
    from pydreamer_tpu_torch.scripts import bench_gru

    for M, want in ((16, "skinny"), (1024, "wide")):
        res = check_k1(rs, M, DV3_IN, DV3_H, torch.bfloat16, want, timed=True)
        res.update(k1_backward_ms(M, DV3_IN, DV3_H, rs.gen, rs.device))
        res["plan"] = vars(k1.plan(M, DV3_IN, DV3_H, torch.bfloat16))
        rs.report["k1"].append(res)
        print(f"[18] K1 {want} M={M} In={DV3_IN} H={DV3_H} bf16 {res['plan']}: {k1_summary(res)}; "
              f"forward+backward {res['k1_fwd_bwd_ms']:.3f} ms (plain "
              f"{res['plain_fwd_bwd_ms']:.3f})", flush=True)
    lines = bench_gru.main(["--cells", "dv3", "--warmup", "2", "--steps", "10"])
    if [line["schedule"] for line in lines] != ["skinny", "wide"]:
        raise AssertionError(f"[18] bench_gru --cells dv3: {lines}")
    rs.report["bench_gru_dv3"] = lines


# Phase 20's shapes (M, In, H): the posterior loop's and the dream's at the
# Atari and DMC widths (H=1024, 2048; In=1000) and at DreamerV3 XL's.
BWD_SHAPES = ((32, 1000, 1024), (1536, 1000, 1024), (32, 1000, 2048), (1536, 1000, 2048),
              (16, DV3_IN, DV3_H), (1024, DV3_IN, DV3_H))
X_H = (True, True, False, False, False, False)  # the dream under actor_grad: dynamics


def k1_backward_bound_ms(M, In, H, peaks, needs) -> tuple[float, str]:
    """Least time of K1's bf16 backward: the recompute's product and one
    product per pair of gradients asked for (dx and dh share one; dw_ih and
    dw_hh one) at the bf16 tensor rate, or the bytes: the weights read by the
    recompute and by dx/dh, dW written, the f32 gates written and read, dG
    written once and read once a product, grad_out, h, x and the outputs.
    -> (ms, "bytes" or "operations")."""
    bw, bf16_rate = peaks[0], peaks[1]
    K, N = In + H, 3 * H
    pairs = 1 + int(needs[0] or needs[1]) + int(needs[2] or needs[3])
    weights = 2 * K * N * pairs
    acts = M * N * (4 * 2 + 2 * pairs) + M * H * 4 * 2 + M * K * 2 * 2
    t_bytes, t_ops = (weights + acts) / bw, pairs * 2 * M * K * N / bf16_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def k1_backward_phase(rs: RunState) -> None:
    """20. K1's backward, the bf16 pass (``ops/gru_dv2.py::k1_backward``: the
    forward's gate products recomputed, the LayerNorm/gate backward kernel,
    three bf16 products with f32 sums), at the posterior loop's and the
    dream's shapes (``BWD_SHAPES``); all six gradients, and at M > 64 also x
    and h alone (the dream under ``actor_grad: dynamics``). Each gradient is
    held to autograd through the plain version in float32 (the backward
    before the bf16 pass) within ``BWD_WITNESS_FACTOR`` times the witness's
    distance from it (``backward_witness``: the same float32 arithmetic with
    dG rounded to bf16, the pass's one new rounding), or ``GRAD_TOL``, and
    never more than ``BWD_LIMIT_CAP``. Timed (CUDA graphs, cold L2) beside
    its bound (bytes at the card's bandwidth or bf16 operations at its tensor
    rate) and the plain recompute's time. Its rows close the kernels line,
    with the K1 backward calls that phases 4, 9 and 19b counted."""
    gen, device, peaks = rs.gen, rs.device, rs.peaks
    flush_buf = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=device)  # 128 MB > L2
    rows = []
    for M, In, H in BWD_SHAPES:
        ins = k1_inputs(M, In, H, gen, device, torch.bfloat16)
        grad_out = torch.randn(M, H, generator=gen, device=device)
        res = dict(M=M, In=In, H=H, schedule=k1.plan(M, In, H, torch.bfloat16).schedule,
                   rows=k1.backward_rows(M), route=k1.backward_route(torch.bfloat16))
        if res["route"] != "kernel":
            raise AssertionError(f"[20] M={M} H={H}: route {res['route']}")
        checks = (("all", (True,) * 6),) + ((("x_h", X_H),) if M > 64 else ())
        for label, needs in checks:
            leaves = [t.clone().requires_grad_(need) for t, need in zip(ins, needs)]
            wanted = [t for t in leaves if t.requires_grad]
            plain = torch.autograd.grad(k1.gru_dv2_reference(*leaves), wanted, grad_out)
            got = [g for g in k1.k1_backward(*ins, grad_out, needs) if g is not None]
            witness = [g for g in backward_witness(ins, grad_out, needs) if g is not None]
            names = [n for n, need in zip(GRAD_NAMES, needs) if need]
            errs = {}
            for name, a, b, w in zip(names, got, plain, witness):
                if a.dtype != b.dtype or a.shape != b.shape:
                    raise AssertionError(f"[20] M={M} H={H} {name}: {a.dtype} {tuple(a.shape)}, "
                                         f"expected {b.dtype} {tuple(b.shape)}")
                err, wit = rel_err(a, b), rel_err(w, b)
                limit = bwd_limit(wit)
                errs[name] = dict(err=err, witness=wit, limit=limit)
                if not math.isfinite(err) or err > limit:
                    raise AssertionError(f"[20] M={M} In={In} H={H} {label}: grad {name} rel err "
                                         f"{err} > {limit} (witness {wit})")
            res[f"grads_{label}"] = errs
            iters = 20 if H < 4096 else 10
            res[f"ms_{label}"] = time_ms(lambda: k1.k1_backward(*ins, grad_out, needs),
                                         iters, flush_buf.zero_)
            res[f"plain_ms_{label}"] = time_ms(
                lambda: torch.autograd.grad(k1.gru_dv2_reference(*leaves), wanted, grad_out),
                iters, flush_buf.zero_)
            res[f"bound_ms_{label}"], res[f"bound_by_{label}"] = k1_backward_bound_ms(
                M, In, H, peaks, needs)
            ms, bound = res[f"ms_{label}"], res[f"bound_ms_{label}"]
            grads = ", ".join(f"{n} {e['err']:.2e}/{e['limit']:.2e}" for n, e in errs.items())
            print(f"[20] K1 backward {res['schedule']} M={M} In={In} H={H} ({label}, rows "
                  f"{res['rows']}): {ms:.5f} ms, bound {bound:.5f} ({res[f'bound_by_{label}']}, "
                  f"{100 * bound / ms:.1f}%), plain recompute {res[f'plain_ms_{label}']:.5f} ms; "
                  f"grads err/limit {grads}", flush=True)
        rows.append(res)
    rs.report["k1_backward"] = rows
    (OUT_DIR / "k1_backward_phase.json").write_text(json.dumps(rows, indent=1))


DV3_LEARNER_STEPS = 60  # phase 19b: step 1 a log step (eager), step 2 the capture, then replays


def dv3_learner(rs: RunState) -> None:
    """19b. ``trainer.run`` on ``--configs defaults atari dreamerv3_xl`` from
    episode files written from a seed (60 steps): ``make_model`` builds
    DreamerV3 XL, step 1 is a log step, step 2 captures, the rest replay (at
    least 97% of the calls), K1 launches 64 ``skinny`` (M=16) and 15 ``wide``
    (M=1024) a step, plus the log step's 63-step dream at M=16 (credited to
    the kernels line's two DreamerV3 XL rows), 64 K1 backward calls a step at
    M=16, all on the bf16 pass, and the checkpoint lands at step 60."""
    import shutil

    from pydreamer_tpu_torch.data import NpzEpisodeRepository
    from pydreamer_tpu_torch.tracing import COUNTERS
    from pydreamer_tpu_torch.tracking import load_checkpoint_file
    from pydreamer_tpu_torch.training import trainer

    report, device = rs.report, rs.device
    t0 = time.perf_counter()
    d = dv3_conf()
    episodes = ROOT / "runs" / "chip_smoke_dv3_episodes"
    run_dir = ROOT / "runs" / "chip_smoke_dv3_learner"
    for path in (episodes, run_dir):
        shutil.rmtree(path, ignore_errors=True)
    write_episodes(NpzEpisodeRepository(episodes), 4, 1000, d["action_dim"], seed=19)
    d.update(offline_data_dir=str(episodes), generator_prefill_steps=0, data_workers=2,
             n_steps=DV3_LEARNER_STEPS, save_interval=DV3_LEARNER_STEPS, eval_interval=0)
    torch.cuda.empty_cache()
    COUNTERS.reset()
    k1.LAUNCHES.reset()
    k1.K1_BACKWARDS.reset()
    trainer.run(Conf(d), run_dir=str(run_dir), device=device)
    torch.cuda.synchronize()
    rows, sched = dict(k1.LAUNCHES.by_rows), dict(k1.LAUNCHES.by_schedule)
    share = 100.0 * COUNTERS.graph_replays / COUNTERS.train_steps
    saved, step = load_checkpoint_file(run_dir / "checkpoints" / "latest.ckpt", "cpu")
    params = sum(v.numel() for k, v in saved["model"].items() if ".critic_target." not in k
                 and k != "ac.retnorm.stats")
    out = dict(train_steps=COUNTERS.train_steps, graph_captures=COUNTERS.graph_captures,
               graph_replays=COUNTERS.graph_replays, graph_replay_share=share,
               launches_by_rows=rows, launches_by_schedule=sched,
               checkpoint_step=step, parameters=params, seconds=time.perf_counter() - t0)
    report["dv3_learner"] = out
    print(f"[19b] trainer.run on defaults atari dreamerv3_xl: {out}", flush=True)
    n, T, B, H_imag = COUNTERS.train_steps, d["batch_length"], d["batch_size"], d["imag_horizon"]
    want = {"skinny": n * T + T - 1, "wide": n * H_imag}  # step 1 logs the dream: T-1 more
    if (step != DV3_LEARNER_STEPS or COUNTERS.graph_captures != 1 or share < 97.0
            or tuple(saved["model"]["wm.core.cell.initial"].shape) != (4096,)
            or sched != want or rows != {B: want["skinny"], T * B: want["wide"]}):
        raise AssertionError(f"[19b] {out}; expected K1 launches {want}")
    H = d["deter_dim"]
    check_k1_backwards(report, "19b", k1_backward_rows(
        T, B, H_imag, d["actor_grad"] == "dynamics", n), H, n)
    rs.credit("skinny", B, H, sched["skinny"], n)
    rs.credit("wide", T * B, H, sched["wide"], n)
    for path in (episodes, run_dir):
        shutil.rmtree(path, ignore_errors=True)


GRAPH_STEPS = 6      # steps a side in phase 17
GRAPH_LOG_STEP = 4   # the eager log step inside the graphed run
GRAPH_SEED = 2 ** 33 + 17
GRAPH_RTOL = 1e-5    # losses and gradient norms, relative: the same kernels on the same operands
GRAPH_ATOL = 1e-6    # out-state and parameters, max-abs
GRAPH_BUSY_RTOL = 0.05
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch")


def profiled_step(ts, obs, state, step: int) -> dict:
    """One TrainStep call under torch.profiler: the union of its device
    activity (the spans' annotations left out), the host's launch calls, K1's
    kernel records by kind and its launches by the wrapper's count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = dict(k1.LAUNCHES.by_schedule)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _, _, _ = ts(obs, state, step)
        torch.cuda.synchronize()
    device, launch_calls = [], 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA and not ev.is_user_annotation():
            device.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name()))
        elif ev.name() in LAUNCH_CALLS:
            launch_calls += 1
    busy, end = 0, None
    for a, b, _ in sorted(device):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    launched = {k: n - before.get(k, 0) for k, n in k1.LAUNCHES.by_schedule.items()
                if n != before.get(k, 0)}
    k1_launches = {kind: sum(1 for *_, name in device if "k1::" in name and kind in name)
                   for kind in ("skinny::gates_kernel", "wide::gates_kernel", "generic::", "f32::")}
    return dict(state=state, busy_ms=busy / 1e6, launch_calls=launch_calls, launched=launched,
                k1_launches=k1_launches, k1_kernels=sorted({n for *_, n in device if "k1::" in n}),
                k2_kernels=sorted({n for *_, n in device if "k2::" in n}))


def graphs_vs_eager(rs: RunState, configs, phase: str, key: str, core: str = "k1") -> None:
    """Phase 17's check (and 19's and 23's) at ``configs``, (label, conf
    dict) pairs; its numbers go to ``report[key]``. ``core="k2"``: the model
    runs K2 and no K1, each call counts T + H K2 calls (``K2_LAUNCHES``), the
    profiled replay records ``k2::`` kernels, and the graphed step must equal
    the eager one bit for bit."""
    from pydreamer_tpu_torch.ops.block_gru import K2_LAUNCHES
    from pydreamer_tpu_torch.tracing import COUNTERS
    from pydreamer_tpu_torch.training.train_step import METRICS

    report, gen, device = rs.report, rs.gen, rs.device
    t_phase = time.perf_counter()
    out = {}
    for label, cfg in configs:
        conf = Conf(cfg)
        T, B, H_imag = conf.batch_length, conf.batch_size, conf.imag_horizon
        torch.manual_seed(17)
        models = {"graphed": Dreamer(conf, device=device), "eager": Dreamer(conf, device=device)}
        models["eager"].load_state_dict(models["graphed"].state_dict())
        steps = {k: TrainStep(m, conf, device=device) for k, m in models.items()}
        steps["eager"].graphs = None
        batches = [make_obs(conf, gen, device) for _ in range(GRAPH_STEPS)]
        states = {k: m.init_state(B) for k, m in models.items()}
        counts0 = (COUNTERS.graph_captures, COUNTERS.graph_replays)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kept, worst, rows = [], {"metrics": 0.0, "state": 0.0, "params": 0.0}, []
        bwd_want = k1_backward_rows(T, B, H_imag, conf.actor_grad == "dynamics")
        rtol, atol = (0.0, 0.0) if core == "k2" else (GRAPH_RTOL, GRAPH_ATOL)
        for i, obs in enumerate(batches):
            step = i + 1
            flags = dict(do_image_pred=True) if step == GRAPH_LOG_STEP else {}
            got = {}
            for k in ("graphed", "eager"):
                k1.K1_BACKWARDS.reset()
                K2_LAUNCHES.reset()
                states[k], metrics, tensors, _ = steps[k](obs, states[k], step, seed=GRAPH_SEED,
                                                          **flags)
                got[k] = (states[k], metrics, tensors)
                if core == "k2":
                    want = {B: T, T * B: H_imag}
                    if dict(K2_LAUNCHES.by_rows) != want or k1.K1_BACKWARDS.by_route:
                        raise AssertionError(f"[{phase}] {label} {k} step {step}: K2 calls "
                                             f"{K2_LAUNCHES.by_rows}, expected {want}; K1 "
                                             f"backward calls {k1.K1_BACKWARDS.by_route}")
                    path = report.setdefault("k2_path", {})
                    for M, n in want.items():
                        calls, n_steps = path.get(M, (0, 0))
                        path[M] = (calls + n, n_steps + 1)
                else:
                    check_k1_backwards(report, f"{phase}] [{label} {k} step {step}", bwd_want,
                                       conf.deter_dim, 1, credit=False)
            kept.append(got["graphed"])
            (sg, mg, _), (se, me, _) = got["graphed"], got["eager"]
            names = ["loss_model", "loss_probe", "loss_actor", "loss_critic",
                     *[m for m in METRICS.values() if m in me]]
            rel = max(abs(mg[n].item() - me[n].item()) / max(abs(me[n].item()), 1e-12)
                      for n in names)
            st = max((a.float() - b.float()).abs().max().item() for a, b in zip(sg, se))
            pa = max((a - b).abs().max().item() for a, b in
                     zip(models["graphed"].parameters(), models["eager"].parameters()))
            if models["eager"].ac.retnorm is not None:  # DreamerV3's return statistics
                st = max(st, (models["graphed"].ac.retnorm.stats
                              - models["eager"].ac.retnorm.stats).abs().max().item())
            rows.append(dict(step=step, metrics_rel=rel, state_abs=st, params_abs=pa,
                             loss_model=(mg["loss_model"].item(), me["loss_model"].item())))
            worst = {k: max(worst[k], v) for k, v in
                     (("metrics", rel), ("state", st), ("params", pa))}
            if not (rel <= rtol and st <= atol and pa <= atol):
                raise AssertionError(f"[{phase}] {label} step {step}: graphed vs eager metrics rel "
                                     f"{rel}, out-state {st}, parameters {pa}: {rows}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        captures = COUNTERS.graph_captures - counts0[0]
        replays = COUNTERS.graph_replays - counts0[1]
        if captures != 1 or replays != GRAPH_STEPS - 2:
            raise AssertionError(f"[{phase}] {label}: {captures} captures, {replays} replays; expected "
                                 f"1 and {GRAPH_STEPS - 2}")
        storages = [{t.untyped_storage().data_ptr() for t in
                     torch.utils._pytree.tree_leaves(step_out)} for step_out in kept]
        shared = [(a, b) for a in range(len(storages)) for b in range(a + 1, len(storages))
                  if storages[a] & storages[b]]
        if shared:
            raise AssertionError(f"[{phase}] {label}: steps {shared} returned tensors that share storage")
        (captured,) = steps["graphed"].graphs.captured.values()
        tags = [t[-1] if t else "-" for t, _ in captured.segments]
        out[label] = dict(rows=rows, worst=worst, capture_s=captured.seconds,
                          segments=len(captured.segments),
                          segments_by_span={t: tags.count(t) for t in dict.fromkeys(tags)},
                          peak_mem_gb=peak_gb)
        print(f"[{phase}] {label}: graphed vs eager over {GRAPH_STEPS} steps (eager log step "
              f"{GRAPH_LOG_STEP}): largest metrics rel {worst['metrics']:.3e}, out-state "
              f"{worst['state']:.3e}, parameters {worst['params']:.3e} (limits {rtol}, "
              f"{atol}); capture {captured.seconds:.3f} s, {len(captured.segments)} "
              f"segments {out[label]['segments_by_span']}; peak mem {peak_gb:.2f} GB", flush=True)
        # A profiled replay and a profiled eager step, then both timed.
        prof = {k: profiled_step(steps[k], batches[0], states[k], GRAPH_STEPS + 1)
                for k in ("graphed", "eager")}
        for k in prof:
            states[k] = prof[k].pop("state")
        busy = {k: prof[k]["busy_ms"] for k in prof}
        ms = {}
        for k in ("graphed", "eager"):
            ms[k], states[k], _ = timed_steps(steps[k], batches[1], states[k],
                                              GRAPH_STEPS + 1, 5)
        out[label].update(profiled=prof, step_ms=ms)
        print(f"[{phase}] {label}: a profiled step, graphed / eager: launch calls "
              f"{prof['graphed']['launch_calls']} / {prof['eager']['launch_calls']}, device busy "
              f"ms {busy['graphed']:.3f} / {busy['eager']:.3f}, K1 kernels recorded "
              f"{prof['graphed']['k1_launches']} / {prof['eager']['k1_launches']}; ms a step "
              f"{ms['graphed']:.2f} / {ms['eager']:.2f}", flush=True)
        if not abs(busy["graphed"] - busy["eager"]) <= GRAPH_BUSY_RTOL * busy["eager"]:
            raise AssertionError(f"[{phase}] {label}: device busy ms graphed {busy['graphed']} vs "
                                 f"eager {busy['eager']}")
        if core == "k2":
            kernels = prof["graphed"]["k2_kernels"]
            if not kernels or prof["graphed"]["k1_kernels"]:
                raise AssertionError(f"[{phase}] {label} profiled replay: K2 kernels {kernels}, "
                                     f"K1 kernels {prof['graphed']['k1_kernels']}")
        else:
            check_profiled_k1(prof["graphed"], T, H_imag, f"[{phase}] {label} profiled replay")
        del models, steps, states, kept, batches, captured
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    report[key] = out
    print(f"[{phase}] phase {phase} took {out['seconds']:.1f} s")


def graph_phase(rs: RunState) -> None:
    """17. The train step replayed from CUDA graphs against the eager step, at
    the ``atari_dv2`` and ``dmc_dv2`` widths (``flagship_conf``,
    ``dmc_conf``): two models from the same weights, one ``TrainStep`` as it
    runs (graphs) and one held eager, the same six batches and ``(seed,
    step)``. The graphed run warms at step 1, captures at step 2 and replays
    from then on, but for an eager log step (``do_image_pred``) at step 4,
    which the eager run takes too. Per step the losses, the four gradient
    norms, the out-state and every parameter are held to the eager run's
    (``GRAPH_RTOL``, ``GRAPH_ATOL``; the largest differences are printed);
    each call, replayed or eager, counts K1's backward calls of a step, all
    on the bf16 pass (T at M=B, and H at M=T*B under ``actor_grad:
    dynamics``); one capture; no returned tensor shares storage with another
    step's; a profiled replay shows K1's kernels, T ``skinny`` and H ``wide``
    launches credited, and device busy time within ``GRAPH_BUSY_RTOL`` of a
    profiled eager step's. Prints the capture's seconds, the segments, the
    host launch calls a step, ms a step either way, the peak memory and the
    phase's seconds."""
    graphs_vs_eager(rs, (("atari_dv2", flagship_conf()), ("dmc_dv2", dmc_conf())), "17", "graphs")


def dv3_graph_phase(rs: RunState) -> None:
    """19. The DreamerV3 XL step (``dv3_conf``) replayed from CUDA graphs
    against the eager step, as 17 does at the DreamerV2 widths, with the
    return statistics (``ac.retnorm.stats``) and the slow critic
    (``ac.critic_target``) held too: the device state that each replay must
    update in place. Every batch starts with a reset, so the learned initial
    state enters each step. Then 19b (``dv3_learner``)."""
    graphs_vs_eager(rs, (("atari_dv3_xl", dv3_conf()),), "19", "graphs_dv3")
    dv3_learner(rs)


COPY_SEED = 2 ** 33 + 21
ACC_SHAPES = ((4096, 12288), (1000, 1000))  # DreamerV3 XL's W_hh; a DreamerV2 1000-wide Dense
ACC_SOURCE = "pydreamer_tpu_torch/ops/csrc/accumulate.cu"


def per_call_grads(model, obs, state, step: int) -> dict:
    """The per-call path's gradients by leaf name: ``training_step`` and
    ``backward()`` outside a ``TrainStep`` update, so that each use casts its
    weight itself, on ``TrainStep``'s own noise of ``(COPY_SEED, step)``."""
    from pydreamer_tpu_torch.training.train_step import noise_seed

    model.zero_grad(set_to_none=True)
    losses, *_ = model.training_step(obs, state, GeneratorNoise(
        model.device, seed=noise_seed(COPY_SEED, step)))
    sum(losses.values()).backward()
    return {n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in model.named_parameters() if p.requires_grad}


def check_accumulate(rs: RunState, acc, g, what: str) -> None:
    """``accumulate_``, the wrapper the path runs, against torch's ``add_``:
    equal."""
    from pydreamer_tpu_torch.ops.accumulate import accumulate_

    want, got = acc.clone().add_(g), acc.clone()
    accumulate_(got, g)
    if not torch.equal(got, want):
        raise AssertionError(f"[21] accumulate at {what}: {(got - want).abs().max().item()} "
                             f"off torch's add_")


def leaf_accumulates(rs: RunState, leaves) -> dict:
    """``check_accumulate`` at the shape of every leaf the step copies (the
    shapes the path accumulates into: biases, convs, LayerNorms' affine
    maps, Dense and GRU weights), and at the first 2-D one with a transposed
    addend (the wrapper's copy to a dense one). Returns the shapes checked
    and how many of them end in a tail of n % 8 elements."""
    shapes = sorted({tuple(p.shape) for p in leaves})
    for shape in shapes:
        acc = torch.randn(shape, generator=rs.gen, device=rs.device)
        check_accumulate(rs, acc, torch.randn(shape, generator=rs.gen, device=rs.device)
                         .bfloat16(), str(shape))
    rows, cols = next(shape for shape in shapes if len(shape) == 2)
    acc = torch.randn(rows, cols, generator=rs.gen, device=rs.device)
    check_accumulate(rs, acc, torch.randn(cols, rows, generator=rs.gen, device=rs.device)
                     .bfloat16().t(), f"{(rows, cols)}, addend transposed")
    return dict(shapes=len(shapes), tail_shapes=sum(math.prod(s) % 8 != 0 for s in shapes))


def path_accumulate_ms(rs: RunState, by_numel: dict) -> dict:
    """One step's accumulations as the path makes them (``ACCUMULATES.by_numel``
    of one step: that many launches at each size), timed in one graph with the
    kernel and with torch's mixed-dtype ``add_`` (L2 not flushed between
    launches), and their bound: 10 bytes an element at the card's HBM peak."""
    from pydreamer_tpu_torch.ops.accumulate import ACCUMULATES, accumulate_

    device = rs.device
    bufs = [(torch.randn(n, generator=rs.gen, device=device),
             torch.randn(n, generator=rs.gen, device=device).bfloat16(), count)
            for n, count in sorted(by_numel.items())]

    def run(add):
        for acc, g, count in bufs:
            for _ in range(count):
                add(acc, g)

    ms = time_ms(lambda: run(accumulate_), 2)
    plain_ms = time_ms(lambda: run(lambda acc, g: acc.add_(g)), 2)
    ACCUMULATES.reset()
    nbytes = 10 * sum(n * count for n, count in by_numel.items())
    del bufs
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, bytes=nbytes, bound_ms=nbytes / rs.peaks[0] * 1e3)


def accumulate_rows(rs: RunState) -> list:
    """The accumulate kernel at ``ACC_SHAPES``: the wrapper's sums against
    torch's mixed-dtype ``add_`` (equal), both timed (L2 flushed before each
    call), GB/s at 10 bytes an element against the card's HBM peak."""
    from pydreamer_tpu_torch.ops.accumulate import accumulate_

    device, gen, bw = rs.device, rs.gen, rs.peaks[0]
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=device).zero_
    rows = []
    for shape in ACC_SHAPES:
        acc = torch.randn(shape, generator=gen, device=device)
        g = torch.randn(shape, generator=gen, device=device).bfloat16()
        check_accumulate(rs, acc, g, str(shape))
        nbytes = 10 * acc.numel()
        row = dict(shape=list(shape), bytes=nbytes)
        for name, fn in (("kernel", lambda: accumulate_(acc, g)),
                         ("torch_add", lambda: acc.add_(g))):
            ms = time_ms(fn, 20, flush)
            row[f"{name}_ms"], row[f"{name}_gbps"] = ms, nbytes / ms / 1e6
            row[f"{name}_of_hbm"] = nbytes / (ms * 1e-3) / bw
        row["bound_ms"] = nbytes / bw * 1e3
        rows.append(row)
        print(f"[21] accumulate {shape}: kernel {row['kernel_ms']:.4f} ms, "
              f"{row['kernel_gbps']:.0f} GB/s ({100 * row['kernel_of_hbm']:.1f}% of "
              f"{bw / 1e12:.2f} TB/s); torch add_ {row['torch_add_ms']:.4f} ms, "
              f"{row['torch_add_gbps']:.0f} GB/s ({100 * row['torch_add_of_hbm']:.1f}%)",
              flush=True)
    return rows


def copies_phase(rs: RunState) -> None:
    """21. The step's weight copies (``models/modules.py`` ``WeightCopies``,
    ``CopyUse``) at the three cells' widths (``flagship_conf``, ``dmc_conf``,
    ``dv3_conf``): two models from the same weights; one trains through its
    ``TrainStep`` as it runs, with the clip off (an infinite max norm, so
    ``.grad`` is what ``backward()`` left), eager at step 1 (the copies made),
    captured and replayed at step 2, replayed at 3; before each step the
    other takes its weights and runs the per-call path (``per_call_grads``).
    Every leaf's gradient is held equal (``torch.equal``) after each step;
    each step counts one cast per copy, no per-call cast, and the same
    accumulate launches (``ACCUMULATES``, at most one a use). Then the
    wrapper against ``add_`` at every leaf's shape (``leaf_accumulates``),
    one step's accumulations timed (``path_accumulate_ms``), and the kernel
    at ``ACC_SHAPES`` (``accumulate_rows``)."""
    from pydreamer_tpu_torch.ops.accumulate import ACCUMULATES
    from pydreamer_tpu_torch.tracing import COUNTERS

    device, out = rs.device, {}
    for label, cfg in (("atari_dv2", flagship_conf()), ("dmc_dv2", dmc_conf()),
                       ("atari_dv3_xl", dv3_conf())):
        conf = Conf(cfg)
        torch.manual_seed(21)
        model, ref = Dreamer(conf, device=device), Dreamer(conf, device=device)
        ts = TrainStep(model, conf, device=device)
        ts.clips = {k: math.inf for k in ts.clips}
        obs = make_obs(conf, rs.gen, device)
        rows = []
        for step in (1, 2, 3):
            ref.load_state_dict(model.state_dict())
            state = model.init_state(conf.batch_size)
            want = per_call_grads(ref, obs, state, step)
            before = (COUNTERS.graph_captures, COUNTERS.graph_replays)
            COUNTERS.weight_casts = COUNTERS.weight_copies = COUNTERS.weight_copy_uses = 0
            ACCUMULATES.reset()
            ts(obs, state, step, seed=COPY_SEED)
            torch.cuda.synchronize()
            how = {(0, 0): "eager", (1, 1): "capture+replay", (0, 1): "replay"}[
                (COUNTERS.graph_captures - before[0], COUNTERS.graph_replays - before[1])]
            differ = [n for n, p in model.named_parameters()
                      if p.requires_grad and not torch.equal(p.grad, want[n])]
            row = dict(step=step, how=how, casts=COUNTERS.weight_casts,
                       copies=COUNTERS.weight_copies, uses=COUNTERS.weight_copy_uses,
                       leaves=len(ts.copies), accumulates=ACCUMULATES.count,
                       by_numel=dict(ACCUMULATES.by_numel), differ=differ)
            rows.append(row)
            if (differ or not row["casts"] == row["copies"] == row["leaves"] > 0
                    or not 0 < row["accumulates"] <= row["uses"]
                    or (row["accumulates"], row["by_numel"]) != (rows[0]["accumulates"],
                                                                 rows[0]["by_numel"])):
                raise AssertionError(f"[21] {label} step {step} ({how}): {row}")
        if [r["how"] for r in rows] != ["eager", "capture+replay", "replay"]:
            raise AssertionError(f"[21] {label}: steps ran {[r['how'] for r in rows]}")
        leaves = leaf_accumulates(rs, ts.copies.copies)
        timed = path_accumulate_ms(rs, rows[0]["by_numel"])
        out[label] = dict(steps=rows, leaf_shapes=leaves, step_accumulates=timed)
        print(f"[21] {label}: gradients equal to the per-call path's after an eager step, a "
              f"capture + replay and a replay; {rows[0]['leaves']} copies, "
              f"{rows[0]['uses']} uses and {rows[0]['accumulates']} accumulate launches a step; "
              f"the wrapper equal to add_ at {leaves['shapes']} leaf shapes "
              f"({leaves['tail_shapes']} with a tail); one step's accumulations "
              f"{timed['ms']:.3f} ms (add_ {timed['plain_ms']:.3f} ms, bound "
              f"{timed['bound_ms']:.3f} ms)", flush=True)
        del model, ref, ts
        torch.cuda.empty_cache()
    if not any(out[label]["leaf_shapes"]["tail_shapes"] for label in out):
        raise AssertionError("[21] no leaf shape has a tail of n % 8 elements")
    out["accumulate"] = accumulate_rows(rs)
    rs.report["copies"] = out


K2_SOURCE = "pydreamer_tpu_torch/ops/csrc/block_gru.cu"
K2_GRAD_NAMES = ("h", "x", "w_hid", "b_hid", "scale", "w_gru", "b_gru")
K2_FWD_FLOOR = 2e-3  # max-abs on h': K2 may differ from the float32 plain version by the bf16
                     # plain version's own distance from it (its products rounded to bf16), or this
K2_BWD_CAP = 5e-2    # each gradient of the bf16 recompute against float32 autograd, relative to its
                     # max: a sanity bound, printed; the recompute itself is held bit for bit


# K2's shapes (M, D, X, blocks, schedule): ``dreamerv3_200m``'s, on the path
# (M=16 the posterior loop, M=1024 the dream), then the source's size25m
# (deter 3072, hidden 384: Hb 384), which no path runs, for the 128-wide
# tiles that Hb 384 takes.
K2_SHAPES = ((16, 8192, 3 * 1024, 8, "skinny"), (1024, 8192, 3 * 1024, 8, "wide"),
             (16, 3072, 3 * 384, 8, "skinny"), (1024, 3072, 3 * 384, 8, "wide128"))
K2_PATH_D = 8192


def k2_inputs(M, D, X, blocks, gen, device):
    """bf16 operands of K2 at Xavier scale, f32 biases and scale."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)
    Hb = D // blocks
    bf16 = torch.bfloat16
    return (torch.tanh(randn(M, D)).to(bf16), torch.nn.functional.silu(randn(M, X)).to(bf16),
            (randn(Hb + X, D) / math.sqrt(Hb + X)).to(bf16), 0.1 * randn(D), 1.0 + 0.1 * randn(D),
            (randn(Hb, 3 * D) / math.sqrt(Hb)).to(bf16), 0.1 * randn(3 * D))


def k2_gemms(h, x, w_hid, w_gru, blocks):
    """cuBLAS on K2's operands: the same three products (h's blocks, x
    against every block, y's blocks), bf16 out, and nothing else."""
    from pydreamer_tpu_torch.ops.block_gru import block_mm
    Hb = h.shape[1] // blocks
    y = block_mm(h, w_hid[:Hb], blocks) + x @ w_hid[Hb:]
    return block_mm(y, w_gru, blocks)


def k2_phase(rs: RunState) -> None:
    """22. Kernel K2 (``ops/csrc/block_gru.cu``) at ``K2_SHAPES``: the
    ``dreamerv3_200m`` shapes (D=8192 in 8 blocks, X=3x1024), ``skinny`` at
    M=16 (the posterior loop) and ``wide`` at M=1024 (the dream), and
    size25m's (D=3072, X=3x384), ``skinny`` and ``wide128``. The forward against the plain
    version in float32 on the same bf16 operands, within the bf16 plain
    version's own distance from it or ``K2_FWD_FLOOR``; the seven gradients
    of ``BlockGRUFunction``'s backward bit for bit autograd's through the
    plain version at bf16, and their distance from float32 autograd printed
    (at most ``K2_BWD_CAP``). Timed (CUDA graphs, cold L2) beside its bound
    (``benchmark/k2_bound.py``), the plain version's time and cuBLAS's for
    the same three products alone; the forward and backward by CUDA events.
    Each K2 call counts once in ``K2_LAUNCHES`` at its rows."""
    from benchmark.k2_bound import k2_bound_ms
    from pydreamer_tpu_torch.models.modules import RMS_EPS
    from pydreamer_tpu_torch.ops import block_gru as k2

    gen, device, peaks = rs.gen, rs.device, rs.peaks
    t0 = time.time()
    lib = k2.gru_dv2.build(k2.SOURCE)
    build_s = time.time() - t0
    ptxas = [ln for ln in lib.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[22] built {lib.name} in {build_s:.1f} s", *ptxas, sep="\n    ", flush=True)
    flush_buf = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=device)
    rows = []
    for M, D, X, blocks, want in K2_SHAPES:
        ins = k2_inputs(M, D, X, blocks, gen, device)
        p = k2.plan(M, D, X, blocks)
        if p.schedule != want:
            raise AssertionError(f"[22] M={M} D={D}: plan {p}, expected {want}")
        before = k2.K2_LAUNCHES.by_rows.get(M, 0)
        out = k2.block_gru_cuda(*ins, blocks, RMS_EPS)
        if k2.K2_LAUNCHES.by_rows.get(M, 0) != before + 1:
            raise AssertionError(f"[22] M={M}: K2_LAUNCHES {k2.K2_LAUNCHES.by_rows}")
        f32 = k2.block_gru_reference(*(t.float() for t in ins), blocks, RMS_EPS)
        plain_bf16 = k2.block_gru_reference(*ins, blocks, RMS_EPS)
        err, witness = (out - f32).abs().max().item(), (plain_bf16 - f32).abs().max().item()
        limit = max(witness, K2_FWD_FLOOR)
        if not math.isfinite(err) or err > limit:
            raise AssertionError(f"[22] M={M} D={D}: forward max-abs err {err} > {limit}")
        grad_out = torch.randn(M, D, generator=gen, device=device)
        leaves = [t.clone().requires_grad_() for t in ins]
        got = torch.autograd.grad(k2.BlockGRUFunction.apply(*leaves, blocks, RMS_EPS),
                                  leaves, grad_out)
        same = torch.autograd.grad(k2.block_gru_reference(*leaves, blocks, RMS_EPS), leaves,
                                   grad_out)
        f32_leaves = [t.float().requires_grad_() for t in ins]
        ref = torch.autograd.grad(k2.block_gru_reference(*f32_leaves, blocks, RMS_EPS),
                                  f32_leaves, grad_out)
        errs = {}
        for name, a, b, r in zip(K2_GRAD_NAMES, got, same, ref):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"[22] M={M} D={D} grad {name}: not the plain recompute's")
            errs[name] = rel_err(a, r)
            if not errs[name] <= K2_BWD_CAP:
                raise AssertionError(f"[22] M={M} D={D} grad {name}: rel err {errs[name]} > "
                                     f"{K2_BWD_CAP}")
        iters = 20 if M <= 64 else 10
        ms = time_ms(lambda: k2.block_gru_cuda(*ins, blocks, RMS_EPS), iters, flush_buf.zero_)
        plain_ms = time_ms(lambda: k2.block_gru_reference(*ins, blocks, RMS_EPS), iters,
                           flush_buf.zero_)
        gemm_ms = time_ms(lambda: k2_gemms(ins[0], ins[1], ins[2], ins[5], blocks), iters,
                          flush_buf.zero_)
        bound, bound_by = k2_bound_ms(M, D, X, blocks, peaks)

        def fwd_bwd():
            leaves = [t.clone().requires_grad_() for t in ins]
            (k2.BlockGRUFunction.apply(*leaves, blocks, RMS_EPS) * grad_out).sum().backward()
        for _ in range(2):
            fwd_bwd()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(5):
            fwd_bwd()
        end.record()
        torch.cuda.synchronize()
        res = dict(M=M, D=D, X=X, blocks=blocks, schedule=p.schedule, plan=vars(p),
                   max_abs_err=err, witness=witness, limit=limit, grads_rel_err=errs, ms=ms,
                   plain_ms=plain_ms, gemm_library_ms=gemm_ms, bound_ms=bound, bound_by=bound_by,
                   fwd_bwd_ms=start.elapsed_time(end) / 5)
        rows.append(res)
        print(f"[22] K2 {p.schedule} M={M} D={D} X={X} g={blocks} {vars(p)}: {ms:.5f} ms cold L2, "
              f"bound {bound:.5f} ({bound_by}, {100 * bound / ms:.1f}%), plain {plain_ms:.5f}, "
              f"cuBLAS products alone {gemm_ms:.5f}; forward err {err:.3e} (bf16 plain "
              f"{witness:.3e}); grads vs f32 "
              + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
              + f"; forward+backward {res['fwd_bwd_ms']:.3f} ms", flush=True)
    rs.report["k2"] = dict(build_s=build_s, rows=rows)


def dv3_200m_graph_phase(rs: RunState) -> None:
    """23. The ``dreamerv3_200m`` step (``dv3_200m_conf``, kernel K2)
    replayed from CUDA graphs against the eager step, as 19 does at XL, but
    bit for bit: losses, gradient norms, out-state, return statistics and
    every parameter equal after each of the six steps. Each call, replayed
    or eager, counts T K2 calls at M=B and H at M=T*B in ``K2_LAUNCHES``,
    and no K1 backward; the profiled replay records K2's kernels and no
    K1's."""
    graphs_vs_eager(rs, (("atari_dv3_200m", dv3_200m_conf()),), "23", "graphs_dv3_200m",
                    core="k2")


DW_STEPS = 6  # phase 24's steps a width: eager, capture + replay, then replays
DW_SEED = 2 ** 33 + 24
DW_GAP_LIMIT = 2.0 ** -7  # K1's batched dW against the per-call one, relative to the latter's
                          # max: twice bf16's spacing. Set from the gaps first read on the H100 at
                          # the DMC widths and XL's step 1, 2.1e-3 to 3.2e-3 (the per-call path's
                          # 48-64 bf16 roundings); XL's steps 2-6 then read up to 5.2e-3


@contextlib.contextmanager
def per_call_dw():
    """K1's weight gradient made by each call, as before the posterior loop
    summed it once: ``RSSMCore.forward``'s loop run without ``dw_batches()``."""
    from pydreamer_tpu_torch.models import rssm

    saved = rssm.dw_batches
    rssm.dw_batches = contextlib.nullcontext
    try:
        yield
    finally:
        rssm.dw_batches = saved


def dw_product_ms(rs: RunState, T: int, M: int, In: int, H: int) -> dict:
    """The loop's one sum (``DWBatch.sum``'s two products over T*M rows) and
    the T per-call products it replaces, timed (CUDA graphs, L2 warm), beside
    the sum's bound: its operations at the card's bf16 rate."""
    gen, device = rs.gen, rs.device
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=device).bfloat16()
    X, Hs, dG = randn(T * M, In), randn(T * M, H), randn(T * M, 3 * H)
    rows = [slice(t * M, (t + 1) * M) for t in range(T)]
    ms = time_ms(lambda: (k1._dw(X, dG), k1._dw(Hs, dG)), 10)
    per_call_ms = time_ms(lambda: [(k1._dw(X[r], dG[r]), k1._dw(Hs[r], dG[r])) for r in rows], 2)
    flops = 2 * T * M * (In + H) * 3 * H
    return dict(T=T, M=M, In=In, H=H, ms=ms, per_call_ms=per_call_ms, gflop=flops / 1e9,
                bound_ms=flops / rs.peaks[1] * 1e3)


def dw_batch_phase(rs: RunState) -> None:
    """24. K1's weight gradient summed once over the posterior loop
    (``ops/gru_dv2.py`` ``DWBatch``, ``DWSum``) at the ``dmc_dv2`` and
    ``atari_dv3_xl`` widths (``dmc_conf``, ``dv3_conf``): two models from the
    same weights, one training through its ``TrainStep`` as it runs (eager at
    step 1, captured and replayed at 2, replayed from 3), one through an eager
    ``TrainStep`` with K1's dW made per call (``per_call_dw``), its weights
    reset to the first's before each of ``DW_STEPS`` steps; the clip off, so
    ``.grad`` is what ``backward()`` left. Per step: the K1 gate weights'
    gradients against the per-call path's (``rel_err``, held to
    ``DW_GAP_LIMIT``; the norm-relative gap printed too), every other gradient
    equal bit for bit; ``K1_DW``: T batched calls and one sum a step on the
    first (a replay credits them), T per-call calls on the other;
    ``ACCUMULATES.by_numel`` at the K1 weights' sizes: each K1 weight added
    once a step in place of T times (another leaf of the same size, as XL's
    ``post_mlp_e`` beside ``weight_ih``, keeps its own adds). Then the sum's
    products timed at each width beside their bound and the per-call products
    they replace (``dw_product_ms``), and phase 17's check of the graphed step
    against the eager one over six steps at both widths (``graphs_vs_eager``)."""
    from pydreamer_tpu_torch.ops.accumulate import ACCUMULATES
    from pydreamer_tpu_torch.tracing import COUNTERS

    device, out = rs.device, {}
    for label, cfg in (("dmc_dv2", dmc_conf()), ("atari_dv3_xl", dv3_conf())):
        conf = Conf(cfg)
        T, B = conf.batch_length, conf.batch_size
        torch.manual_seed(24)
        models = {"batched": Dreamer(conf, device=device), "per_call": Dreamer(conf, device=device)}
        steps = {k: TrainStep(m, conf, device=device) for k, m in models.items()}
        steps["per_call"].graphs = None
        for ts in steps.values():
            ts.clips = {k: math.inf for k in ts.clips}
        params = {k: dict(m.named_parameters()) for k, m in models.items()}
        names = [n for n in params["batched"] if ".gru." in n and n.endswith(("_ih", "_hh"))]
        numels = [params["batched"][n].numel() for n in names]
        k1_weights = {n: numels.count(n) for n in sorted(set(numels))}  # of each size
        rows = []
        for step in range(1, DW_STEPS + 1):
            obs = make_obs(conf, rs.gen, device)
            models["per_call"].load_state_dict(models["batched"].state_dict())
            state = models["batched"].init_state(B)
            row = dict(step=step)
            for key in ("per_call", "batched"):
                k1.K1_DW.reset()
                ACCUMULATES.reset()
                before = (COUNTERS.graph_captures, COUNTERS.graph_replays)
                with per_call_dw() if key == "per_call" else contextlib.nullcontext():
                    steps[key](obs, state, step, seed=DW_SEED)
                torch.cuda.synchronize()
                row[key] = dict(
                    how={(0, 0): "eager", (1, 1): "capture+replay", (0, 1): "replay"}[
                        (COUNTERS.graph_captures - before[0], COUNTERS.graph_replays - before[1])],
                    by_path=dict(k1.K1_DW.by_path), products=k1.K1_DW.products,
                    adds={n: ACCUMULATES.by_numel.get(n, 0) for n in k1_weights})
            got, want = params["batched"], params["per_call"]
            row["gap"] = {n: rel_err(got[n].grad, want[n].grad) for n in names}
            row["norm_gap"] = {n: ((got[n].grad - want[n].grad).norm()
                                   / want[n].grad.norm()).item() for n in names}
            row["differ"] = [n for n, p in got.items() if p.requires_grad and n not in names
                             and not torch.equal(p.grad, want[n].grad)]
            rows.append(row)
            print(f"[24] {label} step {step} ({row['batched']['how']}): K1 dW gap to the per-call "
                  f"path {row['gap']} (norm {row['norm_gap']}); adds a step by size "
                  f"{row['batched']['adds']} against {row['per_call']['adds']}; K1_DW "
                  f"{row['batched']['by_path']}, {row['batched']['products']} sums", flush=True)
            batched, per_call = row["batched"], row["per_call"]
            if (row["differ"] or (batched["by_path"], batched["products"]) != ({"batched": T}, 1)
                    or (per_call["by_path"], per_call["products"]) != ({"per_call": T}, 0)
                    or any(per_call["adds"][n] - batched["adds"][n] != (T - 1) * k
                           or batched["adds"][n] < k for n, k in k1_weights.items())
                    or not all(math.isfinite(g) for g in row["gap"].values())
                    or max(row["gap"].values()) > DW_GAP_LIMIT):
                raise AssertionError(f"[24] {label} step {step}: {row} (limit {DW_GAP_LIMIT})")
        if [r["batched"]["how"] for r in rows[:3]] != ["eager", "capture+replay", "replay"]:
            raise AssertionError(f"[24] {label}: steps ran {[r['batched']['how'] for r in rows]}")
        cell = models["batched"].wm.core.cell.gru.cell_0
        product = dw_product_ms(rs, T, B, cell.weight_ih.shape[0], cell.hidden_size)
        out[label] = dict(steps=rows, product=product,
                          worst_gap=max(max(r["gap"].values()) for r in rows))
        print(f"[24] {label}: worst K1 dW gap {out[label]['worst_gap']:.3e} (limit "
              f"{DW_GAP_LIMIT:.3e}); the sum's products over {T * B} rows {product['ms']:.4f} ms, "
              f"bound {product['bound_ms']:.4f} ms ({product['gflop']:.1f} GFLOP, "
              f"{100 * product['bound_ms'] / product['ms']:.1f}%); the {T} per-call products "
              f"{product['per_call_ms']:.4f} ms", flush=True)
        del models, steps, params
        torch.cuda.empty_cache()
    rs.report["dw_batch"] = out
    graphs_vs_eager(rs, (("dmc_dv2", dmc_conf()), ("atari_dv3_xl", dv3_conf())), "24",
                    "graphs_dw")


def finish(rs: RunState, marks: list) -> int:
    """The kernels line (one entry per timed K1 row: its launches on the paths
    that ran its shape, per train step or acting call; then one per timed
    shape and gradient set of K1's backward, phase 20, with the calls that
    phases 4, 9 and 19b counted; then the accumulate kernel's, phase 21: one
    step's launches at each preset, and the two timed shapes, with the
    launches phase 21's steps made at their size), the nvidia-smi line and
    the last line.
    ``marks``: (phase, start time) in run order."""
    report = rs.report
    kernels = []
    for r in report["k1"]:
        n, steps = rs.path.get((r["schedule"], r["M"], r["H"]), (0, 0))
        common = dict(route="cuda", source=K1_SOURCE, replaces=K1_REPLACES, bound_ms=r["bound_ms"],
                      bound_by=r["bound_by"], bound_route=r["bound_route"], plain_ms=r["plain_ms"],
                      library_ms=r["gemm_library_ms"], unfused_ms=r["unfused_ms"])
        kernels.append(dict(name=f"gru_dv2.{r['schedule']}[M={r['M']},H={r['H']},{r['dtype']}]",
                            launches=n, launches_per_step=n / steps if n else 0,
                            max_abs_err=r["max_abs_err"], ms=r["ms"], ms_l2_warm=r["ms_l2_warm"],
                            **common))
        for first, sched in (("generic", "generic"), ("f32_ffma", "f32")):
            if f"{first}_ms" in r:  # the dtype's first design at the same shape: no path runs it
                kernels.append(dict(name=f"gru_dv2.{sched}[M={r['M']},H={r['H']},{r['dtype']}]",
                                    launches=0, launches_per_step=0,
                                    max_abs_err=r[f"{first}_max_abs_err"], ms=r[f"{first}_ms"],
                                    **common))
    bwd_path = report.get("k1_backward_path", {})
    for r in report.get("k1_backward", []):
        # The path's gradient set: all six in the posterior loop, x and h alone
        # in the dream (only actor_grad: dynamics differentiates it).
        on_path = "x_h" if "ms_x_h" in r else "all"
        for label in ("all", "x_h"):
            if f"ms_{label}" not in r:
                continue
            n, steps = bwd_path.get(f"M={r['M']},H={r['H']}", (0, 0)) if label == on_path else (0, 0)
            kernels.append(dict(
                name=f"gru_dv2.k1_backward.{label}[M={r['M']},H={r['H']},bfloat16]", launches=n,
                launches_per_step=n / steps if n else 0,
                max_rel_err=max(e["err"] for e in r[f"grads_{label}"].values()),
                ms=r[f"ms_{label}"], route="cuda", source=K1_SOURCE, replaces=K1_BWD_REPLACES,
                bound_ms=r[f"bound_ms_{label}"], bound_by=r[f"bound_by_{label}"],
                plain_ms=r[f"plain_ms_{label}"]))
    k2_path = report.get("k2_path", {})
    for r in report.get("k2", {}).get("rows", []):  # phase 22, with phase 23's calls
        n, steps = k2_path.get(r["M"], (0, 0)) if r["D"] == K2_PATH_D else (0, 0)
        kernels.append(dict(
            name=f"block_gru.{r['schedule']}[M={r['M']},D={r['D']},g={r['blocks']},bfloat16]",
            launches=n, launches_per_step=n / steps if n else 0, max_abs_err=r["max_abs_err"],
            ms=r["ms"], route="cuda", source=K2_SOURCE, replaces=None, bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], plain_ms=r["plain_ms"], library_ms=r["gemm_library_ms"]))
    copies = report.get("copies", {})
    for label, r in copies.items():  # one step's accumulations at each preset, phase 21
        if label != "accumulate":
            steps = r["steps"]
            kernels.append(dict(
                name=f"accumulate.add_bf16_into_f32[{label},step]",
                launches=sum(s["accumulates"] for s in steps),
                launches_per_step=steps[0]["accumulates"], ms=r["step_accumulates"]["ms"],
                route="cuda", source=ACC_SOURCE, replaces=None,
                bound_ms=r["step_accumulates"]["bound_ms"], bound_by="bytes",
                plain_ms=r["step_accumulates"]["plain_ms"]))
    for r in copies.get("accumulate", []):
        numel = math.prod(r["shape"])
        on_path = [s for label, c in copies.items() if label != "accumulate" for s in c["steps"]]
        n = sum(s["by_numel"].get(numel, 0) for s in on_path)
        kernels.append(dict(
            name=f"accumulate.add_bf16_into_f32[{'x'.join(map(str, r['shape']))}]", launches=n,
            launches_per_step=n / len(on_path) if n else 0, ms=r["kernel_ms"], route="cuda",
            source=ACC_SOURCE, replaces=None, bound_ms=r["bound_ms"], bound_by="bytes",
            plain_ms=r["torch_add_ms"]))
    marks = [*marks, ("end", time.perf_counter())]
    report["phase_s"] = {str(a): b_t - a_t for (a, a_t), (_, b_t) in zip(marks, marks[1:])}
    print(f"[t] seconds by phase: { {k: round(v, 1) for k, v in report['phase_s'].items()} }; "
          f"total {marks[-1][1] - marks[0][1]:.1f}")
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(rs.smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": rs.name,
                                             "count": torch.cuda.device_count()}}))
    return 0


# The phases in run order, by number (the keys of ``report["phase_s"]``).
PHASES = ((1, build_phase), (2, schedules_phase), (3, fused_forward_phase), (4, train_step_phase),
          (5, profile_phase), (6, turns_phase), (7, acting_shapes_phase), (8, dmc_fused_phase),
          (9, dmc_step_phase), (10, inference_phase), (11, learner_phase), (12, generator_phase),
          (13, probe_phase), (14, mesh_phase), (15, learning_phase), (16, tools_phase),
          (17, graph_phase), (18, dv3_k1_phase), (19, dv3_graph_phase), (20, k1_backward_phase),
          (21, copies_phase), (22, k2_phase), (23, dv3_200m_graph_phase), (24, dw_batch_phase))

# What each flag runs instead: phase numbers, or (number, options) for a phase
# that a flag runs with options.
ONLY = {
    "--learning-only": (1, 15),
    "--tools-only": (1, (2, {"flagship_only": True}), (16, {"with_e2e": True})),
    "--graph-only": (1, 17),
    "--dv3-only": (1, 18, 19),
    "--backward-only": (1, 20),
    "--copies-only": (1, 21),
    "--k2-only": (1, 22, 23),
    "--dw-only": (1, 24),
}


def plan(argv: list) -> list | None:
    """(number, phase, options) in run order for ``argv``: every phase
    without an argument, a flag's phases with one flag of ``ONLY``, None for
    anything else."""
    if not argv:
        return [(n, phase, {}) for n, phase in PHASES]
    if len(argv) != 1 or argv[0] not in ONLY:
        return None
    phases = dict(PHASES)
    rows = [row if isinstance(row, tuple) else (row, {}) for row in ONLY[argv[0]]]
    return [(n, phases[n], options) for n, options in rows]


def usage() -> str:
    """The usage line: each flag with the phases it runs."""
    said = "; ".join(f"{flag}: phases " + ", ".join(
        f"{n}" + (f" ({', '.join(options)})" if options else "") for n, _, options in plan([flag]))
        for flag in ONLY)
    return f"usage: chip_smoke.py [{' | '.join(ONLY)}]  ({said})"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    phases = plan(argv)
    if phases is None:
        print(usage(), file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; it needs a CUDA card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version runs full f32
    torch.backends.cudnn.allow_tf32 = False
    OUT_DIR.mkdir(exist_ok=True)
    rs, marks = RunState(), []
    for n, phase, options in phases:
        marks.append((n, time.perf_counter()))
        phase(rs, **options)
    return finish(rs, marks)


if __name__ == "__main__":
    sys.exit(main())
