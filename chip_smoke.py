#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``pydreamer_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught to carry on):

1. Build kernel K1 (``ops/csrc/gru_dv2.cu``, nvcc for sm_90a) and print the
   card's name and power limit as nvidia-smi reports them.
2. Hold every K1 schedule against its plain PyTorch version: forward max-abs
   error and the gradients of all six inputs. ``skinny`` and ``wide`` at the
   two main-path shapes (M=32 and M=1536 rows, In=1000, H=1024, bf16) and at
   H=2048 (the ``defaults`` width), ``generic`` at small ragged shapes, ``f32``
   at both main-path row counts in float32. Time each (CUDA graphs of many
   launches, cold and warm L2) beside its bound, the plain version, the
   cuBLAS product of the concatenated operands (``gemm_library_ms``), the
   unfused composition the ``gru_layernorm_dv2_xla`` cell runs
   (``unfused_ms``), and, at the main-path shapes, the ``generic`` schedule
   (the first, unpipelined design). The port calls none of these yardsticks. Then the fused
   cell under ``precision: float32`` on the card: it must take ``f32``.
3. Check the train step's forward at full width with the K1 cell against the
   unfused ``gru_layernorm_dv2_xla`` cell (same weights, same noise).
4. Drive the main path: the flagship Dreamer/Atari train step
   (T=48, B=32, deter 1024, stoch 32x32, hidden 1000, cnn_depth 48, H=15,
   bf16 compute, uint8 images, gru_type gru_layernorm_dv2) from random
   weights made from a seed: 2 warm-up and 5 timed TrainStep calls. The K1
   launch counter is set to 0 just before and read just after: T launches a
   step must have taken ``skinny`` and H ``wide``, none ``generic``.
5. Profile one more step with torch.profiler: K1's kernels, device time and
   launches, and the device's busy time in the step.
6. Time the train step with the K1 cell against the unfused cell, in turns
   (unfused, K1, K1, unfused; 5 steps per window).
7. Inference shapes: hold ``skinny`` at M=1 and M=8 (In=1000, H=2048, bf16)
   against its plain version, forward and six gradients, timed as in 2.
8. The DMC path (``defaults`` + ``dmc``: deter 2048, action_dim 12,
   ``actor_grad: dynamics``, ``actor_dist: trunc_normal``; DMC below is its
   own copy): one forward and backward with the K1 cell and with the unfused
   cell from the same weights and noise; the four losses and the actor's
   gradient norm must agree. K1's backward runs at M=1536, H=2048 here.
9. Drive the DMC train step: 2 warm-up and 5 timed TrainStep calls, counts
   set to 0 just before and read just after (48 ``skinny`` and 15 ``wide`` a
   step, none ``generic``), a finite non-zero actor gradient norm, and no
   world-model gradient from the actor loss alone. Then one log step
   (``do_image_pred``, ``do_dream_tensors``: 48 + 47 skinny, 15 wide, finite
   dream tensors of JAX's shapes) and one profiled step: busy time, K1's
   kernels and the f32 GEMMs of K1's backward recompute.
10. ``Dreamer.inference`` on the DMC model at B=1 and B=8: one ``skinny``
   launch a call, finite actions in [-1, 1], host microseconds per call.

Prints one JSON line of per-kernel numbers (``launches``: the count on the
path that runs the shape, ``launches_per_step``: per train step or acting
call), then the nvidia-smi line, then
as the last line ``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json`` and ``chiprun_out/chip_smoke_profile.txt``.
This script imports nothing of JAX or of the JAX package; the flagship
config below is its own copy.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"

# Flagship Dreamer/Atari config (config/defaults.yaml `defaults` + `atari`),
# with the DreamerV2 late-reset GRU cell so the train step runs kernel K1.
FLAGSHIP = dict(
    image_key="image", image_size=64, image_channels=3, image_categorical=False,
    action_dim=18, clip_rewards="tanh", vecobs_size=0,
    map_key=None, map_size=0, map_channels=0, map_categorical=True, goals_size=0,
    model="dreamer", deter_dim=1024, stoch_dim=32, stoch_discrete=32, hidden_dim=1000,
    gru_layers=1, gru_type="gru_layernorm_dv2", layer_norm=True,
    image_encoder="cnn", cnn_depth=48, image_encoder_layers=0,
    image_decoder="cnn", image_decoder_layers=0, image_decoder_min_prob=0.0,
    reward_input=False, reward_decoder_layers=4,
    reward_decoder_categorical=None, terminal_decoder_layers=4,
    probe_model="none", probe_gradients=False,
    iwae_samples=1, kl_balance=0.8, kl_weight=0.1,
    image_weight=1.0, vecobs_weight=1.0, reward_weight=1.0, terminal_weight=1.0,
    adam_lr=3e-4, adam_lr_actor=1e-4, adam_lr_critic=1e-4, adam_eps=1e-5,
    keep_state=True, batch_length=48, batch_size=32,
    grad_clip=200.0, grad_clip_ac=200.0, precision="bfloat16",
    gamma=0.99, lambda_gae=0.95, entropy=1e-3, target_interval=100,
    imag_horizon=15, actor_grad="reinforce", actor_dist="onehot",
    aux_critic=False, aux_critic_weight=1.0, gamma_aux=0.99,
    lambda_gae_aux=0.95, target_interval_aux=1000,
)

# `defaults` + `dmc` (config/defaults.yaml): the defaults' width (deter 2048,
# kl_weight 1.0, gamma 0.995) with the DMC policy: 12 continuous actions, the
# dynamics gradient through the dream, the truncated-normal head.
DMC = dict(FLAGSHIP, deter_dim=2048, action_dim=12, kl_weight=1.0, gamma=0.995, entropy=1e-4,
           actor_grad="dynamics", actor_dist="trunc_normal")

# Dense peak rates from NVIDIA's data sheets: (bytes/s, bf16 tensor FLOP/s,
# fp32 non-tensor FLOP/s), at the card's full power limit.
PEAKS = {
    "H100 PCIe": (2.0e12, 756e12, 51e12),
    "H100 NVL": (3.9e12, 835e12, 60e12),
    "H100": (3.35e12, 989e12, 67e12),  # SXM5 (nvidia-smi: "NVIDIA H100 80GB HBM3")
}

FWD_TOL = 2e-3      # max-abs on h' (|h'| <= ~1), bf16 operands: f32 sums in another order, amplified by LayerNorm
FWD_TOL_F32 = 1e-4  # max-abs on h', f32 operands: both sides full f32 (TF32 off), sums in another order
GRAD_TOL = 1e-3     # relative to each gradient's max-abs: backward is the same plain recompute
LOSS_RTOL = 2e-2    # fused vs unfused cell in bf16 over a 48-step loop and a 15-step dream
LOSS_ATOL = 1e-3    # ... for losses near 0 (the dummy probe)
AC_LOSS_RTOL = 1e-1  # actor/critic losses: small means over a 15-step bf16 dream (the unfused
                     # cell rounds its gates to bf16); the flagship's differed by 3.6% in phase 3
GRAD_NORM_RTOL = 5e-2  # the actor's gradient norm, fused vs unfused, through the 15-step dream

K1_SOURCE = "pydreamer_tpu_torch/ops/csrc/gru_dv2.cu"
K1_REPLACES = "pydreamer_tpu/ops/gru_pallas.py:78"


def peaks_for(name: str):
    for key, peaks in PEAKS.items():
        if key in name:
            return key, peaks
    raise RuntimeError(f"no peak rates known for card {name!r}")


def k1_bound_ms(M: int, In: int, H: int, peaks, tensor_cores: bool) -> tuple[float, str]:
    """Least time for one K1 step: each input read once, the output written once;
    the two products at the bf16 tensor rate (bf16 operands) or the fp32 rate
    (f32 operands, no TF32), LayerNorm and gates at the fp32 rate."""
    bw, bf16_rate, f32_rate = peaks
    elem = 2 if tensor_cores else 4
    nbytes = elem * (M * In + M * H + In * 3 * H + H * 3 * H) + 4 * (2 * 3 * H) + 4 * M * H
    t_bytes = nbytes / bw
    t_ops = (2 * M * (In + H) * 3 * H / (bf16_rate if tensor_cores else f32_rate)
             + M * (8 * 3 * H + 10 * H) / f32_rate)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, iters: int, flush=None) -> float:
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


def call_us(torch, fn, n: int = 200) -> float:
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


def k1_inputs(torch, M, In, H, gen, device, dtype):
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)
    return (randn(M, In).to(dtype), torch.tanh(randn(M, H)).to(dtype),
            (0.03 * randn(In, 3 * H)).to(dtype), (0.03 * randn(H, 3 * H)).to(dtype),
            1.0 + 0.1 * randn(3 * H), 0.1 * randn(3 * H))


def unfused_cell(torch, layer_norm):
    """The composition NormGRUCellLateReset.forward runs, on operands already
    in its compute dtype: two products, LayerNorm in f32, the gate ops."""
    def cell(x, h, w_ih, w_hh, scale, bias):
        dt = x.dtype
        gates = layer_norm(x @ w_ih + h @ w_hh, scale, bias, dt)
        r, u, n = gates.chunk(3, -1)
        update = torch.sigmoid(u - 1.0)
        return update * torch.tanh(torch.sigmoid(r) * n) + (1.0 - update) * h
    return cell


def check_k1(torch, k1, M, In, H, dtype, want, gen, device, timed: bool, peaks, unfused=None):
    ins = k1_inputs(torch, M, In, H, gen, device, dtype)
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
    grad_errs = {}
    for name, a, b in zip(("x", "h", "w_ih", "w_hh", "scale", "bias"), leaves_k, leaves_p):
        err = ((a.grad.float() - b.grad.float()).abs().max() / b.grad.float().abs().max()).item()
        grad_errs[name] = err
        if not math.isfinite(err) or err > GRAD_TOL:
            raise AssertionError(f"K1 {got} M={M}: grad {name} rel err {err} > {GRAD_TOL}")
    result = dict(schedule=got, M=M, In=In, H=H, dtype=str(dtype).replace("torch.", ""),
                  max_abs_err=fwd_err, tol=tol, grad_rel_err=grad_errs)
    if timed:
        flush_buf = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=device)  # 128 MB > L2
        flush = flush_buf.zero_
        iters = 50
        xh, w = torch.cat(ins[:2], 1), torch.cat(ins[2:4], 0)
        result["ms"] = time_ms(torch, lambda: k1.gru_dv2_cuda(*ins), iters, flush)
        result["ms_l2_warm"] = time_ms(torch, lambda: k1.gru_dv2_cuda(*ins), iters)
        result["plain_ms"] = time_ms(torch, lambda: k1.gru_dv2_reference(*ins), iters, flush)
        result["gemm_library_ms"] = time_ms(torch, lambda: torch.mm(xh, w), iters, flush)
        result["unfused_ms"] = time_ms(torch, lambda: unfused(*ins), iters, flush)
        result["call_us"] = call_us(torch, lambda: k1.gru_dv2_cuda(*ins))
        result["unfused_call_us"] = call_us(torch, lambda: unfused(*ins))
        if dtype == torch.bfloat16 and H == 1024:  # the first design, at the main-path shapes
            generic = k1.Plan("generic", workspace=M * 3 * H)
            result["generic_ms"] = time_ms(torch, lambda: k1._launch(generic, *ins), iters, flush)
            out_g = k1._launch(generic, *ins)
            result["generic_max_abs_err"] = (out_g - out_p).abs().max().item()
        result["bound_ms"], result["bound_by"] = k1_bound_ms(M, In, H, peaks,
                                                              dtype == torch.bfloat16)
        result["bound_share"] = result["bound_ms"] / result["ms"]
    return result


def timed_steps(torch, ts, obs, state, step: int, n: int):
    """Run n TrainStep calls from ``step + 1``; host-clock ms per step, synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        state, metrics, _, _ = ts(obs, state, step + 1 + i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3, state, metrics


def make_obs(torch, conf, gen, device, T=None, B=None):
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


def on_device(event) -> bool:
    """A kernel (or memcpy/memset) event, as opposed to the CPU op that launched it."""
    return str(event.device_type).endswith("CUDA")


def profile_step(torch, ts, obs, state, step):
    """One TrainStep under torch.profiler: (state, report, key_averages)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _, _, _ = ts(obs, state, step)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    attr = "self_device_time_total"
    dev_events = [e for e in events if on_device(e)]
    busy_us = sum(getattr(e, attr) for e in dev_events)
    k1_events = [e for e in dev_events if "k1::" in e.key]  # the .cu's namespace
    k1_rows = [(e.key, e.count, getattr(e, attr)) for e in k1_events]
    n_by_kernel = {kind: sum(e.count for e in k1_events if kind in e.key)
                   for kind in ("skinny::gates_kernel", "wide::gates_kernel", "generic::", "f32::")}
    ms_by_kernel = {kind: sum(getattr(e, attr) for e in k1_events if kind in e.key) / 1e3
                    for kind in ("skinny::gates_kernel", "wide::gates_kernel", "ln_gate_kernel")}
    # K1's backward recomputes the cell through the plain version in float32:
    # its products are the step's only float32 GEMMs (the model's run in bf16).
    f32_gemms = [e for e in dev_events if "gemm" in e.key.lower() and "k1::" not in e.key
                 and ("f32f32" in e.key or "sgemm" in e.key)]
    report = dict(wall_ms=wall_ms, device_busy_ms=busy_us / 1e3, k1_kernels=k1_rows,
                  k1_ms=sum(r[2] for r in k1_rows) / 1e3, k1_launches=n_by_kernel,
                  k1_ms_by_kernel=ms_by_kernel,
                  f32_gemm_ms=sum(getattr(e, attr) for e in f32_gemms) / 1e3,
                  f32_gemm_calls=sum(e.count for e in f32_gemms),
                  f32_gemm_kernels=sorted({e.key for e in f32_gemms}))
    return state, report, events


def unfused_state_dict(sd):
    """The K1 cell's weights under the unfused cell's names."""
    return {k.replace("cell_0.ln_scale", "cell_0.lnorm.weight")
             .replace("cell_0.ln_bias", "cell_0.lnorm.bias"): v for k, v in sd.items()}


def actor_grad_norm(torch, model):
    return torch.sqrt(sum(p.grad.float().square().sum() for p in model.ac.actor.parameters()
                          if p.grad is not None)).item()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; it needs a CUDA card",
              file=sys.stderr)
        return 1
    from pydreamer_tpu_torch.conf import Conf
    from pydreamer_tpu_torch.models.dreamer import Dreamer
    from pydreamer_tpu_torch.models.modules import layer_norm
    from pydreamer_tpu_torch.models.noise import GeneratorNoise
    from pydreamer_tpu_torch.models.rnn import make_gru_cell
    from pydreamer_tpu_torch.ops import gru_dv2 as k1
    from pydreamer_tpu_torch.training.train_step import TrainStep

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version runs full f32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    OUT_DIR.mkdir(exist_ok=True)
    report = {}

    # 1. Build K1; the card's name and power limit.
    t0 = time.time()
    lib_path = k1.build()
    report["build_s"] = time.time() - t0
    ptxas = [ln for ln in lib_path.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln or "smem" in ln]
    print(f"[1] built {lib_path.name} in {report['build_s']:.1f} s", *ptxas, sep="\n    ")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    peak_key, peaks = peaks_for(name)
    report.update(card=name, nvidia_smi=smi, peaks_of=peak_key, torch=torch.__version__,
                  cuda=torch.version.cuda)
    print(f"    card {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. Every K1 schedule against its plain version; times beside the yardsticks.
    conf = Conf(FLAGSHIP)
    T, B, H_imag = conf.batch_length, conf.batch_size, conf.imag_horizon
    In, H = conf.hidden_dim, conf.deter_dim
    gen = torch.Generator(device=device).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    unfused = unfused_cell(torch, layer_norm)
    report["k1"] = []
    for M, H_s, dtype, want in ((B, H, bf16, "skinny"), (T * B, H, bf16, "wide"),
                                (B, 2048, bf16, "skinny"), (T * B, 2048, bf16, "wide"),
                                (B, H, f32, "f32"), (T * B, H, f32, "f32")):
        res = check_k1(torch, k1, M, In, H_s, dtype, want, gen, device, True, peaks, unfused)
        report["k1"].append(res)
        print(f"[2] K1 {want} M={M} H={H_s} {res['dtype']}: max_abs_err {res['max_abs_err']:.3e}, "
              f"grads ok, {res['ms']:.5f} ms (L2 warm {res['ms_l2_warm']:.5f}), "
              f"bound {res['bound_ms']:.5f} ms ({res['bound_by']}, {100 * res['bound_share']:.1f}%), "
              f"plain {res['plain_ms']:.5f}, gemm_library {res['gemm_library_ms']:.5f}, "
              f"unfused {res['unfused_ms']:.5f}, generic {res.get('generic_ms', float('nan')):.5f} ms; "
              f"host {res['call_us']:.1f} us/call (unfused {res['unfused_call_us']:.1f})")
    for M, In_s, H_s in ((5, 37, 50), (70, 129, 67), (1, 8, 16)):
        res = check_k1(torch, k1, M, In_s, H_s, bf16, "generic", gen, device, False, peaks)
        print(f"[2] K1 generic M={M} In={In_s} H={H_s}: max_abs_err {res['max_abs_err']:.3e}, grads ok")
    # The fused cell under precision: float32 runs K1's f32 schedule.
    cell = make_gru_cell("gru_layernorm_dv2", In, H, dtype=f32).to(device)
    x32, h32 = k1_inputs(torch, B, In, H, gen, device, f32)[:2]
    k1.LAUNCHES.reset()
    with torch.no_grad():
        out32 = cell(x32, h32)
        ref32 = k1.gru_dv2_reference(x32, h32, cell.weight_ih, cell.weight_hh, cell.ln_scale,
                                     cell.ln_bias)
    err32 = (out32 - ref32).abs().max().item()
    report["f32_cell"] = dict(max_abs_err=err32, launches=dict(k1.LAUNCHES.by_schedule))
    print(f"[2] gru_layernorm_dv2 cell in float32: {k1.LAUNCHES.by_schedule}, max_abs_err {err32:.3e}")
    if out32.dtype != f32 or k1.LAUNCHES.by_schedule != {"f32": 1} or not err32 <= FWD_TOL_F32:
        raise AssertionError(f"float32 cell: {out32.dtype}, {k1.LAUNCHES.by_schedule}, err {err32}")

    # 3. Fused vs unfused cell through the full-width forward.
    torch.manual_seed(0)
    model = Dreamer(conf, device=device)
    obs = make_obs(torch, conf, gen, device)
    xla = Dreamer(conf.replace(gru_type="gru_layernorm_dv2_xla"), device=device)
    xla.load_state_dict(unfused_state_dict(model.state_dict()))
    with torch.no_grad():
        lf, *_ = model.training_step(obs, model.init_state(B), GeneratorNoise(device, seed=7))
        lx, *_ = xla.training_step(obs, xla.init_state(B), GeneratorNoise(device, seed=7))
    cmp = {k: (lf[k].item(), lx[k].item()) for k in lf}
    report["fused_vs_unfused"] = cmp
    print("[3] fused vs unfused losses:", {k: f"{a:.5f}/{b:.5f}" for k, (a, b) in cmp.items()})
    rel = abs(cmp["loss_model"][0] - cmp["loss_model"][1]) / abs(cmp["loss_model"][1])
    if not rel <= LOSS_RTOL:
        raise AssertionError(f"fused vs unfused loss_model rel diff {rel} > {LOSS_RTOL}")

    # 4. The main path: full-width TrainStep, 2 warm-up + 5 timed steps.
    ts = TrainStep(model, conf, device=device)
    _, state, _ = timed_steps(torch, ts, obs, model.init_state(B), 0, 2)
    torch.cuda.reset_peak_memory_stats()
    n_steps = 5
    k1.LAUNCHES.reset()
    step_ms, state, metrics = timed_steps(torch, ts, obs, state, 2, n_steps)
    launches, by_rows = k1.LAUNCHES.count, dict(k1.LAUNCHES.by_rows)
    by_schedule = dict(k1.LAUNCHES.by_schedule)
    step = 2 + n_steps
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
    if tuple(state[0].shape) != (B, H) or not torch.isfinite(state[0]).all():
        raise AssertionError("out_state h is not finite of shape (B, deter)")

    # 5. Profile one step.
    state, prof5, events = profile_step(torch, ts, obs, state, step + 1)
    report["profile"] = prof5
    table = events.table(sort_by="self_device_time_total", row_limit=30)
    print(f"[5] profiled step: wall {prof5['wall_ms']:.2f} ms, device busy "
          f"{prof5['device_busy_ms']:.2f} ms; K1 {prof5['k1_ms']:.3f} ms in {prof5['k1_kernels']}")
    if prof5["k1_launches"] != {"skinny::gates_kernel": T, "wide::gates_kernel": H_imag,
                                "generic::": 0, "f32::": 0}:
        raise AssertionError(f"profiler saw K1 launches {prof5['k1_launches']}, expected {T} skinny "
                             f"+ {H_imag} wide = {T + H_imag} a step: {prof5['k1_kernels']}")
    step += 1

    # 6. Step time with the K1 cell against the unfused cell, in turns
    #    (unfused, K1, K1, unfused), 5 steps per window after 2 warm-up steps.
    ts_xla = TrainStep(xla, conf, device=device)
    _, state_xla, _ = timed_steps(torch, ts_xla, obs, xla.init_state(B), 0, 2)
    windows = {"unfused": [], "k1": []}
    for variant in ("unfused", "k1", "k1", "unfused"):
        if variant == "k1":
            ms, state, _ = timed_steps(torch, ts, obs, state, step, n_steps)
            step += n_steps
        else:
            ms, state_xla, _ = timed_steps(torch, ts_xla, obs, state_xla, 2 + len(windows["unfused"]) * n_steps, n_steps)
        windows[variant].append(ms)
    report["step_ms_ab"] = windows
    print(f"[6] ms/step in turns: K1 cell {windows['k1']}, unfused cell {windows['unfused']}")

    path_launches = {("skinny", B, H): by_schedule.get("skinny", 0),
                     ("wide", T * B, H): by_schedule.get("wide", 0)}  # phase 4, flagship
    del model, xla, ts, ts_xla, state, state_xla
    torch.cuda.empty_cache()

    # 7. Inference shapes: skinny at M=1 and M=8, H=2048, against its plain version.
    for M in (1, 8):
        res = check_k1(torch, k1, M, In, 2048, bf16, "skinny", gen, device, True, peaks, unfused)
        report["k1"].append(res)
        print(f"[7] K1 skinny M={M} H=2048: max_abs_err {res['max_abs_err']:.3e}, grads ok, "
              f"{res['ms']:.5f} ms (L2 warm {res['ms_l2_warm']:.5f}), bound {res['bound_ms']:.5f} ms "
              f"({res['bound_by']}, {100 * res['bound_share']:.1f}%), plain {res['plain_ms']:.5f}, "
              f"gemm_library {res['gemm_library_ms']:.5f}, unfused {res['unfused_ms']:.5f} ms; "
              f"host {res['call_us']:.1f} us/call (unfused {res['unfused_call_us']:.1f})")

    # 8. The DMC path: one forward and backward with the K1 cell and with the
    #    unfused cell, same weights, same noise.
    dconf = Conf(DMC)
    Hd, A = dconf.deter_dim, dconf.action_dim
    torch.manual_seed(1)
    dmodel = Dreamer(dconf, device=device)
    dxla = Dreamer(dconf.replace(gru_type="gru_layernorm_dv2_xla"), device=device)
    dxla.load_state_dict(unfused_state_dict(dmodel.state_dict()))
    dobs = make_obs(torch, dconf, gen, device)
    cmp8 = {}
    for tag, m in (("k1", dmodel), ("unfused", dxla)):
        k1.LAUNCHES.reset()
        losses, *_ = m.training_step(dobs, m.init_state(B), GeneratorNoise(device, seed=8))
        sum(losses.values()).backward()
        torch.cuda.synchronize()
        cmp8[tag] = dict({k: v.item() for k, v in losses.items()},
                         grad_norm_actor=actor_grad_norm(torch, m),
                         launches=dict(k1.LAUNCHES.by_schedule))
        m.zero_grad(set_to_none=True)
    report["dmc_fused_vs_unfused"] = cmp8
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
    del dxla
    torch.cuda.empty_cache()

    # 9. Drive the DMC train step: 2 warm-up + 5 timed steps.
    dts = TrainStep(dmodel, dconf, device=device)
    _, dstate, _ = timed_steps(torch, dts, dobs, dmodel.init_state(B), 0, 2)
    torch.cuda.reset_peak_memory_stats()
    k1.LAUNCHES.reset()
    dstep_ms, dstate, dmetrics = timed_steps(torch, dts, dobs, dstate, 2, n_steps)
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
    path_launches.update({("skinny", B, Hd): d_sched["skinny"], ("wide", T * B, Hd): d_sched["wide"]})

    # The actor loss alone reaches the actor and leaves the world model alone.
    dmodel.zero_grad(set_to_none=True)  # TrainStep leaves its step's gradients behind
    losses, *_ = dmodel.training_step(dobs, dstate, GeneratorNoise(device, seed=9))
    losses["loss_actor"].backward()
    leaked = [n for n, p in dmodel.wm.named_parameters() if p.grad is not None and p.grad.any()]
    only_actor = actor_grad_norm(torch, dmodel)
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
    dstate, prof9, events9 = profile_step(torch, dts, dobs, dstate, dstep + 1)
    dstep += 1
    report["dmc"]["profile"] = prof9
    print(f"[9] profiled DMC step: wall {prof9['wall_ms']:.2f} ms, device busy "
          f"{prof9['device_busy_ms']:.2f} ms; K1 {prof9['k1_ms']:.3f} ms {prof9['k1_ms_by_kernel']}; "
          f"f32 GEMMs (K1's backward recompute) {prof9['f32_gemm_ms']:.3f} ms in "
          f"{prof9['f32_gemm_calls']} calls")
    if prof9["k1_launches"] != {"skinny::gates_kernel": T, "wide::gates_kernel": H_imag,
                                "generic::": 0, "f32::": 0}:
        raise AssertionError(f"profiler saw K1 launches {prof9['k1_launches']} in the DMC step")
    (OUT_DIR / "chip_smoke_profile.txt").write_text(
        f"{smi}\n[5] flagship step\n{table}\n[9] DMC step\n"
        f"{events9.table(sort_by='self_device_time_total', row_limit=40)}\n")

    # 10. Dreamer.inference on the DMC model, the generators' acting step.
    report["inference"] = {}
    n_calls = 50
    for Bi in (1, 8):
        iobs = make_obs(torch, dconf, gen, device, T=1, B=Bi)
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
        report["inference"][Bi] = dict(us_per_call=call_us_i, launches_by_rows=i_rows,
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
        path_launches[("skinny", Bi, Hd)] = n_calls

    # Launches by shape on each path: flagship (phase 4, 5 steps), DMC (phase
    # 9, 5 steps) and inference (phase 10, 50 calls); 0 where no path runs it.
    per_step = {(B, H): n_steps, (T * B, H): n_steps, (B, Hd): n_steps, (T * B, Hd): n_steps,
                (1, Hd): n_calls, (8, Hd): n_calls}
    kernels = []
    for r in report["k1"]:
        key = (r["schedule"], r["M"], r["H"]) if r["dtype"] == "bfloat16" else None
        n = path_launches.get(key, 0)
        common = dict(route="cuda", source=K1_SOURCE, replaces=K1_REPLACES, bound_ms=r["bound_ms"],
                      bound_by=r["bound_by"], plain_ms=r["plain_ms"],
                      library_ms=r["gemm_library_ms"], unfused_ms=r["unfused_ms"])
        kernels.append(dict(name=f"gru_dv2.{r['schedule']}[M={r['M']},H={r['H']},{r['dtype']}]",
                            launches=n, launches_per_step=n / per_step[(r["M"], r["H"])] if n else 0,
                            max_abs_err=r["max_abs_err"], ms=r["ms"], ms_l2_warm=r["ms_l2_warm"],
                            **common))
        if "generic_ms" in r:
            kernels.append(dict(name=f"gru_dv2.generic[M={r['M']},H={r['H']},bfloat16]", launches=0,
                                launches_per_step=0, max_abs_err=r["generic_max_abs_err"],
                                ms=r["generic_ms"], **common))
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
