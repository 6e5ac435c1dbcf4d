#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``pydreamer_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught to carry on):

1. Build kernel K1 (``ops/csrc/gru_dv2.cu``, nvcc for sm_90a) and print the
   card's name and power limit as nvidia-smi reports them.
2. Hold every K1 schedule against its plain PyTorch version: forward max-abs
   error and the gradients of all six inputs. ``skinny`` and ``wide`` at the
   two main-path shapes (M=32 and M=1536 rows, In=1000, H=1024, bf16) and at
   H=2048 (the ``defaults`` width), ``skinny_f32`` and ``wide_f32`` at the
   same four shapes in float32 (3xTF32 on the tensor cores, held to the f32
   tolerance with TF32 off in the plain version), ``generic`` and ``f32``
   at small ragged shapes. Time each (CUDA graphs of many launches, cold and
   warm L2) beside its bound (for f32 operands the faster of FFMA and
   3xTF32, the route named), the plain version, the cuBLAS product of the
   concatenated operands (``gemm_library_ms``), the unfused composition the
   ``gru_layernorm_dv2_xla`` cell runs (``unfused_ms``), and, at H=1024, the
   first design of the dtype at the same shape: ``generic`` (the first,
   unpipelined bf16 design) or ``f32`` (the FFMA design, ``f32_ffma_ms``),
   each held to the same tolerance. The port calls none of these
   yardsticks. Then the fused cell under ``precision: float32`` on the
   card: it must take ``skinny_f32``.
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
11. The learner loop on the flagship model. K1 at the eval protocol's
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
   step, ``timer_*``, peak host RSS and peak device memory.
12. The actors at the flagship width (action_dim 4, ``Grid-8x64``, the one
   image env that needs no SDK). K1 ``skinny`` at M=1 and M=8 (H=1024)
   against its plain version, timed as in 2. Then ``generator.main`` on the
   card with the network policy from a checkpoint of a seeded model, at B=1
   and B=8 (``envs_per_worker``): counts set to 0 just before and read just
   after each run, one ``skinny`` launch per acting call and none other; at
   least two episode files each, read back through the repository and
   ``SequentialDataset`` with the JAX generator's keys, shapes and policy
   columns; host microseconds per env step. Then ``python -m
   pydreamer_tpu_torch.launch --configs defaults atari`` (two CPU
   generators, the learner on the card, 80 steps) under ``timeout`` in a
   session of its own: exit 0, no process of that session left, episodes
   from both generators, each generator loading the learner's checkpoint,
   finite ``train/`` losses, a checkpoint at step 80, and the learner's own
   log line of K1 launches (48 ``skinny`` + 15 ``wide`` a step plus the log
   step's 47, none ``generic``); the loop's ms/step beside phase 11's and
   the CPU generators' ``agent/fps``.
13. The probes and the baseline world models at the MiniWorld width
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
   step and the busy time; for the two GRU models a step from the
   carried state differs from one from zeros on the streams that go on, and
   only there. 13c: ``gru_vae`` at ``iwae_samples: 3`` for one step.
14. The learner on a mesh of ranks (``parallel/``). 14a: ``trainer.run`` on
   the flagship model from phase 11's files (``data_workers: 1``, 8 steps,
   step 1 a log step, a checkpoint at 8) at world size 1 under the production
   backend ``cpu:gloo,cuda:nccl``, then the same 8 steps with no group: the
   ``train/`` losses and the final weights agree (cuDNN held deterministic;
   bit for bit is reported, within 1e-4 relative / 1e-3 absolute is
   required), K1's launches by rows match the steps. 14b: K1 ``skinny`` at
   M=16 and ``wide`` at M=768 (the data ranks' shapes) against its plain
   version, timed as in 2; then two ranks on the one card over gloo (NCCL
   refuses two ranks on one device), ``mesh_data: 2``, each stepping on
   B=16 of one B=32 batch from the same weights with its rows of the global
   noise: 3 bf16 steps against one process at B=32 (step 1, from the same
   weights: every world-model loss and ``grad_norm`` within 2e-2 relative;
   steps 2-3: ``loss_model`` and ``loss_image`` within 2e-2, the rest
   reported, see ``WM_TOTALS``), 3 float32 steps (TF32 off) with every
   world-model metric within 1e-4 at every step, and per rank per step 48
   ``skinny`` [M=16] and 15 ``wide`` [M=768] launches in bf16, 48
   ``skinny_f32`` [M=16] and 15 ``wide_f32`` [M=768] in float32, none
   ``generic`` or ``f32``. The float32 reference (one process, B=32) takes
   48 ``skinny_f32`` + 15 ``wide_f32`` a step; its step is then timed in
   turns against the same step with K1 put on the FFMA schedule ``f32``
   (``f32_step_ab``). K1 ``skinny_f32`` / ``wide_f32`` at M=16 / M=768 are
   held and timed beside the bf16 rows. 14c: ``mesh_model: 2``, ``tp_min_size: 1024``
   on two ranks: the sharded parameters listed, each rank's parameter and
   AdamW bytes smaller by half of the sharded bytes, 3 steps against one
   process as in 14b, K1 at M=32 / M=1536 on the gathered gate kernels. The
   ranks' ms per step are printed beside phase 4's: two ranks share one card
   and one host, so they are no multi-GPU number.

15. Learning on the card. 15a: K1 at the shapes no earlier phase launched,
   against its plain version and timed as in 2: ``skinny_f32`` at each
   canary's posterior (M=B) and acting (M=1) rows, ``wide_f32`` at its dream
   (M=T*B) rows (H=32 and 64), and
   ``skinny`` M=32 and ``wide`` M=1536 at the ``gridworld`` preset's In=H=256
   in bf16. 15b: the four learning canaries of ``tests/test_learning.py``
   (``pydreamer_tpu_torch/scripts/canaries.py``) on the card with
   ``gru_type: gru_layernorm_dv2``, each held to the JAX test's own gate
   (bandit: after > 6 and after > before + 2; GridWorld world model:
   ``loss_model`` at step 60 under half of step 5's; pixel policy: the rolling
   80-episode gate clears by step 4000; point: after > before + 4 and after >
   12), counts set to 0 just before and read just after each: T posterior
   launches a train step on ``skinny_f32``, H dream launches on ``wide_f32``
   and one ``skinny_f32`` launch a policy call, exact per schedule. 15c: ``python
   -m pydreamer_tpu_torch.launch --configs defaults gridworld --gru_type
   gru_layernorm_dv2`` (deter 256, T=48, B=32, bf16, ``Grid-8x64``, one CPU
   generator reloading the checkpoint every 15 s) for 120 steps under
   ``timeout`` in a session of its own, started before 15a and running beside
   15a and 15b (its own processes; its log goes to a file): exit 0, no process
   left,
   ``loss_model`` at the last log step under half its first logged value, the
   generator's ``agent/`` rows both before and after its first checkpoint
   load, the learner's K1 line (48 ``skinny`` [M=32] + 10 ``wide`` [M=1536] a
   step plus the log step's 47, none ``generic``). Then the run tools on its
   directory, as ``python -m pydreamer_tpu_torch.scripts.<tool>``:
   ``export_metrics`` (a CSV whose first column is ``_step``), ``plot_curves``
   (a PNG) where matplotlib is installed and ``make_gif`` (a GIF of the run's
   ``d2_wm_dream`` dump) where PIL is; what a tool would read is kept in
   ``chiprun_out/live_run/`` beside what they wrote. ``--learning-only`` runs
   phases 1 and 15 alone.
16. The measurement tools of ``pydreamer_tpu_torch/scripts/``, each ``main``
   run in-process on the card at the flagship width with short counts (2
   warm-up steps, windows of 1-5): ``bench`` (``gru``), ``bench_gru`` (three
   cells), ``bench_step_ab`` (``gru`` against ``gru_layernorm_dv2`` in turns),
   ``profile_step`` under ``gru_layernorm_dv2``, ``bench_dream`` (both cells at
   M=1536), ``roofline`` at the card's peaks, ``bench_conv --all``,
   ``scaling_bench`` (one NCCL rank a card).
   Each line must carry the JAX tool's keys, finite values and the card's
   name and nvidia-smi line; K1's launches in each tool are set to 0 before
   it and read after, T ``skinny`` [M=B] a DV2 train step and H ``wide``
   [M=T*B] a DV2 train step or dream call, exact; ``bench_gru`` reports 48
   + 15 a step under both DV2 cells and none under ``gru``; ``profile_step``
   saw kernel records of both schedules; ``roofline``'s K1 bound equals
   phase 2's. One ``[16] tools summary`` line; details in
   ``chiprun_out/tools_phase.json``. ``--tools-only`` runs phase 1, phase
   2's two flagship rows and phase 16 with ``bench_e2e --quick`` (six CPU
   generator processes: 139 s on an H100's host) and ``scaling_bench
   --gspmd-overhead`` (a second rank process) as well; the default run has
   no room for them.

Prints one JSON line of per-kernel numbers (``launches``: the count on the
path that runs the shape, ``launches_per_step``: per train step or acting
call), then the nvidia-smi line, then
as the last line ``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``, ``chiprun_out/chip_smoke_profile.txt`` and
``chiprun_out/learner_metrics.jsonl`` (phase 11's metrics),
``chiprun_out/launch_log.txt`` and ``chiprun_out/launch_metrics.jsonl``
(phase 12's launcher run), ``chiprun_out/probe_phase.json`` (phase 13),
``chiprun_out/phase14_*_rank*.json`` (phase 14's ranks), ``chiprun_out/live_log.txt``
and ``chiprun_out/live_run/`` (phase 15c);
phase 11's episode files stay in
``chiprun_out/learner_episodes/`` and the run directories (under ``runs/``,
git-ignored) are removed at the end.
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

from pydreamer_tpu_torch.scripts.profile_step import profile_step
from pydreamer_tpu_torch.scripts.roofline import k1_bound_ms, peaks_for

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
        if H == 1024:  # the dtype's first design at the same shape, as generic_ms / f32_ffma_ms
            sched, key = ("generic", "generic") if dtype == torch.bfloat16 else ("f32", "f32_ffma")
            first = k1.Plan(sched, workspace=M * 3 * H)
            result[f"{key}_ms"] = time_ms(torch, lambda: k1._launch(first, *ins), iters, flush)
            out_f = k1._launch(first, *ins)
            torch.cuda.synchronize()
            result[f"{key}_max_abs_err"] = err = (out_f - out_p).abs().max().item()
            if not math.isfinite(err) or err > tol:
                raise AssertionError(f"K1 {sched} M={M} H={H}: forward max-abs err {err} > {tol}")
        result["bound_ms"], result["bound_by"], result["bound_route"] = k1_bound_ms(
            M, In, H, peaks, dtype == torch.bfloat16)
        result["bound_share"] = result["bound_ms"] / result["ms"]
    return result


def k1_summary(res) -> str:
    """One timed ``check_k1`` result on a line."""
    first = "".join(f", {k} {res[f'{k}_ms']:.5f} (err {res[f'{k}_max_abs_err']:.3e})"
                    for k in ("generic", "f32_ffma") if f"{k}_ms" in res)
    return (f"max_abs_err {res['max_abs_err']:.3e}, grads ok, {res['ms']:.5f} ms (L2 warm "
            f"{res['ms_l2_warm']:.5f}), bound {res['bound_ms']:.5f} ms ({res['bound_by']}, "
            f"{res['bound_route']}, {100 * res['bound_share']:.1f}%), plain {res['plain_ms']:.5f}, "
            f"gemm_library {res['gemm_library_ms']:.5f}, unfused {res['unfused_ms']:.5f}{first} "
            f"ms; host {res['call_us']:.1f} us/call (unfused {res['unfused_call_us']:.1f})")


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


def actor_grad_norm(torch, model):
    return torch.sqrt(sum(p.grad.float().square().sum() for p in model.ac.actor.parameters()
                          if p.grad is not None)).item()


def _bounce(p, span):
    """Positions p folded into [0, span] (a block bouncing between walls)."""
    p = p % (2 * span)
    return span - abs(p - span)


def write_episodes(np, repo, n_files: int, length: int, action_dim: int, seed: int) -> None:
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


# The learner keys trainer.run reads (config/defaults.yaml `defaults` + `atari`),
# set for phase 11's short run from episode files on disk.
LEARNER = dict(
    env_id="Atari-Pong", env_action_repeat=4, n_env_steps=10**9, seed=0, platform=None,
    offline_prefill_dir=None, offline_test_dir=None, data_workers=4,
    generator_workers=1, generator_workers_train=0, generator_workers_eval=0,
    generator_prefill_steps=0, buffer_size=10_000_000, buffer_size_offline=0,
    reset_interval=200, allow_mid_reset=True, enable_profiler=False, max_rss_gb=0.0,
    n_steps=12, log_interval=4, logbatch_interval=1000, save_interval=6,
    # The loop stops at n_steps before its eval (as the JAX loop does), so an
    # eval_interval of 12 would never evaluate in a 12-step run.
    eval_interval=6,
    test_batches=2, test_batch_size=10, test_save_size=1,
    eval_batches=2, eval_batch_size=32, eval_samples=1, eval_save_size=1,
)


def check_prefetch(torch, batches, device, n: int):
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


def learner_phase(torch, k1, conf, report, path_launches, gen, device, peaks, unfused) -> int:
    """Phase 11: K1 at the eval protocol's shapes, then ``trainer.run`` on the
    flagship model from episode files on disk, then a resume. Returns the
    number of test-protocol train-step calls (for the per-call launch counts)."""
    import resource
    import shutil

    import numpy as np

    from pydreamer_tpu_torch import native
    from pydreamer_tpu_torch.data import (NpzEpisodeRepository, Preprocessor, SequentialDataset,
                                          make_repository)
    from pydreamer_tpu_torch.models.dreamer import Dreamer
    from pydreamer_tpu_torch.tracking import Run, load_checkpoint_file
    from pydreamer_tpu_torch.training import trainer
    from pydreamer_tpu_torch.training.train_step import TrainStep

    T, B, H_imag = conf.batch_length, conf.batch_size, conf.imag_horizon
    In, H = conf.hidden_dim, conf.deter_dim
    TB = LEARNER["test_batch_size"]
    out = report["learner"] = {}

    # K1 at the eval protocol's shapes: skinny at M=10 (posterior, open loop),
    # wide at M=T*10=480 (the dream of a test batch).
    for M, want in ((TB, "skinny"), (T * TB, "wide")):
        res = check_k1(torch, k1, M, In, H, torch.bfloat16, want, gen, device, True, peaks, unfused)
        report["k1"].append(res)
        print(f"[11] K1 {want} M={M} H={H}: {k1_summary(res)}")

    # Episode files: 8 train and 2 eval files of 1000 steps, written by the
    # port's repository as the generators write them.
    episodes = OUT_DIR / "learner_episodes"
    shutil.rmtree(episodes, ignore_errors=True)
    t0 = time.perf_counter()
    write_episodes(np, NpzEpisodeRepository(episodes / "train"), 8, 1000, conf.action_dim, seed=11)
    write_episodes(np, NpzEpisodeRepository(episodes / "eval"), 2, 1000, conf.action_dim, seed=12)
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
                         offline_eval_dir=str(episodes / "eval"), **LEARNER)
    # The prefetch's device copies against their numpy sources.
    batches = Preprocessor.from_conf(lconf)(iter(SequentialDataset(
        make_repository(str(episodes / "train")), T, B, reset_interval=200, seed=3)))
    out["prefetch_batches_equal"], obs = check_prefetch(torch, batches, device, 6)
    print(f"[11] prefetch: {out['prefetch_batches_equal']} batches on the card equal their numpy sources")

    def bare_step_ms():
        """The bare TrainStep on a batch from these files: 2 warm-up and 5
        timed steps of a fresh flagship model (a turn beside the loop's)."""
        torch.manual_seed(0)
        model = Dreamer(conf, device=device)
        ts = TrainStep(model, conf, device=device)
        _, state, _ = timed_steps(torch, ts, obs, model.init_state(B), 0, 2)
        ms, _, _ = timed_steps(torch, ts, obs, state, 2, 5)
        del model, ts, state
        torch.cuda.empty_cache()
        return ms

    out["bare_step_ms_turns"] = [bare_step_ms()]
    run_dir = Path(__file__).resolve().parent / "runs" / "chip_smoke_learner"
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
    n_eval, EB = 3, LEARNER["eval_batch_size"]
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
    path_launches[("skinny", TB, H)] = rows[TB]
    path_launches[("wide", T * TB, H)] = rows[T * TB]
    return n_test


def policy_columns_ok(np, data) -> bool:
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


def generator_phase(torch, k1, conf, report, path_launches, gen, device, peaks, unfused) -> dict:
    """Phase 12: K1 at the acting shapes of the flagship width, the generator
    in process on the card at B=1 and B=8, then the launcher end to end.
    Returns the acting calls per batch size (for the per-call launch counts)."""
    import os
    import re
    import shutil

    import numpy as np

    from pydreamer_tpu_torch import generator
    from pydreamer_tpu_torch.data import SequentialDataset, make_repository
    from pydreamer_tpu_torch.models.dreamer import Dreamer
    from pydreamer_tpu_torch.tracking import Run, load_checkpoint_model, save_checkpoint_file

    In, H = conf.hidden_dim, conf.deter_dim
    out = report["generator"] = {}
    root = Path(__file__).resolve().parent

    # 12a. K1 skinny at the acting shapes, M=1 (NetworkPolicy) and M=8
    # (VectorNetworkPolicy over 8 envs), at the flagship's H=1024.
    for M in (1, 8):
        res = check_k1(torch, k1, M, In, H, torch.bfloat16, "skinny", gen, device, True, peaks,
                       unfused)
        report["k1"].append(res)
        print(f"[12] K1 skinny M={M} H={H}: {k1_summary(res)}")

    # 12b. generator.main on the card with the network policy from a
    # checkpoint of a flagship model with 4 actions, at B=1 and B=8.
    gconf = conf.replace(action_dim=4)
    run_dir = root / "runs" / "chip_smoke_generator"
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
                    or not policy_columns_ok(np, data)):
                raise AssertionError(f"generator B={B} files: {shapes}")
            batch = next(iter(SequentialDataset(make_repository(str(save_dir)), 16, 4, seed=0)))
            if batch["image"].shape != (16, 4, 64, 64, 3) or batch["policy_value"].shape != (16, 4):
                raise AssertionError(f"generator B={B}: dataset batch "
                                     f"{ {k: v.shape for k, v in batch.items()} }")
    finally:
        generator.NetworkPolicy, generator.VectorNetworkPolicy = plain_policies
        os.environ.pop("PYDREAMER_RUN_DIR", None)
    path_launches[("skinny", 1, H)] = out[1]["calls"]
    path_launches[("skinny", 8, H)] = out[8]["calls"]
    shutil.rmtree(run_dir)
    torch.cuda.empty_cache()

    # 12c. The launcher: two CPU generators feed the flagship learner on the card.
    run_dir = root / "runs" / "chip_smoke_launch"
    shutil.rmtree(run_dir, ignore_errors=True)
    env = {k: v for k, v in os.environ.items() if k != "PYDREAMER_RUN_DIR"}
    env["PYTHONPATH"] = str(root)
    cmd = ["timeout", "-k", "10", str(LAUNCH_TIMEOUT_S), sys.executable, "-m",
           "pydreamer_tpu_torch.launch", *LAUNCH_ARGS, "--run_dir", str(run_dir)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, env=env, start_new_session=True, text=True,
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
    return calls


# Phase 13: the MiniWorld preset (config/defaults.yaml `defaults` + `miniworld`,
# goals_size as its note asks) with both probes, read by the port's parse_args.
MINIWORLD_ARGS = ["--configs", "defaults", "miniworld", "--goals_size", "4",
                  "--probe_model", "map+goals", "--gru_type", "gru_layernorm_dv2"]
BASELINES = ("vae", "gru_vae", "transformer_vae", "gru_probe")
PROBE_METRICS = ("loss_map", "acc_map", "acc_map_seen", "mse_goals", "grad_norm_probe")


def make_probe_obs(torch, conf, gen, device):
    """A MiniWorld-shaped batch with the keys the Preprocessor makes for the
    probes (config/defaults.yaml:206-221) and ``action_next``; half the
    streams go on from the previous batch (no reset at t=0)."""
    obs = make_obs(torch, conf, gen, device)
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


def step_times(torch, ts, obs, state, n: int, first_step: int = 1):
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


def probe_phase(torch, k1, report, gen, device):
    """Phase 13: Dreamer with both probes and the four baselines at the
    MiniWorld width. Returns K1's launches by (schedule, M, H) and the
    number of calls that made them."""
    from pydreamer_tpu_torch.conf import parse_args
    from pydreamer_tpu_torch.models.baselines import WorldModelProbe
    from pydreamer_tpu_torch.models.dreamer import Dreamer
    from pydreamer_tpu_torch.models.noise import GeneratorNoise
    from pydreamer_tpu_torch.training.train_step import TrainStep

    config_dir = str(Path(__file__).resolve().parent / "config")
    conf = parse_args(MINIWORLD_ARGS, config_dir=config_dir)
    T, B, H_imag, H = conf.batch_length, conf.batch_size, conf.imag_horizon, conf.deter_dim
    out = report["probes"] = {}
    obs = make_probe_obs(torch, conf, gen, device)

    # 13a. Dreamer with the map and goals probes, K1 in both loops.
    torch.manual_seed(13)
    model = Dreamer(conf, device=device)
    ts = TrainStep(model, conf, device=device)
    probe_before = [p.detach().clone() for p in model.probe.parameters()]
    torch.cuda.reset_peak_memory_stats()
    times, state, _ = step_times(torch, ts, obs, model.init_state(B), 3)
    k1.LAUNCHES.reset()
    counted, state, metrics = step_times(torch, ts, obs, state, 1, first_step=4)
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
    launches = {(kind, M, H): sched[kind] + eval_sched[kind]
                for kind, M in (("skinny", B), ("wide", T * B))}

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
        times, state, metrics = step_times(torch, bts, obs, state0, 3)
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
    times, state, metrics = step_times(torch, TrainStep(imodel, iconf, device=device), obs,
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
    return launches, 2


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


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_rank(rank: int, port: int, mode: str, out_path: str, device: str = "cuda:0") -> None:
    """One of two ranks on ``device`` (the one card): 3 flagship steps on its
    rows of one global batch (``mode`` "dp": data 2; "tp": model 2,
    ``TP_MIN_SIZE``), then for "dp" 3 float32 steps; K1's launches by rows
    each step, the rank's parameter and AdamW bytes. Writes its report to
    ``out_path``."""
    import torch
    import torch.distributed as dist

    from pydreamer_tpu_torch.conf import Conf
    from pydreamer_tpu_torch.models.dreamer import Dreamer
    from pydreamer_tpu_torch.ops import gru_dv2 as k1
    from pydreamer_tpu_torch.parallel import DistributedContext, batch_sharding
    from pydreamer_tpu_torch.parallel.multihost import COLLECTIVE_TIMEOUT
    from pydreamer_tpu_torch.training.train_step import TrainStep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
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
               for k, v in make_obs(torch, conf, gen, device).items()}
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

    out["bf16"] = run(Conf(dict(FLAGSHIP, **mesh)), MESH_STEPS)
    if mode == "dp":
        out["f32"] = run(Conf(dict(FLAGSHIP, precision="float32", **mesh)), MESH_STEPS)
    dist.destroy_process_group()
    Path(out_path).write_text(json.dumps(out))


def spawn_mesh(mode: str, device: str = "cuda:0") -> list:
    """Two ``mesh_rank`` processes to their end; either failing or outliving
    ``RANK_TIMEOUT_S`` fails the phase. -> their reports."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    port = _free_port()
    paths = [OUT_DIR / f"phase14_{mode}_rank{r}.json" for r in range(2)]
    for p in paths:
        p.unlink(missing_ok=True)
    procs = [ctx.Process(target=mesh_rank, args=(r, port, mode, str(paths[r]), device))
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


def single_steps(torch, k1, conf, n: int, device):
    """The reference: one process, the whole batch, the same seeds; K1's
    launches counted each step."""
    from pydreamer_tpu_torch.models.dreamer import Dreamer
    from pydreamer_tpu_torch.training.train_step import TrainStep
    torch.manual_seed(0)
    model = Dreamer(conf, device=device)
    ts = TrainStep(model, conf, device=device)
    gen = torch.Generator(device=device).manual_seed(14)
    obs = make_obs(torch, conf, gen, device)
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


def f32_step_ab(torch, k1, conf, device, n: int) -> dict:
    """The float32 flagship step as the port runs it (K1 on ``skinny_f32`` /
    ``wide_f32``) against the same step with K1's launches put on the first
    f32 design (the FFMA schedule ``f32``), in turns (ffma, 3xtf32, 3xtf32,
    ffma), ``n`` steps a window after 2 warm-up steps. -> ms per step by
    variant and each window's launches by schedule."""
    from pydreamer_tpu_torch.models.dreamer import Dreamer
    from pydreamer_tpu_torch.training.train_step import TrainStep
    plan = k1.plan

    def ffma_plan(M, In, H, *dtypes):
        return k1.Plan("f32", workspace=M * 3 * H)

    torch.manual_seed(0)
    model = Dreamer(conf, device=device)
    ts = TrainStep(model, conf, device=device)
    gen = torch.Generator(device=device).manual_seed(14)
    obs = make_obs(torch, conf, gen, device)
    _, state, _ = timed_steps(torch, ts, obs, model.init_state(conf.batch_size), 0, 2)
    out, step = {"ffma": [], "3xtf32": [], "launches": []}, 2
    try:
        for variant in ("ffma", "3xtf32", "3xtf32", "ffma"):
            k1.plan = ffma_plan if variant == "ffma" else plan
            k1.LAUNCHES.reset()
            ms, state, _ = timed_steps(torch, ts, obs, state, step, n)
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


def mesh_phase(torch, k1, conf, report, path_launches, gen, device, peaks, unfused) -> dict:
    """Phase 14. Returns the data-parallel rank-steps that made the M=16 /
    M=768 launches and the tensor-parallel ones at M=32 / M=1536."""
    import os
    import shutil

    import torch.distributed as dist

    from pydreamer_tpu_torch.tracking import Run, load_checkpoint_file
    from pydreamer_tpu_torch.training import trainer

    T, B, H_imag = conf.batch_length, conf.batch_size, conf.imag_horizon
    In, H = conf.hidden_dim, conf.deter_dim
    out = report["mesh"] = {}

    # 14a. trainer.run at world size 1 under the production backend, then the
    # same 8 steps with no group. cuDNN is held deterministic for both runs.
    episodes = OUT_DIR / "learner_episodes"
    aconf = conf.replace(offline_data_dir=str(episodes / "train"),
                         offline_eval_dir=str(episodes / "eval"),
                         **dict(LEARNER, data_workers=1, n_steps=8, save_interval=8,
                                eval_interval=0, log_interval=4, mesh_data=0, mesh_model=1))
    runs = Path(__file__).resolve().parent / "runs"
    cudnn_flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), WORLD_SIZE="1", RANK="0",
               LOCAL_RANK="0", LOCAL_WORLD_SIZE="1")
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
    ref = single_steps(torch, k1, conf, MESH_STEPS, device)
    conf32 = conf.replace(precision="float32")
    ref32 = single_steps(torch, k1, conf32, MESH_STEPS, device)
    want_f32 = ({B: T, T * B: H_imag}, {"skinny_f32": T, "wide_f32": H_imag})
    for i, s in enumerate(ref32):
        if (s["by_rows"], s["by_schedule"]) != want_f32:
            raise AssertionError(f"[14b] one process, float32 step {i + 1}: K1 launches "
                                 f"{s['by_rows']} {s['by_schedule']}, expected {want_f32}")
    ab = f32_step_ab(torch, k1, conf32, device, AB_STEPS)
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
    path_launches[("skinny_f32", B, H)] = MESH_STEPS * T + n_ab * T
    path_launches[("wide_f32", T * B, H)] = MESH_STEPS * H_imag + n_ab * H_imag

    # 14b. Data parallel: two ranks, B=16 each.
    for M, want, dtype in ((B // 2, "skinny", torch.bfloat16), (T * B // 2, "wide", torch.bfloat16),
                           (B // 2, "skinny_f32", torch.float32),
                           (T * B // 2, "wide_f32", torch.float32)):
        res = check_k1(torch, k1, M, In, H, dtype, want, gen, device, True, peaks, unfused)
        report["k1"].append(res)
        print(f"[14b] K1 {want} M={M} H={H}: {k1_summary(res)}")
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
    path_launches[("skinny", B // 2, H)] = sum(s["by_schedule"]["skinny"] for r in dp
                                               for s in r["bf16"]["steps"])
    path_launches[("wide", T * B // 2, H)] = sum(s["by_schedule"]["wide"] for r in dp
                                                 for s in r["bf16"]["steps"])
    for sched, M in (("skinny_f32", B // 2), ("wide_f32", T * B // 2)):
        path_launches[(sched, M, H)] = sum(s["by_schedule"][sched] for r in dp
                                           for s in r["f32"]["steps"])

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
    path_launches[("skinny", B, H)] += sum(s["by_schedule"]["skinny"] for r in tp
                                           for s in r["bf16"]["steps"])
    path_launches[("wide", T * B, H)] += sum(s["by_schedule"]["wide"] for r in tp
                                             for s in r["bf16"]["steps"])
    return dict(dp_rank_steps=2 * MESH_STEPS, tp_rank_steps=2 * MESH_STEPS,
                f32_steps=MESH_STEPS + n_ab)


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
# are processes of their own, and the card has room for both.
LIVE_STEPS = 120
LIVE_ARGS = ["--configs", "defaults", "gridworld", "--gru_type", "gru_layernorm_dv2",
             "--limit_step_ratio", "200", "--model_reload_interval", "15",
             "--generator_log_every", "2", "--eval_interval", "0", "--save_interval", "40",
             "--log_interval", "10", "--data_workers", "2", "--n_steps", str(LIVE_STEPS)]
LIVE_TIMEOUT_S = 420


def run_tool(root, tool: str, *args) -> str:
    """``python -m pydreamer_tpu_torch.scripts.<tool> args`` -> its last line."""
    proc = subprocess.run([sys.executable, "-m", f"pydreamer_tpu_torch.scripts.{tool}",
                           *map(str, args)], cwd=root, capture_output=True, text=True)
    if proc.returncode != 0:
        raise AssertionError(f"{tool} exit {proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout.strip().splitlines()[-1]


def learning_phase(torch, k1, report, path_launches, per_step, gen, device, peaks,
                   unfused) -> None:
    """Phase 15: the live GridWorld run started (15c), K1 at the canaries' and
    the live run's shapes (15a), the four canaries on the card through K1
    (15b), then the live run's checks and the run tools. Adds the paths'
    launches by (schedule, M, H) and their train steps or acting calls by (M, H)."""
    import importlib.util
    import os
    import re
    import shutil
    import tempfile

    from pydreamer_tpu_torch.conf import parse_args
    from pydreamer_tpu_torch.scripts import canaries
    from pydreamer_tpu_torch.tracking import Run

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    out = report["learning"] = {}
    confs = {name: make("gru_layernorm_dv2") for name, make in canaries.CONFS.items()}
    live_conf = parse_args(LIVE_ARGS[:5], config_dir=str(root / "config"))

    # 15c, started: the launcher in a session of its own, its log to a file.
    run_dir = root / "runs" / "chip_smoke_live"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.parent.mkdir(exist_ok=True)
    env = {k: v for k, v in os.environ.items() if k != "PYDREAMER_RUN_DIR"}
    env["PYTHONPATH"] = str(root)
    cmd = ["timeout", "-k", "10", str(LIVE_TIMEOUT_S), sys.executable, "-m",
           "pydreamer_tpu_torch.launch", *LIVE_ARGS, "--run_dir", str(run_dir)]
    log_path = OUT_DIR / "live_log.txt"
    t_live = time.time()
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(cmd, cwd=root, env=env, start_new_session=True,
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
        res = check_k1(torch, k1, M, In_s, H_s, dtype, want, gen, device, True, peaks, unfused)
        report["k1"].append(res)
        print(f"[15a] K1 {want} M={M} In={In_s} H={H_s}: {k1_summary(res)}")

    # 15b. The canaries on the card, each launch of K1 counted.
    scratch = Path(tempfile.mkdtemp(prefix="canaries_", dir=root / "runs"))
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
            key = (sched_of[M], M, c.deter_dim)
            path_launches[key] = path_launches.get(key, 0) + n
            per_key = (M, c.deter_dim, "float32")
            per_step[per_key] = per_step.get(per_key, 0) + (
                r["policy_calls"] if M == 1 else r["steps"])
    shutil.rmtree(scratch)
    torch.cuda.empty_cache()

    # 15c. The live run's end and its checks.
    rc = proc.wait()
    live_s = log_path.stat().st_mtime - t_live  # to the launcher's last line
    log = log_path.read_text()
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
    path_launches[("skinny", B, H)] = path_launches.get(("skinny", B, H), 0) + sched["skinny"]
    path_launches[("wide", T * B, H)] = path_launches.get(("wide", T * B, H), 0) + sched["wide"]
    per_step[(B, H)] = per_step.get((B, H), 0) + n
    per_step[(T * B, H)] = per_step.get((T * B, H), 0) + n

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
    said = {"export_metrics": run_tool(root, "export_metrics", run_dir, csv_path)}
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
        said[tool] = run_tool(root, *args)
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
DV2 = "gru_layernorm_dv2"


def _finite(x) -> bool:
    """Every number in a tool's line finite (None: not measured on this path)."""
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, list):
        return all(_finite(v) for v in x)
    return x is None or isinstance(x, str) or math.isfinite(x)


def tools_phase(torch, k1, report, path_launches, per_step, peaks, smi: str,
                with_e2e: bool) -> None:
    """Phase 16: the measurement tools of ``pydreamer_tpu_torch/scripts/``, each
    ``main(argv)`` in-process on the card at the flagship width with short
    step counts. Checks each line's keys, its card provenance and finite
    values, K1's launches per step of ``bench_gru`` (exact, by cell), that
    ``profile_step`` saw kernels of both K1 schedules, and that ``roofline``'s
    K1 bound is phase 2's. K1's launches in the phase are counted by rows
    (each tool's own, set to 0 before it and read after) and added to the
    flagship rows (``skinny`` M=32, ``wide`` M=1536)."""
    from pydreamer_tpu_torch.scripts import (bench, bench_conv, bench_dream, bench_e2e, bench_gru,
                                             bench_step_ab, flagship, roofline, scaling_bench)
    from pydreamer_tpu_torch.scripts import profile_step as profile_tool

    conf = flagship.make_conf()
    T, B, H_imag, In, H = (conf.batch_length, conf.batch_size, conf.imag_horizon,
                           conf.hidden_dim, conf.deter_dim)
    w, n = TOOL_STEPS["warmup"], TOOL_STEPS["steps"]
    out = report["tools"] = {"seconds": {}}
    name = torch.cuda.get_device_name(0)
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
        bound = roofline.k1_bound_ms(M, In, H, peaks, True)[0]
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

    path_launches[("skinny", B, H)] = path_launches.get(("skinny", B, H), 0) + T * dv2_steps
    path_launches[("wide", T * B, H)] = (path_launches.get(("wide", T * B, H), 0)
                                         + H_imag * (dv2_steps + dream_calls))
    per_step[(B, H)] = per_step.get((B, H), 0) + dv2_steps
    per_step[(T * B, H)] = per_step.get((T * B, H), 0) + dv2_steps + dream_calls
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



def finish(torch, report, path_launches, per_step, smi: str, name: str) -> int:
    """The kernels line (one entry per timed K1 row: its launches on the path
    that runs its shape, per train step or acting call), the nvidia-smi line
    and the last line."""
    kernels = []
    for r in report["k1"]:
        n = path_launches.get((r["schedule"], r["M"], r["H"]), 0)
        steps = per_step.get((r["M"], r["H"]) if r["dtype"] == "bfloat16"
                             else (r["M"], r["H"], "float32"))
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
    marks = sorted(report.pop("phase_start").items(), key=lambda kv: kv[1])
    marks.append(("end", time.perf_counter()))
    report["phase_s"] = {str(a): b_t - a_t for (a, a_t), (_, b_t) in zip(marks, marks[1:])}
    print(f"[t] seconds by phase: { {k: round(v, 1) for k, v in report['phase_s'].items()} }; "
          f"total {marks[-1][1] - marks[0][1]:.1f}")
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--learning-only"], ["--tools-only"]):
        print("usage: chip_smoke.py [--learning-only | --tools-only]  (phases 1 and 15 alone; "
              "phases 1, 2 at the flagship shapes, and 16 with bench_e2e)", file=sys.stderr)
        return 2
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
    report = {"phase_start": {}}

    report["phase_start"][1] = time.perf_counter()
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

    report["phase_start"][2] = time.perf_counter()
    # 2. Every K1 schedule against its plain version; times beside the yardsticks.
    conf = Conf(FLAGSHIP)
    T, B, H_imag = conf.batch_length, conf.batch_size, conf.imag_horizon
    In, H = conf.hidden_dim, conf.deter_dim
    gen = torch.Generator(device=device).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    unfused = unfused_cell(torch, layer_norm)
    report["k1"] = []
    if argv == ["--learning-only"]:
        report["phase_start"][15] = report["phase_start"].pop(2)
        path_launches, per_step = {}, {}
        learning_phase(torch, k1, report, path_launches, per_step, gen, device, peaks, unfused)
        return finish(torch, report, path_launches, per_step, smi, name)
    if argv == ["--tools-only"]:
        for M, want in ((B, "skinny"), (T * B, "wide")):
            res = check_k1(torch, k1, M, In, H, bf16, want, gen, device, True, peaks, unfused)
            report["k1"].append(res)
            print(f"[2] K1 {want} M={M} H={H} {res['dtype']}: {k1_summary(res)}")
        report["phase_start"][16] = time.perf_counter()
        path_launches, per_step = {}, {}
        tools_phase(torch, k1, report, path_launches, per_step, peaks, smi, with_e2e=True)
        return finish(torch, report, path_launches, per_step, smi, name)
    for M, H_s, dtype, want in ((B, H, bf16, "skinny"), (T * B, H, bf16, "wide"),
                                (B, 2048, bf16, "skinny"), (T * B, 2048, bf16, "wide"),
                                (B, H, f32, "skinny_f32"), (T * B, H, f32, "wide_f32"),
                                (B, 2048, f32, "skinny_f32"), (T * B, 2048, f32, "wide_f32")):
        res = check_k1(torch, k1, M, In, H_s, dtype, want, gen, device, True, peaks, unfused)
        report["k1"].append(res)
        print(f"[2] K1 {want} M={M} H={H_s} {res['dtype']}: {k1_summary(res)}")
    for M, In_s, H_s, dtype, want in ((5, 37, 50, bf16, "generic"), (70, 129, 67, bf16, "generic"),
                                      (1, 8, 16, bf16, "generic"), (5, 37, 50, f32, "f32"),
                                      (70, 129, 67, f32, "f32")):
        res = check_k1(torch, k1, M, In_s, H_s, dtype, want, gen, device, False, peaks)
        print(f"[2] K1 {want} M={M} In={In_s} H={H_s} {res['dtype']}: max_abs_err "
              f"{res['max_abs_err']:.3e}, grads ok")
    # The fused cell under precision: float32 runs K1's skinny_f32 schedule at M=B.
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
    if (out32.dtype != f32 or k1.LAUNCHES.by_schedule != {"skinny_f32": 1}
            or not err32 <= FWD_TOL_F32):
        raise AssertionError(f"float32 cell: {out32.dtype}, {k1.LAUNCHES.by_schedule}, err {err32}")

    report["phase_start"][3] = time.perf_counter()
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

    report["phase_start"][4] = time.perf_counter()
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

    report["phase_start"][5] = time.perf_counter()
    # 5. Profile one step.
    state, prof5, events = profile_step(ts, obs, state, step + 1)
    report["profile"] = prof5
    table = events.table(sort_by="self_device_time_total", row_limit=30)
    print(f"[5] profiled step: wall {prof5['wall_ms']:.2f} ms, device busy "
          f"{prof5['device_busy_ms']:.2f} ms; K1 {prof5['k1_ms']:.3f} ms in {prof5['k1_kernels']}; "
          f"launched {prof5['launched']}, recorded {prof5['k1_launches']}")
    check_profiled_k1(prof5, T, H_imag, "[5] profiled step")
    step += 1

    report["phase_start"][6] = time.perf_counter()
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

    report["phase_start"][7] = time.perf_counter()
    # 7. Inference shapes: skinny at M=1 and M=8, H=2048, against its plain version.
    for M in (1, 8):
        res = check_k1(torch, k1, M, In, 2048, bf16, "skinny", gen, device, True, peaks, unfused)
        report["k1"].append(res)
        print(f"[7] K1 skinny M={M} H=2048: {k1_summary(res)}")

    report["phase_start"][8] = time.perf_counter()
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

    report["phase_start"][9] = time.perf_counter()
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
    dstate, prof9, events9 = profile_step(dts, dobs, dstate, dstep + 1)
    dstep += 1
    report["dmc"]["profile"] = prof9
    print(f"[9] profiled DMC step: wall {prof9['wall_ms']:.2f} ms, device busy "
          f"{prof9['device_busy_ms']:.2f} ms; K1 {prof9['k1_ms']:.3f} ms {prof9['k1_ms_by_kernel']}; "
          f"f32 GEMMs (K1's backward recompute) {prof9['f32_gemm_ms']:.3f} ms in "
          f"{prof9['f32_gemm_calls']} calls; K1 launched {prof9['launched']}, recorded "
          f"{prof9['k1_launches']}")
    check_profiled_k1(prof9, T, H_imag, "[9] profiled DMC step")
    (OUT_DIR / "chip_smoke_profile.txt").write_text(
        f"{smi}\n[5] flagship step\n{table}\n[9] DMC step\n"
        f"{events9.table(sort_by='self_device_time_total', row_limit=40)}\n")

    report["phase_start"][10] = time.perf_counter()
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
    del dmodel, dts, dstate, dobs
    torch.cuda.empty_cache()

    report["phase_start"][11] = time.perf_counter()
    # 11. The learner loop: trainer.run on the flagship model from episode files.
    n_test_calls = learner_phase(torch, k1, conf, report, path_launches, gen, device, peaks,
                                 unfused)

    report["phase_start"][12] = time.perf_counter()
    # 12. The actors: K1 at the flagship's acting shapes, the generator on the
    #     card, the launcher feeding the learner from live generators.
    acting_calls = generator_phase(torch, k1, conf, report, path_launches, gen, device, peaks,
                                   unfused)

    report["phase_start"][13] = time.perf_counter()
    # 13. The probes and the baselines at the MiniWorld width.
    probe_launches, probe_calls = probe_phase(torch, k1, report, gen, device)
    for key, n in probe_launches.items():
        path_launches[key] += n

    report["phase_start"][14] = time.perf_counter()
    # 14. The learner on a mesh: NCCL at world size 1, two data ranks, two
    #     model ranks.
    mesh_steps = mesh_phase(torch, k1, conf, report, path_launches, gen, device, peaks, unfused)

    # Launches by shape on each path: flagship (phase 4, 5 steps), DMC (phase
    # 9, 5 steps) with the MiniWorld probes (phase 13, a step and an eval
    # call), inference (phase 10, 50 calls), the learner's test protocol
    # (phase 11, per eval call), the generator's acting calls (phase 12) and
    # the mesh's rank-steps (phase 14: data ranks at M=16 / M=768, model ranks
    # at the flagship shapes); 0 where no path runs it.
    per_step = {(B, H): n_steps + mesh_steps["tp_rank_steps"],
                (T * B, H): n_steps + mesh_steps["tp_rank_steps"],
                (B // 2, H): mesh_steps["dp_rank_steps"],
                (T * B // 2, H): mesh_steps["dp_rank_steps"], (B, Hd): n_steps + probe_calls,
                (T * B, Hd): n_steps + probe_calls,
                (1, Hd): n_calls, (8, Hd): n_calls,
                (LEARNER["test_batch_size"], H): n_test_calls,
                (T * LEARNER["test_batch_size"], H): n_test_calls,
                (1, H): acting_calls[1], (8, H): acting_calls[8],
                (B, H, "float32"): mesh_steps["f32_steps"],
                (T * B, H, "float32"): mesh_steps["f32_steps"],
                (B // 2, H, "float32"): mesh_steps["dp_rank_steps"],
                (T * B // 2, H, "float32"): mesh_steps["dp_rank_steps"]}
    report["phase_start"][15] = time.perf_counter()
    # 15. Learning on the card: K1 at the new shapes, the canaries through K1,
    #     the live GridWorld run and the run tools.
    learning_phase(torch, k1, report, path_launches, per_step, gen, device, peaks, unfused)

    report["phase_start"][16] = time.perf_counter()
    # 16. The measurement tools at the flagship width (bench_e2e under --tools-only).
    tools_phase(torch, k1, report, path_launches, per_step, peaks, smi, with_e2e=False)
    return finish(torch, report, path_launches, per_step, smi, name)


if __name__ == "__main__":
    sys.exit(main())
