"""Orchestration: spawn N generator processes + 1 learner, watchdog them.

Counterpart of ``pydreamer_tpu/launch.py`` (reference: launch.py:16-210):
  * parse ``--configs a b c`` + per-key overrides (conf.py)
  * detect a distributed role from TF_CONFIG (chief -> learner,
    worker[i] -> generator i); non-main workers wait for the main worker to
    create the run before joining (launch.py:45-47, tools.py:66-81)
  * spawn train+eval generators (split_fraction=0.05), optional train-only /
    eval-only generator pools, and the learner as multiprocessing Processes
  * watchdog: poll every second, fail fast if any child dies nonzero
    (launch.py:114-120,168-178); relaunch a learner that asks to be
    recycled; stop the generators when the learner is done

Learner ranks: JAX's one learner process drives every device of its host.
The port runs one learner process (rank) per device of the host's share of
the mesh (``learner_ranks``): ``mesh_data * mesh_model`` ranks over the
job's nodes when both are given, every visible card when ``mesh_data`` is 0,
and one rank, with no process group, when there is no card or under
``debug`` (``mesh_data: 1``). Each rank gets torch's environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``); a multi-node job sets ``NNODES``, ``NODE_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT`` (torch's names), else the launcher uses
one node, ``127.0.0.1`` and a free port. Generators start once per host. The
watchdog covers every rank; the ranks recycle together (the trainer decides
it unanimously) and the launcher relaunches all of them.

Device split: the learner trains on the card (``trainer.run``'s rule: the
CPU only under ``platform: cpu``, the ``debug`` preset) and each generator
acts on the CPU because this launcher passes ``device="cpu"`` to
``generator.main``, so only the learner ranks use the cards. Nothing here
touches CUDA before the workers are spawned, so no child inherits a CUDA
context. Every worker's torch gets an equal share of the threads torch
would use here (``torch.get_num_threads()``: the host's cores, or
``OMP_NUM_THREADS``), ``threads // (generators + ranks)``: torch's default,
all of them in every process, oversubscribes the host once the generators
act, and spinning OpenMP threads then hold back the learner's host-bound
step.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import signal
import socket
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from .conf import parse_args
from .tools import configure_logging, logger, print_once
from .tracking import init_run

__all__ = ["launch", "launch_learner", "launch_generator", "check_subprocesses",
           "belongs_to_worker", "get_worker_info", "learner_ranks", "rank_environments",
           "RECYCLE_EXIT_CODE"]

# Learner exit code meaning "relaunch me" (clean self-recycle after hitting
# conf.max_rss_gb, see training/trainer.py). Distinct from 0 (done) and from
# error codes (fail the job).
RECYCLE_EXIT_CODE = 42


def _generator_entry(kwargs, num_threads: int):
    torch.set_num_threads(num_threads)
    from . import generator
    generator.main(**kwargs, device="cpu")


def _learner_entry(conf, run_dir, num_threads: Optional[int] = None,
                   env: Optional[Dict[str, str]] = None):
    """One learner rank: ``env`` is its torch environment (none for a lone
    learner)."""
    os.environ.update(env or {})
    if num_threads:
        torch.set_num_threads(num_threads)
    import torch.distributed as dist

    from .ops import gru_dv2
    from .training import trainer
    result = trainer.run(conf, run_dir=run_dir)
    rank = dist.get_rank() if dist.is_initialized() else 0
    logger.info("Learner %sK1 launches: by schedule %s, by rows %s",
                f"rank {rank} " if rank else "", json.dumps(gru_dv2.LAUNCHES.by_schedule),
                json.dumps(gru_dv2.LAUNCHES.by_rows))
    if dist.is_initialized():
        dist.destroy_process_group()
    if result == "recycle":
        sys.exit(RECYCLE_EXIT_CODE)


def learner_ranks(conf) -> int:
    """Learner ranks on this host: the host's share of ``mesh_data *
    mesh_model`` over ``NNODES`` nodes, or every visible card under
    ``mesh_data: 0`` (one without a card or under ``platform: cpu``)."""
    n_data, n_model = conf.get("mesh_data", 0), max(conf.get("mesh_model", 1), 1)
    nnodes = int(os.environ.get("NNODES", "1"))
    if n_data > 0:
        world = n_data * n_model
        if world % nnodes:
            raise ValueError(f"mesh {n_data}x{n_model} does not split over {nnodes} nodes")
        return world // nnodes
    if conf.get("platform") == "cpu":
        return 1
    return max(torch.cuda.device_count(), 1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_environments(n_local: int) -> List[Dict[str, str]]:
    """torch's environment for each of this host's ``n_local`` ranks, or one
    empty environment (no process group) for a lone rank on one node."""
    nnodes = int(os.environ.get("NNODES", "1"))
    if n_local == 1 and nnodes == 1:
        return [{}]
    node = int(os.environ.get("NODE_RANK", "0"))
    common = dict(MASTER_ADDR=os.environ.get("MASTER_ADDR", "127.0.0.1"),
                  MASTER_PORT=os.environ.get("MASTER_PORT", str(_free_port())),
                  WORLD_SIZE=str(nnodes * n_local), LOCAL_WORLD_SIZE=str(n_local),
                  NNODES=str(nnodes), NODE_RANK=str(node))
    return [dict(common, RANK=str(node * n_local + i), LOCAL_RANK=str(i))
            for i in range(n_local)]


def launch(argv: Optional[List[str]] = None, config_dir: str = "./config"):
    configure_logging("[launcher]")
    conf = parse_args(argv, config_dir=config_dir)

    worker_type, worker_index = get_worker_info()
    is_main_worker = worker_type is None or worker_type == "learner"
    run_ = init_run(run_dir=conf.get("run_dir"),
                    resume_id=os.environ.get("PYDREAMER_RESUME_ID"),
                    wait_for_resume=not is_main_worker)
    run_.log_params(conf.to_dict())
    artifact_dir = run_.dir

    ctx = mp.get_context("spawn")  # CUDA is not fork-safe
    subprocesses: List[mp.Process] = []
    n_generators = sum(
        belongs_to_worker(kind, i) for kind, n in (
            ("generator", conf.generator_workers),
            ("generator_train", conf.generator_workers_train),
            ("generator_eval", conf.generator_workers_eval)) for i in range(n))
    n_ranks = learner_ranks(conf) if belongs_to_worker("learner", 0) else 0
    num_threads = max(1, torch.get_num_threads() // (n_generators + max(n_ranks, 1)))

    # SIGTERM must reap the worker pool: the default handler exits without
    # unwinding, so the finally-kill below never runs and the spawned
    # learner/generators survive as orphans double-writing the run dir.
    # Raising SystemExit routes the signal through the try/finally.
    def _terminate(signum, frame):
        raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, _terminate)

    # Train+eval generators.
    for i in range(conf.generator_workers):
        if belongs_to_worker("generator", i):
            logger.info("Launching train+eval generator %d", i)
            subprocesses.append(launch_generator(
                ctx, conf.env_id, conf,
                save_uri=str(artifact_dir / "episodes" / str(i)),
                save_uri2=str(artifact_dir / "episodes_eval" / str(i)),
                num_steps=conf.n_env_steps // conf.env_action_repeat // conf.generator_workers,
                limit_step_ratio=conf.limit_step_ratio / conf.generator_workers,
                worker_id=i,
                policy_main="network",
                policy_prefill=conf.generator_prefill_policy,
                num_steps_prefill=conf.generator_prefill_steps // conf.generator_workers,
                split_fraction=0.05,
                num_threads=num_threads,
            ))

    # Train-only generators.
    for i in range(conf.generator_workers_train):
        if belongs_to_worker("generator_train", i):
            logger.info("Launching train generator %d", i)
            subprocesses.append(launch_generator(
                ctx, conf.env_id, conf,
                save_uri=str(artifact_dir / "episodes" / str(i)),
                num_steps=conf.n_env_steps // conf.env_action_repeat // max(conf.generator_workers_train, 1),
                limit_step_ratio=conf.limit_step_ratio / max(conf.generator_workers_train, 1),
                worker_id=i,
                policy_main="network",
                policy_prefill=conf.generator_prefill_policy,
                num_steps_prefill=conf.generator_prefill_steps // max(conf.generator_workers_train, 1),
                num_threads=num_threads,
            ))

    # Eval-only generators.
    for i in range(conf.generator_workers_eval):
        if belongs_to_worker("generator_eval", i):
            logger.info("Launching eval generator %d", i)
            subprocesses.append(launch_generator(
                ctx, conf.get("env_id_eval") or conf.env_id, conf,
                save_uri=str(artifact_dir / "episodes_eval" / str(i)),
                worker_id=conf.generator_workers + i,
                policy_main="network",
                metrics_prefix="agent_eval",
                num_threads=num_threads,
            ))

    # Learner: one process per rank of this host.
    def start_learners() -> List[mp.Process]:
        procs = []
        for env in rank_environments(n_ranks):
            logger.info("Launching learner%s", f" rank {env['RANK']}" if env else "")
            p = ctx.Process(target=_learner_entry, daemon=False,
                            args=(conf, str(artifact_dir), num_threads, env))
            p.start()
            procs.append(p)
        return procs

    learners = start_learners() if n_ranks else []
    subprocesses.extend(learners)

    try:
        while subprocesses:
            # Learner self-recycle (max_rss_gb): once every rank has asked,
            # relaunch them all; they resume from the checkpoint while the
            # generators keep running.
            waiting = [p for p in learners if not p.is_alive()
                       and p.exitcode == RECYCLE_EXIT_CODE]
            if learners and len(waiting) == len(learners):
                logger.info("Learner requested recycle; relaunching.")
                subprocesses = [p for p in subprocesses if p not in learners]
                learners, waiting = start_learners(), []
                subprocesses.extend(learners)
            live = [p for p in subprocesses if p not in waiting]
            check_subprocesses(live)  # raises on a failure, drops what finished
            subprocesses = live + waiting
            # When the learner completes cleanly there is nothing left to
            # train; shut the generator pool down too (the reference hangs
            # here waiting on infinite generators).
            if learners and not any(p in subprocesses for p in learners):
                logger.info("Learner finished; shutting down generators.")
                break
            time.sleep(1)
    finally:
        for p in subprocesses:
            p.kill()
        for p in subprocesses:
            p.join()


def launch_generator(ctx, env_id, conf, save_uri, save_uri2=None,
                     policy_main="network", policy_prefill="random",
                     worker_id=0, num_steps=int(1e9), num_steps_prefill=0,
                     limit_step_ratio=0.0, split_fraction=0.0,
                     metrics_prefix="agent", log_metrics=True,
                     num_threads: Optional[int] = None) -> mp.Process:
    """Start one generator process acting on the CPU with ``num_threads``
    torch threads (default: torch's own count)."""
    p = ctx.Process(
        target=_generator_entry, daemon=True,
        args=(dict(
            env_id=env_id,
            save_uri=save_uri,
            save_uri2=save_uri2,
            env_time_limit=conf.env_time_limit,
            env_action_repeat=conf.env_action_repeat,
            env_no_terminal=conf.env_no_terminal,
            limit_step_ratio=limit_step_ratio,
            policy_main=policy_main,
            policy_prefill=policy_prefill,
            num_steps=num_steps,
            num_steps_prefill=num_steps_prefill,
            worker_id=worker_id,
            model_conf=conf,
            log_metrics=log_metrics,
            split_fraction=split_fraction,
            metrics_prefix=metrics_prefix,
            metrics_gamma=conf.gamma,
            log_every=conf.get("generator_log_every", 10),
            envs_per_worker=conf.get("generator_envs_per_worker", 1),
        ), num_threads or torch.get_num_threads()))
    p.start()
    return p


def launch_learner(conf, run_dir: Optional[str] = None) -> mp.Process:
    ctx = mp.get_context("spawn")
    p = ctx.Process(target=_learner_entry, daemon=False, args=(conf, run_dir))
    p.start()
    return p


def check_subprocesses(subprocesses: List[mp.Process]):
    finished = []
    for p in subprocesses:
        if not p.is_alive():
            if p.exitcode == 0:
                finished.append(p)
                logger.info("Process %d finished", p.pid)
            else:
                raise RuntimeError(
                    f"Process {p.pid} died with exitcode {p.exitcode}")
    for p in finished:
        subprocesses.remove(p)


def belongs_to_worker(work_type: str, work_index: int) -> bool:
    """Which subprocesses start on this node (reference: launch.py:181-190)."""
    worker_type, worker_index = get_worker_info()
    return ((worker_type is None or worker_type == work_type) and
            (worker_index is None or worker_index == work_index))


def get_worker_info() -> Tuple[Optional[str], Optional[int]]:
    """TF_CONFIG cluster role -> (worker_type, worker_index)
    (reference: launch.py:193-210)."""
    worker_type = None
    worker_index = None
    if "TF_CONFIG" in os.environ:
        tf_config = json.loads(os.environ["TF_CONFIG"])
        print_once("TF_CONFIG is set:", tf_config)
        if tf_config["cluster"].get("worker"):
            worker_type = {
                "chief": "learner",
                "worker": "generator",
            }[str(tf_config["task"]["type"])]
            worker_index = int(tf_config["task"]["index"])
            print_once("Distributed run detected, current worker is:",
                       f"{worker_type} ({worker_index})")
    return worker_type, worker_index


if __name__ == "__main__":
    launch()
