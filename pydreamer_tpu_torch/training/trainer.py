"""Learner runtime: the gradient-step loop.

Counterpart of ``pydreamer_tpu/training/trainer.py`` (reference: train.py:
24-303): prefill wait, one TBTT state per data stream, the train step,
metric windows of means and maxima, periodic npz batch dumps, periodic
checkpoints (the policy channel, see ``tracking.py``), the eval protocol,
and a stop at ``n_steps`` / ``n_env_steps``.

Its multi-host branches run over ``torch.distributed`` with one process
(rank) per device, which ``launch.py`` or ``torchrun`` start with torch's
environment (``parallel/multihost.py``). When a group is active:

  * the rank trains on ``cuda:LOCAL_RANK`` unless the caller names a device,
    inside a ``parallel.DistributedContext`` (JAX trainer.py:144-149) whose
    ``mesh_data`` x ``mesh_model`` mesh covers the world; ``batch_size`` must
    divide over the data ranks. Without a group a mesh larger than one rank
    raises instead of training on one device;
  * each rank streams ``batch_size / n_data`` rows (``local_b``) with its
    data index in the seed (``* 7919``, :195-206) in strict round-robin
    order, each stream with its own TBTT state of ``local_b * I`` rows. The
    ranks of one ``model`` group step on the batches their first rank reads
    (``share_batch``);
  * the replay is per host (its generators write it): the prefill target is
    ``generator_prefill_steps // hosts`` and each host's count enters the
    global sum once (through its local rank 0), so the prefill and env-step
    stops are unanimous (:110-134, :301-309);
  * rank 0 alone writes the architecture text, the metric rows, the
    checkpoints (gathered over 'model' first, so the format is the
    single-process one) and the npz dumps (gathered over 'data' into the
    global batch), and runs the eval on a whole copy of the weights;
  * a resume reads the whole checkpoint on every rank, which keeps its
    blocks;
  * the RSS self-recycle is decided by all ranks together (an all-reduce
    MAX). JAX decides per process and then enters a collective that the
    other processes never reach.

Differences that follow from PyTorch:

  * ``run`` takes ``device`` (default ``"cuda"``, raising without a card);
    ``conf.platform == "cpu"`` (the ``debug`` preset) asks for the CPU;
  * data workers are threads and ``data/prefetch.py`` copies batches to the
    card through pinned memory on a side stream;
  * the previous step's 0-d metrics are fetched in one transfer that is
    queued right behind that step's kernels (``_MetricsFetch``), so reading
    them does not wait for the current step's device work;
  * the prefill counter is logged at the step the run resumes from, not at
    step 0 on every restart as the JAX loop does;
  * ``torch.profiler`` traces steps 11-12 into ``<run>/profiling`` when
    ``enable_profiler`` is set (``_ProfileWindow``).
"""

from __future__ import annotations

import time
import warnings
from collections import defaultdict
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..conf import Conf
from ..data import (ParallelLoader, Preprocessor, SequentialDataset, make_repository,
                    prefetch_iterator)
from ..device import resolve_device
from ..models.baselines import WorldModelProbe
from ..models.dreamer import Dreamer
from ..models.noise import GeneratorNoise
from ..parallel import DistributedContext
from ..parallel.multihost import (global_any, global_sum, is_main_process, local_batch_size,
                                  local_rank, local_world_size, maybe_initialize_distributed,
                                  world_size)
from ..tools import Timer, configure_logging, logger, print_once, timers_summary
from ..tracking import Run, init_run
from .train_step import TrainStep

__all__ = ["run", "evaluate", "prepare_batch_npz", "log_batch_npz", "make_model", "to_list"]


def to_list(s):
    return s if isinstance(s, list) else [s]


def make_model(conf, device: str | torch.device = "cuda"):
    """Model factory (reference: train.py:104-107): ``Dreamer`` (DreamerV2,
    or DreamerV3 under ``model: dreamerv3``), or a baseline world model with
    its probe."""
    if conf.model in ("dreamer", "dreamerv3"):
        return Dreamer(conf, device=device)
    return WorldModelProbe(conf, device=device)


def run(conf: Conf, run_dir: Optional[str] = None, max_steps: Optional[int] = None,
        device: str | torch.device = "cuda"):
    """Train until n_steps / n_env_steps (reference: train.py:24).

    Returns None at the end, or ``"recycle"`` when host RSS passed
    ``max_rss_gb`` (after a checkpoint), so a launcher can restart the
    learner, which then resumes.
    """
    configure_logging(prefix="[TRAIN]")
    if conf.get("platform") == "cpu":
        device = "cpu"  # the debug preset runs the learner on the CPU
    device = torch.device(device)
    distributed = maybe_initialize_distributed(device.type)
    if distributed and device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank())
    device = resolve_device(device)
    logger.info("Learner device: %s", device)
    ctx, local_b = None, conf.batch_size
    if distributed:
        ctx = DistributedContext(conf, device)
        local_b = local_batch_size(conf.batch_size, ctx.n_data)
    elif max(conf.get("mesh_data", 0), conf.get("mesh_model", 1)) > 1:
        raise ValueError(
            f"mesh {conf.get('mesh_data', 0)}x{conf.get('mesh_model', 1)} but no process group: "
            "start one rank per device (the launcher, or torchrun with torch's environment)")
    elif device.type == "cuda" and torch.cuda.device_count() > 1:
        logger.warning("%d cards visible, training on %s only: start one rank per card to use "
                       "them all", torch.cuda.device_count(), device)
    main = is_main_process()
    run_ = init_run(run_dir=run_dir)
    artifact_dir = run_.dir
    timers_summary(reset=True)

    # Data directories (reference: train.py:34-60).
    if conf.offline_data_dir:
        online_data = False
        input_dirs = to_list(conf.offline_data_dir)
    else:
        online_data = True
        input_dirs = [
            str(artifact_dir / "episodes" / str(i))
            for i in range(max(conf.generator_workers_train, conf.generator_workers))
        ]
    if conf.offline_prefill_dir:
        input_dirs.extend(to_list(conf.offline_prefill_dir))
    if conf.offline_eval_dir:
        eval_dirs = to_list(conf.offline_eval_dir)
    else:
        eval_dirs = [
            str(artifact_dir / "episodes_eval" / str(i))
            for i in range(max(conf.generator_workers_eval, conf.generator_workers))
        ]
    test_dirs = to_list(conf.offline_test_dir) if conf.offline_test_dir else eval_dirs

    # Model + optimizer, then resume (reference: train.py:104-116). Both come
    # before the prefill wait so that the wait logs at the resumed step.
    torch.manual_seed(conf.get("seed", 0))
    model = make_model(conf, device)
    if main:
        run_.log_text(_describe_params(model), "architecture.txt")
    trainstep = TrainStep(model, conf, device=device, ctx=ctx)
    steps = 0
    ckpt = run_.load_checkpoint(device)
    if ckpt is not None:
        state_dict, steps = ckpt
        if ctx is not None:  # every rank reads the whole file and keeps its blocks
            state_dict = ctx.place_like(state_dict, trainstep.optimizer)
        model.load_state_dict(state_dict["model"])
        trainstep.optimizer.load_state_dict(state_dict["optimizer"])
        logger.info("Loaded model from checkpoint epoch %d", steps)

    # Wait for prefill (reference: train.py:62-82). Each host waits for its
    # own replay; the stop is decided on the sum over hosts, so all agree.
    if online_data:
        prefill_target = conf.generator_prefill_steps // _hosts()
        last_logged_steps = -1
        while True:
            _, steps_now, _ = make_repository(input_dirs).count_steps()
            # Log the counter only when it changes: a long prefill polls
            # every 10 s.
            if main and steps_now != last_logged_steps:
                run_.log_metrics(
                    {"train/data_steps": steps_now,
                     "train/data_env_steps": steps_now * conf.env_action_repeat},
                    step=steps)
                last_logged_steps = steps_now
            if steps_now < prefill_target:
                logger.debug("Waiting for prefill: %d/%d steps...", steps_now, prefill_target)
                time.sleep(10)
            else:
                logger.info("Done prefilling: %d/%d steps.", steps_now, prefill_target)
                break
        if _replay_steps(steps_now) * conf.env_action_repeat >= conf.n_env_steps:
            logger.info("Finished %d env steps.", conf.n_env_steps)
            return

    preprocess = Preprocessor.from_conf(conf)

    # Input pipeline: N worker threads, each an independent TBTT stream of
    # local_b rows; under a mesh the data index offsets the seed and the
    # streams take turns in a fixed order (JAX trainer.py:191-210). Only the
    # first rank of a model group reads; the others receive its batches.
    data_index = 0 if ctx is None else ctx.mesh.data_index

    def make_stream(worker_id: int):
        data = SequentialDataset(
            make_repository(input_dirs), conf.batch_length, local_b,
            skip_first=True,
            reload_interval=120 if online_data else 0,
            buffer_size=conf.buffer_size if online_data else conf.buffer_size_offline,
            reset_interval=conf.reset_interval,
            allow_mid_reset=conf.allow_mid_reset,
            seed=conf.get("seed", 0) * 1000 + worker_id + data_index * 7919)
        return preprocess(iter(data))

    loader = data_iter = None
    if ctx is None or ctx.mesh.model_index == 0:
        loader = ParallelLoader(make_stream, num_workers=conf.data_workers,
                                strict_order=ctx is not None)
        data_iter = prefetch_iterator(iter(loader), device, size=2,
                                      transform=_make_input_transform())
    profiler = _ProfileWindow(run_, device, conf.get("enable_profiler", False))
    try:
        return _train_loop(conf, model, trainstep, data_iter, run_, steps, max_steps,
                           online_data, input_dirs, test_dirs, eval_dirs, preprocess,
                           profiler, ctx, local_b)
    finally:
        profiler.close()
        if loader is not None:
            loader.close()
            data_iter.close()


def _hosts() -> int:
    """Hosts of the learner's world: each holds one replay, which its own
    generators write and all its ranks read."""
    return max(world_size() // local_world_size(), 1)


def _replay_steps(steps_local: int) -> int:
    """The replay steps of all hosts: each host's count once, through its
    local rank 0. A collective under a process group."""
    return global_sum(steps_local if local_rank() == 0 else 0)


class _ProfileWindow:
    """``torch.profiler`` over steps [11, 13) after warmup (reference
    schedule wait=10/warmup=10/active=1, train.py:468-476), exported as a
    Chrome trace under ``<run>/profiling``. A run resumed past step 11
    traces nothing; ``close()`` stops a trace the run ended inside."""

    WINDOW = (11, 13)

    def __init__(self, run_: Run, device: torch.device, enabled: bool):
        self.run_, self.device, self.enabled = run_, device, enabled
        self.profiler = None

    def before_step(self, step: int):
        if self.enabled and step == self.WINDOW[0]:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.profiler = torch.profiler.profile(activities=activities)
            self.profiler.start()
        elif self.profiler is not None and step == self.WINDOW[1]:
            self.profiler.stop()
            trace = self.run_.artifact_dir("profiling") / f"trace_{step - 1:07}.json"
            self.profiler.export_chrome_trace(str(trace))
            logger.info("Saved profiler trace to %s", trace)
            self.profiler = None

    def close(self):
        if self.profiler is not None:
            self.profiler.stop()
            self.profiler = None


def _train_loop(conf, model, trainstep, data_iter, run_, steps, max_steps,
                online_data, input_dirs, test_dirs, eval_dirs, preprocess, profiler,
                ctx, local_b):
    states: Dict[int, tuple] = {}  # TBTT state per data worker (train.py:168-178)
    main = is_main_process()
    seed = conf.get("seed", 0) + 1
    metrics_agg = defaultdict(list)
    metrics_max = defaultdict(list)
    last_time = time.time()
    last_steps = steps
    prev_metrics = None  # one step behind: drain step i-1 while step i runs

    def checkpoint():
        """Rank 0 saves the whole state; under 'model' its group gathers it
        first (a collective: every rank calls this at the same step)."""
        if ctx is None:
            state = {"model": model.state_dict(), "optimizer": trainstep.optimizer.state_dict()}
        else:
            state = ctx.fetch(model, trainstep.optimizer)
        if main:
            run_.save_checkpoint(state, steps)

    n_steps = min(conf.n_steps, max_steps) if max_steps else conf.n_steps

    while True:
        profiler.before_step(steps + 1)
        with Timer("total"):
            steps += 1
            will_log_batch = steps % conf.logbatch_interval == 1
            will_image_pred = (
                will_log_batch or
                steps % conf.log_interval >= int(conf.log_interval * 0.9))

            with Timer("data"):
                item = next(data_iter) if data_iter is not None else None
                batch, wid, data_stats = item if ctx is None else ctx.share_batch(item)
                # Fail fast with a config-level message instead of a shape
                # error inside the model.
                if "action" in batch and batch["action"].shape[-1] != conf.action_dim:
                    raise ValueError(
                        f"conf.action_dim={conf.action_dim} but the replay "
                        f"data has action dim {batch['action'].shape[-1]} — "
                        f"pass --action_dim matching the env "
                        f"(env_id={conf.get('env_id')})")

            with Timer("step"):
                state = states.get(wid)
                if state is None:
                    state = model.init_state(local_b * conf.iwae_samples)
                new_state, metrics, tensors, dream_tensors = trainstep(
                    batch, state, steps, seed=seed,
                    do_image_pred=will_image_pred, do_dream_tensors=will_log_batch)
                if conf.keep_state:
                    states[wid] = new_state  # detached by the model (rssm.py)

            with Timer("other"):
                # Drain last step's metrics; queue this step's fetch.
                if prev_metrics is not None:
                    _aggregate_metrics(prev_metrics.result(), metrics_agg, metrics_max)
                for k, v in data_stats.items():
                    if k.endswith("_max"):
                        metrics_max[k[:-4]].append(v)
                    else:
                        metrics_agg[k].append(v)
                prev_metrics = _MetricsFetch(metrics)

                # The dumps hold the global batch: under 'data' the ranks of
                # rank 0's data group gather it (JAX's fetch_all, :286-296).
                dumps = [("d2_wm_closed", tensors)] if will_log_batch else []
                dumps += [("d2_wm_dream", dream_tensors)] if dream_tensors else []
                for subdir, tens in dumps:
                    if ctx is not None and ctx.mesh.model_index != 0:
                        continue
                    data = _host_tensors({**batch, **tens})
                    if ctx is not None:
                        data = ctx.gather_batch(data)
                    if main:
                        log_batch_npz(run_, data, {}, f"{steps:07}.npz", subdir=subdir)

                # Buffer size recount + env-step stop (train.py:225-231).
                if online_data and steps % conf.logbatch_interval == 0:
                    _, steps_local, _ = make_repository(input_dirs).count_steps()
                    steps_now = _replay_steps(steps_local)
                    metrics_agg["data_steps"].append(steps_now)
                    metrics_agg["data_env_steps"].append(steps_now * conf.env_action_repeat)
                    if steps_now * conf.env_action_repeat >= conf.n_env_steps:
                        logger.info("Finished %d env steps.", conf.n_env_steps)
                        return None

                if steps % conf.log_interval == 0:
                    out = {f"train/{k}": float(np.mean(v)) for k, v in metrics_agg.items()}
                    out.update({f"train/{k}_max": float(np.max(v))
                                for k, v in metrics_max.items()})
                    out["train/steps"] = steps
                    t = time.time()
                    out["train/fps"] = (steps - last_steps) / max(t - last_time, 1e-6)
                    last_time, last_steps = t, steps
                    out.update({f"train/{k}": v for k, v in timers_summary().items()})
                    logger.info(
                        "[%06d]  loss_model: %.3f  loss_critic: %.3f  "
                        "policy_value: %.3f  policy_entropy: %.3f  fps: %.3f",
                        steps, out.get("train/loss_model", 0),
                        out.get("train/loss_critic", 0),
                        out.get("train/policy_value", 0),
                        out.get("train/policy_entropy", 0), out["train/fps"])
                    if main and steps > conf.log_interval:
                        # the first window skews the axes (reference: train.py:255)
                        run_.log_metrics(out, step=steps)
                    metrics_agg = defaultdict(list)
                    metrics_max = defaultdict(list)

                if steps % conf.save_interval == 0:
                    checkpoint()
                    logger.info("Saved model checkpoint %d", steps)

                if steps >= n_steps:
                    logger.info("Finished %d grad steps.", n_steps)
                    checkpoint()
                    return None

                # Self-recycle when host RSS crosses max_rss_gb: checkpoint and
                # return so a launcher restarts a fresh learner that resumes.
                # One rank's excess recycles every rank (an all-reduce MAX).
                if conf.get("max_rss_gb", 0) and steps % conf.log_interval == 0:
                    import resource
                    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1048576
                    if global_any(rss_gb > conf.max_rss_gb):
                        logger.warning(
                            "RSS %.1f GB (this rank) vs max_rss_gb %.1f: checkpointing "
                            "and requesting learner recycle.", rss_gb, conf.max_rss_gb)
                        checkpoint()
                        return "recycle"

            with Timer("eval"):
                if conf.eval_interval and steps % conf.eval_interval == 0:
                    # Rank 0 evaluates alone (JAX :371-383), on a whole copy of
                    # the weights under 'model' (its group gathers them).
                    eval_model = model
                    if ctx is not None and ctx.n_model > 1:
                        whole = ctx.fetch(model)
                        if main:
                            eval_model = make_model(conf, model.device)
                            eval_model.load_state_dict(whole["model"])
                    if main:
                        missing = [d for d in (test_dirs, eval_dirs)
                                   if make_repository(d).count_steps()[0] == 0]
                        if missing:
                            # Benign while the eval generators have written nothing yet.
                            logger.warning("Evaluation skipped: no episodes in %s", missing)
                        else:
                            _run_eval(conf, eval_model, preprocess, test_dirs, eval_dirs, run_,
                                      steps)
                    del eval_model


class _MetricsFetch:
    """The 0-d metric tensors of one step, stacked and copied to the host in
    one transfer queued behind that step's kernels; ``result()`` waits for
    that copy only."""

    def __init__(self, metrics: Dict[str, torch.Tensor]):
        self.keys = list(metrics)
        if not self.keys:
            self.host, self.event = torch.zeros(0), None
            return
        stacked = torch.stack([metrics[k].detach().float().reshape(()) for k in self.keys])
        if stacked.is_cuda:
            self.host = torch.empty(stacked.shape, dtype=stacked.dtype, pin_memory=True)
            self.host.copy_(stacked, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = stacked, None

    def result(self) -> Dict[str, float]:
        if self.event is not None:
            self.event.synchronize()
        return dict(zip(self.keys, self.host.tolist()))


def _run_eval(conf, model, preprocess, test_dirs, eval_dirs, run_, steps):
    """The two eval modes (reference: train.py:274-285): 'test' = train-like
    with state resets; 'eval' = state kept, multisampling-capable."""
    data_test = SequentialDataset(
        make_repository(test_dirs), conf.batch_length,
        conf.test_batch_size, skip_first=False,
        reset_interval=conf.reset_interval)
    evaluate("test", steps, model, preprocess(iter(data_test)), run_,
             conf.test_batches, conf.iwae_samples,
             conf.keep_state, conf.test_save_size)
    data_eval = SequentialDataset(
        make_repository(eval_dirs), conf.batch_length,
        conf.eval_batch_size, skip_first=False)
    evaluate("eval", steps, model, preprocess(iter(data_eval)), run_,
             conf.eval_batches, conf.eval_samples,
             True, conf.eval_save_size)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.is_floating_point():
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


@torch.no_grad()
def evaluate(prefix: str, steps: int, model, data_iterator: Iterator, run_: Run,
             eval_batches: int, eval_samples: int, keep_state: bool, save_size: int):
    """Open/closed-loop eval protocol (reference: train.py:306-408) through
    the model's ``training_step`` without gradients; the noise is a
    ``GeneratorNoise`` seeded from ``steps``."""
    start_time = time.time()
    device = model.device
    metrics_eval = defaultdict(list)
    state = None
    tensors = None
    npz_datas = []
    n_finished_episodes = np.zeros(1)
    do_output_tensors = True
    noise = GeneratorNoise(device, seed=steps)

    def eval_step(obs, state, do_open_loop):
        _, out_state, metrics, tensors, _ = model.training_step(
            obs, state, noise, iwae_samples=eval_samples, do_open_loop=do_open_loop,
            do_image_pred=True)
        return out_state, metrics, tensors

    for i_batch in range(eval_batches):
        batch = next(data_iterator)
        obs = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        T, B = batch["action"].shape[:2]
        if i_batch == 0:
            logger.info("Evaluation (%s): batches: %d, size(T,B,I): (%d,%d,%d)",
                        prefix, eval_batches, T, B, eval_samples)
            n_finished_episodes = np.zeros(B)

        reset_episodes = batch["reset"].any(axis=0)  # (B,)
        n_reset_episodes = int(reset_episodes.sum())
        n_continued = int((~reset_episodes).sum())
        if i_batch > 0:
            n_finished_episodes += reset_episodes

        # Last-batch probe logprob for episodes that just ended.
        if n_reset_episodes > 0 and tensors is not None and "loss_map" in tensors:
            lm = _to_numpy(tensors["loss_map"]).mean(axis=0)
            metrics_eval["logprob_map_last"].append(
                float((lm * reset_episodes).sum() / reset_episodes.sum()))

        # Open loop on continued episodes (train.py:351-372).
        if n_continued > 0 and state is not None:
            _, _, tensors_im = eval_step(obs, state, True)
            if np.random.rand() < 0.10:
                r = float(batch["reward"].sum())
                log_batch_npz(run_, batch, tensors_im,
                              f"{steps:07}_{i_batch}_r{r:.0f}.npz",
                              subdir=f"d2_wm_open_{prefix}")
            mask = (~reset_episodes).astype(np.float32)
            mask = np.where(mask > 0, mask, np.nan)
            for key_name, logprobs in tensors_im.items():
                if key_name.startswith("logprob_"):
                    lps = _to_numpy(logprobs)[:5] * mask
                    with warnings.catch_warnings():
                        # all-NaN slices are expected (reference: train.py:368)
                        warnings.simplefilter("ignore", RuntimeWarning)
                        lp = np.nanmean(lps)
                    if not np.isnan(lp):
                        metrics_eval[f"{key_name}_open"].append(float(lp))

        # Closed loop (train.py:374-389).
        if state is None or not keep_state:
            state = model.init_state(B * eval_samples)
        state, loss_metrics, tensors = eval_step(obs, state, False)
        for k, v in _MetricsFetch(loss_metrics).result().items():
            if not np.isnan(v):
                metrics_eval[k].append(v)

        if do_output_tensors:
            host = {k: _to_numpy(v) for k, v in tensors.items()}
            npz_datas.append(prepare_batch_npz({**batch, **host}, take_b=save_size))
        if n_finished_episodes[0] > 0:
            do_output_tensors = False

    out = {f"{prefix}/{k}": float(np.mean(v)) for k, v in metrics_eval.items()}
    run_.log_metrics(out, step=steps)

    if npz_datas:
        npz_data = {k: np.concatenate([d[k] for d in npz_datas], 1) for k in npz_datas[0]}
        print_once(f"Saving batch d2_wm_closed_{prefix}:",
                   {k: tuple(v.shape) for k, v in npz_data.items()})
        r = float(npz_data["reward"][0].sum())
        run_.log_npz(npz_data, f"{steps:07}_r{r:.0f}.npz", subdir=f"d2_wm_closed_{prefix}")
    logger.info("Evaluation (%s): done in %.0f sec, recorded %d episodes",
                prefix, time.time() - start_time, int(n_finished_episodes.sum()))


def _make_input_transform():
    """Prefetch transform: host-side data stats of the numpy batch, computed
    before the copy to the device. Yields (batch, wid, stats); the hot loop
    never reads batch values back from the device."""

    def tf(item):
        batch, wid = item
        stats = {
            "data_reward": float(np.mean(batch["reward"])),
            "data_reward_max": float(np.max(batch["reward"])),
            "data_reset": float(np.mean(batch["reset"])),
            "data_terminal": float(np.mean(batch["terminal"])),
        }
        return batch, wid, stats

    return tf


def _aggregate_metrics(metrics: Dict[str, float], metrics_agg, metrics_max):
    for k, v in metrics.items():
        if not np.isnan(v):
            metrics_agg[k].append(v)
        if k.startswith("grad_norm") and np.isfinite(v):
            metrics_max[k].append(v)


def _host_tensors(data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Device tensors on the host, floats as float32 (what the npz dump keeps)."""
    return {k: torch.from_numpy(_to_numpy(v)) for k, v in data.items()}


def log_batch_npz(run_: Run, batch, tensors, filename: str, subdir: str):
    data = {k: _to_numpy(v) for k, v in {**batch, **tensors}.items()}
    print_once(f"Saving batch {subdir} (input):",
               {k: tuple(v.shape) for k, v in data.items()})
    run_.log_npz(prepare_batch_npz(data), filename, subdir=subdir)


def prepare_batch_npz(data: Dict[str, np.ndarray], take_b: int = 999):
    """Un-preprocess tensors for npz inspection (reference: train.py:423-465).

    float images -> uint8, one-hot -> argmax, categorical logits -> softmax;
    output is (B,T,...) batch-major.
    """
    import scipy.special

    def unpreprocess(key: str, val) -> np.ndarray:
        x = np.asarray(val)
        if take_b < x.shape[1]:
            x = x[:, :take_b]
        if x.dtype in (np.float16, np.float64) or str(x.dtype) == "bfloat16":
            x = x.astype(np.float32)

        if x.ndim == 5:  # image (T,B,H,W,C)
            assert (key.startswith("image") or key.startswith("map")), \
                f"Unexpected 3D tensor: {key}: {x.shape}, {x.dtype}"
            if x.dtype == np.uint8:
                pass  # already display-ready
            elif x.shape[-1] in (1, 3):
                x = ((x + 0.5) * 255.0).clip(0, 255).astype("uint8")
            elif np.allclose(x.sum(axis=-1), 1.0) and np.allclose(x.max(axis=-1), 1.0):
                x = x.argmax(axis=-1)
            else:
                x = scipy.special.softmax(x, axis=-1)
        return x.swapaxes(0, 1)  # (T,B,*) => (B,T,*)

    return {k: unpreprocess(k, v) for k, v in data.items()}


def _describe_params(model: torch.nn.Module) -> str:
    lines = ["Model parameters:"]
    total = 0
    for key, sub in model.named_children():
        n = sum(p.numel() for p in sub.parameters())
        total += n
        lines.append(f"  {key:<15}: {n:,} parameters")
    lines.insert(1, f"  {'TOTAL':<15}: {total:,} parameters")
    return "\n".join(lines)
