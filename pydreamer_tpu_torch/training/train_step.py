"""The gradient step: forward + one backward + per-group clip + AdamW.

Counterpart of ``pydreamer_tpu/training/train_step.py:53-162``:

* the periodic critic -> critic_target hard copy happens BEFORE the update,
  when ``step % target_interval == 0``, and likewise for the auxiliary
  critic of the world model every ``target_interval_aux`` steps;
* one forward computes all four losses and ONE ``backward()`` over their sum
  yields the partitioned gradients (each loss touches only its own
  parameters, see ``models/dreamer.py``);
* the parameters are split as JAX labels its params tree, by top-level key
  (``make_optimizer_labels``, train_step.py:38-50): ``probe``, ``actor`` and
  ``critic`` are their own groups, every other key (``wm``) is ``wm``, and
  under ``probe_gradients`` the probe joins the ``wm`` group. A baseline
  (``WorldModelProbe``) has only ``wm`` and ``probe``;
* pre-clip gradient norms per top-level key are reported as ``grad_norm``
  (wm), ``grad_norm_probe``, ``grad_norm_actor`` and ``grad_norm_critic``,
  whatever the groups;
* each group is clipped by its global norm with optax's rule (scale by
  ``max/norm`` when ``norm > max``, not ``clip_grad_norm_``'s
  ``max/(norm+1e-6)``) and updated by AdamW with ``weight_decay=0``, each
  with its own learning rate and eps: ``adam_eps``, and ``adam_eps_ac``
  where set for the actor and the critic (DreamerV3);
* a model whose actor-critic keeps a slow critic (DreamerV3) updates it by
  its EMA after each optimizer step, inside the step (a replay updates it
  too), and takes no hard copies;
* the critic targets are frozen (no gradient, not in the optimizer). In JAX
  the auxiliary critic's target sits in the ``wm`` subtree with zero
  gradients, which leaves both the update and ``grad_norm`` as they are here.

Master parameters and optimizer state are float32. A step reads each
parameter that its ops take in bfloat16 from one copy (``WeightCopies``),
refreshed from the master at the start of ``update`` (after the target
copies, the slow-critic EMA and any ``load_state_dict``), and each use's
gradient is added straight into the float32 ``.grad``, which ``update``
therefore zeroes in place before ``backward()`` (``models/modules.py``).

Under a mesh (``ctx``, a ``parallel.DistributedContext``; JAX's step is
jitted over one, train_step.py:18-20) the model is placed on it before the
optimizer is built, so AdamW's moments are born sharded. The noise, given or
default, is the global source, and each rank draws its rows of it. After
``backward()`` the gradients are averaged over the ranks before the norms and
the clip; a sharded parameter's squared norm is summed over 'model', so
``grad_norm*`` and each group's clip are global; the metrics are averaged
over 'data'. ``model.training_step`` is called directly, so the step uses
plain collectives and not ``DistributedDataParallel``, whose hooks would
never fire.

On a CUDA device without a mesh, the step is replayed from CUDA graphs
(``StepGraphs``): a call with the program's own noise and no log tensors
runs the captured step of its input signature, with the critic-target
copies eager before it. A signature is captured at its first such call
after any call has run it eagerly (the first such call runs eagerly where
none has), from the first op of the forward to ``AdamW.step()``,
cut at the layer spans (``tracing.LEAVES``) into one graph per layer
segment, all in one memory pool, so that a replay opens each layer's span
around its graphs as the eager step does. ``MAX_GRAPHS`` signatures are
held; others run eagerly. A capture that fails raises, and its signature runs
eagerly from then on. An explicit noise source, ``do_image_pred``,
``do_dream_tensors``, a mesh and the CPU run eagerly. The eager step and the
replays share the parameters, their gradients and AdamW's state (AdamW is
``capturable`` on CUDA), so either may follow the other.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from .. import tracing
from ..device import resolve_device
from ..models.functions import global_norm
from ..models.modules import WeightCopies
from ..models.noise import GeneratorNoise
from ..tracing import COUNTERS, TALLIES, span

__all__ = ["TrainStep", "StepGraphs", "CudaGraphs", "param_parts", "param_groups",
           "clip_by_global_norm_", "graphable", "noise_seed", "MAX_GRAPHS"]

GROUPS = ("wm", "probe", "actor", "critic")
METRICS = {"wm": "grad_norm", "probe": "grad_norm_probe", "actor": "grad_norm_actor",
           "critic": "grad_norm_critic"}


def param_parts(model) -> Dict[str, List[torch.nn.Parameter]]:
    """Trainable parameters by the JAX params tree's top-level key: the
    model's children, with ``ac`` split into ``actor`` and ``critic`` (its
    frozen ``critic_target`` has none) and any key but these four in ``wm``."""
    children = dict(model.named_children())
    if "ac" in children:
        ac = children.pop("ac")
        children.update(actor=ac.actor, critic=ac.critic)
    parts: Dict[str, List[torch.nn.Parameter]] = {}
    for name, child in children.items():
        parts.setdefault(name if name in GROUPS else "wm", []).extend(
            p for p in child.parameters() if p.requires_grad)
    return {name: parts[name] for name in GROUPS if parts.get(name)}


def param_groups(model, conf) -> Dict[str, List[str]]:
    """The parts (``param_parts``' keys) in each optimizer group
    (train_step.py:38-72)."""
    probe_label = "wm" if conf.get("probe_gradients", False) else "probe"
    groups: Dict[str, List[str]] = {}
    for part in param_parts(model):
        groups.setdefault(probe_label if part == "probe" else part, []).append(part)
    return groups


def graphable(device: torch.device, ctx) -> bool:
    """Whether ``TrainStep`` may replay its step from CUDA graphs: on a CUDA
    device, without a mesh (whose collectives no capture has been held to)."""
    return device.type == "cuda" and ctx is None


def capturable_on_its_device(optimizer) -> None:
    """After ``load_state_dict``: AdamW ``capturable`` on CUDA alone, whatever
    the file said, with its step counts on the parameters' device there
    (the saved groups' flag replaces the optimizer's, and a file written on
    one device may be resumed on the other)."""
    for group in optimizer.param_groups:
        cuda = group["params"][0].device.type == "cuda"
        group["capturable"] = cuda
        for p in group["params"]:
            state = optimizer.state.get(p, {})
            if cuda and "step" in state:
                state["step"] = state["step"].to(device=p.device, dtype=torch.float32)


def noise_seed(seed: int, step: int) -> int:
    """The seed of the program's own noise at ``step`` of a run seeded ``seed``."""
    return seed * 1_000_003 + step


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], norm: torch.Tensor, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: g * max/norm where norm >= max."""
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, factor.to(grads[0].device))


class TrainStep:
    """Owns the optimizer of a ``Dreamer`` or ``WorldModelProbe`` and runs its
    gradient step."""

    def __init__(self, model, conf, device: str | torch.device = "cuda", ctx=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, TrainStep on {self.device}")
        self.model = model
        self.conf = conf
        self.ctx = ctx
        if ctx is not None:
            ctx.place_model(model)
        # The target copies run only where the model has the targets (JAX:
        # ``if "critic_target" in params``); a baseline has neither.
        self.slow_critic = getattr(getattr(model, "ac", None), "slow_critic", None) is not None
        self.target_interval = (conf.get("target_interval", 0)
                                if hasattr(model, "ac") and not self.slow_critic else 0)
        self.target_interval_aux = (conf.get("target_interval_aux", 0)
                                    if getattr(model.wm, "ac_aux", None) is not None else 0)
        self.parts = param_parts(model)
        self.params = [p for params in self.parts.values() for p in params]
        self.grads: List[torch.Tensor] = []  # each parameter's ``.grad``, held (``zero_grads_``)
        self.copies = WeightCopies()
        self.groups = param_groups(model, conf)
        lrs = {"wm": conf.adam_lr, "probe": conf.adam_lr,
               "actor": conf.adam_lr_actor or conf.adam_lr,
               "critic": conf.adam_lr_critic or conf.adam_lr}
        clip_ac = conf.grad_clip_ac or conf.grad_clip
        self.clips = {"wm": conf.grad_clip, "probe": conf.grad_clip,
                      "actor": clip_ac, "critic": clip_ac}
        eps_ac = conf.get("adam_eps_ac") or conf.adam_eps
        eps = {"wm": conf.adam_eps, "probe": conf.adam_eps, "actor": eps_ac, "critic": eps_ac}
        cuda = self.device.type == "cuda"
        self.optimizer = torch.optim.AdamW(
            [{"params": [p for part in parts for p in self.parts[part]], "lr": lrs[name],
              "eps": eps[name], "name": name} for name, parts in self.groups.items()],
            eps=conf.adam_eps, weight_decay=0.0, capturable=cuda)
        self.optimizer.register_load_state_dict_post_hook(capturable_on_its_device)
        self.graphs = StepGraphs(CudaGraphs(self.device)) if graphable(self.device, ctx) else None

    def __call__(self, obs: Dict[str, torch.Tensor], in_state, step: int,
                 noise: Optional[object] = None, seed: int = 0,
                 do_image_pred: bool = False, do_dream_tensors: bool = False):
        """One step. ``noise`` defaults to a ``GeneratorNoise`` seeded from
        ``(seed, step)``. Returns (out_state, metrics, tensors, dream_tensors);
        metrics are 0-d tensors on the device (no host sync here), and every
        returned tensor is this call's own. Counted in
        ``tracing.COUNTERS.train_steps``; the ``pd.train_step`` span."""
        COUNTERS.train_steps += 1
        with span("pd.train_step"):
            self.update_targets(step)
            if self.graphs is not None:
                sig = self.signature(obs, in_state)
                if noise is None and not do_image_pred and not do_dream_tensors:
                    replayed = self.graphs(self, sig, obs, in_state, noise_seed(seed, step))
                    if replayed is not None:
                        return replayed
                else:
                    self.graphs.warm.add(sig)
            if noise is None:
                noise = GeneratorNoise(self.device, seed=noise_seed(seed, step))
            return self.update(obs, in_state, noise, do_image_pred, do_dream_tensors)

    def signature(self, obs, in_state) -> Tuple:
        """What a captured step is specific to: each input's shape and dtype,
        the IWAE samples and the dream's horizon."""
        leaves = [(k, tuple(v.shape), v.dtype) for k, v in sorted(obs.items())]
        leaves += [(tuple(t.shape), t.dtype) for t in pytree.tree_leaves(in_state)]
        return (tuple(leaves), self.conf.get("iwae_samples", 1),
                getattr(self.model, "imag_horizon", None))

    def update_targets(self, step: int) -> None:
        """The periodic critic -> critic-target copies due at ``step``."""
        model = self.model
        with span("pd.optimizer"):
            if self.target_interval and step % self.target_interval == 0:
                model.ac.update_critic_target()
            if self.target_interval_aux and step % self.target_interval_aux == 0:
                model.wm.ac_aux.update_critic_target()

    def hold_grads(self) -> None:
        """Each parameter's ``.grad`` set back to the tensor held for it, where
        anything (``zero_grad()``, a script) has set it to another or None."""
        for p, g in zip(self.params, self.grads):
            if p.grad is not g:
                p.grad = g

    def zero_grads_(self) -> None:
        """Each parameter's ``.grad`` zeroed in place: tensors made at the
        first update (or taken from ``.grad`` there) and held here, so their
        addresses hold from step to step and those a captured step writes stay
        alive whatever sets ``.grad`` between calls."""
        if not self.grads:
            self.grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        self.hold_grads()
        torch._foreach_zero_(self.grads)

    def update(self, obs, in_state, noise, do_image_pred: bool = False,
               do_dream_tensors: bool = False):
        """The forward, the backward, the clip and AdamW: what a graph captures."""
        ctx, model = self.ctx, self.model
        if self.copies:
            with span("pd.optimizer"):
                self.copies.refresh()
        if ctx is not None:
            streams = obs["action"].shape[1] * self.conf.iwae_samples
            noise = ctx.noise(noise, streams)
            ctx.batch_reduce.active = True
        try:
            with self.copies.serving():
                losses, out_state, metrics, tensors, dream_tensors = model.training_step(
                    obs, in_state, noise, do_image_pred=do_image_pred,
                    do_dream_tensors=do_dream_tensors)
        finally:
            if ctx is not None:
                ctx.batch_reduce.active = False
        with span("pd.backward"):
            self.zero_grads_()
            sum(losses.values()).backward()

        metrics = dict(metrics)
        with span("pd.optimizer"):
            grads = {part: [p.grad for p in params] for part, params in self.parts.items()}
            if ctx is None:
                norms = {part: global_norm(g) for part, g in grads.items()}
            else:
                ctx.reduce_gradients(self.params)
                norms = ctx.grad_norms(grads, self.parts)
            for part, norm in norms.items():
                metrics[METRICS[part]] = norm
            for name, parts in self.groups.items():
                norm = torch.stack([norms[part] for part in parts]).square().sum().sqrt()
                clip_by_global_norm_([g for part in parts for g in grads[part]], norm,
                                     self.clips[name])
            self.optimizer.step()
            if self.slow_critic:
                model.ac.update_slow_critic()
        metrics.update({k: v.detach() for k, v in losses.items()})
        if ctx is not None:
            metrics = ctx.reduce_metrics(metrics)
        return out_state, metrics, tensors, dream_tensors


# -- the step replayed from CUDA graphs ---------------------------------------

# Input signatures held as captured steps; the others run eagerly. Every
# caller (the trainer, the benchmark, the tools) presents one signature, its
# batch and carried state, and each held signature keeps a memory pool of its
# own (4.1 GB at the Atari widths, 8.5 GB at DMC's).
MAX_GRAPHS = 1


class CudaGraphs:
    """The capture backend on a CUDA device: ``torch.cuda.CUDAGraph`` on one
    side stream, each graph holding the generator of the step's noise.
    Captures are ``relaxed``, since K1's backward ends one segment and begins
    the next on autograd's device thread."""

    def __init__(self, device: torch.device):
        self.device = device
        self.generator = torch.Generator(device=device)
        self.stream = None

    def pool(self):
        return torch.cuda.graph_pool_handle()

    @contextlib.contextmanager
    def capturing(self):
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        torch.cuda.synchronize(self.device)
        with torch.cuda.stream(self.stream):
            yield

    def begin(self, pool):
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        graph.capture_begin(pool=pool, capture_error_mode="relaxed")
        return graph

    @staticmethod
    def end(graph) -> None:
        graph.capture_end()

    @staticmethod
    def replay(graph) -> None:
        graph.replay()


class Segments:
    """One capture cut at the leaf spans (``tracing.cutting`` calls ``enter``
    and ``exit``). Each segment is ``(spans, graph)``: the leaf spans open
    while it was captured, outermost first. A span whose leaves equal the
    open segment's joins it; leaving a span cuts only back into an enclosing
    one (K1's backward back into the backward), so what runs between two
    layers stays with the layer before, and the first segment takes the
    spans of the first layer entered."""

    def __init__(self, backend, pool):
        self.backend, self.pool = backend, pool
        self.stack: List[str] = []
        self.done: List[Tuple[Tuple[str, ...], object]] = []
        self.open = ((), backend.begin(pool))

    def _cut(self, spans: Tuple[str, ...]) -> None:
        tags, graph = self.open
        if tags == spans:
            return
        if not tags and not self.done:
            self.open = (spans, graph)
            return
        self.backend.end(graph)
        self.done.append((tags, graph))
        self.open = (spans, self.backend.begin(self.pool))

    def enter(self, name: str) -> None:
        self.stack.append(name)
        self._cut(tuple(self.stack))

    def exit(self, name: str, failed: bool = False) -> None:
        self.stack.pop()
        if self.stack and not failed:
            self._cut(tuple(self.stack))

    def finish(self) -> List[Tuple[Tuple[str, ...], object]]:
        tags, graph = self.open
        self.open = None
        self.backend.end(graph)
        self.done.append((tags, graph))
        return self.done


def replay_segments(backend, segments) -> None:
    """Replay ``segments`` in capture order, each inside its spans."""
    opened: List[Tuple[str, object]] = []  # the open spans, outermost first
    try:
        for tags, graph in segments:
            keep = 0
            while keep < min(len(opened), len(tags)) and opened[keep][0] == tags[keep]:
                keep += 1
            while len(opened) > keep:
                opened.pop()[1].__exit__(None, None, None)
            for name in tags[keep:]:
                context = span(name)
                context.__enter__()
                opened.append((name, context))
            backend.replay(graph)
    finally:
        while opened:
            opened.pop()[1].__exit__(None, None, None)


class Packed:
    """Tensors packed inside the graph into one flat buffer per dtype;
    ``copy()`` unpacks views of a fresh copy of each, so a replay's results
    are its own, in one copy per dtype. The out-state, the metrics and the
    tensors are packed apart: a caller that keeps one metric keeps the
    metrics' few bytes, not the tensors' reconstructed images."""

    def __init__(self, tree):
        leaves, self.spec = pytree.tree_flatten(tree)
        dtypes = sorted({t.dtype for t in leaves}, key=str)
        self.flat = [torch.cat([t.detach().reshape(-1) for t in leaves if t.dtype == dtype])
                     for dtype in dtypes]
        offsets = [0] * len(dtypes)
        self.layout = []
        for t in leaves:
            i = dtypes.index(t.dtype)
            self.layout.append((i, offsets[i], t.numel(), tuple(t.shape)))
            offsets[i] += t.numel()

    def copy(self):
        flat = [f.clone() for f in self.flat]
        return pytree.tree_unflatten([flat[i][o:o + n].view(shape)
                                      for i, o, n, shape in self.layout], self.spec)


@dataclass
class Captured:
    """One input signature's captured step: the static inputs it reads, its
    segments, its packed (out_state, metrics, tensors), what its capture
    added to the counters (``TALLIES.since``) and the seconds it took. The
    gradients it writes are the ones ``TrainStep`` holds (``zero_grads_``),
    which each replay sets back as the parameters' ``.grad``."""

    obs: Dict[str, torch.Tensor]
    in_state: object
    segments: List[Tuple[Tuple[str, ...], object]]
    outputs: Tuple[Packed, ...]
    delta: list
    seconds: float


class StepGraphs:
    """Decides, per call, whether ``TrainStep`` replays, captures or runs
    eagerly, and does it. ``backend`` makes, ends and replays one graph
    (``CudaGraphs``; the tests give a fake one)."""

    def __init__(self, backend):
        self.backend = backend
        self.captured: Dict[Tuple, Captured] = {}
        self.warm: set = set()
        self.refused: set = set()

    def decide(self, sig) -> str:
        """'replay', 'capture' or 'eager' for an eligible call of signature
        ``sig``: a signature no call has run eagerly yet runs eagerly (that
        warms what a capture must find made: AdamW's state, the kernels'
        attributes, any library's first-call work at these shapes); a warm
        one captures, while fewer than ``MAX_GRAPHS`` are held. ``warm`` also
        takes the signatures of ``TrainStep``'s other eager calls."""
        if sig in self.captured:
            return "replay"
        if sig in self.refused or len(self.captured) >= MAX_GRAPHS:
            return "eager"
        if sig in self.warm:
            return "capture"
        self.warm.add(sig)
        return "eager"

    def __call__(self, ts, sig, obs, in_state, seed: int):
        """``ts``'s step on these inputs (signature ``sig``) with its own noise
        seeded ``seed``, replayed (captured first where it is due), or None
        where the call runs eagerly. A capture that fails raises; a caller
        that goes on runs this signature eagerly."""
        how = self.decide(sig)
        if how == "capture":
            try:
                self.captured[sig] = self.capture(ts, obs, in_state)
            except Exception:
                self.refused.add(sig)
                raise
            COUNTERS.graph_captures += 1
        elif how == "eager":
            return None
        return self.replay(ts, self.captured[sig], obs, in_state, seed)

    def capture(self, ts, obs, in_state) -> Captured:
        """Capture ``ts.update`` on static copies of the inputs; the counters
        are left as they were, for the replay that follows to credit."""
        t0 = time.perf_counter()
        static_obs = {k: v.clone() for k, v in obs.items()}
        static_state = pytree.tree_map(torch.clone, in_state)
        noise = GeneratorNoise(ts.device, generator=self.backend.generator)
        before = TALLIES.snapshot()
        with self.backend.capturing(), ts.copies.sealed():
            cut = Segments(self.backend, self.backend.pool())
            try:
                with tracing.cutting(cut):
                    out_state, metrics, tensors, _ = ts.update(dict(static_obs), static_state,
                                                               noise)
                    with span("pd.optimizer"), torch.no_grad():
                        outputs = tuple(Packed(part) for part in (out_state, metrics, tensors))
            except BaseException:
                with contextlib.suppress(RuntimeError):  # the capture is broken already
                    cut.finish()
                TALLIES.restore(before)
                raise
            segments = cut.finish()
        delta = TALLIES.since(before)
        TALLIES.restore(before)
        return Captured(static_obs, static_state, segments, outputs, delta,
                        time.perf_counter() - t0)

    def replay(self, ts, captured: Captured, obs, in_state, seed: int):
        for k, v in obs.items():
            captured.obs[k].copy_(v)
        for dst, src in zip(pytree.tree_leaves(captured.in_state), pytree.tree_leaves(in_state)):
            dst.copy_(src)
        if self.backend.generator is not None:
            self.backend.generator.manual_seed(seed)
        replay_segments(self.backend, captured.segments)
        ts.hold_grads()
        TALLIES.credit(captured.delta)
        COUNTERS.graph_replays += 1
        out_state, metrics, tensors = (part.copy() for part in captured.outputs)
        return out_state, metrics, tensors, {}
