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
  ``max/(norm+1e-6)``) and updated by AdamW with ``weight_decay=0`` and
  ``eps=adam_eps``, each with its own learning rate;
* the critic targets are frozen (no gradient, not in the optimizer). In JAX
  the auxiliary critic's target sits in the ``wm`` subtree with zero
  gradients, which leaves both the update and ``grad_norm`` as they are here.

Master parameters and optimizer state are float32.

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
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..device import resolve_device
from ..models.functions import global_norm
from ..models.noise import GeneratorNoise
from ..tracing import COUNTERS, span

__all__ = ["TrainStep", "param_parts", "param_groups", "clip_by_global_norm_"]

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
        self.target_interval = conf.get("target_interval", 0) if hasattr(model, "ac") else 0
        self.target_interval_aux = (conf.get("target_interval_aux", 0)
                                    if getattr(model.wm, "ac_aux", None) is not None else 0)
        self.parts = param_parts(model)
        self.groups = param_groups(model, conf)
        lrs = {"wm": conf.adam_lr, "probe": conf.adam_lr,
               "actor": conf.adam_lr_actor or conf.adam_lr,
               "critic": conf.adam_lr_critic or conf.adam_lr}
        clip_ac = conf.grad_clip_ac or conf.grad_clip
        self.clips = {"wm": conf.grad_clip, "probe": conf.grad_clip,
                      "actor": clip_ac, "critic": clip_ac}
        self.optimizer = torch.optim.AdamW(
            [{"params": [p for part in parts for p in self.parts[part]], "lr": lrs[name],
              "name": name} for name, parts in self.groups.items()],
            eps=conf.adam_eps, weight_decay=0.0)

    def __call__(self, obs: Dict[str, torch.Tensor], in_state, step: int,
                 noise: Optional[object] = None, seed: int = 0,
                 do_image_pred: bool = False, do_dream_tensors: bool = False):
        """One step. ``noise`` defaults to a ``GeneratorNoise`` seeded from
        ``(seed, step)``. Returns (out_state, metrics, tensors, dream_tensors);
        metrics are 0-d tensors on the device (no host sync here). Counted in
        ``tracing.COUNTERS.train_steps``; the ``pd.train_step`` span."""
        COUNTERS.train_steps += 1
        with span("pd.train_step"):
            return self._step(obs, in_state, step, noise, seed, do_image_pred, do_dream_tensors)

    def _step(self, obs, in_state, step, noise, seed, do_image_pred, do_dream_tensors):
        if noise is None:
            noise = GeneratorNoise(self.device, seed=seed * 1_000_003 + step)
        ctx = self.ctx
        if ctx is not None:
            streams = obs["action"].shape[1] * self.conf.iwae_samples
            noise = ctx.noise(noise, streams)
        model = self.model
        with span("pd.optimizer"):
            if self.target_interval and step % self.target_interval == 0:
                model.ac.update_critic_target()
            if self.target_interval_aux and step % self.target_interval_aux == 0:
                model.wm.ac_aux.update_critic_target()

        if ctx is not None:
            ctx.batch_reduce.active = True
        try:
            losses, out_state, metrics, tensors, dream_tensors = model.training_step(
                obs, in_state, noise, do_image_pred=do_image_pred,
                do_dream_tensors=do_dream_tensors)
        finally:
            if ctx is not None:
                ctx.batch_reduce.active = False
        with span("pd.backward"):
            self.optimizer.zero_grad(set_to_none=True)
            sum(losses.values()).backward()

        metrics = dict(metrics)
        with span("pd.optimizer"):
            grads = {}
            for part, params in self.parts.items():
                for p in params:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                grads[part] = [p.grad for p in params]
            if ctx is None:
                norms = {part: global_norm(g) for part, g in grads.items()}
            else:
                ctx.reduce_gradients([p for params in self.parts.values() for p in params])
                norms = ctx.grad_norms(grads, self.parts)
            for part, norm in norms.items():
                metrics[METRICS[part]] = norm
            for name, parts in self.groups.items():
                norm = torch.stack([norms[part] for part in parts]).square().sum().sqrt()
                clip_by_global_norm_([g for part in parts for g in grads[part]], norm,
                                     self.clips[name])
            self.optimizer.step()
        metrics.update({k: v.detach() for k, v in losses.items()})
        if ctx is not None:
            metrics = ctx.reduce_metrics(metrics)
        return out_state, metrics, tensors, dream_tensors
