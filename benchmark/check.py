"""How ``correct`` is decided: the program's first three train steps against
the plain reference's, from the same weights, batches and noise.

Set-up hands the program's ``TrainStep`` the run's first three batches,
through the same call and feed as the window. The readings of a side are:

* ``losses``: each step's losses (the world model's total and its image,
  reward, terminal and KL terms, the actor's and the critic's);
* ``grad``: each trainable leaf's gradient norm at the first update, as the
  optimizer took it (after the clip). The program's is worked out from
  AdamW's first moment after one step;
* ``change``: each leaf's distance from its starting value after the third
  update, before the fourth.

After them the reference runs once more with the operands of its products
rounded to bfloat16 (``cast_bf16``): the witness of what the
configuration's own precision costs on this seed.

``numbers`` reduces the sides' readings to numbers; ``COMPARED`` of them
decide ``correct`` against the configuration's limits:

* ``grad``: per leaf, the gap between the program's and the reference's
  norms over the reference's norm of that leaf or of the median leaf,
  whichever is larger; the worst leaf;
* ``change``: per leaf, the gap between the two sides' norms of the change
  over the reference's norm of it, the median over the leaves whose
  reference gradient is at least a thousandth of the median leaf's (a leaf
  whose gradient is nought to rounding moves under Adam by round-off alone,
  such as the ``none`` probe's parameter); as a multiple of the witness's
  median gap. Some seeds are several times more sensitive to rounding than
  others, on every side alike; the multiple is not;
* ``change_worst``: the same gaps of the change over the reference's norm of
  that leaf or of the median leaf, whichever is larger; the worst leaf. The
  median above always falls on a world-model leaf, so this is the number
  that sees an update gone wrong in the actor's or the critic's group alone
  (a learning rate of the wrong group).

The others are read and printed, not compared, because no precision or
fault that they should catch reads three times what the program does
(PERF.md gives the readings): ``loss_wm`` and ``loss_ac``, the first step's
losses of the world model and of the actor and critic (gap over the size of
the reference's loss, the larger of the two for ``loss_ac``); ``change_gap``
and ``witness_gap``, the median gaps that ``change`` divides. The losses of
steps 2 and 3 swing on every side alike: AdamW's first update moves every
element by about the learning rate whatever its gradient's size, so an
element whose gradient is at the level of rounding moves one way or the
other.
"""

from __future__ import annotations

import hashlib
import math
import statistics
from typing import Callable, Dict, List, Optional

import torch

from .feed import Feed
from .weights import make_weights

__all__ = ["make_inputs", "follow_program", "follow_reference", "numbers", "subseed", "cast_bf16",
           "STEPS", "COMPARED", "WM_LOSSES", "AC_LOSSES"]

STEPS = 3
COMPARED = ("grad", "change", "change_worst")
WM_LOSSES = ("loss_model", "loss_image", "loss_reward", "loss_terminal", "loss_kl")
AC_LOSSES = ("loss_actor", "loss_critic")
MOVED = 1e-3  # a leaf counts for ``change`` if its reference gradient is this share of the median's


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = sorted(tensors)
    values = torch.stack([tensors[n].detach().float().norm() for n in names]).tolist()
    return dict(zip(names, values))


def follow_program(program, feed, weights: Dict[str, torch.Tensor], batch_size: int) -> tuple:
    """Steps 1-3 of the program. -> (readings, state after step 3)."""
    state = program.init_state(batch_size)
    losses, grad = [], None
    for s in range(1, STEPS + 1):
        state, metrics = program.step(feed.batch(s), state, s, feed.noise(s))
        losses.append(program.readings(metrics))
        if s == 1:
            grad = _norms(program.first_grads())
    params = program.params()
    change = _norms({n: p - weights[n] for n, p in params.items()})
    return dict(losses=losses, grad=grad, change=change), state


def straight_through(x: torch.Tensor, rounded: torch.Tensor) -> torch.Tensor:
    """``rounded`` forward, the gradient as if unrounded."""
    return x + (rounded - x).detach()


def cast_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (the witness's operands)."""
    with torch.no_grad():
        rounded = x.detach().to(torch.bfloat16).float()
    return straight_through(x, rounded)


def subseed(seed: int, tag: str) -> int:
    """An independent 63-bit seed for one use of the run's seed."""
    digest = hashlib.blake2b(f"{seed}/{tag}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def make_inputs(reference, conf: Dict, mix: Dict, seed: int, device) -> tuple:
    """What both sides are handed, from the run's seed: (weights, feed). The
    names and shapes of the weights are the reference's own."""
    with torch.device("meta"):
        shapes = {n: tuple(t.shape) for n, t in reference.Model(conf).state_dict().items()}
    weights = make_weights(shapes, subseed(seed, "weights"), device)
    return weights, Feed(conf, mix, subseed(seed, "feed"), device, subseed(seed, "noise"))


def follow_reference(reference, conf: Dict, weights: Dict[str, torch.Tensor], feed, device,
                     cast: Optional[Callable] = None, columns: Optional[int] = None,
                     override: Optional[Dict] = None) -> Dict:
    """Steps 1-3 of the plain reference (the module ``reference``) in float32
    with TF32 off. ``cast`` rounds the operands of its products (the
    control); ``columns`` keeps only that many columns of each batch (a
    fault: part of the batch left out); ``override`` replaces keys of the
    configuration (a fault: a wrong setting of the optimizer)."""
    conf = dict(conf, **(override or {}))
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.device("meta"):
            model = reference.Model(conf, cast or reference.identity)
        model = model.to_empty(device=device)
        model.load_state_dict(weights, strict=True)
        step = reference.TrainStep(model, conf)
        state = model.init_state(columns or conf["batch_size"], device)
        losses, grad = [], None
        for s in range(1, STEPS + 1):
            obs = feed.batch(s)
            if columns:
                obs = {k: v[:, :columns] for k, v in obs.items()}
            state, readings, grads = step(obs, state, s, feed.noise(s))
            losses.append(readings)
            if s == 1:
                grad = _norms(grads)
        change = _norms({n: p.detach() - weights[n] for n, p in model.named_parameters()
                         if p.requires_grad})
        return dict(losses=losses, grad=grad, change=change)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


def _worst(values) -> float:
    """The largest value; NaN if any is not finite."""
    values = list(values)
    return max(values) if all(math.isfinite(v) for v in values) else float("nan")


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], names: List[str], floor: float):
    return [abs(prog[n] - ref[n]) / max(ref[n], floor) for n in names]


def _median_change_gap(side: Dict, ref: Dict, moved: List[str]) -> float:
    own = _leaf_gaps(side["change"], ref["change"], moved, 0.0)
    return statistics.median(own) if all(map(math.isfinite, own)) else float("nan")


def numbers(prog: Dict, ref: Dict, witness: Dict) -> Dict[str, float]:
    """The numbers (see the module's docstring); NaN where a reading is not finite."""
    if set(prog["grad"]) != set(ref["grad"]) or set(prog["change"]) != set(ref["change"]):
        raise ValueError("the program's and the reference's trainable leaves differ")
    p, r = prog["losses"][0], ref["losses"][0]
    loss_wm = _worst(abs(p[k] - r[k]) / abs(r[k]) for k in WM_LOSSES)
    loss_ac = _worst(abs(p[k] - r[k]) / max(abs(r[j]) for j in AC_LOSSES) for k in AC_LOSSES)
    names = sorted(ref["grad"])
    median_grad = statistics.median(ref["grad"][n] for n in names)
    grad = _worst(_leaf_gaps(prog["grad"], ref["grad"], names, median_grad))
    moved = [n for n in names if ref["grad"][n] >= MOVED * median_grad]
    change_gap = _median_change_gap(prog, ref, moved)
    witness_gap = _median_change_gap(witness, ref, moved)
    floor = statistics.median(ref["change"][n] for n in moved)
    change_worst = _worst(_leaf_gaps(prog["change"], ref["change"], moved, floor))
    return dict(grad=grad, change=change_gap / witness_gap, loss_wm=loss_wm, loss_ac=loss_ac,
                change_worst=change_worst, change_gap=change_gap, witness_gap=witness_gap)
