"""Named spans of the train step on the profiler's clock, and its counters.

``span(name)`` marks a layer for ``torch.profiler``. While a profiler
records, it is ``torch.profiler.record_function(name)``: Kineto puts the span
on the same timeline as the CUDA activity launched inside it, so a reader
can put each kernel down to the span of its launch. While ``TrainStep``
captures its step into CUDA graphs (``training/train_step.py``), a span of
one of the ``LEAVES`` also tells the capture (``cutting``) where a layer
begins and ends, and the capture cuts its graph there. Otherwise it is one
shared null context (``NULL``), and a span site costs two flag checks (no
capture, no profiler): no object, no allocation, no synchronize, no launch.

The spans the port opens; each name starts with ``pd.`` (never ``cu``, which
trace readers take for the CUDA runtime's own calls):

* ``pd.train_step``: ``TrainStep.__call__``, the root of the rest;
* ``pd.encoder``: ``prepare_obs`` and the encoder (the convs);
* ``pd.posterior``: the posterior noise and ``RSSMCore.forward``, the T-step
  loop (K1's forward) and ``batch_prior``;
* ``pd.heads``: the decoders, the KL loss, the auxiliary critic, the probe;
* ``pd.dream``: ``Dreamer.dream``, the H-step loop;
* ``pd.actor_critic``: ``ActorCritic.training_step`` (GAE, actor and critic
  losses);
* ``pd.backward``: the gradients zeroed in place, the loss sum and the one
  ``backward()`` (with the step copies' accumulations); inside it
  ``pd.k1_backward``, ``GRUDv2Function.backward`` (K1's backward and its recompute)
  and ``DWSum.backward`` (an unroll's one K1 weight gradient), which run on
  autograd's device thread, and ``pd.k2_backward``,
  ``BlockGRUFunction.backward`` (K2's recompute and its gradients);
* ``pd.optimizer``: the critic-target copies, the refresh of the step's
  weight copies before the forward, the norms, the clip and ``AdamW.step``
  (and DreamerV3's slow-critic EMA);
* ``pd.twohot``: DreamerV3's two-hot symlog work (the target's encoding,
  the log-softmax over the bins, the means) of the reward head and of both
  critics, inside ``pd.heads``, ``pd.dream`` and ``pd.actor_critic``;
* ``pd.retnorm``: DreamerV3's return normalisation (the percentiles, the
  EMA of the statistics, the scaled advantage), inside ``pd.actor_critic``;
* ``pd.loop.<name>``: ``tools.Timer``'s phases of the trainer's loop.

``COUNTERS`` counts always, in plain integer adds: ``weight_casts``, each
cast of a parameter to another dtype (``models/modules.py::cast_param``, and
each made or refreshed step copy, ``WeightCopies``); ``weight_copies``, the
step copies' casts alone; ``weight_copy_uses``, the casts that a step copy
served instead; ``train_steps``, the ``TrainStep`` calls; ``graph_captures``,
the steps ``TrainStep`` captured into CUDA graphs, and ``graph_replays``, its
calls served by replaying them. The adds of the model's code run only while a
step runs eagerly or is captured: a replay credits what its capture counted,
in every counter field registered with ``TALLIES`` (``COUNTERS``' three
weight counters here, K1's ``LAUNCHES``, ``K1_BACKWARDS`` and ``K1_DW`` in
``ops/gru_dv2.py``, K2's ``K2_LAUNCHES`` in ``ops/block_gru.py``). A counter
that the model's code adds to registers its fields there, or a replayed
step leaves it short.
"""

from __future__ import annotations

import contextlib
import copy

from torch.autograd import profiler as _profiler

__all__ = ["span", "NULL", "COUNTERS", "TALLIES", "LEAVES", "cutting"]

NULL = contextlib.nullcontext()
record_function = _profiler.record_function
# The spans at which a capture cuts: the seven layers of the step, K1's and
# K2's backward and DreamerV3's two-hot and return-normalisation work.
LEAVES = frozenset(("pd.encoder", "pd.posterior", "pd.heads", "pd.dream", "pd.actor_critic",
                    "pd.backward", "pd.optimizer", "pd.k1_backward", "pd.k2_backward",
                    "pd.twohot", "pd.retnorm"))
_capture = None  # the capture being cut at the spans (``cutting``), or None


def span(name: str):
    """``record_function(name)`` while a profiler records, a cut of the
    capture at a leaf while a step is captured, else ``NULL``."""
    if _capture is None and not _profiler._is_profiler_enabled:
        return NULL
    if _capture is not None and name in LEAVES:
        return _Cut(_capture, name)
    return record_function(name) if _profiler._is_profiler_enabled else NULL


class _Cut:
    """A leaf span during a capture: ``capture.enter(name)`` on entry and
    ``capture.exit(name)`` on exit, around the profiler's span if one records."""

    def __init__(self, capture, name: str):
        self.capture, self.name = capture, name
        self.recorded = record_function(name) if _profiler._is_profiler_enabled else None

    def __enter__(self):
        self.capture.enter(self.name)
        if self.recorded is not None:
            self.recorded.__enter__()
        return self

    def __exit__(self, *exc):
        if self.recorded is not None:
            self.recorded.__exit__(*exc)
        self.capture.exit(self.name, failed=exc[0] is not None)
        return False


@contextlib.contextmanager
def cutting(capture):
    """Route the leaf spans opened inside the block, on any thread, to
    ``capture``'s ``enter(name)`` and ``exit(name, failed)``."""
    global _capture
    if _capture is not None:
        raise RuntimeError("a capture is being cut already")
    _capture = capture
    try:
        yield capture
    finally:
        _capture = None


class _Counters:
    """Counts since the last ``reset()``."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.weight_casts = 0
        self.weight_copies = 0
        self.weight_copy_uses = 0
        self.train_steps = 0
        self.graph_captures = 0
        self.graph_replays = 0


class Tallies:
    """The fields of counters that the model's code adds to while a step
    runs, each an int or a dict of ints: what a replay of a captured step
    credits. ``snapshot()`` before the capture, ``since(it)`` after it, and
    ``credit(since)`` at each replay."""

    def __init__(self):
        self.fields = []  # (counter, attribute name)

    def register(self, counter, *names: str):
        self.fields += [(counter, name) for name in names]
        return counter

    def snapshot(self) -> list:
        return [(c, n, copy.copy(getattr(c, n))) for c, n in self.fields]

    @staticmethod
    def restore(snapshot: list) -> None:
        for c, n, value in snapshot:
            setattr(c, n, copy.copy(value))

    @staticmethod
    def since(snapshot: list) -> list:
        """What each field of ``snapshot`` counted since it was taken."""
        changes = []
        for c, n, before in snapshot:
            now = getattr(c, n)
            if isinstance(now, dict):
                now = {k: v - before.get(k, 0) for k, v in now.items() if v != before.get(k, 0)}
            else:
                now = now - before
            changes.append((c, n, now))
        return changes

    @staticmethod
    def credit(changes: list) -> None:
        for c, n, change in changes:
            if isinstance(change, dict):
                counts = getattr(c, n)
                for k, v in change.items():
                    counts[k] = counts.get(k, 0) + v
            else:
                setattr(c, n, getattr(c, n) + change)


COUNTERS = _Counters()
TALLIES = Tallies()
TALLIES.register(COUNTERS, "weight_casts", "weight_copies", "weight_copy_uses")
