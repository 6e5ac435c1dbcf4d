"""Named spans of the train step on the profiler's clock, and its counters.

``span(name)`` marks a layer for ``torch.profiler``. While a profiler
records, it is ``torch.profiler.record_function(name)``: Kineto puts the span
on the same timeline as the CUDA activity launched inside it, so a reader
can put each kernel down to the span of its launch. Otherwise it is one
shared null context (``NULL``), and a span site costs one flag check: no
object, no allocation, no synchronize, no launch.

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
* ``pd.backward``: the loss sum and the one ``backward()``; inside it
  ``pd.k1_backward``, ``GRUDv2Function.backward`` (K1's float32 recompute),
  which runs on autograd's device thread;
* ``pd.optimizer``: the critic-target copies, the gradient zero-fill, the
  norms, the clip and ``AdamW.step``;
* ``pd.loop.<name>``: ``tools.Timer``'s phases of the trainer's loop.

``COUNTERS`` counts always, in plain integer adds: ``weight_casts``, each
cast of a parameter to another dtype (``models/modules.py::cast_param``),
and ``train_steps``, the ``TrainStep`` calls.
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler

__all__ = ["span", "NULL", "COUNTERS"]

NULL = contextlib.nullcontext()
record_function = _profiler.record_function


def span(name: str):
    """``record_function(name)`` while a profiler records, else ``NULL``."""
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return NULL


class _Counters:
    """Counts since the last ``reset()``."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.weight_casts = 0
        self.train_steps = 0


COUNTERS = _Counters()
