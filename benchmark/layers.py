"""The train step's layers in a traced window, from the port's ``pd.*`` spans.

The port opens a ``torch.profiler.record_function`` span at each layer of
its train step (``pydreamer_tpu_torch/tracing.py``): the root
``pd.train_step``, its seven leaves ``pd.<layer>`` for the layers in
``LAYERS``, and ``pd.k1_backward`` inside ``pd.backward``. This module reads
only the fields of ``benchmark/trace.py``'s ``Trace``:

* a device activity belongs to a span when its launch (the ``launches``
  entry with its correlation id) falls inside one of that span's intervals
  in ``host_ops``, on whatever thread: ``pd.k1_backward`` runs on autograd's
  device thread, inside the interval of ``pd.backward`` on the caller's. An
  activity whose launch the trace lacks (a copy or a set made through the
  runtime's own calls) belongs to no span;
* an idle gap, a stretch in which the device runs nothing, belongs to the
  span in which the activity that ended it was launched: what the host was
  doing while the device waited. The profiler stretches host time (about
  2.2x a step), so the idle ms a layer reads are stretched alike.

Each reading is per profiled step. A program without the spans (an older
checkout) reads ``None`` everywhere, as does a trace without device activity.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .trace import Trace, union_ns

__all__ = ["LAYERS", "ROOT", "Split", "split", "device_ms", "idle_ms", "coverage"]

ROOT = "pd.train_step"
LAYERS = ("encoder", "posterior", "heads", "dream", "actor_critic", "backward", "optimizer")
NAMES = (ROOT, *(f"pd.{layer}" for layer in LAYERS), "pd.k1_backward")


@dataclass
class Split:
    """Nanoseconds of the whole window by span name: ``device`` the union of
    the activity belonging to the span, ``idle`` the gaps belonging to it;
    ``covered`` / ``timeline`` the root's busy plus idle time that belongs to
    one of the leaves / to the root."""

    spans: Dict[str, List[Tuple[int, int]]]
    device: Dict[str, int]
    idle: Dict[str, int]
    covered: int
    timeline: int


def _holds(intervals: List[Tuple[int, int]], starts: List[int], t: int) -> bool:
    """Whether one of the disjoint, ordered ``intervals`` holds ``t``."""
    j = bisect.bisect_right(starts, t) - 1
    return j >= 0 and t <= intervals[j][1]


def _length(spans: List[Tuple[int, int, str]]) -> int:
    return sum(b - a for a, b in union_ns(spans))


def _split(trace: Trace) -> Split:
    by_name: Dict[str, list] = {}
    for op in trace.host_ops:
        if op[2] in NAMES:
            by_name.setdefault(op[2], []).append(op)
    spans = {name: union_ns(ops) for name, ops in by_name.items()}
    starts = {name: [a for a, _ in iv] for name, iv in spans.items()}
    launch_at = {corr: start for start, corr in trace.launches}
    leaves = [f"pd.{layer}" for layer in LAYERS]

    def owners(i: int) -> List[str]:
        t = launch_at.get(trace.device_corr[i]) if trace.device_corr else None
        if t is None:
            return []
        return [name for name, iv in spans.items() if _holds(iv, starts[name], t)]

    active: Dict[str, list] = {name: [] for name in spans}
    idle = {name: 0 for name in spans}
    covered_busy = []
    covered_idle = root_idle = 0
    end = None
    for i in sorted(range(len(trace.device)), key=lambda i: trace.device[i][0]):
        s, e, _ = activity = trace.device[i]
        gap = s - end if end is not None and s > end else 0
        end = e if end is None else max(end, e)
        names = owners(i)
        for name in names:
            active[name].append(activity)
            idle[name] += gap
        if ROOT in names:
            root_idle += gap
            if any(leaf in names for leaf in leaves):
                covered_busy.append(activity)
                covered_idle += gap
    return Split(spans=spans, device={name: _length(iv) for name, iv in active.items()},
                 idle=idle, covered=_length(covered_busy) + covered_idle,
                 timeline=_length(active.get(ROOT, [])) + root_idle)


_last: Optional[Tuple[Trace, Split]] = None


def split(trace: Trace) -> Split:
    """The ``Split`` of ``trace``; the last one is kept, as each metric asks."""
    global _last
    if _last is None or _last[0] is not trace:
        _last = (trace, _split(trace))
    return _last[1]


def _read(trace: Trace, name: str, field: str) -> Optional[float]:
    if not trace.device:
        return None
    s = split(trace)
    if name not in s.spans:
        return None
    return getattr(s, field)[name] / 1e6 / trace.steps


def device_ms(trace: Trace, layer: str) -> Optional[float]:
    """Device ms a profiled step of the activity launched in ``pd.<layer>``."""
    return _read(trace, f"pd.{layer}", "device")


def idle_ms(trace: Trace, layer: str) -> Optional[float]:
    """Idle ms a profiled step that end in an activity launched in ``pd.<layer>``."""
    return _read(trace, f"pd.{layer}", "idle")


def coverage(trace: Trace) -> Optional[float]:
    """Of the device timeline of ``pd.train_step`` (busy plus idle time), the
    share in % that belongs to one of the seven leaf layers."""
    if not trace.device:
        return None
    s = split(trace)
    return 100.0 * s.covered / s.timeline if s.timeline > 0 else None
