"""The device time of the activity launched inside one of the port's spans,
by its name, from a traced window.

``benchmark/layers.py`` reads a fixed tuple of span names; this module reads
any one, by the same rule: a device activity belongs to the span when its
launch (the ``launches`` entry with its correlation id) falls inside one of
the span's intervals in ``host_ops``, on whatever thread. An activity whose
launch the trace lacks belongs to no span. The reading is the union of the
activities' intervals, in ms per profiled step; ``None`` where the program
opened no such span (an older checkout, a model without that work) or the
trace has no device activity.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

from .trace import Trace, union_ns

__all__ = ["device_ms"]


def _holds(intervals: List[Tuple[int, int]], starts: List[int], t: int) -> bool:
    """Whether one of the disjoint, ordered ``intervals`` holds ``t``."""
    j = bisect.bisect_right(starts, t) - 1
    return j >= 0 and t <= intervals[j][1]


def device_ms(trace: Trace, name: str) -> Optional[float]:
    """Device ms a profiled step of the activity launched in the span ``name``."""
    if not trace.device:
        return None
    intervals = union_ns([op for op in trace.host_ops if op[2] == name])
    if not intervals:
        return None
    starts = [a for a, _ in intervals]
    launch_at = {corr: start for start, corr in trace.launches}
    inside = []
    for i, activity in enumerate(trace.device):
        t = launch_at.get(trace.device_corr[i]) if trace.device_corr else None
        if t is not None and _holds(intervals, starts, t):
            inside.append(activity)
    return sum(b - a for a, b in union_ns(inside)) / 1e6 / trace.steps
