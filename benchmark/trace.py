"""What a ``torch.profiler`` window of train steps says about the device.

``summarize`` reads the profiler's raw records (``kineto_results.events()``)
once into plain tuples; ``Trace`` then answers from those alone, so the
arithmetic is tested without a card:

* device busy time is the union of the intervals of every device activity
  (kernels, copies, sets), not the sum of their durations, which counts
  overlapping kernels twice; the annotations that ``record_function`` puts
  on the device's timeline (the optimizer's step) are spans, not activity,
  and are left out;
* launches are the host's CUDA launch calls (``LAUNCH_CALLS``);
* an idle gap is a stretch between two device activities, labelled with the
  innermost host op that was running when the activity after it was
  launched: what the host was doing while the device waited.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["Trace", "summarize", "LAUNCH_CALLS", "union_ns"]

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch")

Span = Tuple[int, int, str]  # (start ns, end ns, name)


def union_ns(spans: List[Span]) -> List[Tuple[int, int]]:
    """The disjoint intervals that ``spans`` cover, in order."""
    out: List[List[int]] = []
    for start, end, _ in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


@dataclass
class Trace:
    """A profiled window of ``steps`` steps lasting ``window_s`` on the host's clock."""

    steps: int
    window_s: float
    device: List[Span] = field(default_factory=list)       # device activities
    host_ops: List[Span] = field(default_factory=list)     # host ops (not runtime calls)
    launches: List[Tuple[int, int]] = field(default_factory=list)  # (start ns, correlation)
    device_corr: List[int] = field(default_factory=list)   # correlation of each device span
    launch_names: Dict[str, int] = field(default_factory=dict)  # launches by call
    annotations: int = 0                                   # device-timeline annotations left out

    def busy_s(self) -> float:
        return sum(b - a for a, b in union_ns(self.device)) / 1e9

    def launch_count(self) -> int:
        return len(self.launches)

    def device_s(self, match: Callable[[str], bool]) -> float:
        """Seconds of the device activities whose name ``match`` accepts."""
        return sum(e - s for s, e, name in self.device if match(name)) / 1e9

    def top_ops(self, n: int = 10) -> List[List]:
        """[name, seconds a step] of the device activities that took most time."""
        by_name: Dict[str, int] = {}
        for s, e, name in self.device:
            by_name[name] = by_name.get(name, 0) + e - s
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9 / self.steps] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """[host op, seconds] of the ``n`` longest idle stretches of the device."""
        order = sorted(range(len(self.device)), key=lambda i: self.device[i][0])
        gaps = []
        end = None
        for i in order:
            s, e, _ = self.device[i]
            if end is not None and s > end:
                gaps.append((s - end, i))
            end = e if end is None else max(end, e)
        gaps.sort(reverse=True)
        launch_at = {corr: start for start, corr in self.launches}
        starts = [s for s, _, _ in self.host_ops]
        out = []
        for length, i in gaps[:n]:
            t = launch_at.get(self.device_corr[i]) if self.device_corr else None
            out.append([self._host_op_at(t, starts) if t is not None else "unattributed",
                        length / 1e9])
        return out

    def _host_op_at(self, t: int, starts: List[int]) -> str:
        best: Optional[Span] = None
        for j in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            s, e, name = self.host_ops[j]
            if e >= t and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        return best[2] if best else "unattributed"


def summarize(prof, steps: int, window_s: float) -> Trace:
    """The ``Trace`` of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    trace = Trace(steps, window_s)
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns()
        span = (start, start + ev.duration_ns(), ev.name())
        if ev.device_type() == DeviceType.CUDA:
            if ev.is_user_annotation():
                trace.annotations += 1
                continue
            trace.device.append(span)
            trace.device_corr.append(ev.correlation_id())
        elif ev.name() in LAUNCH_CALLS:
            trace.launches.append((start, ev.correlation_id()))
            trace.launch_names[ev.name()] = trace.launch_names.get(ev.name(), 0) + 1
        elif not ev.name().startswith(("cuda", "cu")) and ev.duration_ns() > 0:
            trace.host_ops.append(span)
    trace.host_ops.sort()
    return trace
