"""Logging, timing and small host-side utilities.

Counterpart of ``pydreamer_tpu/tools.py``: colored per-process log
prefixes, ``print_once`` dedup, ``Timer`` phase timings reported as
``timer_*`` metrics, ``discount`` (the generators' discounted return) and
the null profiler ``NoProfiler``.
The JAX package's persistent compilation cache
(``enable_persistent_compilation_cache``, which the JAX generator enables at
start) is a cache of XLA executables and has no counterpart here: eager
PyTorch compiles nothing, and K1's library is built once into
``ops/_build/`` and reused by every process.
"""

from __future__ import annotations

import logging
import sys
import time
from typing import Dict, Optional

import numpy as np

from .tracing import span

__all__ = ["logger", "configure_logging", "print_once", "Timer", "timers_summary",
           "discount", "NoProfiler", "LogColorFormatter"]

logger = logging.getLogger("pydreamer_tpu_torch")

_printed_once = set()


def print_once(msg: str, *args):
    if msg not in _printed_once:
        _printed_once.add(msg)
        logger.info("%s %s", msg, " ".join(str(a) for a in args))


class LogColorFormatter(logging.Formatter):
    """ANSI-colored [PREFIX] formatter (reference: tools.py:281-320)."""

    GREY = "\033[90m"
    GREEN = "\033[32m"
    YELLOW = "\033[33m"
    RED = "\033[31m"
    BOLD_RED = "\033[31;1m"
    RESET = "\033[0m"

    def __init__(self, prefix: str, color: Optional[str] = None):
        super().__init__()
        self.prefix = prefix
        self.color = color or ""

    def format(self, record: logging.LogRecord) -> str:
        if record.levelno >= logging.ERROR:
            color = self.BOLD_RED
        elif record.levelno >= logging.WARNING:
            color = self.YELLOW
        else:
            color = self.color
        ts = time.strftime("%H:%M:%S", time.localtime(record.created))
        msg = record.getMessage()
        if record.exc_info:
            msg += "\n" + self.formatException(record.exc_info)
        return f"{color}{ts} {self.prefix}{self.RESET}  {msg}"


def configure_logging(prefix: str = "[MAIN]", color: Optional[str] = None,
                      level: int = logging.INFO):
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(LogColorFormatter(prefix, color))
    root = logging.getLogger()
    root.handlers = [handler]
    root.setLevel(level)
    for name in ("urllib3", "requests", "PIL"):
        logging.getLogger(name).setLevel(logging.WARNING)


class Timer:
    """Context timer accumulating seconds per name (reference: tools.py:231-255).

    Samples accumulate in a class-level registry keyed by name, so
    ``with Timer("step"):`` constructed fresh every loop iteration keeps
    appending to the same series until ``timers_summary(reset=True)`` drains it.
    ``verbose`` logs each sample at debug level. The block is also the span
    ``pd.loop.<name>`` (``tracing.span``), so the phases show in a profiler's
    trace beside the train step's layers; the samples keep the host clock.
    """

    registry: Dict[str, list] = {}

    def __init__(self, name: str = "timer", verbose: bool = False):
        self.name = name
        self.verbose = verbose
        self.start_time: Optional[float] = None

    def __enter__(self):
        self._span = span("pd.loop." + self.name)
        self._span.__enter__()
        self.start_time = time.time()
        return self

    def __exit__(self, *exc):
        dt = time.time() - self.start_time  # type: ignore
        Timer.registry.setdefault(self.name, []).append(dt)
        if self.verbose:
            logger.debug("%s: %.1f ms", self.name, dt * 1000)
        self._span.__exit__(*exc)
        return False

    @property
    def times(self) -> list:
        """This name's samples (seconds) since the last reset."""
        return Timer.registry.get(self.name, [])

    @property
    def dt_mean(self) -> float:
        """Mean of ``times``; 0.0 without a sample."""
        return float(np.mean(self.times)) if self.times else 0.0

    def reset(self):
        Timer.registry[self.name] = []


def timers_summary(reset: bool = True) -> Dict[str, float]:
    """Mean seconds per named timer over the window, as ``timer_*`` metrics."""
    out = {}
    for name, times in Timer.registry.items():
        if times:
            out[f"timer_{name}"] = float(np.mean(times))
    if reset:
        for name in Timer.registry:
            Timer.registry[name] = []
    return out


def discount(x: np.ndarray, gamma: float) -> np.ndarray:
    """Discounted cumulative sums along axis 0 (reference: tools.py:226-228)."""
    import scipy.signal
    return scipy.signal.lfilter([1.0], [1.0, -gamma], x[::-1], axis=0)[::-1]


class NoProfiler:
    """Null profiler (reference: tools.py:258-266)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def step(self):
        pass
