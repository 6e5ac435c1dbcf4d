"""Input pipeline parallelism: worker threads + device prefetch.

Counterpart of ``pydreamer_tpu/data/prefetch.py`` (reference: train.py:137-141).
Each of ``num_workers`` threads runs an independent SequentialDataset stream
and every batch is tagged with its worker id, so the learner keeps a separate
TBTT state per stream. The heavy lifting (zlib inflate, numpy slicing and
stacking) releases the interpreter lock.

``prefetch_iterator`` keeps ``size`` batches in flight on the device. On a
CUDA device a background thread copies each numpy array into pinned host
memory and issues ``.to(device, non_blocking=True)`` on a side stream, then
records an event:

  * the consumer makes its current stream wait on that event before it hands
    the batch out, so no kernel reads a batch before its copy landed;
  * the device tensors get ``record_stream(current)``: they were allocated on
    the side stream, and without it the caching allocator could give their
    memory to the next copy while the step's kernels still read it;
  * the thread waits for the event before it drops the pinned buffers, so a
    pinned buffer outlives its copy.

On ``device="cpu"`` the arrays become tensors with ``torch.from_numpy`` (no
copy, no pinning).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..tools import logger

__all__ = ["ParallelLoader", "prefetch_iterator"]


class ParallelLoader:
    """N worker threads, each running its own dataset stream.

    ``make_dataset(worker_id)`` builds an independent iterator per worker
    (with its own RNG seed). Yields ``(batch, worker_id)`` tuples as they
    become ready. ``num_workers=0`` runs inline on the caller thread.

    ``strict_order=True`` yields workers in round-robin order (0, 1, ...,
    N-1, 0, ...) instead of arrival order, so a stream id pairs with a
    known step. A crashed worker sends a poison pill that raises in the
    consumer. ``close()`` stops the workers and ends the iteration.
    """

    def __init__(self,
                 make_dataset: Callable[[int], Iterator[Dict[str, np.ndarray]]],
                 num_workers: int = 0,
                 queue_size: int = 4,
                 strict_order: bool = False):
        self.make_dataset = make_dataset
        self.num_workers = num_workers
        self.queue_size = queue_size
        self.strict_order = strict_order
        self._threads = []
        self._queues = []
        self._stop = threading.Event()

    def _worker(self, worker_id: int, q: queue.Queue):
        try:
            for batch in iter(self.make_dataset(worker_id)):
                if not _put(q, (batch, worker_id), self._stop):
                    return
        except Exception:  # a thread boundary: report and hand the failure on
            logger.exception("Data worker %d crashed", worker_id)
            _put(q, (None, worker_id), self._stop)  # poison pill -> raise in main

    def __iter__(self) -> Iterator[Tuple[Dict[str, np.ndarray], int]]:
        if self.num_workers == 0:
            for batch in iter(self.make_dataset(0)):
                yield batch, 0
            return
        self._stop.clear()
        if self.strict_order:
            self._queues = [queue.Queue(maxsize=max(self.queue_size // self.num_workers, 1))
                            for _ in range(self.num_workers)]
        else:
            self._queues = [queue.Queue(maxsize=self.queue_size)] * self.num_workers
        self._threads = [
            threading.Thread(target=self._worker, args=(i, self._queues[i]),
                             daemon=True, name=f"data-worker-{i}")
            for i in range(self.num_workers)
        ]
        for t in self._threads:
            t.start()
        try:
            i = 0
            while not self._stop.is_set():
                try:
                    batch, wid = self._queues[i % self.num_workers].get(timeout=1.0)
                except queue.Empty:
                    continue
                if self.strict_order:
                    i += 1
                if batch is None:
                    raise RuntimeError(f"Data worker {wid} crashed")
                yield batch, wid
        finally:
            self.close()

    def close(self):
        self._stop.set()


def _put(q: queue.Queue, item, stop: threading.Event) -> bool:
    """Put unless ``stop`` is set first; -> whether the item went in."""
    while not stop.is_set():
        try:
            q.put(item, timeout=1.0)
            return True
        except queue.Full:
            continue
    return False


def _map(item, fn, kind):
    """Apply ``fn`` to every leaf of type ``kind`` in nested dicts/tuples/lists."""
    if isinstance(item, kind):
        return fn(item)
    if isinstance(item, dict):
        return {k: _map(v, fn, kind) for k, v in item.items()}
    if isinstance(item, (tuple, list)):
        return type(item)(_map(v, fn, kind) for v in item)
    return item


def _copy_to_cuda(item, device: torch.device, stream: torch.cuda.Stream):
    """Numpy leaves -> device tensors through pinned buffers on ``stream``;
    -> (item, event). Returns once the copies completed, so the pinned
    buffers it drops are no longer read."""
    pinned = []

    def copy(x: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(x)
        buf = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        buf.copy_(host)
        pinned.append(buf)
        return buf.to(device, non_blocking=True)

    with torch.cuda.stream(stream):
        out = _map(item, copy, np.ndarray)
    event = torch.cuda.Event()
    event.record(stream)
    event.synchronize()
    del pinned
    return out, event


def prefetch_iterator(iterator: Iterator[Any],
                      device: str | torch.device = "cuda",
                      size: int = 2,
                      transform: Optional[Callable[[Any], Any]] = None) -> Iterator[Any]:
    """Keep ``size`` items in flight on ``device``, copied off the caller's
    thread. ``transform`` runs on the host item first; numpy arrays anywhere
    in the item become tensors on ``device``, anything else passes through."""
    device = resolve_device(device)
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()
    _SENTINEL = object()
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def producer():
        try:
            for item in iterator:
                if transform is not None:
                    item = transform(item)
                if side is not None:
                    item, event = _copy_to_cuda(item, device, side)
                else:
                    item, event = _map(item, torch.from_numpy, np.ndarray), None
                if not _put(q, (item, event), stop):
                    return
            _put(q, _SENTINEL, stop)
        except Exception as e:  # a thread boundary: report and re-raise in the consumer
            logger.exception("Prefetch producer crashed")
            _put(q, e, stop)

    t = threading.Thread(target=producer, daemon=True, name="prefetch")
    t.start()
    try:
        while True:
            got = q.get()
            if got is _SENTINEL:
                return
            if isinstance(got, Exception):
                raise got
            item, event = got
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                _map(item, lambda x: x.record_stream(current), torch.Tensor)
            yield item
    finally:
        stop.set()
        t.join(timeout=30)
