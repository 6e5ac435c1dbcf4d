"""Sequential TBTT dataset: B independent per-slot episode streams.

Counterpart of ``pydreamer_tpu/data/dataset.py`` (reference: pydreamer/data.py:
128-308), with the same semantics and the same ``np.random.default_rng(seed)``
calls in the same order, so one seed yields the same batches, byte for byte:

  * each of the B batch slots runs an independent infinite stream: pick a
    random file, cut it into ``batch_length`` windows in temporal order
    (truncated BPTT), repeat
  * ``allow_mid_reset``: a partial window at a file end is stitched to the
    start of the next file so episodes span batch boundaries; otherwise the
    partial tail is dropped
  * ``buffer_size`` keeps only the most recent files by total steps
  * ``reload_interval`` re-lists the repository (online data)
  * ``reset_interval`` injects randomized resets at window starts so the
    model also learns cold starts
  * too-short files are skipped; ``action_next`` is synthesized; a file must
    start with a reset and zero reward
  * the generators' ``image_t`` (HWCT) compression transpose is undone on load

The iterator yields dict batches of numpy arrays of shape (T, B, ...).
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..tools import logger
from .repository import EpisodeRepository, FileInfo

__all__ = ["SequentialDataset"]


def _lenb(batch: Dict[str, np.ndarray]) -> int:
    return batch["reward"].shape[0]


def _cat_structure(datas: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = set(datas[0].keys())
    for d in datas[1:]:
        keys.intersection_update(d.keys())
    return {k: np.concatenate([d[k] for d in datas]) for k in keys}


def _stack_structure(datas: Tuple[Dict[str, np.ndarray], ...]) -> Dict[str, np.ndarray]:
    keys = set(datas[0].keys())
    for d in datas[1:]:
        keys.intersection_update(d.keys())
    return {k: np.stack([d[k] for d in datas]) for k in keys}


class SequentialDataset:
    """Infinite iterator over (T,B) batches with per-slot sequential streams."""

    def __init__(self,
                 repository: EpisodeRepository,
                 batch_length: int,
                 batch_size: int,
                 skip_first: bool = True,
                 reload_interval: float = 0,
                 buffer_size: int = 0,
                 reset_interval: int = 0,
                 allow_mid_reset: bool = False,
                 seed: Optional[int] = None):
        self.repository = repository
        self.batch_length = batch_length
        self.batch_size = batch_size
        self.skip_first = skip_first
        self.reload_interval = reload_interval
        self.buffer_size = buffer_size
        self.reset_interval = reset_interval
        self.allow_mid_reset = allow_mid_reset
        self.rng = np.random.default_rng(seed)
        self.reload_files(True)
        if not self.files:
            raise ValueError(f"No data found in {self.repository}")

    def reload_files(self, is_first: bool = False):
        if is_first:
            logger.debug("Reading files from %s...", self.repository)
        files_all = self.repository.list_files()
        # Newest-first so buffer_size keeps the most recent experience.
        files_all.sort(key=lambda e: -e.episode_to)
        files: List[FileInfo] = []
        steps_total = 0
        steps_filtered = 0
        for f in files_all:
            steps_total += f.steps
            if steps_total < self.buffer_size or not self.buffer_size:
                files.append(f)
                steps_filtered += f.steps
        self.files = files
        self.last_reload = time.time()
        self.stats_steps = steps_total
        logger.debug("Found total files|steps: %d|%d, filtered: %d|%d",
                     len(files_all), steps_total, len(files), steps_filtered)

    def should_reload_files(self) -> bool:
        return bool(self.reload_interval) and (
            time.time() - self.last_reload > self.reload_interval)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        iters = [self.iter_single(ix) for ix in range(self.batch_size)]
        for batches in zip(*iters):
            batch = _stack_structure(batches)          # (B,T,...)
            yield {k: v.swapaxes(0, 1) for k, v in batch.items()}  # (T,B,...)

    def iter_single(self, ix: int) -> Iterator[Dict[str, np.ndarray]]:
        """One slot's infinite stream of (T,...) windows in temporal order."""
        skip_random = self.skip_first
        last_partial_batch: Optional[Dict[str, np.ndarray]] = None

        for file in self.iter_shuffled_files():
            if last_partial_batch is not None:
                first_shorter_length = self.batch_length - _lenb(last_partial_batch)
            else:
                first_shorter_length = None

            it = self.iter_file(file, self.batch_length, skip_random, first_shorter_length)

            # Stitch the previous file's partial tail to this file's first
            # window to emit one full-length batch.
            if last_partial_batch is not None:
                for batch, partial in it:
                    if partial:
                        raise ValueError("First batch must be full. Is episode_length < batch_size?")
                    batch = _cat_structure([last_partial_batch, batch])
                    assert _lenb(batch) == self.batch_length
                    last_partial_batch = None
                    yield batch
                    break

            for batch, partial in it:
                if partial:
                    if self.allow_mid_reset:
                        last_partial_batch = batch
                    else:
                        last_partial_batch = None
                    break  # partial is always last
                yield batch

            skip_random = False

    def iter_file(self, file: FileInfo, batch_length: int,
                  skip_random: bool = False,
                  first_shorter_length: Optional[int] = None):
        try:
            data = file.load_data()
        except Exception as e:  # a corrupt or foreign file: skip it, keep streaming
            logger.warning("Error reading file - skipping: %s (%s)", file, e)
            return

        # Undo the image_t (HWCT) compression transpose from the generator.
        if "image" not in data and "image_t" in data:
            data["image"] = data["image_t"].transpose(3, 0, 1, 2)  # HWCT => THWC
            del data["image_t"]

        # action[i] -> obs[i] -> action_next[i] -> obs[i+1]; last is zero.
        data = dict(data)
        data["action_next"] = np.concatenate(
            [data["action"][1:], np.zeros_like(data["action"][:1])])

        n = _lenb(data)
        if n < batch_length:
            logger.debug("Skipping too short file: %s, len=%d", file, n)
            return

        if "reset" not in data:
            data["reset"] = np.zeros(n, bool)
        data["reset"] = data["reset"].copy()
        data["reward"] = data["reward"].copy()
        data["reset"][0] = True   # file must start with reset
        data["reward"][0] = 0.0   # ... and no reward

        i = 0 if not skip_random else int(self.rng.integers(n - batch_length + 1))
        l = first_shorter_length or batch_length

        if self.reset_interval:
            random_resets = self.randomize_resets(data["reset"], self.reset_interval,
                                                  self.batch_length)
        else:
            random_resets = np.zeros_like(data["reset"])

        while i < n:
            batch = {key: data[key][i:i + l] for key in data}
            if np.any(random_resets[i:i + l]):
                # Resets injected mid-episode are applied at the START of the
                # window for a longer backprop span.
                if np.any(batch["reset"]):
                    raise AssertionError("randomize_resets should not coincide with actual resets")
                batch["reset"] = batch["reset"].copy()
                batch["reset"][0] = True
            is_partial = _lenb(batch) < l
            i += l
            l = batch_length
            yield batch, is_partial

    def iter_shuffled_files(self) -> Iterator[FileInfo]:
        while True:
            if self.should_reload_files():
                self.reload_files()
            yield self.files[int(self.rng.integers(len(self.files)))]

    def randomize_resets(self, resets: np.ndarray, reset_interval: int,
                         batch_length: int) -> np.ndarray:
        """Inject random TBTT state resets (cold-start regularization).

        Each episode is independently cut into k ~ U{1 .. len//interval + 1}
        chunks, every chunk at least ``batch_length`` long; chunk starts
        (except the episode's own) become synthetic resets.
        """
        assert resets[0]
        out = np.zeros_like(resets)
        ep_starts = np.flatnonzero(resets)
        ep_lengths = np.diff(np.append(ep_starts, len(resets)))
        for start, n in zip(ep_starts, ep_lengths):
            k = 1 + int(self.rng.integers(n // reset_interval + 1))
            slack = int(n) - batch_length * k
            if k == 1 or slack <= 0:
                continue
            # k-1 cut positions: sorted uniform draws over the slack, spread
            # by a mandatory batch_length stride so no chunk is shorter than
            # one batch window.
            cuts = np.sort(self.rng.integers(0, slack, size=k - 1))
            out[start + batch_length * np.arange(1, k) + cuts] = True
        return out
