"""The learner's data pipeline (counterpart of ``pydreamer_tpu/data``)."""

from .dataset import SequentialDataset
from .prefetch import ParallelLoader, prefetch_iterator
from .preprocessing import Preprocessor
from .repository import EpisodeRepository, FileInfo, NpzEpisodeRepository, make_repository

__all__ = [
    "FileInfo", "EpisodeRepository", "NpzEpisodeRepository", "make_repository",
    "SequentialDataset", "Preprocessor", "ParallelLoader", "prefetch_iterator",
]
