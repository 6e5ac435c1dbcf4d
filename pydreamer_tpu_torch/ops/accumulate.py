"""``accumulate_(acc, g)``: ``acc += g`` for a float32 accumulator and a
bfloat16 addend, the gradient accumulation of the train step's weight copies
(``models/modules.py::CopyUse``).

On CUDA it is always one pass of the hand-written kernel
``csrc/accumulate.cu`` (read 2 + 4 bytes, write 4 an element): torch's
mixed-dtype ``add_`` takes its dynamic-cast path there, below the kernel's
bandwidth. An addend that is not dense or not on 16 bytes is copied to one
that is first; an accumulator that is neither raises. On the CPU it is
``acc.add_(g)``. Both add the exactly widened addend in one f32 add, so the
sums are bit for bit those of an upcast followed by an add. ``ACCUMULATES``
counts the kernel's launches, in all and by element count, and is registered
with ``tracing.TALLIES``, so a replayed train step credits them. The kernel
is built with ``nvcc`` at first use, as K1 is (``gru_dv2.build``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..tracing import TALLIES
from . import gru_dv2

__all__ = ["accumulate_", "accumulate_cuda", "ACCUMULATES", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "accumulate.cu"
_lib = None


class _AccumulateCounter:
    """Launches of the accumulate kernel since the last ``reset()``, in all
    and by element count."""

    def __init__(self):
        self.reset()

    def add(self, numel: int) -> None:
        self.count += 1
        self.by_numel[numel] = self.by_numel.get(numel, 0) + 1

    def reset(self) -> None:
        self.count = 0
        self.by_numel: dict[int, int] = {}


ACCUMULATES = TALLIES.register(_AccumulateCounter(), "count", "by_numel")


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(gru_dv2.build(SOURCE)))
        lib.accumulate_bf16_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                            ctypes.c_void_p]
        lib.accumulate_bf16_f32.restype = ctypes.c_int
        _lib = lib
    return _lib


def _dense(t: torch.Tensor) -> bool:
    """Contiguous and on 16 bytes, as the kernel's vector loads need."""
    return t.is_contiguous() and t.data_ptr() % 16 == 0


def accumulate_cuda(acc: torch.Tensor, g: torch.Tensor) -> None:
    """The kernel's pass on the current stream of ``acc``'s device; both
    dense (``_dense``), of one size. Counted in ``ACCUMULATES``."""
    lib, device = _load(), acc.device
    args = (acc.data_ptr(), g.data_ptr(), acc.numel(),
            torch.cuda.current_stream(device).cuda_stream)
    if device.index in (None, torch.cuda.current_device()):
        err = lib.accumulate_bf16_f32(*args)
    else:  # the kernel launches on the current device
        with torch.cuda.device(device):
            err = lib.accumulate_bf16_f32(*args)
    if err != 0:
        raise RuntimeError(f"accumulate launch failed: CUDA error {err}")
    ACCUMULATES.add(acc.numel())


def accumulate_(acc: torch.Tensor, g: torch.Tensor) -> None:
    """``acc += g`` in place (see the module docstring)."""
    if not acc.is_cuda:
        acc.add_(g)
        return
    if (acc.dtype != torch.float32 or g.dtype != torch.bfloat16 or g.device != acc.device
            or g.shape != acc.shape or not _dense(acc)):
        raise ValueError(f"accumulate_ takes a dense float32 accumulator and a bfloat16 addend "
                         f"of its shape on its device; got {acc.dtype} {tuple(acc.shape)} "
                         f"(dense: {_dense(acc)}) and {g.dtype} {tuple(g.shape)} on {g.device}")
    if not _dense(g):
        g = g.clone(memory_format=torch.contiguous_format)
    accumulate_cuda(acc, g)
