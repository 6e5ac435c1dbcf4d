"""Device selection for the port's entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "compute_dtype"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; never falls back to the CPU.

    ``"cuda"`` (the default everywhere) raises when no card is visible, so a
    run that was meant for the GPU cannot silently carry on on the CPU. Pass
    ``"cpu"`` explicitly to run there (the tests do).
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return device


def compute_dtype(conf) -> torch.dtype:
    """Compute dtype from config: 'bfloat16'|'float32' (conf.amp => bf16).

    Parameters stay float32 master copies; modules cast to this dtype per op.
    """
    prec = conf.get("precision", None)
    if prec is None:
        prec = "bfloat16" if conf.get("amp", False) else "float32"
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[str(prec)]
