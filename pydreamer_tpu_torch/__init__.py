"""PyTorch/CUDA port of pydreamer_tpu for NVIDIA Hopper (H100).

The JAX package ``pydreamer_tpu`` stays the reference; this package mirrors its
layout module for module (``conf``, ``models/*``, ``ops/*``, ``training/*``) so
each counterpart is easy to find. It imports ``torch`` and nothing of JAX or of
the JAX package.

Every entry point takes an explicit ``device`` (default ``"cuda"``) and raises
when there is no card unless the caller asks for ``"cpu"``
(:func:`pydreamer_tpu_torch.device.resolve_device`).
"""

__version__ = "0.1.0"

__all__ = ["conf", "convert", "device", "models", "ops", "parallel", "training"]
