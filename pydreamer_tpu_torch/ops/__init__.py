"""Hand-written kernels of the PyTorch port (counterparts of ``pydreamer_tpu.ops``)."""
