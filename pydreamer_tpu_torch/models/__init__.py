"""Model modules of the PyTorch port (counterparts of ``pydreamer_tpu.models``)."""
