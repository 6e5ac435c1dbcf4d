"""Training step of the PyTorch port (counterpart of ``pydreamer_tpu.training``)."""
