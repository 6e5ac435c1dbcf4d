"""optimizer_device_ms.train: the device time of the activity launched inside
the port's ``pd.optimizer`` spans (the critic-target copies, the gradient
zero-fill, the norms, the clip and ``AdamW.step``), as the union of its
intervals, in ms per profiled step (``benchmark/layers.py``). Silent where
the program has no such span."""


def read(run):
    from benchmark.layers import device_ms
    return device_ms(run.trace, "optimizer")
