"""backward_device_ms.train: the device time of the activity launched inside
the port's ``pd.backward`` spans (the loss sum and the one ``backward()``,
K1's recompute included), as the union of its intervals, in ms per profiled
step (``benchmark/layers.py``). Silent where the program has no such span."""


def read(run):
    from benchmark.layers import device_ms
    return device_ms(run.trace, "backward")
