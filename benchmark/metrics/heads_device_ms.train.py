"""heads_device_ms.train: the device time of the activity launched inside the
port's ``pd.heads`` spans (the decoders, the KL loss, the auxiliary critic
and the probe), as the union of its intervals, in ms per profiled step
(``benchmark/layers.py``). Silent where the program has no such span."""


def read(run):
    from benchmark.layers import device_ms
    return device_ms(run.trace, "heads")
