"""heads_idle_ms.train: the device's idle gaps that end in an activity launched
inside the port's ``pd.heads`` spans (the decoders, the KL loss, the
auxiliary critic and the probe): what the host was doing while the device
waited, in ms per profiled step (``benchmark/layers.py``). The profiler
stretches host time, about 2.2x a step, so these gaps are stretched too:
compare them with each other and across commits, not with an unprofiled
step. Silent where the program has no such span."""


def read(run):
    from benchmark.layers import idle_ms
    return idle_ms(run.trace, "heads")
