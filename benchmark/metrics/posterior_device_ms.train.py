"""posterior_device_ms.train: the device time of the activity launched inside
the port's ``pd.posterior`` spans (the posterior noise and the T-step loop
of ``RSSMCore.forward`` (K1's forward, the MLPs) with ``batch_prior``), as
the union of its intervals, in ms per profiled step
(``benchmark/layers.py``). Silent where the program has no such span."""


def read(run):
    from benchmark.layers import device_ms
    return device_ms(run.trace, "posterior")
