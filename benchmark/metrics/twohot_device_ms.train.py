"""twohot_device_ms.train: the device time of the activity launched inside the
port's ``pd.twohot`` spans (DreamerV3's two-hot symlog work: the targets'
encoding, the log-softmax over the bins and the means, of the reward head
and of both critics), as the union of its intervals, in ms per profiled step
(``benchmark/spans.py``). Silent where the program has no such span."""


def read(run):
    from benchmark.spans import device_ms
    return device_ms(run.trace, "pd.twohot")
