"""retnorm_device_ms.train: the device time of the activity launched inside the
port's ``pd.retnorm`` spans (DreamerV3's return normalisation: the returns'
percentiles, the EMA of the statistics, the scaled advantage), as the union
of its intervals, in ms per profiled step (``benchmark/spans.py``). Silent
where the program has no such span."""


def read(run):
    from benchmark.spans import device_ms
    return device_ms(run.trace, "pd.retnorm")
