"""span_coverage.train: of the device timeline inside the port's
``pd.train_step`` spans (the busy time of the activity launched there plus
the idle gaps those activities end), the share in % that belongs to one of
the seven leaf layers (``benchmark/layers.py``). It falls where a code path
of the step escapes the layer spans. Silent where the program has no such
span."""


def read(run):
    from benchmark.layers import coverage
    return coverage(run.trace)
