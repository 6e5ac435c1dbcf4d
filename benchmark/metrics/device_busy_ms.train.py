"""device_busy_ms.train: the union of the device's activity intervals per
profiled train step (kernels, copies, sets), in ms."""


def read(run):
    busy = run.trace.busy_s()
    return busy * 1e3 / run.trace.steps if busy > 0 else None
