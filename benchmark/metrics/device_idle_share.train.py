"""device_idle_share.train: 100 * (1 - busy ms a step / ms a step), the busy
time from the profiled steps and the step time from the same run's
unprofiled window, since the profiler stretches the steps it records."""


def read(run):
    busy = run.trace.busy_s()
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy * 1e3 / run.trace.steps / run.ms_per_step)
