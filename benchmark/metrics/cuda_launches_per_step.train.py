"""cuda_launches_per_step.train: the host's CUDA launch calls per train step
in the profiled steps (``benchmark/trace.py``'s ``LAUNCH_CALLS``)."""


def read(run):
    n = run.trace.launch_count()
    return n / run.trace.steps if n else None
