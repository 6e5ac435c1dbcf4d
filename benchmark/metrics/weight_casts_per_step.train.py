"""weight_casts_per_step.train: the casts of a parameter to another dtype per
train step, from the port's own counters
(``pydreamer_tpu_torch.tracing.COUNTERS``: ``weight_casts`` over
``train_steps``, both over the run's every ``TrainStep`` call, as each step
casts alike). A count, so it repeats exactly. Silent where the program has
no such counter."""


def read(run):
    try:
        from pydreamer_tpu_torch.tracing import COUNTERS
    except ImportError:
        return None
    if not COUNTERS.train_steps:
        return None
    return COUNTERS.weight_casts / COUNTERS.train_steps
