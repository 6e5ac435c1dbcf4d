"""weight_copy_share.train: of the reads of a parameter in another dtype, the
share in % that the train step's weight copies served, from the port's own
counters (``pydreamer_tpu_torch.tracing.COUNTERS``: ``weight_copy_uses`` over
``weight_copy_uses`` plus the per-call casts, ``weight_casts`` less the
copies' own casts ``weight_copies``, all over the run's every ``TrainStep``
call). 100 where no read casts per call. A count, so it repeats exactly.
Silent where the program has no such counter."""


def read(run):
    try:
        from pydreamer_tpu_torch.tracing import COUNTERS
    except ImportError:
        return None
    if not COUNTERS.train_steps or not hasattr(COUNTERS, "weight_copy_uses"):
        return None
    uses = COUNTERS.weight_copy_uses
    reads = uses + COUNTERS.weight_casts - COUNTERS.weight_copies
    if not reads:
        return None
    return 100.0 * uses / reads
