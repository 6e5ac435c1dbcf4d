"""mfu.train: the train step's model FLOPs over the card's bf16 dense peak.

FLOPs from the configuration's shapes (``benchmark/flops/<model>.py``; no
recomputation counted), time from the run's unprofiled window (host clock
over all its steps), peak from ``benchmark/peaks.py`` at the full power limit.
"""


def read(run):
    from benchmark.peaks import peaks_for

    if run.card == "cpu" or run.ms_per_step <= 0:
        return None
    _, (_, bf16, _, _) = peaks_for(run.device_name)
    return 100.0 * run.flops_per_step / (run.ms_per_step / 1e3) / bf16
