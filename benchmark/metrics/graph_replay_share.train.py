"""graph_replay_share.train: of the run's ``TrainStep`` calls, the share in %
served by replaying the step's CUDA graphs, from the port's own counters
(``pydreamer_tpu_torch.tracing.COUNTERS``: ``graph_replays`` over
``train_steps``, both over the run's every call: the keyed steps and the
warm-up steps run eagerly, the window's steps replay). A count, so it repeats
exactly. Silent where the program has no such counter."""


def read(run):
    try:
        from pydreamer_tpu_torch.tracing import COUNTERS
    except ImportError:
        return None
    if not COUNTERS.train_steps or not hasattr(COUNTERS, "graph_replays"):
        return None
    return 100.0 * COUNTERS.graph_replays / COUNTERS.train_steps
