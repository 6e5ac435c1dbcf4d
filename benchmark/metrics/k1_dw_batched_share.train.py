"""k1_dw_batched_share.train: of K1's backward calls in the run that needed a
weight gradient, the share in % whose dW was summed once over its unroll,
from the port's own tally (``pydreamer_tpu_torch.ops.gru_dv2.K1_DW``:
``batched`` over ``batched`` plus ``per_call`` in ``by_path``, over every
``TrainStep`` call of the run, the replays credited as their capture counted).
A count, so it repeats exactly. Silent where the program has no such tally or
no call needed a weight gradient."""


def read(run):
    try:
        from pydreamer_tpu_torch.ops.gru_dv2 import K1_DW
    except ImportError:
        return None
    calls = sum(K1_DW.by_path.values())
    if not calls:
        return None
    return 100.0 * K1_DW.by_path.get("batched", 0) / calls
