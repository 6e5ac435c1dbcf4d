"""k1_backward_kernel_share.train: of K1's backward calls in the run, the share
in % that K1's bf16 pass served (``GRUDv2Function.backward``'s ``kernel``
route), from the port's own counter (``pydreamer_tpu_torch.ops.gru_dv2.
K1_BACKWARDS``, by route, over every ``TrainStep`` call of the run, the
replays credited as their capture counted). A count, so it repeats exactly.
Silent where the program has no such counter or ran no K1 backward."""


def read(run):
    try:
        from pydreamer_tpu_torch.ops.gru_dv2 import K1_BACKWARDS
    except ImportError:
        return None
    calls = sum(K1_BACKWARDS.by_route.values())
    if not calls:
        return None
    return 100.0 * K1_BACKWARDS.by_route.get("kernel", 0) / calls
