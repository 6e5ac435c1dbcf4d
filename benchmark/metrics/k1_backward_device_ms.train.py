"""k1_backward_device_ms.train: the device time of the activity launched inside
the port's ``pd.k1_backward`` spans (``GRUDv2Function.backward``: K1's
backward, a float32 recompute through the plain version and its gradients,
on autograd's device thread), as the union of its intervals, in ms per
profiled step (``benchmark/layers.py``). Silent where the program has no
such span."""


def read(run):
    from benchmark.layers import device_ms
    return device_ms(run.trace, "k1_backward")
