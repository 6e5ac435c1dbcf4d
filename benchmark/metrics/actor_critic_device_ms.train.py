"""actor_critic_device_ms.train: the device time of the activity launched
inside the port's ``pd.actor_critic`` spans (``ActorCritic.training_step``:
GAE, the actor's and the critic's losses), as the union of its intervals, in
ms per profiled step (``benchmark/layers.py``). Silent where the program has
no such span."""


def read(run):
    from benchmark.layers import device_ms
    return device_ms(run.trace, "actor_critic")
