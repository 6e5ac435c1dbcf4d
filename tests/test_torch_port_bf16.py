"""One bfloat16 step of the tiny Dreamer against the float32 JAX step.

The flagship trains under ``precision: bfloat16``; every other port test runs
float32. The port's model in bfloat16, with the weights and the replayed
noise of the float32 JAX model, takes one ``TrainStep`` step (the K1 cell's
plain version in bfloat16 on the CPU). The world model's losses and
``grad_norm`` stay within 1e-2 relative of JAX's float32 step. The dream's
metrics are left to the float32 tests: one bfloat16 rounding can flip the
argmax of a latent or action sample, and the dream takes another path from
there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydreamer_tpu.training.train_step import TrainStep as JTrainStep
from pydreamer_tpu_torch.models.dreamer import Dreamer
from pydreamer_tpu_torch.training.train_step import TrainStep
from tests.test_torch_port_train_step import _batch, _conf, _jax_noise, paired_models

BF16_RTOL = 1e-2
WM_METRICS = ("loss_model", "loss_kl", "loss_image", "loss_reward", "loss_terminal", "grad_norm")


@pytest.mark.parametrize("gru_type", ["gru_layernorm_dv2", "gru"])
def test_bf16_world_model_step_near_f32_jax(gru_type):
    conf = _conf().replace(gru_type=gru_type)
    jmodel, params, model32 = paired_models(conf)
    bconf = conf.replace(precision="bfloat16")
    model = Dreamer(bconf, device="cpu")
    model.load_state_dict(model32.state_dict())
    obs = _batch(conf)
    key = jax.random.PRNGKey(2)

    jstep = JTrainStep(jmodel, conf, donate=False)
    _, _, _, jmetrics, _, _ = jstep(params, jstep.init_optimizer(params),
                                    {k: jnp.asarray(v) for k, v in obs.items()},
                                    jmodel.init_state(conf.batch_size), 1, np.asarray(key))
    _, tmetrics, _, _ = TrainStep(model, bconf, device="cpu")(
        {k: torch.from_numpy(v) for k, v in obs.items()}, model.init_state(conf.batch_size), 1,
        _jax_noise(conf, key, 1))
    for name in WM_METRICS:
        got, want = tmetrics[name].item(), float(jmetrics[name])
        assert abs(got - want) <= BF16_RTOL * abs(want), (name, got, want)
    assert all(np.isfinite(v.item()) for v in tmetrics.values())
