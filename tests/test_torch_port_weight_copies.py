"""The train step's weight copies (``models/modules.py`` ``WeightCopies``,
``CopyUse``; ``training/train_step.py``), on the CPU at tiny widths.

Inside a ``TrainStep`` update each parameter read in bfloat16 comes from one
copy a step, and each use's gradient is added into the float32 ``.grad`` by
the use's own backward; outside it every use casts its weight itself. The
gradients are held equal (``torch.equal``) between the two, the copies equal
to their masters whenever a forward starts, and float32 makes no copy. The
same check on the card, eager and replayed, is ``chip_smoke.py``'s phase 21.
Port only.
"""

import threading
from pathlib import Path

import pytest
import torch

from pydreamer_tpu_torch.conf import Conf, build_conf
from pydreamer_tpu_torch.models.dreamer import Dreamer
from pydreamer_tpu_torch.models.modules import CopyUse, WeightCopies, cast_param
from pydreamer_tpu_torch.models.noise import GeneratorNoise
from pydreamer_tpu_torch.scripts.flagship import make_batch, make_conf
from pydreamer_tpu_torch.tracing import COUNTERS
from pydreamer_tpu_torch.training.train_step import TrainStep, noise_seed

CONFIG_DIR = str(Path(__file__).resolve().parents[1] / "config")
SEED = 3
# DreamerV3 XL's preset at the widths of tests/test_torch_port_dreamerv3.py.
DV3_TINY = dict(deter_dim=64, stoch_dim=4, stoch_discrete=4, hidden_dim=32, cnn_depth=4,
                mlp_units=32, batch_length=5, batch_size=4, imag_horizon=3, action_dim=5)


def tiny(model: str, gru_type: str, precision: str = "bfloat16") -> Conf:
    if model == "dreamerv3":
        d = build_conf(CONFIG_DIR, ["defaults", "atari", "dreamerv3_xl"])
        d.update(DV3_TINY, gru_type=gru_type, precision=precision)
        return Conf(d)
    return make_conf(tiny=True).replace(gru_type=gru_type, precision=precision)


def trained(conf):
    """A model, its ``TrainStep`` with the clip off (an infinite max norm, so
    ``.grad`` stays what ``backward()`` left) and a batch."""
    torch.manual_seed(0)
    model = Dreamer(conf, device="cpu")
    ts = TrainStep(model, conf, device="cpu")
    ts.clips = {k: float("inf") for k in ts.clips}
    return model, ts, make_batch(conf, device="cpu")


def per_call_grads(model, obs, state, step: int) -> dict:
    """The per-call path: ``training_step`` and ``backward()`` outside a
    ``TrainStep`` update, on the step's own noise."""
    model.zero_grad(set_to_none=True)
    before = COUNTERS.weight_copy_uses
    losses, *_ = model.training_step(obs, state, GeneratorNoise("cpu", seed=noise_seed(SEED, step)))
    sum(losses.values()).backward()
    assert COUNTERS.weight_copy_uses == before  # no copy served outside an update
    return {n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in model.named_parameters() if p.requires_grad}


@pytest.mark.parametrize("model_name", ["dreamer", "dreamerv3"])
@pytest.mark.parametrize("gru_type", ["gru_layernorm_dv2", "gru"])
def test_step_copy_gradients_equal_the_per_call_paths(model_name, gru_type):
    """Step 1 makes the copies, step 2 refreshes them: after each, every
    leaf's gradient equals the per-call path's on the same weights and noise,
    bit for bit."""
    conf = tiny(model_name, gru_type)
    model, ts, obs = trained(conf)
    ref = Dreamer(conf, device="cpu")
    for step in (1, 2):
        ref.load_state_dict(model.state_dict())
        state = model.init_state(conf.batch_size)
        want = per_call_grads(ref, obs, state, step)
        COUNTERS.reset()
        ts(obs, state, step, seed=SEED)
        assert COUNTERS.weight_casts == COUNTERS.weight_copies == len(ts.copies) > 0
        assert COUNTERS.weight_copy_uses > len(ts.copies)
        for name, p in model.named_parameters():
            if p.requires_grad:
                assert torch.equal(p.grad, want[name]), (step, name)


@pytest.mark.parametrize("model_name, event", [("dreamer", "step"),
                                               ("dreamer", "update_critic_target"),
                                               ("dreamerv3", "slow_critic_ema"),
                                               ("dreamer", "load_state_dict")])
def test_copies_equal_their_masters_when_the_forward_starts(monkeypatch, model_name, event):
    conf = tiny(model_name, "gru_layernorm_dv2")
    model, ts, obs = trained(conf)
    state = model.init_state(conf.batch_size)
    ts(obs, state, 1, seed=SEED)
    assert ts.copies.copies
    if event == "update_critic_target":
        with torch.no_grad():
            for p in model.ac.critic.parameters():
                p.add_(1.0)
        model.ac.update_critic_target()
    elif event == "load_state_dict":
        other = Dreamer(conf, device="cpu")
        model.load_state_dict(other.state_dict())
    elif event == "slow_critic_ema":
        assert ts.slow_critic  # each step ends with the EMA, after AdamW
    copies = dict(ts.copies.copies)
    fresh = {p: torch.equal(c, p.detach().to(c.dtype)) for p, c in copies.items()}
    target = [p for p in model.ac.critic_target.parameters() if p in copies]
    assert target  # its Dense layers' (its LayerNorms are read in float32)
    # The event left masters unlike their copies: the targets', or any.
    assert not all(fresh[p] for p in (target if event in ("update_critic_target",
                                                           "slow_critic_ema") else copies))
    training_step = model.training_step
    seen = []

    def checked(*args, **kwargs):
        seen.append(all(torch.equal(c, p.detach().to(c.dtype)) for p, c in copies.items()))
        return training_step(*args, **kwargs)

    monkeypatch.setattr(model, "training_step", checked)
    ts(obs, state, 2, seed=SEED)
    assert seen == [True]


def test_float32_makes_no_copy():
    conf = tiny("dreamer", "gru_layernorm_dv2", precision="float32")
    model, ts, obs = trained(conf)
    COUNTERS.reset()
    state = model.init_state(conf.batch_size)
    for step in (1, 2):
        ts(obs, state, step, seed=SEED)
    assert len(ts.copies) == 0
    assert COUNTERS.weight_casts == COUNTERS.weight_copies == COUNTERS.weight_copy_uses == 0


def test_each_use_adds_its_own_gradient_in_order_and_a_frozen_use_takes_none():
    """Two uses of one weight: two ``CopyUse`` nodes, each adding its bf16
    gradient into the float32 ``.grad`` (not summed in bf16 first), as the
    per-call casts' backward does; a weight that takes no gradient gets the
    copy itself."""
    g = torch.Generator().manual_seed(0)
    w = torch.nn.Parameter(torch.randn(6, 5, generator=g))
    frozen = torch.nn.Parameter(torch.randn(6, 5, generator=g), requires_grad=False)
    x = torch.randn(3, 5, generator=g).bfloat16()

    def loss():
        a = x @ cast_param(w, torch.bfloat16).t()
        b = (x * 3) @ cast_param(w, torch.bfloat16).t()
        return (a.float().square() + b.float().sin()).sum()

    loss().backward()
    want, w.grad = w.grad.clone(), torch.zeros_like(w)
    copies = WeightCopies()
    with copies.serving():
        got = loss()
        assert isinstance(cast_param(frozen, torch.bfloat16).grad_fn, type(None))
        assert type(cast_param(w, torch.bfloat16).grad_fn).__name__ == f"{CopyUse.__name__}Backward"
    got.backward()
    assert torch.equal(w.grad, want)
    assert len(copies) == 2


def test_the_copies_serve_only_the_context_that_opened_them():
    """``serving()`` is a context variable: another thread's casts, made
    meanwhile, are per call."""
    w = torch.nn.Parameter(torch.randn(4, 3))
    seen = {}

    def elsewhere():
        before = COUNTERS.weight_copy_uses
        seen["grad_fn"] = type(cast_param(w, torch.bfloat16).grad_fn).__name__
        seen["uses"] = COUNTERS.weight_copy_uses - before

    copies = WeightCopies()
    with copies.serving():
        thread = threading.Thread(target=elsewhere)
        thread.start()
        thread.join()
        assert type(cast_param(w, torch.bfloat16).grad_fn).__name__ == f"{CopyUse.__name__}Backward"
    assert seen == {"grad_fn": "ToCopyBackward0", "uses": 0}
    assert len(copies) == 1
