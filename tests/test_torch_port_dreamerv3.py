"""DreamerV3 (``model: dreamerv3``) in the port, at a tiny width on the CPU.

The port's train step against the benchmark's plain float32 reference
(``benchmark/reference/dreamerv3.py``) from the same seeded weights, batches and
keyed noise over three steps: each loss, each leaf's gradient after the clip,
each leaf's change, the slow critic and the return statistics. Each
tolerance sits between what the port reads (float32 against float32: sums in
another order) and what the reference reads with its products' operands
rounded to bfloat16, which ``test_tolerances_catch_bf16_products`` asserts
fails every one of them. Then the pieces DreamerV3 adds, one by one; the
constants the port and the reference share; the presets; K1's plan at
DreamerV3 XL's shapes; the
capture's cuts at the new spans; and ``trainer.run`` on the normal path with
acting, a checkpoint and a resume.
"""

import hashlib
import importlib.util
import json
import math
import statistics
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pydreamer_tpu_torch import generator as tgen
from pydreamer_tpu_torch.conf import Conf, build_conf, read_yamls
from pydreamer_tpu_torch.envs import create_env
from pydreamer_tpu_torch.models.a2c import ReturnNormalizer, SlowCriticEMA, percentile
from pydreamer_tpu_torch.models.distributions import (OneHotCategorical, TwoHotSymlog, symexp,
                                                      symlog, twohot)
from pydreamer_tpu_torch.models.dreamer import (KL_DYN, KL_FREE, KL_REP, UNIMIX, Dreamer,
                                                free_bits_kl)
from pydreamer_tpu_torch.ops.gru_dv2 import Plan, plan
from pydreamer_tpu_torch.tracking import load_checkpoint_file
from pydreamer_tpu_torch.training import trainer
from pydreamer_tpu_torch.training.train_step import TrainStep

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "benchmark_reference_dreamerv3", ROOT / "benchmark" / "reference" / "dreamerv3.py")
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)
CONFIG_DIR = str(ROOT / "config")
TINY = dict(deter_dim=64, stoch_dim=4, stoch_discrete=4, hidden_dim=32, cnn_depth=4, mlp_units=32,
            batch_length=5, batch_size=4, imag_horizon=3, precision="float32", action_dim=5)
STEPS = 3
SEED = 3

# Tolerances. The port reads (float32 against float32, seeds 3-6): losses
# 3.4e-7, gradients 1.0e-5, the trainable leaves' change 1.8e-3 at the worst
# leaf, the slow critic 1.9e-7, the return statistics 1.1e-8. The reference
# with bfloat16 operands reads at least 8.4e-4, 4.6e-2, 0.17, 4.4e-6 and
# 2.1e-5 on the same seeds.
LOSS_RTOL = 2e-5      # relative to the reference's loss
GRAD_RTOL = 5e-4      # per leaf, of the reference gradient's max-abs
CHANGE_RTOL = 2e-2    # per trainable leaf, of the norm of its change: Adam's first steps move an
                      # element by ~lr whatever its gradient, so rounding in a small gradient shows
SLOW_RTOL = 1e-6      # the slow critic, of its max-abs: its change is 2% of the critic's, so its
                      # rounding is held against its size, not its change
STATS_ATOL = 1e-6     # the return statistics (lo, hi)


def tiny_conf(**over):
    d = build_conf(CONFIG_DIR, ["defaults", "atari", "dreamerv3_xl"])
    d.update(TINY, **over)
    return d


def _key(*parts) -> int:
    return int.from_bytes(hashlib.blake2b("/".join(map(str, parts)).encode(),
                                          digest_size=8).digest(), "little") >> 1


class KeyedNoise:
    """Noise keyed by (seed, step, name, t), so the port and the reference
    draw the same numbers whatever the order of their requests. Each gumbel
    draw carries a margin of 100 on one class, so that no sample flips
    between the two sides' roundings."""

    def __init__(self, seed: int, step: int):
        self.seed, self.step = seed, step

    def draw(self, name, shape, kind, t=None):
        g = torch.Generator().manual_seed(_key(self.seed, self.step, name, t))
        shape = tuple(shape)
        if kind == "normal":
            return torch.randn(shape, generator=g)
        u = torch.rand(shape, generator=g)
        if kind == "uniform":
            return u
        gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))
        pick = torch.randint(0, shape[-1], shape[:-1], generator=g)
        return gumbel + 100.0 * F.one_hot(pick, shape[-1])


def seeded_weights(shapes, seed: int):
    """Uniform draws: matrices and kernels in Xavier's range, vectors in
    +-0.1, LayerNorm scales in 1 +- 0.1; the slow critic a copy of the critic."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in shapes.items():
        if ".critic_target." in name:
            continue
        u = torch.rand(shape, generator=g) * 2 - 1
        if len(shape) <= 1:
            scale = name.endswith("ln_scale") or (name.endswith("weight")
                                                  and ("Norm_" in name or "_norm." in name))
            out[name] = u * 0.1 + (1.0 if scale else 0.0)
        else:
            r = math.prod(shape[2:])
            out[name] = u * math.sqrt(6.0 / (shape[0] * r + shape[1] * r))
    for name in shapes:
        if ".critic_target." in name:
            out[name] = out[name.replace(".critic_target.", ".critic.")].clone()
    return {n: out[n] for n in shapes}


def make_batch(step: int, T=5, B=4, A=5):
    """Step ``step``'s inputs: rewards of both signs, a reset in column 1, a
    terminal in column 2 (a dream start with no continuation)."""
    g = torch.Generator().manual_seed(1000 + step)
    obs = dict(image=torch.randint(0, 256, (T, B, 64, 64, 3), generator=g, dtype=torch.uint8),
               action=F.one_hot(torch.randint(0, A, (T, B), generator=g), A).float(),
               reward=(torch.rand(T, B, generator=g) * 6 - 3)
               * (torch.rand(T, B, generator=g) < 0.5),
               terminal=torch.zeros(T, B), reset=torch.zeros(T, B, dtype=torch.bool))
    obs["reset"][2, 1] = True
    obs["terminal"][3, 2] = 1.0
    return obs


def ref_shapes(conf):
    with torch.device("meta"):
        return {n: tuple(t.shape) for n, t in ref.Model(conf).state_dict().items()}


def cast_bf16(x):
    """x rounded to bfloat16 forward, its gradient as if unrounded."""
    with torch.no_grad():
        rounded = x.detach().to(torch.bfloat16).float()
    return x + (rounded - x).detach()


def run_reference(module, conf, weights, cast=None):
    """Steps 1-3 of a reference module -> per step (losses, grads, params, stats)."""
    model = module.Model(conf, cast or module.identity)
    model.load_state_dict(weights)
    step = module.TrainStep(model, conf)
    state = model.init_state(conf["batch_size"], "cpu")
    out = []
    for s in range(1, STEPS + 1):
        state, readings, grads = step(make_batch(s), state, s, KeyedNoise(9, s))
        out.append((readings, grads, {n: p.detach().clone() for n, p in model.named_parameters()},
                    model.ac.retnorm.stats.clone()))
    return out


def run_port(conf, weights):
    """Steps 1-3 of the port's TrainStep -> as ``run_reference``."""
    model = Dreamer(Conf(conf), device="cpu")
    model.load_state_dict(weights)
    ts = TrainStep(model, Conf(conf), device="cpu")
    state = model.init_state(conf["batch_size"])
    out = []
    for s in range(1, STEPS + 1):
        state, metrics, _, _ = ts(make_batch(s), state, s, noise=KeyedNoise(9, s))
        readings = {k: float(metrics[k]) for k in ("loss_model", "loss_probe", "loss_actor",
                                                   "loss_critic", "loss_image", "loss_reward",
                                                   "loss_terminal")}
        readings["loss_kl"] = (KL_DYN * float(metrics["loss_dyn"])
                               + KL_REP * float(metrics["loss_rep"]))
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
        out.append((readings, grads, {n: p.detach().clone() for n, p in model.named_parameters()},
                    model.ac.retnorm.stats.clone()))
    return out


def gaps(side, want, weights):
    """The worst reading of each check over the steps (the module docstring)."""
    worst = dict(losses=0.0, grads=0.0, change=0.0, slow=0.0, stats=0.0)
    for (la, ga, pa, sa), (lb, gb, pb, sb) in zip(side, want):
        worst["losses"] = max([worst["losses"]] + [abs(la[k] - lb[k]) / abs(lb[k])
                                                   for k in lb if k != "loss_probe"])
        for n in gb:
            scale = gb[n].abs().max().item()
            gap = (ga[n] - gb[n]).abs().max().item()
            worst["grads"] = max(worst["grads"], gap / scale if scale > 0 else gap * 1e30)
        for n in pb:
            if ".critic_target." in n:
                gap = ((pa[n] - pb[n]).abs().max() / pb[n].abs().max()).item()
                worst["slow"] = max(worst["slow"], gap)
            elif (pb[n] - weights[n]).norm() > 0:
                gap = ((pa[n] - pb[n]).norm() / (pb[n] - weights[n]).norm()).item()
                worst["change"] = max(worst["change"], gap)
            else:
                worst["change"] = max(worst["change"], (pa[n] - pb[n]).norm().item() * 1e30)
        worst["stats"] = max(worst["stats"], (sa - sb).abs().max().item())
    return worst


LIMITS = dict(losses=LOSS_RTOL, grads=GRAD_RTOL, change=CHANGE_RTOL, slow=SLOW_RTOL,
              stats=STATS_ATOL)


@pytest.fixture(scope="module")
def reference_run():
    conf = tiny_conf()
    weights = seeded_weights(ref_shapes(conf), SEED)
    return conf, weights, run_reference(ref, conf, weights)


def test_port_follows_the_reference(reference_run):
    """Three steps from the same weights, batches and noise: every reading
    within its tolerance."""
    conf, weights, want = reference_run
    got = gaps(run_port(conf, weights), want, weights)
    assert all(got[k] <= LIMITS[k] for k in LIMITS), got
    # A leaf left out of a step would pass the gaps: every trainable leaf moved.
    moved = [n for n, p in want[-1][2].items() if (p - weights[n]).norm() > 0]
    assert len(moved) >= len(want[0][1]) - 1  # all but the initial state (reset only in column 1)


def test_tolerances_catch_bf16_products(reference_run):
    """The reference with its products' operands rounded to bfloat16 fails
    every tolerance: each is tight enough to see the port's own precision."""
    conf, weights, want = reference_run
    got = gaps(run_reference(ref, conf, weights, cast_bf16), want, weights)
    assert all(got[k] > LIMITS[k] for k in LIMITS), got


def test_the_port_and_the_reference_take_dreamerv3s_published_constants():
    """DreamerV3's constants (no config key sets them): the port's and the
    reference's are the published values, so a change to one side shows."""
    assert (KL_FREE, KL_DYN, KL_REP) == (ref.KL_FREE, ref.KL_DYN, ref.KL_REP) == (1.0, 0.5, 0.1)
    assert UNIMIX == ref.UNIMIX == 0.01
    assert TwoHotSymlog.BINS == ref.BINS == 255
    assert (TwoHotSymlog.LOW, TwoHotSymlog.HIGH) == (ref.BINS_LOW, ref.BINS_HIGH) == (-20.0, 20.0)
    assert ((ReturnNormalizer.DECAY, ReturnNormalizer.LOW, ReturnNormalizer.HIGH)
            == (ref.RETNORM_DECAY, ref.RETNORM_LOW, ref.RETNORM_HIGH) == (0.99, 0.05, 0.95))
    assert SlowCriticEMA.FRACTION == ref.SLOW_FRACTION == 0.02
    model = Dreamer(Conf(tiny_conf()), device="cpu")
    assert model.wm.core.cell.unimix == UNIMIX and model.wm.free_bits
    assert model.ac.twohot_bins == TwoHotSymlog.BINS


def test_port_state_dict_is_the_references():
    conf = tiny_conf()
    model = Dreamer(Conf(conf), device="cpu")
    got = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    assert got == ref_shapes(conf)


# -- the pieces DreamerV3 adds ---------------------------------------------------

def test_twohot_encodes_between_two_bins_and_at_the_ends():
    bins = TwoHotSymlog.make_bins(255)
    step = 40.0 / 254
    x = torch.tensor([-25.0, -20.0, -20.0 + 0.25 * step, -1e-3, bins[127].item(), 0.3,
                      bins[200].item(), 20.0 - 0.5 * step, 20.0, 31.0])
    w = twohot(x, bins)
    assert torch.allclose(w.sum(-1), torch.ones(len(x)))
    assert (w > 0).sum(-1).tolist() == [1, 1, 2, 2, 1, 2, 1, 2, 1, 1]
    assert w[0, 0] == 1 and w[1, 0] == 1 and w[-2, -1] == 1 and w[-1, -1] == 1
    assert torch.allclose(w[2, :2], torch.tensor([0.75, 0.25]), atol=1e-5)
    assert torch.allclose(w[7, -2:], torch.tensor([0.5, 0.5]), atol=1e-5)
    assert w[4, 127] == 1 and w[6, 200] == 1
    # Inside the range the weights interpolate x exactly: sum(w * bins) = x.
    inside = torch.linspace(-19.99, 19.99, 301)
    assert torch.allclose((twohot(inside, bins) * bins).sum(-1), inside, atol=2e-5)
    # The reference's encoding (by the fractional position, which float32
    # holds to ~1e-5 of a bin at the top) agrees.
    both = torch.cat([x, inside])
    assert torch.allclose(twohot(both, bins), ref.twohot(both, 255), atol=1e-4)


def test_twohot_decodes_the_symlog_mean():
    bins = TwoHotSymlog.make_bins(255)
    r = torch.tensor([-3e8, -1000.0, -2.5, -1e-3, 0.0, 0.7, 42.0, 4e8])
    logits = torch.log(twohot(symlog(r), bins).clamp(min=1e-30))
    dist = TwoHotSymlog(logits, bins)
    far = symexp(torch.tensor(20.0))
    want = torch.where(r.abs() > far, r.sign() * far, r)
    assert torch.allclose(dist.mean, want, rtol=1e-4)
    assert torch.allclose(symexp(symlog(r)), r, rtol=1e-5)
    # log_prob is the cross-entropy against the target's two-hot: highest at the encoded value.
    inner = r[1:-1]  # +-5 moves the outer two by less than float32 resolves
    assert torch.all(dist.log_prob(r)[1:-1] > TwoHotSymlog(logits[1:-1], bins).log_prob(inner + 5))
    assert torch.allclose(dist.log_prob(r), ref.twohot_log_prob(logits, r), atol=1e-4)


def test_percentile_matches_numpy():
    g = torch.Generator().manual_seed(0)
    for n in (1, 2, 7, 240):
        x = torch.randn(n, generator=g) * 3
        for q in (0.0, 0.05, 0.5, 0.95, 1.0):
            assert math.isclose(percentile(x, q).item(), np.percentile(x.numpy(), 100 * q),
                                rel_tol=1e-6, abs_tol=1e-6)


def test_return_statistics_are_an_ema_of_the_percentiles_across_steps():
    norm = ReturnNormalizer()
    assert norm.stats.tolist() == [0.0, 0.0] and norm.scale().item() == 1.0
    g = torch.Generator().manual_seed(1)
    lo = hi = 0.0
    for _ in range(4):
        ret = torch.randn(15, 32, generator=g) * 40 + 5
        norm.update(ret)
        lo = 0.99 * lo + 0.01 * np.percentile(ret.numpy(), 5)
        hi = 0.99 * hi + 0.01 * np.percentile(ret.numpy(), 95)
        assert np.allclose(norm.stats.numpy(), [lo, hi], rtol=1e-5)
    assert math.isclose(norm.scale().item(), max(1.0, hi - lo), rel_tol=1e-5)
    assert "retnorm.stats" in dict(torch.nn.ModuleDict({"retnorm": norm}).state_dict())


def test_free_bits_clip_each_side_and_stop_its_gradient():
    conf = Conf(tiny_conf())
    model = Dreamer(conf, device="cpu")
    zdistr = model.wm.core.zdistr
    g = torch.Generator().manual_seed(2)
    prior = torch.randn(3, 16, generator=g, requires_grad=True)
    for post, above in ((prior.detach().clone().requires_grad_(), False),
                        ((torch.randn(3, 16, generator=g) * 6).requires_grad_(), True)):
        loss, dyn, rep = free_bits_kl(zdistr, post, prior)
        kl = zdistr(post).kl_to(zdistr(prior)).detach()
        assert torch.allclose(dyn, kl.clamp(min=1.0)) and torch.allclose(rep, kl.clamp(min=1.0))
        assert torch.all((kl > 1.0) == above)
        prior.grad = None
        loss.sum().backward()
        if above:  # dyn trains the prior, rep the posterior
            assert prior.grad.abs().sum() > 0 and post.grad.abs().sum() > 0
        else:      # below the free nats neither side takes a gradient
            assert prior.grad.abs().sum() == 0 and post.grad.abs().sum() == 0
            assert torch.allclose(loss, torch.full_like(loss, 0.6))


def test_unimix_mixes_one_percent_uniform():
    g = torch.Generator().manual_seed(3)
    logits = torch.randn(6, 32, generator=g) * 20
    dist = OneHotCategorical(logits, unimix=0.01)
    want = 0.99 * torch.softmax(logits, -1) + 0.01 / 32
    assert torch.allclose(dist.probs, want, rtol=1e-5)
    assert dist.probs.min() >= 0.01 / 32 * 0.999
    assert torch.equal(OneHotCategorical(logits).logits,
                       logits - torch.logsumexp(logits, -1, keepdim=True))
    conf = Conf(tiny_conf())
    model = Dreamer(conf, device="cpu")
    latents = model.wm.core.zdistr(torch.randn(2, 16, generator=g) * 50)
    assert latents.probs.min() >= 0.01 / 4 * 0.999
    actor = model.ac.forward_actor(torch.randn(2, model.features_dim, generator=g))
    assert torch.allclose(actor.probs.sum(-1), torch.ones(2))
    assert actor.probs.min() >= 0.01 / conf.action_dim * 0.999


def test_learned_initial_state_at_resets():
    """A reset replaces the carried state by (tanh(w0), the prior's mode) and
    zeroes the action; w0 takes a gradient only through a reset."""
    conf = Conf(tiny_conf())
    torch.manual_seed(0)
    model = Dreamer(conf, device="cpu")
    cell = model.wm.core.cell
    with torch.no_grad():
        cell.initial.copy_(torch.linspace(-2, 2, conf.deter_dim))
    h0, z0 = model.init_state(3)
    assert torch.allclose(h0, torch.tanh(cell.initial).expand(3, -1))
    assert torch.equal(z0.reshape(3, 4, 4).sum(-1), torch.ones(3, 4))
    logits = cell.zdistr(cell._prior_stats(h0[:1])).logits
    assert torch.equal(z0[0].reshape(4, 4).argmax(-1), logits[0].argmax(-1))

    B, D = 3, conf.deter_dim
    carried = (torch.randn(B, D), F.one_hot(torch.randint(0, 4, (B, 4)), 4).float().reshape(B, -1))
    action = torch.eye(conf.action_dim)[:B]
    keep = torch.tensor([[1.0], [0.0], [1.0]])
    initial = cell.initial_state(1)
    h_reset = cell._gru_step(action, carried, keep, initial)
    by_hand = cell._gru_step(action * keep, (carried[0] * keep + initial[0] * (1 - keep),
                                             carried[1] * keep + initial[1] * (1 - keep)), None)
    assert torch.allclose(h_reset, by_hand)
    fresh = cell._gru_step(torch.zeros(1, conf.action_dim), initial, None)
    assert torch.allclose(h_reset[1:2], fresh, atol=1e-6)
    h_reset.sum().backward()
    assert cell.initial.grad.abs().sum() > 0
    cell.initial.grad = None
    cell._gru_step(action, carried, torch.ones(B, 1), cell.initial_state(1)).sum().backward()
    assert cell.initial.grad is None or cell.initial.grad.abs().sum() == 0


def test_slow_critic_takes_the_ema_after_each_update():
    conf = Conf(tiny_conf())
    torch.manual_seed(0)
    model = Dreamer(conf, device="cpu")
    ts = TrainStep(model, conf, device="cpu")
    assert ts.target_interval == 0 and ts.slow_critic
    for a, b in zip(model.ac.critic_target.parameters(), model.ac.critic.parameters()):
        assert torch.equal(a, b)
    state = model.init_state(conf.batch_size)
    for s in (1, 2):
        before = [p.detach().clone() for p in model.ac.critic_target.parameters()]
        state, *_ = ts(make_batch(s), state, s, noise=KeyedNoise(1, s))
        for old, slow, online in zip(before, model.ac.critic_target.parameters(),
                                     model.ac.critic.parameters()):
            assert torch.allclose(slow, 0.98 * old + 0.02 * online, atol=1e-7)
            assert not slow.requires_grad
    assert SlowCriticEMA.FRACTION == 0.02


def test_adam_eps_and_clip_per_group():
    conf = Conf(tiny_conf())
    model = Dreamer(conf, device="cpu")
    ts = TrainStep(model, conf, device="cpu")
    eps = {g["name"]: g["eps"] for g in ts.optimizer.param_groups}
    assert eps == {"wm": 1e-8, "probe": 1e-8, "actor": 1e-5, "critic": 1e-5}
    assert ts.clips == {"wm": 1000, "probe": 1000, "actor": 100, "critic": 100}
    dv2 = Conf(build_conf(CONFIG_DIR, ["defaults", "atari"]) | TINY)
    ts2 = TrainStep(Dreamer(dv2, device="cpu"), dv2, device="cpu")
    assert {g["eps"] for g in ts2.optimizer.param_groups} == {1e-5}
    assert ts2.target_interval == 100 and not ts2.slow_critic


# -- the presets ------------------------------------------------------------------

# sha256 of json.dumps(build_conf(["defaults", section]), sort_keys=True) before
# DreamerV3's keys were declared in `defaults`, its first 16 hex digits.
PRESET_DIGESTS = {
    "defaults": "f1aad62377d7292a", "atari": "3e80ae11fab5e4ec", "atari_pong": "9a23b5d98da09b57",
    "atari_breakout": "895d73acc5d29ff5", "atari_montezuma": "4e2943262c1a9610",
    "atari_spaceinvaders": "ef2912a3d1a4ba21", "minigrid": "557806a369efc9e5",
    "miniworld": "12b37613a0e5c8de", "miniworld_offline": "eef7bb2c840a12f2",
    "dmc": "967f50742ca1d2b3", "dmlab": "e938a96fed66dded", "dmmemory": "0d0f59b63a05bdf9",
    "dmlab_offline": "682af880e79b12eb", "memmaze": "9776fe5aa9ea1db2",
    "procgen": "95afed7f0a428931", "vectorenv": "f20faf5044130166",
    "minecraft": "63ba302d13f3546e", "gridworld": "50ee45d8f74fb0a9", "debug": "e604dc82a37a24c2",
    "dmc_quadruped_run": "8df756b81a052e35", "dmc_walker_run": "a0fd855bf0788b25",
    "dmc_manipulator_bring_peg": "05c2d55316077ee5",
    "dmlab_rooms_select_nonmatching_object": "5459ec658f2d970a", "minerl": "90273b422231ecc3",
}
NEW_KEYS = ("mlp_units", "actor_critic_layers", "adam_eps_ac")


def test_every_existing_preset_builds_the_same_dict_as_before():
    sections = read_yamls(CONFIG_DIR)
    assert set(sections) == set(PRESET_DIGESTS) | {"dreamerv3_xl"}
    for name, digest in PRESET_DIGESTS.items():
        d = build_conf(CONFIG_DIR, ["defaults"] if name == "defaults" else ["defaults", name])
        assert set(NEW_KEYS) <= set(d)
        old = {k: v for k, v in d.items() if k not in NEW_KEYS}
        text = json.dumps(old, sort_keys=True, default=str).encode()
        assert hashlib.sha256(text).hexdigest()[:16] == digest, name


def test_dreamerv3_xl_preset_has_the_published_widths():
    c = build_conf(CONFIG_DIR, ["defaults", "atari", "dreamerv3_xl"])
    assert (c["model"], c["deter_dim"], c["hidden_dim"], c["cnn_depth"],
            c["mlp_units"]) == ("dreamerv3", 4096, 1024, 96, 1024)
    assert (c["reward_decoder_layers"], c["terminal_decoder_layers"],
            c["actor_critic_layers"]) == (5, 5, 5)
    assert (c["batch_size"], c["batch_length"], c["imag_horizon"]) == (16, 64, 15)
    assert c["gru_type"] == "gru_layernorm_dv2" and c["clip_rewards"] is None
    assert math.isclose(c["gamma"], 1 - 1 / 333, rel_tol=1e-12)
    bench = json.loads((ROOT / "benchmark" / "configs" / "atari_dv3_xl.json").read_text())
    assert {k: c[k] for k in bench["conf"] if k not in ("probe_model",)} == \
        {k: v for k, v in bench["conf"].items() if k != "probe_model"}


# -- K1 at DreamerV3 XL's shapes ------------------------------------------------------

def test_k1_plan_at_dreamerv3_xl_shapes():
    """In=1024, H=4096: the posterior loop (M=16) streams the weights in ten
    K slices of 512 rows; the dream (M=1024) takes the wide schedule with the
    LayerNorm/gate pass (H/128 = 32 blocks, past a cluster's 8) and its f32
    workspace of 50 MB; float32 takes the 3xTF32 schedules."""
    bf16, f32 = torch.bfloat16, torch.float32
    gates = 3 * 4096
    assert plan(16, 1024, 4096, bf16, bf16, bf16, bf16) == Plan("skinny", 10, 512, 10 * 16 * gates)
    assert plan(1024, 1024, 4096, bf16, bf16, bf16, bf16) == Plan("wide", workspace=1024 * gates)
    assert plan(16, 1024, 4096, f32, f32, f32, f32).schedule == "skinny_f32"
    assert plan(1024, 1024, 4096, f32, f32, f32, f32).schedule == "wide_f32"
    assert plan(1, 1024, 4096, bf16, bf16, bf16, bf16).schedule == "skinny"  # acting


# -- the spans and the capture ------------------------------------------------------------

def test_capture_cuts_at_the_twohot_and_retnorm_spans():
    """A capture of the DreamerV3 step (the fake backend of
    ``test_torch_port_step_graph``) cuts segments inside ``pd.heads``,
    ``pd.dream`` and ``pd.actor_critic`` for ``pd.twohot`` and
    ``pd.actor_critic`` for ``pd.retnorm``; DreamerV2's capture has none."""
    from tests.test_torch_port_step_graph import FakeGraphs
    from pydreamer_tpu_torch.training.train_step import StepGraphs

    tags = {}
    for label, conf in (("v3", Conf(tiny_conf())),
                        ("v2", Conf(build_conf(CONFIG_DIR, ["defaults", "atari"]) | TINY))):
        torch.manual_seed(0)
        model = Dreamer(conf, device="cpu")
        ts = TrainStep(model, conf, device="cpu")
        ts.graphs = StepGraphs(FakeGraphs())
        state = model.init_state(conf.batch_size)
        for step in (1, 2):
            state, metrics, _, _ = ts(make_batch(step), state, step, seed=4)
        (captured,) = ts.graphs.captured.values()
        tags[label] = [t for t, _ in captured.segments]
    new = [t for t in tags["v3"] if t and t[-1] in ("pd.twohot", "pd.retnorm")]
    assert sorted(set(new)) == [("pd.actor_critic", "pd.retnorm"), ("pd.actor_critic", "pd.twohot"),
                                ("pd.dream", "pd.twohot"), ("pd.heads", "pd.twohot")]
    assert new.count(("pd.actor_critic", "pd.twohot")) == 2
    assert not any(t and t[-1] in ("pd.twohot", "pd.retnorm") for t in tags["v2"])
    assert len(tags["v3"]) - len(tags["v2"]) == 2 * len(new)


def test_profiled_step_nests_the_new_spans():
    from torch.profiler import ProfilerActivity, profile

    conf = Conf(tiny_conf())
    torch.manual_seed(0)
    model = Dreamer(conf, device="cpu")
    ts = TrainStep(model, conf, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ts(make_batch(1), model.init_state(conf.batch_size), 1, seed=2)
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events() if e.name().startswith("pd.")]
    names = [n for n, *_ in spans]
    assert names.count("pd.retnorm") == 1 and names.count("pd.twohot") == 4

    def inside(name):
        return {p for p, s, e in spans for n, a, b in spans
                if n == name and p != name and s <= a and b <= e and p != "pd.train_step"}
    assert inside("pd.retnorm") == {"pd.actor_critic"}
    assert inside("pd.twohot") == {"pd.heads", "pd.dream", "pd.actor_critic"}


# -- the normal path, end to end -------------------------------------------------------------

def test_trainer_run_acts_saves_and_resumes(tmp_path):
    """``--configs defaults gridworld dreamerv3_xl debug`` at a tiny width:
    episodes from the random policy, two ``trainer.run`` steps through
    ``make_model`` (a DreamerV3), a checkpoint, the network policy acting
    from it on the env, and a resume to step 4."""
    run_dir = tmp_path / "run"
    tgen.main(env_id="Grid-4x64", save_uri=str(run_dir / "episodes" / "0"), worker_id=0,
              policy_main="random", num_steps=150, env_time_limit=20, steps_per_npz=50,
              log_metrics=False, device="cpu")
    d = build_conf(CONFIG_DIR, ["defaults", "gridworld", "dreamerv3_xl", "debug"])
    d.update(env_id="Grid-4x64", action_dim=4, env_time_limit=20, deter_dim=32, hidden_dim=32,
             stoch_dim=4, stoch_discrete=4, cnn_depth=4, mlp_units=16, actor_critic_layers=2,
             reward_decoder_layers=2, terminal_decoder_layers=2, batch_length=8, batch_size=2,
             imag_horizon=3, n_steps=2, log_interval=1, save_interval=2, eval_interval=0,
             generator_prefill_steps=100, generator_workers=1, data_workers=0,
             test_batches=2, test_batch_size=2)
    conf = Conf(d)
    assert conf.model == "dreamerv3" and conf.platform == "cpu"
    assert type(trainer.make_model(conf, "cpu")).__name__ == "Dreamer"
    trainer.run(conf, run_dir=str(run_dir), device="cpu")
    saved, step = load_checkpoint_file(run_dir / "checkpoints" / "latest.ckpt", "cpu")
    assert step == 2 and "wm.core.cell.initial" in saved["model"]
    assert "ac.retnorm.stats" in saved["model"]

    env = create_env("Grid-4x64", False, 20, 1, 0)
    policy = tgen.create_policy("network", env, conf, device="cpu")
    policy.set_params(saved["model"])
    obs = env.reset()
    for _ in range(5):
        action, metrics = policy(obs)
        assert action.shape == (4,) and action.sum() == 1
        assert all(np.isfinite(v) for v in metrics.values())
        obs, _, done, _ = env.step(action)
        if done:
            obs = env.reset()

    trainer.run(conf.replace(n_steps=4), run_dir=str(run_dir), device="cpu")
    resumed, step = load_checkpoint_file(run_dir / "checkpoints" / "latest.ckpt", "cpu")
    assert step == 4
    assert not torch.equal(resumed["model"]["ac.retnorm.stats"], saved["model"]["ac.retnorm.stats"])
