"""Per-module parity of the PyTorch port against the JAX package (CPU, float32).

Each test makes its inputs from a numpy seed, initializes the flax module,
carries its params across with ``pydreamer_tpu_torch.convert`` and compares
outputs (and, where the module has one, the straight-through gradient).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from pydreamer_tpu import conf as jconf
from pydreamer_tpu.models import a2c as ja2c
from pydreamer_tpu.models import decoders as jdec
from pydreamer_tpu.models import distributions as jdist
from pydreamer_tpu.models import encoders as jenc
from pydreamer_tpu.models import functions as jfn
from pydreamer_tpu.models import modules as jmod
from pydreamer_tpu.models import rnn as jrnn
from pydreamer_tpu.models import rssm as jrssm
from pydreamer_tpu.models.dreamer import Dreamer as JDreamer
from pydreamer_tpu_torch import conf
from pydreamer_tpu_torch.convert import jax_to_state_dict, state_dict_to_jax
from pydreamer_tpu_torch.models import (a2c, decoders, distributions, encoders, functions,
                                        modules, rnn, rssm)
from pydreamer_tpu_torch.models.dreamer import Dreamer

RTOL = ATOL = 1e-5
CONFIG_DIR = Path(__file__).resolve().parent.parent / "config"


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def _load(module, flax_params):
    module.load_state_dict(jax_to_state_dict(flax_params))
    return module


# -- conf and functions --------------------------------------------------------

@pytest.mark.parametrize("sections", [["defaults"], ["defaults", "atari"], ["defaults", "dmc"]])
def test_conf_matches_jax_loader(sections):
    """The port's own copy of the loader reads config/*.yaml as the JAX one does."""
    want = jconf.build_conf(str(CONFIG_DIR), sections)
    assert conf.build_conf(str(CONFIG_DIR), sections) == want
    argv = ["--configs", *sections, "--gru_type", "gru_layernorm_dv2", "--batch_size", "4"]
    got = conf.parse_args(argv, str(CONFIG_DIR))
    assert got.to_dict() == jconf.parse_args(argv, str(CONFIG_DIR)).to_dict()
    assert (got.gru_type, got.batch_size) == ("gru_layernorm_dv2", 4)


def test_functions():
    """Shape utilities, logavgexp, nanmean and global_norm (rtol/atol 1e-5)."""
    rng = np.random.RandomState(10)
    x = rng.randn(3, 4, 5).astype(np.float32)
    (got, bd), (want, jbd) = functions.flatten_batch(_t(x), 1), jfn.flatten_batch(jnp.asarray(x), 1)
    assert bd == tuple(jbd)
    _close(got, want)
    _close(functions.unflatten_batch(got, bd), jfn.unflatten_batch(want, jbd))
    _close(functions.insert_dim(_t(x), 1, 2), jfn.insert_dim(jnp.asarray(x), 1, 2))
    _close(functions.expand_iwae(_t(x), 3), jfn.expand_iwae(jnp.asarray(x), 3))
    for axis in (1, 2):
        _close(functions.logavgexp(_t(x), axis), jfn.logavgexp(jnp.asarray(x), axis))
    _close(functions.logavgexp(_t(x[:, :1]), 1), jfn.logavgexp(jnp.asarray(x[:, :1]), 1))
    xn = x.copy()
    xn[0, 0] = np.nan
    _close(functions.nanmean(_t(xn)), jfn.nanmean(jnp.asarray(xn)))
    _close(functions.nanmean(_t(np.full(3, np.nan))), jfn.nanmean(jnp.full(3, jnp.nan)))
    _close(functions.global_norm([_t(x), _t(x[0])]), jfn.global_norm([jnp.asarray(x), jnp.asarray(x[0])]))


# -- distributions -----------------------------------------------------------

def test_onehot_categorical():
    """log_prob, entropy, kl_to and rsample_noise (forward and straight-through
    gradient) against the JAX OneHotCategorical (rtol/atol 1e-5)."""
    rng = np.random.RandomState(0)
    lp, lq = rng.randn(2, 3, 4, 6).astype(np.float32)
    gumbel = rng.gumbel(size=(3, 4, 6)).astype(np.float32)
    onehot = np.eye(6, dtype=np.float32)[rng.randint(0, 6, (3, 4))]
    weights = rng.randn(3, 4, 6).astype(np.float32)

    jp, jq = jdist.OneHotCategorical(jnp.asarray(lp), 1), jdist.OneHotCategorical(jnp.asarray(lq), 1)
    tl = _t(lp).requires_grad_()
    tp, tq = distributions.OneHotCategorical(tl, 1), distributions.OneHotCategorical(_t(lq), 1)
    _close(tp.log_prob(_t(onehot)), jp.log_prob(jnp.asarray(onehot)))
    _close(tp.entropy(), jp.entropy())
    _close(tp.kl_to(tq), jp.kl_to(jq))

    sample = tp.rsample_noise(_t(gumbel))
    _close(sample, jp.rsample_noise(jnp.asarray(gumbel)))
    (sample * _t(weights)).sum().backward()
    want = jax.grad(lambda l: jnp.sum(jdist.OneHotCategorical(l, 1).rsample_noise(
        jnp.asarray(gumbel)) * weights))(jnp.asarray(lp))
    _close(tl.grad, want)


def test_diag_normal_and_bernoulli():
    rng = np.random.RandomState(1)
    x, v = rng.randn(4, 10).astype(np.float32), rng.randn(4, 5).astype(np.float32)
    jd, td = jdist.diag_normal(jnp.asarray(x)), distributions.diag_normal(_t(x))
    _close(td.log_prob(_t(v)), jd.log_prob(jnp.asarray(v)))
    _close(td.entropy(), jd.entropy())
    _close(td.kl_to(distributions.diag_normal(_t(x[::-1].copy()))),
           jd.kl_to(jdist.diag_normal(jnp.asarray(x[::-1].copy()))))
    logits, target = rng.randn(7).astype(np.float32), (rng.rand(7) < 0.5).astype(np.float32)
    jb, tb = jdist.Bernoulli(jnp.asarray(logits)), distributions.Bernoulli(_t(logits))
    _close(tb.log_prob(_t(target)), jb.log_prob(jnp.asarray(target)))
    _close(tb.entropy(), jb.entropy())


# -- modules -----------------------------------------------------------------

@pytest.mark.parametrize("out_dim", [1, 5])
def test_mlp(out_dim):
    """MLP (Dense -> LayerNorm eps 1e-3 -> ELU) x 3 -> Dense, squeezed at out_dim 1."""
    x = np.random.RandomState(2).randn(3, 4, 16).astype(np.float32)
    jm = jmod.MLP(out_dim, hidden_dim=32, hidden_layers=3)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = _load(modules.MLP(16, out_dim, hidden_dim=32, hidden_layers=3), params)
    got = tm(_t(x))
    want = jm.apply(params, jnp.asarray(x))
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


@pytest.mark.parametrize("cell_type", ["gru", "gru_layernorm", "gru_layernorm_dv2",
                                       "gru_layernorm_dv2_xla"])
def test_gru_cells(cell_type):
    rng = np.random.RandomState(3)
    x, h = rng.randn(5, 12).astype(np.float32), rng.randn(5, 16).astype(np.float32)
    jc = jrnn.make_gru_cell(cell_type, 16)
    params = jc.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(h))
    tc = _load(rnn.make_gru_cell(cell_type, 12, 16), params)
    _close(tc(_t(x), _t(h)), jc.apply(params, jnp.asarray(x), jnp.asarray(h)))


def test_conv_encoder():
    """4x Conv k4 s2 VALID + ELU; embedding flattened in the JAX (H,W,C) order (1e-4)."""
    x = np.random.RandomState(4).rand(2, 3, 64, 64, 3).astype(np.float32) - 0.5
    je = jenc.ConvEncoder(3, 4)
    params = je.init(jax.random.PRNGKey(2), jnp.asarray(x))
    te = _load(encoders.ConvEncoder(3, 4), params)
    got = te(_t(x))
    assert tuple(got.shape) == (2, 3, 4 * 32)
    _close(got, je.apply(params, jnp.asarray(x)), rtol=1e-4, atol=1e-4)


def test_conv_decoder():
    """Dense -> 4x ConvTranspose (k 5,5,6,6, s2): proves convert.py's spatial
    flip of the transposed-conv kernel against lax.conv_transpose (1e-4)."""
    feats = np.random.RandomState(5).randn(2, 3, 1, 24).astype(np.float32)
    jd = jdec.ConvDecoder(24, 3, 4, transpose_impl="xla")
    params = jd.init(jax.random.PRNGKey(3), jnp.asarray(feats))
    td = _load(decoders.ConvDecoder(24, 3, 4), params)
    got = td(_t(feats))
    assert tuple(got.shape) == (2, 3, 1, 64, 64, 3)
    _close(got, jd.apply(params, jnp.asarray(feats)), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("gru_type", ["gru", "gru_layernorm_dv2"])
def test_rssm_scan(gru_type):
    """T-step posterior loop + batched prior with reset masks: prior, post,
    samples, features and out_state (rtol/atol 1e-4 over the 6-step loop)."""
    T, B, E, A, D, S, K, Hd = 6, 3, 20, 4, 16, 4, 5, 24
    rng = np.random.RandomState(6)
    embed = rng.randn(T, B, E).astype(np.float32)
    action = np.eye(A, dtype=np.float32)[rng.randint(0, A, (T, B))]
    reset = rng.rand(T, B) < 0.3
    reset[0] = True
    h0, z0 = rng.randn(B, D).astype(np.float32), rng.randn(B, S * K).astype(np.float32)
    key = jax.random.PRNGKey(7)
    kw = dict(embed_dim=E, action_dim=A, deter_dim=D, stoch_dim=S, stoch_discrete=K,
              hidden_dim=Hd, gru_type=gru_type)
    jcore = jrssm.RSSMCore(**kw)
    args = (jnp.asarray(embed), jnp.asarray(action), jnp.asarray(reset),
            (jnp.asarray(h0), jnp.asarray(z0)))
    params = jcore.init(jax.random.PRNGKey(8), *args, key, 1, False)
    want = jcore.apply(params, *args, key, 1, False)
    z_noise = jrssm.draw_z_noise(key, (T, B), S, K)

    tcore = _load(rssm.RSSMCore(E, A, D, S, K, Hd, gru_type=gru_type), params)
    got = tcore(_t(embed), _t(action), torch.from_numpy(reset), (_t(h0), _t(z0)), _t(z_noise))
    for i, name in enumerate(["prior", "post", "samples", "features"]):
        _close(got[i], want[i], rtol=1e-4, atol=1e-4, msg=name)
    for g, w, name in zip(got[5], want[5], ["out_h", "out_z"]):
        _close(g, w, rtol=1e-4, atol=1e-4, msg=name)


def test_gae_advantage():
    rng = np.random.RandomState(9)
    adv = rng.randn(6, 4).astype(np.float32)
    term = (rng.rand(6, 4) < 0.2).astype(np.float32)
    got = a2c.gae_advantage(_t(adv), _t(term), 0.97, 0.9)
    for impl in ("scan", "unrolled"):
        _close(got, ja2c.gae_advantage(jnp.asarray(adv), jnp.asarray(term), 0.97, 0.9, impl=impl))


# -- convert.py ----------------------------------------------------------------

@pytest.mark.parametrize("gru_type", ["gru_layernorm_dv2", "gru_layernorm_dv2_xla", "gru"])
def test_convert_round_trip(gru_type):
    """JAX tree -> state_dict -> JAX tree is bit-exact, and the state_dict has
    exactly the port's keys and shapes, for the tiny flagship config."""
    conf = graft._make_conf(tiny=True).replace(gru_type=gru_type)
    params = JDreamer(conf).init(jax.random.PRNGKey(0))
    sd = jax_to_state_dict(params)
    model = Dreamer(conf, device="cpu")
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}
    model.load_state_dict(sd)
    back = state_dict_to_jax(model.state_dict(), params)
    want, got = jax.tree_util.tree_flatten(params), jax.tree_util.tree_flatten(back)
    assert want[1] == got[1]
    for w, g in zip(want[0], got[0]):
        np.testing.assert_array_equal(np.asarray(w), g)
