"""Kernel K1's schedule picker and its float32 path, on the CPU.

The picker (``ops/gru_dv2.py::plan``) is plain Python and decides, from
(M, In, H, dtype) alone, which hand-written schedule a CUDA launch takes; the
schedules themselves run only on the card (chip_smoke.py phase 2 holds each
against the plain version there). The float32 tests show that the fused cell
under ``precision: float32`` gives what the JAX package gives: on the CPU it
runs K1's plain version, on the card ``skinny_f32`` / ``wide_f32`` (or
``f32`` at shapes those two do not take).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from pydreamer_tpu.models.dreamer import Dreamer as JDreamer
from pydreamer_tpu.ops.gru_pallas import NormGRUCellLateResetPallas
from pydreamer_tpu_torch.convert import jax_to_state_dict
from pydreamer_tpu_torch.models import rnn
from pydreamer_tpu_torch.models.dreamer import Dreamer
from pydreamer_tpu_torch.models.noise import ReplayNoise
from pydreamer_tpu_torch.ops import gru_dv2 as k1

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("M,In,H,dtype,want", [
    (32, 1000, 1024, BF16, "skinny"),    # flagship posterior scan (B=32)
    (1536, 1000, 1024, BF16, "wide"),    # flagship dream scan (T*B=1536)
    (32, 1000, 2048, BF16, "skinny"),    # the `defaults` width
    (1536, 1000, 2048, BF16, "wide"),
    (64, 1000, 1024, BF16, "skinny"),
    (65, 1000, 1024, BF16, "wide"),
    (5, 37, 50, BF16, "generic"),        # ragged: In % 8, H % 64
    (70, 129, 67, BF16, "generic"),
    (1, 8, 16, BF16, "generic"),
    (1536, 1000, 1088, BF16, "generic"),  # H % 128 != 0 for the wide tile
    (32, 1000, 1024, F32, "skinny_f32"),   # flagship in float32 (phases 2 and 14)
    (1536, 1000, 1024, F32, "wide_f32"),
    (5, 37, 50, F32, "f32"),               # ragged: In % 4, H % 4
    (16, 1000, 1024, F32, "skinny_f32"),   # a data rank of 2 (phase 14b)
    (768, 1000, 1024, F32, "wide_f32"),
    (32, 1000, 2048, F32, "skinny_f32"),   # the `defaults` width
    (1536, 1000, 2048, F32, "wide_f32"),
    (16, 32, 32, F32, "skinny_f32"),       # bandit canary: posterior, dream, acting
    (128, 32, 32, F32, "wide_f32"),
    (1, 32, 32, F32, "skinny_f32"),
    (8, 64, 64, F32, "skinny_f32"),        # GridWorld canaries
    (80, 64, 64, F32, "wide_f32"),
    (16, 64, 64, F32, "skinny_f32"),       # point canary
    (256, 64, 64, F32, "wide_f32"),
    (1, 64, 64, F32, "skinny_f32"),
    (64, 1000, 1024, F32, "skinny_f32"),
    (65, 1000, 1024, F32, "wide_f32"),
    (70, 129, 67, F32, "f32"),
    (32, 1002, 1024, F32, "f32"),
    (1536, 1000, 1022, F32, "f32"),
])
def test_pick_schedule(M, In, H, dtype, want):
    assert k1.pick_schedule(M, In, H, dtype, dtype, dtype, dtype) == want
    assert k1.plan(M, In, H, dtype).schedule == want


@pytest.mark.parametrize("dtypes", [(BF16, F32, BF16, BF16), (F32, F32, BF16, F32),
                                    (torch.float16,) * 4])
def test_pick_schedule_refuses_mixed_or_other_dtypes(dtypes):
    with pytest.raises(TypeError):
        k1.pick_schedule(32, 1000, 1024, *dtypes)


@pytest.mark.parametrize("In,H", [(1000, 1024), (1000, 2048), (8, 64), (504, 64),
                                  (1024, 4096), (4096, 4096), (2040, 2048)])
def test_skinny_split_covers_k(In, H):
    """The K split: blocks of kc rows (a multiple of 64, at most 512), none
    empty, together covering K = In + H; the workspace holds every split."""
    p = k1.plan(32, In, H, BF16)
    K = In + H
    assert p.kc % 64 == 0 and 0 < p.kc <= k1.SKINNY_MAX_KC
    assert p.nsplit * p.kc >= K > (p.nsplit - 1) * p.kc
    assert p.workspace == p.nsplit * 32 * 3 * H


@pytest.mark.parametrize("M,In,H,nsplit,kc", [
    (32, 1000, 1024, 8, 256), (16, 1000, 1024, 8, 256), (32, 1000, 2048, 12, 256),
    (16, 32, 32, 1, 64), (1, 32, 32, 1, 64), (8, 64, 64, 1, 128), (16, 64, 64, 1, 128),
    (1, 64, 64, 1, 128), (64, 1000, 1024, 8, 256), (33, 36, 20, 1, 64), (3, 4, 4, 1, 32),
])
def test_skinny_f32_plans(M, In, H, nsplit, kc):
    """skinny_f32's K split: blocks of kc rows (one or more 32-row ring stages,
    at most 256), none empty, covering K = In + H; one partial gate row set
    per split in the workspace."""
    p = k1.plan(M, In, H, F32)
    K = In + H
    assert (p.schedule, p.nsplit, p.kc) == ("skinny_f32", nsplit, kc)
    assert p.kc % 32 == 0 and 0 < p.kc <= k1.SKINNY_F32_MAX_KC
    assert p.nsplit * p.kc >= K > (p.nsplit - 1) * p.kc
    assert p.workspace == nsplit * M * 3 * H


@pytest.mark.parametrize("M,In,H,schedule", [
    (1536, 1000, 1024, "wide_f32"), (768, 1000, 1024, "wide_f32"),
    (1536, 1000, 2048, "wide_f32"), (128, 32, 32, "wide_f32"), (80, 64, 64, "wide_f32"),
    (256, 64, 64, "wide_f32"), (5, 37, 50, "f32"), (70, 129, 67, "f32"),
])
def test_unsplit_f32_plans(M, In, H, schedule):
    """wide_f32 and f32 run the whole K in one block: no split, the f32 gates
    (M x 3H) in the workspace for the LayerNorm/gate pass."""
    assert k1.plan(M, In, H, F32) == k1.Plan(schedule, 1, 0, M * 3 * H)


def test_flagship_plans():
    """The flagship launches: the skinny grid fills the H100's 132 SMs, its
    partial gates stay under 2 MB, and the wide schedule keeps the gates on
    chip (one cluster of 8 blocks per row tile, no workspace)."""
    p = k1.plan(32, 1000, 1024, BF16)
    assert (p.nsplit, p.kc) == (4, 512)
    assert 3 * 1024 // 64 * p.nsplit >= 132
    assert p.workspace * 4 <= 2 * 1024 * 1024
    assert k1.plan(1536, 1000, 1024, BF16).workspace == 0
    assert 1024 // k1.WIDE_HB == k1.WIDE_MAX_CLUSTER
    assert k1.plan(1536, 1000, 2048, BF16).workspace == 1536 * 3 * 2048
    # float32: skinny_f32's grid (48 column blocks x 8 splits) is 384 blocks,
    # three to each of the 132 SMs; its partial gates stay under 4 MB.
    p = k1.plan(32, 1000, 1024, F32)
    assert 3 * 1024 // 64 * p.nsplit == 384 and p.workspace * 4 <= 4 * 1024 * 1024


def test_launch_counter_by_schedule():
    counter = type(k1.LAUNCHES)()
    for rows, sched in [(32, "skinny"), (32, "skinny"), (1536, "wide"), (5, "generic")]:
        counter.add(rows, sched)
    assert counter.count == 4
    assert counter.by_rows == {32: 2, 1536: 1, 5: 1}
    assert counter.by_schedule == {"skinny": 2, "wide": 1, "generic": 1}
    counter.reset()
    assert (counter.count, counter.by_rows, counter.by_schedule) == (0, {}, {})


@pytest.mark.parametrize("M,In,H", [(5, 12, 16), (8, 40, 64)])
def test_f32_cell_matches_jax(M, In, H):
    """NormGRUCellLateResetFused in float32 == the JAX Pallas cell in float32
    (rtol/atol 1e-5, as tests/test_torch_port_modules.py)."""
    rng = np.random.RandomState(M + In)
    x, h = rng.randn(M, In).astype(np.float32), rng.randn(M, H).astype(np.float32)
    jcell = NormGRUCellLateResetPallas(H, dtype=jnp.float32)
    params = jcell.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(h))
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1 * jax.random.normal(jax.random.PRNGKey(4), p.shape), params)
    want = jcell.apply(params, jnp.asarray(x), jnp.asarray(h))
    cell = rnn.make_gru_cell("gru_layernorm_dv2", In, H, dtype=F32)
    cell.load_state_dict(jax_to_state_dict(params))
    got = cell(torch.from_numpy(x), torch.from_numpy(h))
    assert got.dtype == F32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _replay(conf, key):
    """The noise JAX's Dreamer.training_step draws from ``key`` (dream_rng threefry)."""
    T, B, H = conf.batch_length, conf.batch_size, conf.imag_horizon
    S, K, A, M = conf.stoch_dim, conf.stoch_discrete, conf.action_dim, T * B
    k_wm, k_dream, _ = jax.random.split(key, 3)
    k_rssm, _ = jax.random.split(k_wm)
    actions, zs = [], []
    for k in jax.random.split(k_dream, H):
        k_act, k_prior = jax.random.split(k)
        actions.append(jax.random.gumbel(k_act, (M, A), jnp.float32))
        zs.append(jax.random.gumbel(k_prior, (M, S, K), jnp.float32))
    return ReplayNoise(dict(posterior_z=jax.random.gumbel(k_rssm, (T, B, S, K), jnp.float32),
                            dream_action=np.stack(actions), dream_z=np.stack(zs)))


def test_f32_training_step_matches_jax():
    """Dreamer.training_step with gru_layernorm_dv2 under precision: float32
    (the tiny config) gives JAX's four losses within 1e-4 relative."""
    conf = graft._make_conf(tiny=True).replace(gru_type="gru_layernorm_dv2",
                                                dream_rng="threefry", precision="float32")
    T, B, A = conf.batch_length, conf.batch_size, conf.action_dim
    rng = np.random.RandomState(7)
    obs = dict(action=np.eye(A, dtype=np.float32)[rng.randint(0, A, (T, B))],
               reward=rng.rand(T, B).astype(np.float32),
               terminal=np.zeros((T, B), np.float32),
               reset=np.zeros((T, B), bool),
               image=rng.randint(0, 256, (T, B, conf.image_size, conf.image_size,
                                          conf.image_channels)).astype(np.uint8))
    obs["reset"][0] = True
    jmodel = JDreamer(conf)
    params = jmodel.init(jax.random.PRNGKey(5))
    key = jax.random.PRNGKey(6)
    want, *_ = jmodel.training_step(params, {k: jnp.asarray(v) for k, v in obs.items()},
                                    jmodel.init_state(B), key)
    model = Dreamer(conf, device="cpu")
    model.load_state_dict(jax_to_state_dict(params))
    with torch.no_grad():
        got, *_ = model.training_step({k: torch.from_numpy(v) for k, v in obs.items()},
                                      model.init_state(B), _replay(conf, key))
    assert set(want) == set(got)
    for name in want:
        np.testing.assert_allclose(got[name].item(), float(want[name]), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_aligned_copies_only_misaligned_views():
    """TMA and 16-byte cp.async need operands that start on 16 bytes; a view
    that does not is copied, anything else is passed as it is."""
    base = torch.arange(40, dtype=torch.float32).to(BF16)
    assert k1._aligned(base) is base
    view = base[1:33]
    assert view.data_ptr() % 16 != 0
    got = k1._aligned(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)


def test_rssm_init_state_needs_a_device():
    """The zero state has no default device: made on the CPU by default, it
    would send the model's next step there without a word."""
    from pydreamer_tpu_torch.models import rssm
    with pytest.raises(TypeError):
        rssm.init_state(2, 8, 4, 3)
    h, z = rssm.init_state(2, 8, 4, 3, device="cpu")
    assert (tuple(h.shape), tuple(z.shape)) == ((2, 8), (2, 12))
    assert not h.any() and not z.any()
