"""The port's ``parallel/`` against the JAX package's (``tests/test_parallel.py``
holds JAX's own): the rank layout of the mesh, the sharding rule, the
per-rank batch and noise, the column-parallel modules, and two ``TrainStep``
steps on gloo ranks against JAX's ``TrainStep`` run through its
``DistributedContext`` on a mesh of the conftest's virtual CPU devices.

The ranks are worker processes (``test_torch_port_parallel_worker.py``) that
import no JAX: this process computes JAX's side, writes the weights, the
batch and JAX's global noise as ``.npz``, spawns the ranks and compares what
they write back. Every rank has a time limit, so a hung collective fails the
test.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pydreamer_tpu.models.baselines import WorldModelProbe as JWorldModelProbe
from pydreamer_tpu.models.dreamer import Dreamer as JDreamer
from pydreamer_tpu.parallel import DistributedContext as JDistributedContext
from pydreamer_tpu.parallel import make_mesh as jmake_mesh
from pydreamer_tpu.parallel import param_shardings as jparam_shardings
from pydreamer_tpu.training.train_step import TrainStep as JTrainStep
from pydreamer_tpu_torch.convert import jax_leaf_shapes, state_dict_to_jax, torch_key
from pydreamer_tpu_torch.models.baselines import WorldModelProbe
from pydreamer_tpu_torch.models.dreamer import Dreamer
from pydreamer_tpu_torch.models.noise import DataShardNoise, ReplayNoise
from pydreamer_tpu_torch.parallel import param_shardings
from pydreamer_tpu_torch.parallel.mesh import Mesh, mesh_shape
from pydreamer_tpu_torch.parallel.multihost import local_batch_size
from tests.test_baselines import baseline_conf
from tests.test_torch_port_train_step import (LOSS_RTOL, PARAM_ATOL, PARAM_RTOL, _batch, _close,
                                              _conf, _jax_noise, paired_models)

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "test_torch_port_parallel_worker.py"
RANK_TIMEOUT_S = 180


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(mode, in_dir, out_dir, world, timeout=RANK_TIMEOUT_S):
    """Run ``world`` worker ranks (gloo on the CPU) to their end; each must
    exit 0 within ``timeout`` seconds. Returns their outputs."""
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r),
                   PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        env.pop("PYDREAMER_RUN_DIR", None)
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), mode, str(in_dir), str(out_dir)], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline, outs = time.time() + timeout, []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.time(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-6000:]}"
    return outs


# -- the mesh ------------------------------------------------------------------

@pytest.mark.parametrize("n_data,n_model,world,want", [
    (0, 1, 4, (4, 1)), (0, 2, 4, (2, 2)), (2, 2, 4, (2, 2)), (1, 2, 2, (1, 2)), (0, 1, 1, (1, 1)),
])
def test_mesh_covers_the_world(n_data, n_model, world, want):
    """``mesh_data: 0`` takes the world's remaining ranks, as JAX's make_mesh
    does; rank r sits at data r // n_model, model r % n_model, JAX's reshape
    of its device list."""
    assert mesh_shape(n_data, n_model, world) == want
    nd, nm = want
    jmesh = jmake_mesh(nd, nm, jax.devices()[:world])
    for r in range(world):
        mesh = Mesh(nd, nm, r, None, None)
        index = tuple(int(i) for i in np.argwhere(
            np.vectorize(lambda d: d.id)(jmesh.devices) == jax.devices()[r].id)[0])
        assert (mesh.data_index, mesh.model_index) == index
        assert mesh.model_ranks == [r - mesh.model_index + m for m in range(nm)]


@pytest.mark.parametrize("n_data,n_model,world", [(2, 1, 4), (1, 2, 4), (3, 1, 2), (0, 3, 2)])
def test_mesh_refuses_ranks_outside_it(n_data, n_model, world):
    """JAX leaves devices outside a smaller mesh idle; a rank outside the
    mesh would have nothing to do, so the port raises."""
    with pytest.raises(ValueError, match="every rank must hold one device"):
        mesh_shape(n_data, n_model, world)


@pytest.mark.parametrize("global_b,n_data,want", [(32, 2, 16), (8, 4, 2), (4, 1, 4)])
def test_local_batch_size(global_b, n_data, want):
    assert local_batch_size(global_b, n_data) == want


def test_local_batch_size_refuses_a_ragged_split():
    with pytest.raises(ValueError, match="not divisible"):
        local_batch_size(10, 4)


# -- the sharding rule -----------------------------------------------------------

def _pair(name):
    """(JAX model, port model, conf) for the sharding rule's checks."""
    if name == "dreamer":
        conf, classes = _conf(), (JDreamer, Dreamer)
    else:
        conf, classes = baseline_conf(name), (JWorldModelProbe, WorldModelProbe)
    torch.manual_seed(0)
    return classes[0](conf), classes[1](conf, device="cpu"), conf


@pytest.mark.parametrize("name", ["dreamer", "transformer_vae", "gru_vae"])
def test_jax_leaf_shapes_invert_convert(name):
    """``convert.jax_leaf_shapes`` reads every parameter's JAX leaf back from
    its state_dict key and shape: the JAX tree's shapes, attention included."""
    jmodel, model, _ = _pair(name)
    like = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    got = jax_leaf_shapes(model)
    want = {torch_key(tuple(k.key for k in path)): tuple(x.shape)
            for path, x in jax.tree_util.tree_flatten_with_path(like)[0]}
    assert got == want


@pytest.mark.parametrize("name", ["dreamer", "transformer_vae", "gru_vae"])
@pytest.mark.parametrize("tp_min_size", [128, 1024])
def test_param_shardings_are_jax_set(name, tp_min_size):
    """The parameters sharded over 'model' are the JAX leaves that JAX's own
    ``param_shardings`` gives ``P(None, 'model')`` on a (1, 2) mesh."""
    jmodel, model, _ = _pair(name)
    like = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    jsh = jparam_shardings(like, jmake_mesh(1, 2, jax.devices()[:2]), tp_min_size)
    want = {torch_key(tuple(k.key for k in path)) for path, s in
            jax.tree_util.tree_flatten_with_path(jsh)[0] if s.spec == P(None, "model")}
    got = param_shardings(model, Mesh(1, 2, 0, None, None), tp_min_size)
    assert {n for n, s in got.items() if s.axis == "model"} == want
    for n in want:
        dim = 0 if n.endswith(".weight") else 1  # Linear rows; GRU gate columns
        assert got[n].dim == dim, n
    if name == "dreamer" and tp_min_size == 128:
        assert {"wm.core.cell.gru.cell_0.weight_ih", "wm.core.cell.gru.cell_0.weight_hh"} <= want


# -- the per-rank noise ------------------------------------------------------------

@pytest.mark.parametrize("name,local_shape,t", [
    ("posterior_z", (4, 6, 3, 5), None),       # (T, B*I, S, K), B=3, I=2
    ("pred_z", (4, 3, 2, 3, 5), None),         # (T, B, I, S, K)
    ("embed_z", (4, 3, 2, 7), None),           # (T, B, I, S)
    ("embed_pred_z", (4, 3, 2, 7), None),
    ("action", (1, 3, 5), None),
    ("log_action", (3, 5), 2),                 # (B, A) at step t
    ("log_z", (3, 3, 5), 1),
    ("dream_action", (4 * 6, 5), 0),           # (T*B*I, A), t-major
    ("dream_z", (4 * 6, 3, 5), 2),
])
def test_rank_noise_rows_make_the_global_draw(name, local_shape, t):
    """Each data rank's rows of the global draw, put back in their places,
    give the global draw; ``dream_*``'s rows are t-major blocks."""
    n, streams = 3, 6
    rng = np.random.default_rng(0)
    axis = {"log_action": 0, "log_z": 0, "dream_action": 0, "dream_z": 0}.get(name, 1)
    glob = list(local_shape)
    glob[axis] *= n
    whole = rng.normal(size=tuple(glob)).astype(np.float32)
    inner = ReplayNoise({name: whole[None] if t is not None else whole})
    parts = [DataShardNoise(inner, d, n, streams).draw(name, local_shape, "normal",
                                                        0 if t is not None else None).numpy()
             for d in range(n)]
    if name.startswith("dream_"):
        T = local_shape[0] // streams
        back = np.concatenate([p.reshape((T, streams) + p.shape[1:]) for p in parts], 1)
        back = back.reshape(whole.shape)
    else:
        back = np.concatenate(parts, axis)
    np.testing.assert_array_equal(back, whole)


# -- the column-parallel modules -----------------------------------------------------

def test_column_parallel_modules_match_unsharded(tmp_path):
    """A sharded Dense (Megatron column-parallel, gathered output) feeding a
    replicated one and a GRU cell whose gate kernels are gathered: forward
    and every gradient equal the unsharded modules on both of 2 ranks."""
    spawn_ranks("modules", tmp_path, tmp_path, 2)
    for r in range(2):
        for cell, err in json.loads((tmp_path / f"rank{r}.json").read_text()).items():
            assert err.pop("sharded") == ["Dense_0.weight", "cell.weight_hh", "cell.weight_ih"]
            for what, e in err.items():
                assert e <= 1e-6, (r, cell, what, e)


# -- two TrainStep steps on a mesh ---------------------------------------------------

@pytest.mark.parametrize("n_data,n_model", [(2, 1), (1, 2), (2, 2)], ids=["dp2", "tp2", "dp2_tp2"])
def test_two_steps_match_jax_on_the_mesh(tmp_path, n_data, n_model):
    """Two steps (both log flags on) on ``n_data * n_model`` gloo ranks
    against JAX's ``TrainStep`` on the same mesh: every JAX metric on every
    rank (the NaN-skipping buckets and the std and variance metrics too, on
    a batch whose shards differ in their rewards and terminals), the TBTT
    state rows, and every parameter."""
    conf = _conf(mesh_data=n_data, mesh_model=n_model, tp_min_size=128)
    obs = _batch(conf, signed=True)
    jmodel, params, model = paired_models(conf)
    key = jax.random.PRNGKey(2)
    np.savez(tmp_path / "weights.npz", **{k: v.numpy() for k, v in model.state_dict().items()})
    np.savez(tmp_path / "batch.npz", **obs)
    for step in (1, 2):
        np.savez(tmp_path / f"noise{step}.npz",
                 **{k: v.numpy() for k, v in _jax_noise(conf, key, step).arrays.items()})
    (tmp_path / "conf.json").write_text(json.dumps(conf.to_dict()))

    ctx = JDistributedContext(conf, jax.devices()[:n_data * n_model])
    jstep = JTrainStep(jmodel, conf, donate=False)
    opt_state = jstep.init_optimizer(params)
    p, o = ctx.place_params(params), ctx.place_opt_state(opt_state, params)
    b = ctx.place_batch({k: jnp.asarray(v) for k, v in obs.items()})
    s = ctx.place_state(jmodel.init_state(conf.batch_size * conf.iwae_samples))
    want = {}
    for step in (1, 2):
        p, o, s, m, _, _ = jstep(p, o, b, s, step, np.asarray(key), do_image_pred=True,
                                 do_dream_tensors=True)
        want[step] = jax.device_get((m, s))
    assert {"logprob_reward-1", "logprob_reward1", "logprob_terminal1",
            "policy_reward_std"} <= set(want[1][0])

    spawn_ranks("step", tmp_path, tmp_path, n_data * n_model)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(n_data * n_model)]
    for step in (1, 2):
        jmetrics, jstate = want[step]
        for r, got in enumerate(ranks):
            for name, v in jmetrics.items():
                _close(float(got[f"metric{step}/{name}"]), float(v), LOSS_RTOL, 1e-6,
                       f"rank {r} step {step} {name}")
        firsts = sorted((int(g["data_index"]), g) for g in ranks if int(g["model_index"]) == 0)
        for i, leaf in enumerate(jstate):
            rows = np.concatenate([g[f"state{step}/{i}"] for _, g in firsts], 0)
            _close(rows, leaf, PARAM_RTOL, PARAM_ATOL, f"step {step} out_state {i}")
    whole = {k[len("param/"):]: torch.from_numpy(v) for k, v in ranks[0].items()
             if k.startswith("param/")}
    back = state_dict_to_jax(whole, params)
    flat_want = jax.tree_util.tree_flatten_with_path(jax.device_get(p))[0]
    for (path, w), g in zip(flat_want, jax.tree_util.tree_leaves(back)):
        _close(g, w, PARAM_RTOL, PARAM_ATOL, jax.tree_util.keystr(path))
