"""The port learns: the counterpart of ``tests/test_learning.py`` on the CPU.

The four canaries of the JAX tests run through the port's loops
(``pydreamer_tpu_torch/scripts/canaries.py``) and are held to the JAX tests'
own gates. The bandit and the GridWorld world model run in the tier-1 run;
the pixel policy (online collection, up to 4000 steps) and the continuous
point (400 steps with the dynamics gradient) are slow, as in JAX.

The port's copies of the four configs are tied to JAX's: each equals the
config the JAX test builds (its keyword arguments read from the JAX test's
source, over ``tests/util.py``'s base), and two ``TrainStep`` steps of each
from the same weights and JAX's replayed noise agree with JAX's within the
tolerances of ``test_torch_port_train_step.py``.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import tests.test_learning as jlearning
import tests.util as jutil
from pydreamer_tpu_torch.scripts import canaries
from tests.test_torch_port_train_step import _batch, run_two_steps

EP_LEN = jlearning.EP_LEN
JAX_TESTS = {"bandit": "test_return_improves_on_bandit",
             "gridworld_wm": "test_world_model_loss_decreases_on_gridworld",
             "gridworld_pixels": "test_policy_return_improves_on_gridworld_pixels",
             "point": "test_return_improves_on_point_continuous"}


def _make_conf_kwargs(fn: ast.FunctionDef) -> dict:
    """The keyword arguments of the one ``make_conf(...)`` call in a JAX test,
    with the names it passes resolved from the test's own assignments."""
    names = {t.id: ast.literal_eval(n.value) for n in ast.walk(fn) if isinstance(n, ast.Assign)
             for t in n.targets if isinstance(t, ast.Name) and isinstance(n.value, ast.Constant)}
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "make_conf"]
    assert len(calls) == 1, fn.name
    return {k.arg: names[k.value.id] if isinstance(k.value, ast.Name) else ast.literal_eval(k.value)
            for k in calls[0].keywords}


def jax_conf(name: str):
    """The config the JAX test of canary ``name`` trains (a JAX ``Conf``)."""
    if name == "bandit":
        return jlearning.bandit_conf()
    tree = ast.parse(Path(jlearning.__file__).read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == JAX_TESTS[name])
    return jutil.make_conf(**_make_conf_kwargs(fn))


@pytest.fixture
def two_threads():
    """Two torch threads: the tier-1 run shares the host's cores among its
    workers, and oversubscribed OpenMP threads hold each other back."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(canaries.CONFS))
def test_canary_config_is_the_jax_tests(name):
    assert canaries.CONFS[name]().to_dict() == jax_conf(name).to_dict()
    assert canaries.CONFS[name]("gru_layernorm_dv2").gru_type == "gru_layernorm_dv2"
    assert canaries.BASE == jutil.BASE


@pytest.mark.parametrize("name", list(canaries.CONFS))
def test_canary_config_two_steps_match_jax(name):
    """Two TrainStep steps of the canary's config against JAX's (JAX draws its
    dream noise by ``threefry`` here, so that its keys can be replayed)."""
    conf = jax_conf(name).replace(dream_rng="threefry")
    run_two_steps(conf, _batch(conf))


def test_return_improves_on_bandit(tmp_path, two_threads):
    r = canaries.bandit(tmp_path / "episodes", device="cpu")
    assert np.isfinite(r["metrics"]["loss_model"])
    # Untrained policy ~ random: EP_LEN / N_ACTIONS ~ 2.7.
    assert r["before"] < 0.75 * EP_LEN, \
        f"untrained policy suspiciously good ({r['before']}); test is vacuous"
    assert r["after"] > 0.75 * EP_LEN, (
        f"agent did not learn: return {r['before']:.2f} -> {r['after']:.2f} (optimal {EP_LEN})")
    assert r["after"] > r["before"] + 0.25 * EP_LEN, (
        f"no significant improvement: {r['before']:.2f} -> {r['after']:.2f}")
    assert r["policy_calls"] == 40 * EP_LEN


def test_world_model_loss_decreases_on_gridworld(tmp_path, two_threads):
    r = canaries.gridworld_wm(tmp_path / "episodes", device="cpu")
    assert r["after"] < 0.5 * r["before"], (
        f"world-model loss did not improve: {r['before']:.1f} -> {r['after']:.1f}")


@pytest.mark.slow
def test_policy_return_improves_on_gridworld_pixels(tmp_path, two_threads):
    r = canaries.gridworld_pixels(tmp_path / "episodes",
                                  lambda early, late: late > early + 0.08 and late > 0.05,
                                  device="cpu")
    assert np.isfinite(r["metrics"]["loss_model"])
    assert r["passed"], (
        f"pixel policy never cleared the improvement gate by step 4000: collected return "
        f"{r['before']:.2f} (first 80 eps) -> {r['after']:.2f} (last 80)")


@pytest.mark.slow
def test_return_improves_on_point_continuous(tmp_path, two_threads):
    r = canaries.point(tmp_path / "episodes", device="cpu")
    assert np.isfinite(r["metrics"]["loss_model"])
    assert r["after"] > r["before"] + 4.0, (
        f"continuous policy did not improve: {r['before']:.2f} -> {r['after']:.2f}")
    assert r["after"] > 12.0, f"absolute continuous return too low: {r['after']:.2f}"
