"""What decides ``correct``, on the CPU at tiny widths in float32: the
reference agrees with the port; a run whose timed path is broken underneath
comes out not correct; the float8 control reads far above the port."""

import pytest
import torch

from benchmark import calibrate, run
from benchmark.tests.tiny import tiny_spec

QUIET = dict(log=lambda *a, **k: None)


def _run(workload, adapt=None, seed=2**31 + 7):
    return run.run_cell(tiny_spec(workload), seed, 0.2, False, torch.device("cpu"), adapt=adapt,
                        **QUIET)


@pytest.mark.parametrize("workload", ["atari-train", "dmc-train"])
def test_reference_agrees_with_the_port(workload):
    """In float32 both sides agree to far below what bfloat16 rounding costs."""
    result = _run(workload)
    assert result["correct"]
    assert result["compared"]["grad"]["value"] < 1e-4
    assert result["compared"]["change"]["value"] < 1e-2


def _state_unchanged(program):
    """A step that updates nothing: the optimizer's step does nothing."""
    program.trainstep.optimizer.step = lambda *a, **k: None
    return program


class _HalfBatch:
    """Half of the batch's columns left out, the means taken over the rest."""

    def __init__(self, program):
        self.program = program

    def __getattr__(self, name):
        return getattr(self.program, name)

    def step(self, obs, state, step, noise=None, seed=0):
        half = obs["action"].shape[1] // 2
        obs = {k: v[:, :half] for k, v in obs.items()}
        out, metrics = self.program.step(obs, tuple(s[:half] for s in state), step, noise, seed)
        return tuple(torch.cat([o, s[half:]]) for o, s in zip(out, state)), metrics


def _ac_lr(program):
    """The actor's and the critic's groups stepped at the world model's
    learning rate: only ``change_worst`` sees it, as the median leaf of
    ``change`` is the world model's."""
    for group in program.trainstep.optimizer.param_groups:
        if group["name"] in ("actor", "critic"):
            group["lr"] = program.conf.adam_lr
    return program


@pytest.mark.parametrize("fault", [_state_unchanged, _HalfBatch, _ac_lr])
@pytest.mark.parametrize("workload", ["atari-train", "dmc-train"])
def test_a_broken_step_is_not_correct(workload, fault):
    result = _run(workload, adapt=fault)
    assert not result["correct"]


@pytest.mark.parametrize("workload", ["atari-train", "dmc-train"])
def test_control_reads_far_above_the_program(workload):
    spec = tiny_spec(workload)
    got = calibrate.readings_for_seed(spec, 5, torch.device("cpu"),
                                      sides={"control": dict(cast=calibrate.cast_fp8)})
    program, control = got["program"]["numbers"], got["control"]["numbers"]
    assert max(control.values()) > 1e3 * max(max(program.values()), 1e-9)


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["atari-train", "dmc-train"])
def test_control_fails_the_limits_on_the_card(workload, cuda):
    """At the cell's own widths: the float8 control breaks a limit."""
    spec = run.load_spec(workload)
    got = calibrate.readings_for_seed(spec, 2**31 + 101, cuda,
                                      sides={"control": dict(cast=calibrate.cast_fp8)})
    limits = spec.config["limits"]
    assert any(got["control"]["numbers"][k] > limits[k] for k in limits)
    assert all(got["program"]["numbers"][k] <= limits[k] for k in limits)
