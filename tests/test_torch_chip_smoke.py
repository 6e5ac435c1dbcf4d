"""chip_smoke.py's table of phases, its command line and its presets, on the
CPU. The phases themselves run only on the card (``python3 chip_smoke.py``)."""

import json
import re
from pathlib import Path

import pytest
import torch

import chip_smoke

ROOT = Path(__file__).resolve().parent.parent

# The phases each flag runs: as the per-flag branches of main() ran them
# before the table replaced them, phase 21's flag, K2's phases 22-23 and phase 24
# (K1's dW summed once over the posterior loop).
FLAG_PHASES = {"--learning-only": [1, 15], "--tools-only": [1, 2, 16], "--graph-only": [1, 17],
               "--dv3-only": [1, 18, 19], "--backward-only": [1, 20], "--copies-only": [1, 21],
               "--k2-only": [1, 22, 23], "--dw-only": [1, 24]}


@pytest.mark.parametrize("name, preset", [("atari_dv2", "flagship_conf"), ("dmc_dv2", "dmc_conf"),
                                          ("atari_dv3_xl", "dv3_conf"),
                                          ("atari_dv3_200m", "dv3_200m_conf")])
def test_presets_are_the_benchmarks_confs(name, preset):
    """Each preset chip_smoke runs equals the benchmark's conf of the same
    configuration on every key that conf lists."""
    want = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())["conf"]
    got = getattr(chip_smoke, preset)()
    assert {k: got.get(k, "<missing>") for k in want} == want


@pytest.mark.parametrize("flag", sorted(FLAG_PHASES))
def test_each_flag_runs_the_phases_its_usage_names(flag):
    phases = dict(chip_smoke.PHASES)
    rows = chip_smoke.plan([flag])
    assert [n for n, _, _ in rows] == FLAG_PHASES[flag]
    assert all(fn is phases[n] for n, fn, _ in rows)
    said = re.sub(r" \([a-z_, ]+\)", "", chip_smoke.usage())  # the options a phase runs with
    named = re.match(r"[\d, ]+", said.split(f"{flag}: phases ")[1]).group()
    assert [int(n) for n in named.split(", ")] == FLAG_PHASES[flag]
    options = {n: opts for n, _, opts in rows if opts}
    assert options == ({2: {"flagship_only": True}, 16: {"with_e2e": True}}
                       if flag == "--tools-only" else {})


def test_no_flag_runs_every_phase_once_in_order():
    rows = chip_smoke.plan([])
    assert [n for n, _, _ in rows] == list(range(1, 25))
    assert len({fn for _, fn, _ in rows}) == 24
    assert all(opts == {} for _, _, opts in rows)


@pytest.mark.parametrize("argv, rc", [(["--bogus"], 2), (["--graph-only", "--dv3-only"], 2),
                                      ([], 1), (["--backward-only"], 1)])
def test_main_refuses_other_arguments_and_needs_a_card(monkeypatch, capsys, argv, rc):
    """rc 2 with the usage line for anything but one known flag; rc 1 at once
    without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main(argv) == rc
    err = capsys.readouterr().err
    assert (chip_smoke.usage() in err) == (rc == 2)
