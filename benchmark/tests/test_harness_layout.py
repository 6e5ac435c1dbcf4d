"""The harness finds a configuration, a traffic mix and a per-layer metric
by name, so that a new one is new files and ``BENCHMARK.json`` entries."""

import json
import shutil
from pathlib import Path

import torch

from benchmark import run
from benchmark.tests.tiny import TINY

HERE = Path(run.__file__).resolve().parent

NEW_METRIC = '''"""steps_seen.test: the profiled steps (a metric dropped in by a test)."""


def read(run):
    return float(run.trace.steps)
'''


def _tree(tmp_path):
    """A checkout with the benchmark's files, plus a new config, mix and metric."""
    root = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(HERE / sub, root / sub)
    conf = json.loads((HERE / "configs" / "atari_dv2.json").read_text())
    conf["name"] = "atari_small"
    conf["conf"] = dict(conf["conf"], **TINY)
    (root / "configs" / "atari_small.json").write_text(json.dumps(conf))
    mix = json.loads((HERE / "traffic" / "train_resident.json").read_text())
    mix["pool_batches"] = 3
    (root / "traffic" / "train_three.json").write_text(json.dumps(mix))
    (root / "metrics" / "steps_seen.test.py").write_text(NEW_METRIC)
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="atari_small",
                                 file="benchmark/configs/atari_small.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name="atari_small-three",
                                   config="atari_small", traffic="train_three"))
    bench["per_layer"].append({"name": "steps_seen.test", "unit": "steps", "better": "higher",
                               "source": "device_trace", "layer": "test", "moves": "train_steps_per_s"})
    return root, bench


def test_new_files_are_found_without_edits(tmp_path):
    root, bench = _tree(tmp_path)
    spec = run.load_spec("atari_small-three", bench, root=root)
    assert spec.conf["deter_dim"] == TINY["deter_dim"]
    assert spec.mix["pool_batches"] == 3
    assert "steps_seen.test" in [m["name"] for m in spec.per_layer]
    result = run.run_cell(spec, 11, 0.2, True, torch.device("cpu"), log=lambda *a, **k: None)
    assert result["correct"]
    assert result["metrics"]["steps_seen.test"]["value"] == run.PROFILED_STEPS
    assert list(result)[-1] == "compared"

