"""The PyTorch port stands alone: no JAX, no JAX package, explicit devices."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import __graft_entry__ as graft
from pydreamer_tpu_torch.device import resolve_device
from pydreamer_tpu_torch.models.dreamer import Dreamer
from pydreamer_tpu_torch.training.train_step import TrainStep

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, json, pkgutil, sys
import pydreamer_tpu_torch
names = ["pydreamer_tpu_torch"]
for info in pkgutil.walk_packages(pydreamer_tpu_torch.__path__, "pydreamer_tpu_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
print(json.dumps({"imported": names, "modules": sorted(sys.modules)}))
"""


def test_port_imports_no_jax_and_no_jax_package():
    """Import the package and every submodule in a fresh interpreter (this
    process has JAX loaded already) and inspect sys.modules."""
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "pydreamer_tpu_torch.training.train_step" in out["imported"]
    assert "pydreamer_tpu_torch.ops.gru_dv2" in out["imported"]
    bad = [m for m in out["modules"]
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")
           or m == "pydreamer_tpu" or m.startswith("pydreamer_tpu.")]
    assert not bad, bad


def test_entry_points_refuse_cuda_without_a_card(monkeypatch):
    """device defaults to 'cuda' and raises without a card; 'cpu' must be asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = graft._make_conf(tiny=True).replace(gru_type="gru_layernorm_dv2")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Dreamer(conf)
    model = Dreamer(conf, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainStep(model, conf)
    assert TrainStep(model, conf, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("key,value", [("actor_grad", "dynamics"), ("aux_critic", True),
                                       ("iwae_samples", 2), ("probe_model", "map")])
def test_out_of_scope_options_raise(key, value):
    conf = graft._make_conf(tiny=True).replace(**{key: value})
    with pytest.raises(NotImplementedError):
        Dreamer(conf, device="cpu")
