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
    """Import the package and every submodule, the run and measurement tools
    of ``scripts/`` included, in a fresh interpreter (this process has JAX loaded already) and
    inspect sys.modules: no JAX, no JAX package, nothing of ``tests/``."""
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    files = sorted(ROOT.glob("pydreamer_tpu_torch/**/*.py"))
    want = {".".join(f.relative_to(ROOT).with_suffix("").parts).replace(".__init__", "")
            for f in files}
    assert want <= set(out["imported"]), want - set(out["imported"])
    assert {"pydreamer_tpu_torch.models.noise", "pydreamer_tpu_torch.training.trainer",
            "pydreamer_tpu_torch.data.prefetch", "pydreamer_tpu_torch.native",
            "pydreamer_tpu_torch.models.probes", "pydreamer_tpu_torch.models.baselines",
            "pydreamer_tpu_torch.analysis", "pydreamer_tpu_torch.tracing",
            "pydreamer_tpu_torch.scripts.canaries",
            "pydreamer_tpu_torch.scripts.export_metrics", "pydreamer_tpu_torch.scripts.plot_curves",
            "pydreamer_tpu_torch.scripts.make_gif",
            "pydreamer_tpu_torch.scripts.diagnose_gridworld_pixels",
            "pydreamer_tpu_torch.scripts.diagnose_continuous",
            *(f"pydreamer_tpu_torch.scripts.{tool}" for tool in (
                "flagship", "bench", "bench_e2e", "profile_step", "bench_step_ab", "bench_gru",
                "bench_dream", "roofline", "bench_conv", "scaling_bench"))} <= want
    bad = [m for m in out["modules"]
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "msgpack", "tests")
           or m in ("pydreamer_tpu", "__graft_entry__") or m.startswith("pydreamer_tpu.")]
    assert not bad, bad


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py runs where JAX is not installed: no import of JAX, flax,
    optax or the JAX package anywhere in it, at top level or inside a function."""
    import ast
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert "pydreamer_tpu_torch.training" in names
    bad = [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "pydreamer_tpu")]
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


@pytest.mark.parametrize("key,value", [("probe_model", "map"), ("probe_model", "goals"),
                                       ("probe_model", "map+goals")])
def test_out_of_scope_options_raise(key, value):
    """Every probe of the JAX package builds; what JAX refuses (an unknown
    probe, a map decoder other than ``dense``) raises NotImplementedError."""
    conf = graft._make_conf(tiny=True).replace(map_size=5, map_channels=4, goals_size=2,
                                               map_hidden_dim=16, **{key: value})
    assert type(Dreamer(conf, device="cpu").probe).__name__ != "NoProbeHead"
    with pytest.raises(NotImplementedError):
        Dreamer(conf.replace(**{key: value + "_x"}), device="cpu")


@pytest.mark.parametrize("overrides", [
    dict(actor_grad="dynamics", actor_dist="trunc_normal"),
    dict(actor_grad="dynamics", actor_dist="tanh_normal"),
    dict(actor_grad="reinforce", actor_dist="normal_tanh"),
    dict(aux_critic=True), dict(iwae_samples=2), dict(reward_decoder_categorical=(0.0, 1.0)),
    dict(image_encoder="dense", image_decoder="dense", image_size=7, image_channels=4,
         image_encoder_layers=2, image_decoder_layers=2),
    dict(image_encoder=None, image_decoder=None, vecobs_size=3),
], ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_ported_options_build(overrides):
    """The options of this slice build on the CPU; none raises NotImplementedError."""
    conf = graft._make_conf(tiny=True).replace(**overrides)
    model = Dreamer(conf, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    assert (model.wm.ac_aux is not None) == bool(conf.aux_critic)
