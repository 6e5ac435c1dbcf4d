"""One rank of the port's multi-rank CPU tests, run as a script.

    python tests/test_torch_port_parallel_worker.py <mode> <in_dir> <out_dir>

torch's environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``) names the rank; the group is gloo on the CPU. It imports torch,
numpy and the port only, never JAX: the parent tests
(``test_torch_port_parallel.py``, ``test_torch_port_multihost.py``) compute
JAX's side and write the inputs to ``in_dir``. Modes:

* ``modules``: a column-parallel ``Dense`` and the gathered gate kernels of
  three GRU cells against the unsharded modules, forward and every gradient;
  writes ``rank<r>.json`` of max-abs errors;
* ``step``: two ``TrainStep`` steps from ``weights.npz`` on the rank's rows
  of ``batch.npz``, with the global noise ``noise<step>.npz``; writes
  ``rank<r>.npz`` (metrics, out_state rows, and on rank 0 the whole
  parameters);
* ``trainer``: ``trainer.run`` from ``conf.json`` (and ``conf<r>.json`` when
  present, for a rank's own overrides). Ranks other than 0 make every
  ``Run`` writer raise, so a write that is not rank 0's fails the run.
  Prints ``RESULT <rank> <return value>``.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from pydreamer_tpu_torch.conf import Conf  # noqa: E402
from pydreamer_tpu_torch.parallel.multihost import maybe_initialize_distributed, rank  # noqa: E402


def _modules(out_dir: Path):
    import copy

    from pydreamer_tpu_torch.models.modules import Dense
    from pydreamer_tpu_torch.models.rnn import make_gru_cell
    from pydreamer_tpu_torch.parallel import DistributedContext

    errors = {}
    for cell_type in ("gru", "gru_layernorm", "gru_layernorm_dv2"):
        torch.manual_seed(0)
        net = torch.nn.Module()
        net.Dense_0 = Dense(12, 256)   # out 256 >= tp_min_size: rows sharded
        net.Dense_1 = Dense(256, 20)   # out 20: replicated
        net.cell = make_gru_cell(cell_type, 20, 64)  # 3H = 192: columns sharded
        ref = copy.deepcopy(net)
        ctx = DistributedContext(Conf(dict(mesh_data=1, mesh_model=2, tp_min_size=128)), "cpu")
        ctx.place_model(net)
        gen = torch.Generator().manual_seed(1)
        x, h, proj = torch.randn(5, 12, generator=gen), torch.randn(5, 64, generator=gen), \
            torch.randn(5, 64, generator=gen)
        outs = []
        for m in (net, ref):
            xi, hi = x.clone().requires_grad_(), h.clone().requires_grad_()
            y = m.cell(m.Dense_1(torch.tanh(m.Dense_0(xi))), hi)
            (y * proj).sum().backward()
            outs.append((y.detach(), xi.grad, hi.grad, m))
        (y, gx, gh, _), (y_ref, gx_ref, gh_ref, _) = outs
        err = {"out": (y - y_ref).abs().max().item(), "grad_x": (gx - gx_ref).abs().max().item(),
               "grad_h": (gh - gh_ref).abs().max().item()}
        for name, p in ref.named_parameters():
            got = ctx.shardings[name].gather(ctx.mesh, net.get_parameter(name).grad)
            err[f"grad {name}"] = (got - p.grad).abs().max().item()
        err["sharded"] = sorted(n for n, s in ctx.shardings.items() if s.axis == "model")
        errors[cell_type] = err
    (out_dir / f"rank{rank()}.json").write_text(json.dumps(errors))


def _step(in_dir: Path, out_dir: Path):
    from pydreamer_tpu_torch.models.dreamer import Dreamer
    from pydreamer_tpu_torch.models.noise import ReplayNoise
    from pydreamer_tpu_torch.parallel import DistributedContext, batch_sharding
    from pydreamer_tpu_torch.training.train_step import TrainStep

    conf = Conf(json.loads((in_dir / "conf.json").read_text()))
    model = Dreamer(conf, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in np.load(in_dir / "weights.npz").items()})
    ctx = DistributedContext(conf, "cpu")
    step_fn = TrainStep(model, conf, device="cpu", ctx=ctx)
    obs = {k: batch_sharding(ctx.mesh).local(ctx.mesh, torch.from_numpy(v))
           for k, v in np.load(in_dir / "batch.npz").items()}
    state = model.init_state(obs["action"].shape[1] * conf.iwae_samples)
    out = {}
    for step in (1, 2):
        noise = ReplayNoise(dict(np.load(in_dir / f"noise{step}.npz")))
        state, metrics, _, _ = step_fn(obs, state, step, noise, do_image_pred=True,
                                       do_dream_tensors=True)
        out.update({f"metric{step}/{k}": v.numpy() for k, v in metrics.items()})
        out.update({f"state{step}/{i}": s.numpy() for i, s in enumerate(state)})
    whole = ctx.fetch(model, step_fn.optimizer)
    if rank() == 0:
        out.update({f"param/{k}": v.numpy() for k, v in whole["model"].items()})
    np.savez(out_dir / f"rank{rank()}.npz", data_index=ctx.mesh.data_index,
             model_index=ctx.mesh.model_index, **out)


def _trainer(in_dir: Path):
    from pydreamer_tpu_torch import tracking
    from pydreamer_tpu_torch.training import trainer

    me = int(os.environ["RANK"])
    conf = json.loads((in_dir / "conf.json").read_text())
    own = in_dir / f"conf{me}.json"
    if own.exists():
        conf.update(json.loads(own.read_text()))
    if me != 0:
        def refuse(self, *args, **kwargs):
            raise AssertionError(f"rank {me} wrote to the run")
        for name in ("log_metrics", "save_checkpoint", "log_npz", "log_text"):
            setattr(tracking.Run, name, refuse)
    result = trainer.run(Conf(conf), run_dir=conf["run_dir"], device="cpu")
    print(f"RESULT {me} {result}", flush=True)


def main():
    mode, in_dir, out_dir = sys.argv[1], Path(sys.argv[2]), Path(sys.argv[3])
    torch.set_num_threads(1)
    if mode == "trainer":
        _trainer(in_dir)  # trainer.run initializes the group itself
        return
    maybe_initialize_distributed("cpu")
    {"modules": lambda: _modules(out_dir), "step": lambda: _step(in_dir, out_dir)}[mode]()


if __name__ == "__main__":
    main()
