"""Data- and tensor-parallel training over ``torch.distributed``.

Counterpart of ``pydreamer_tpu/parallel/mesh.py``. JAX runs one SPMD program
over a ``Mesh(('data', 'model'))`` of devices and lets GSPMD insert the
collectives. PyTorch's idiom is one process (rank) per device, so here the
mesh is the world of ranks laid out as ``(n_data, n_model)``, rank
``d * n_model + m`` at data index d and model index m, as JAX reshapes its
device list (mesh.py:52). Ranks with the same data index form a ``model``
group, ranks with the same model index a ``data`` group, each a
``torch.distributed`` subgroup. ``mesh_data: 0`` means ``world // n_model``.
JAX may leave devices outside a smaller mesh (mesh.py:50); a rank outside the
mesh would have nothing to do, so ``make_mesh`` raises unless the mesh covers
the world exactly.

* **data.** Each rank feeds its ``(T, B/n_data, ...)`` slice of the batch and
  carries its slice of the TBTT state; ``DataShardNoise`` (``models/noise.py``)
  gives it its rows of the global noise. After ``backward()`` the gradients
  are averaged (``reduce_gradients``, a few flat buckets) before the norms and
  the clip, as GSPMD's psum comes before ``optax.clip_by_global_norm``. The
  metrics that are not means over equal shards reduce their sums, counts and
  moments inside the forward (``functions.BatchReduce``); the step's other
  metrics are averaged in one call (``reduce_metrics``).
* **model.** JAX's rule on JAX's layout (mesh.py:70-86): a parameter is
  column-sharded iff its JAX leaf is 2-D, its last dim is ``>= tp_min_size``
  and divisible by ``n_model`` (``param_shardings``, through ``convert.py``'s
  path mapping). That covers the ``Dense`` weights, sharded by rows (torch's
  ``(out, in)``), which run as a Megatron column-parallel product with a
  gathered output (``ColumnParallel.linear``), and the GRU gate kernels, kept
  ``(in, 3H)`` and sharded by columns, which are gathered before the cell runs
  (``ColumnParallel.gather_columns``), as GSPMD must do before a Pallas call.
  K1 then sees whole weights. AdamW's moments are born sharded because the
  optimizer is built after ``place_model``.

A replicated parameter's gradient is averaged over the whole world, not over
its data group alone: ranks of one model group compute it identically in exact
arithmetic, and averaging keeps their copies equal where a kernel's sums run
in another order.

Two ranks that share one card cannot use NCCL; gloo takes device tensors
for every collective here (all-reduce, broadcast, all-gather), so no
collective is staged through the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..convert import jax_leaf_shapes
from ..device import resolve_device
from ..models.functions import BatchReduce
from ..models.modules import Dense
from ..models.noise import DataShardNoise
from ..models.rnn import _GateWeights
from ..tools import logger
from .multihost import rank, world_size

__all__ = ["Mesh", "Sharding", "make_mesh", "mesh_shape", "param_shardings", "batch_sharding",
           "state_sharding", "replicated", "ColumnParallel", "DistributedContext"]

BUCKET_BYTES = 64 * 2**20  # gradient all-reduce bucket


# -- collectives ------------------------------------------------------------

def _in_place(collective, x: torch.Tensor) -> torch.Tensor:
    """Run an in-place ``collective(buffer)`` on ``x``: a collective sends a
    tensor's storage as it lies, so a tensor that is not contiguous goes
    through a contiguous copy."""
    buf = x.contiguous()
    collective(buf)
    if buf is not x:
        x.copy_(buf)
    return x


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``x`` over ``group``."""
    return _in_place(lambda b: dist.all_reduce(b, op=op, group=group), x)


def broadcast_(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """In-place broadcast of ``x`` from global rank ``src`` over ``group``."""
    return _in_place(lambda b: dist.broadcast(b, src=src, group=group), x)


def all_gather_cat(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` (``size`` ranks, in rank order),
    concatenated along ``dim``."""
    src = x.contiguous()
    chunks = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(chunks, src, group=group)
    return torch.cat(chunks, dim)


def _buckets(tensors: List[torch.Tensor], limit: int):
    """Consecutive runs of ``tensors`` of at most ``limit`` bytes (a larger
    tensor alone)."""
    bucket, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and size + nbytes > limit:
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        yield bucket


# -- the mesh ----------------------------------------------------------------

def mesh_shape(n_data: int, n_model: int, world: int) -> tuple:
    """(n_data, n_model) of a mesh over ``world`` ranks; ``n_data`` 0 takes
    ``world // n_model``. Raises unless the mesh covers the world exactly."""
    n_model = max(n_model, 1)
    if n_data <= 0:
        n_data = world // n_model
    if n_data < 1 or n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} needs {n_data * n_model} ranks, the world has "
                         f"{world}: every rank must hold one device of the mesh")
    return n_data, n_model


@dataclass
class Mesh:
    """The world of ranks as ``(n_data, n_model)``, with this rank's place and
    its two groups. ``shape`` reads as JAX's ``mesh.shape``."""
    n_data: int
    n_model: int
    rank: int
    data_group: Any
    model_group: Any

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def model_ranks(self) -> List[int]:
        """The ranks of this rank's model group (one data index)."""
        return [self.data_index * self.n_model + m for m in range(self.n_model)]


def make_mesh(n_data: int = 0, n_model: int = 1) -> Mesh:
    """The mesh over the initialized world. Every rank creates every subgroup,
    in the same order, as ``torch.distributed.new_group`` requires; a group
    that is the whole world is the world group."""
    world, me = world_size(), rank()
    n_data, n_model = mesh_shape(n_data, n_model, world)

    def group(ranks):
        return dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)

    model_groups = [group([d * n_model + m for m in range(n_model)]) for d in range(n_data)]
    data_groups = [group([d * n_model + m for d in range(n_data)]) for m in range(n_model)]
    return Mesh(n_data, n_model, me, data_groups[me % n_model], model_groups[me // n_model])


@dataclass(frozen=True)
class Sharding:
    """How a tensor lies on the mesh: split along ``dim`` over the ranks of
    ``axis`` (``"data"`` or ``"model"``), or whole on every rank (``axis``
    None). The counterpart of a ``NamedSharding``'s spec."""
    axis: Optional[str] = None
    dim: int = 0

    def local(self, mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor ``x``."""
        if self.axis is None:
            return x
        n, i = ((mesh.n_data, mesh.data_index) if self.axis == "data"
                else (mesh.n_model, mesh.model_index))
        size = x.shape[self.dim] // n
        return x.narrow(self.dim, i * size, size)

    def gather(self, mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's block (a collective of ``axis``)."""
        if self.axis is None:
            return x
        if self.axis == "data":
            return all_gather_cat(x, self.dim, mesh.data_group, mesh.n_data)
        return all_gather_cat(x, self.dim, mesh.model_group, mesh.n_model)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding()


def batch_sharding(mesh: Mesh) -> Sharding:
    """(T, B, ...) inputs: B over 'data'."""
    return Sharding("data", 1)


def state_sharding(mesh: Mesh) -> Sharding:
    """(B, ...) TBTT state: axis 0 over 'data'."""
    return Sharding("data", 0)


def param_shardings(model: torch.nn.Module, mesh: Mesh, tp_min_size: int = 1024
                    ) -> Dict[str, Sharding]:
    """Each parameter's sharding by JAX's rule on its JAX leaf (mesh.py:70-86):
    column-sharded over 'model' iff the leaf is 2-D, its last dim is
    ``>= tp_min_size`` and divisible by ``n_model``. The leaf's shape comes
    from ``convert.jax_leaf_shapes``, so the set is JAX's by construction. A
    torch ``Linear`` weight is the leaf transposed (sharded along dim 0); a GRU
    gate kernel keeps the leaf's layout (dim 1)."""
    out, leaves = {}, jax_leaf_shapes(model)
    for name, p in model.named_parameters():
        segs, leaf = name.split("."), leaves[name]
        if not (mesh.n_model > 1 and len(leaf) == 2 and leaf[-1] >= tp_min_size
                and leaf[-1] % mesh.n_model == 0):
            out[name] = Sharding()
        elif segs[-1] == "weight" and p.dim() == 2 and leaf == tuple(p.shape)[::-1]:
            out[name] = Sharding("model", 0)
        elif leaf == tuple(p.shape):
            out[name] = Sharding("model", p.dim() - 1)
        else:
            raise NotImplementedError(f"{name}: no column-parallel layout for the JAX leaf {leaf}")
    return out


# -- the model axis ----------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the input's gradient over 'model'."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


class _GatherBlocks(torch.autograd.Function):
    """Every model rank's block, concatenated along ``dim``; the backward keeps
    this rank's block of the gradient, which every rank holds whole (the
    consumers are replicated), with no sum. ``torch.distributed.nn``'s
    all_gather sums it over the ranks instead, which would scale it by n."""

    @staticmethod
    def forward(ctx, x, dim, group, index, size):
        ctx.dim, ctx.index, ctx.block = dim, index, x.shape[dim]
        return all_gather_cat(x, dim, group, size)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.block, ctx.block).contiguous(), None, None, \
            None, None


class ColumnParallel:
    """The 'model' axis of a sharded ``Dense`` or GRU gate kernel."""

    def __init__(self, mesh: Mesh):
        self.group, self.index, self.size = mesh.model_group, mesh.model_index, mesh.n_model

    def linear(self, x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor]) -> torch.Tensor:
        """Megatron's column-parallel linear with a gathered output: the input
        whole on every rank (gradient summed over 'model'), the product with
        the rank's rows of the weight, the outputs gathered; the whole bias
        added after. What JAX's ``P(None, 'model')`` kernel with a replicated
        consumer computes (mesh.py:73-75)."""
        y = torch.nn.functional.linear(_CopyToModel.apply(x, self.group), weight)
        y = _GatherBlocks.apply(y, y.dim() - 1, self.group, self.index, self.size)
        return y if bias is None else y + bias

    def gather_columns(self, w: torch.Tensor) -> torch.Tensor:
        """A column-sharded (in, 3H) kernel, whole."""
        return _GatherBlocks.apply(w, 1, self.group, self.index, self.size)


# -- the context ---------------------------------------------------------------

class DistributedContext:
    """Puts a model, its optimizer state, its noise and its batches on the
    mesh (counterpart of JAX's ``DistributedContext``, mesh.py:89-216).

    The trainer builds one whenever a process group is active. The model is
    placed once, before its ``TrainStep`` builds the optimizer
    (``place_model``: rank 0's weights broadcast, then the sharded
    parameters cut to the rank's block, in place of JAX's global SPMD init);
    ``TrainStep`` then calls ``reduce_gradients``, ``grad_norms`` and
    ``reduce_metrics``, and wraps its noise in ``noise``. ``fetch`` and
    ``place_like`` turn the rank's state into the whole state dicts and back,
    so the checkpoint format does not change.
    """

    def __init__(self, conf, device: str | torch.device = "cuda"):
        self.mesh = make_mesh(conf.get("mesh_data", 0), conf.get("mesh_model", 1))
        self.tp_min_size = conf.get("tp_min_size", 1024)
        self.device = resolve_device(device)
        self.shardings: Dict[str, Sharding] = {}
        self._names: Dict[int, str] = {}  # id(parameter) -> name, once placed
        self.batch_reduce = BatchReduce(self._data_sum)
        logger.info("Mesh: %s over %d ranks (rank %d: data %d, model %d)", self.mesh.shape,
                    world_size(), self.mesh.rank, self.mesh.data_index, self.mesh.model_index)

    @property
    def n_data(self) -> int:
        return self.mesh.n_data

    @property
    def n_model(self) -> int:
        return self.mesh.n_model

    def _data_sum(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce_(x.detach().clone(), self.mesh.data_group)

    # -- the model and its optimizer state --------------------------------

    @torch.no_grad()
    def place_model(self, model: torch.nn.Module) -> Dict[str, Sharding]:
        """Rank 0's parameters and buffers on every rank; each sharded
        parameter cut to the rank's block and its module switched to the
        column-parallel forward; the data group's ``BatchReduce`` on the
        modules that compute batch statistics. Returns the shardings."""
        for t in list(model.parameters()) + list(model.buffers()):
            broadcast_(t.data, 0, dist.group.WORLD)
        self.shardings = param_shardings(model, self.mesh, self.tp_min_size)
        sharded = {n: s for n, s in self.shardings.items() if s.axis == "model"}
        tp = ColumnParallel(self.mesh)
        owners = {n.rpartition(".")[0] for n in sharded}
        for owner in owners:
            module = model.get_submodule(owner)
            want = ({"weight": 0} if isinstance(module, Dense) else
                    {"weight_ih": 1, "weight_hh": 1} if isinstance(module, _GateWeights) else None)
            got = {n.rpartition(".")[2]: s.dim for n, s in sharded.items()
                   if n.rpartition(".")[0] == owner}
            if got != want:
                raise NotImplementedError(f"{owner}: sharded {got}, a column-parallel "
                                          f"{type(module).__name__} shards {want}")
            module.tensor_parallel = tp
        for name, s in sharded.items():
            p = model.get_parameter(name)
            p.data = s.local(self.mesh, p.data).clone()
        for module in model.modules():
            if hasattr(module, "batch_reduce"):
                module.batch_reduce = self.batch_reduce
        self._names = {id(p): n for n, p in model.named_parameters()}
        if sharded:
            logger.info("Sharded over 'model' (%d): %s", len(sharded), sorted(sharded))
        return self.shardings

    def _opt_names(self, optimizer) -> List[str]:
        """The parameter name of each index of ``optimizer.state_dict()``."""
        return [self._names[id(p)] for g in optimizer.param_groups for p in g["params"]]

    def _map_opt(self, opt_sd, optimizer, fn):
        """``fn(sharding, tensor)`` over AdamW's moments in ``opt_sd``."""
        names = self._opt_names(optimizer)
        state = {}
        for i, s in opt_sd["state"].items():
            sh = self.shardings[names[i]]
            state[i] = {k: fn(sh, v) if torch.is_tensor(v) and v.dim() > 0 else v
                        for k, v in s.items()}
        return dict(opt_sd, state=state)

    def fetch(self, model, optimizer=None) -> Optional[Dict[str, Any]]:
        """The whole ``{"model", "optimizer"}`` state dicts (the model's alone
        without ``optimizer``), as a single process saves them. A collective
        of the model group of data index 0, which holds the result; other
        ranks get None (JAX's ``fetch`` is a collective of every process,
        mesh.py:181-193)."""
        if self.n_model > 1 and self.mesh.data_index != 0:
            return None
        gather = lambda s, v: s.gather(self.mesh, v)  # noqa: E731
        model_sd = model.state_dict()
        if self.n_model > 1:
            model_sd = {k: gather(self.shardings[k], v) if k in self.shardings else v
                        for k, v in model_sd.items()}
        if optimizer is None:
            return {"model": model_sd}
        opt_sd = optimizer.state_dict()
        if self.n_model > 1:
            opt_sd = self._map_opt(opt_sd, optimizer, gather)
        return {"model": model_sd, "optimizer": opt_sd}

    def place_like(self, state: Dict[str, Any], optimizer) -> Dict[str, Any]:
        """The rank's blocks of a whole ``{"model", "optimizer"}`` checkpoint
        (mesh.py:164-175): every rank reads the whole file and keeps its own."""
        local = lambda s, v: s.local(self.mesh, v).clone()  # noqa: E731
        return {"model": {k: local(self.shardings[k], v) if k in self.shardings else v
                          for k, v in state["model"].items()},
                "optimizer": self._map_opt(state["optimizer"], optimizer, local)}

    # -- the train step ---------------------------------------------------

    def noise(self, inner, streams: int) -> DataShardNoise:
        """The rank's rows of ``inner``'s global draws; ``streams``: its TBTT
        streams (local B * I)."""
        return DataShardNoise(inner, self.mesh.data_index, self.n_data, streams)

    @torch.no_grad()
    def reduce_gradients(self, params: List[torch.nn.Parameter]) -> None:
        """Average the gradients: a sharded parameter's over 'data', a
        replicated one's over the world (the module docstring says why), in
        flat buckets of up to ``BUCKET_BYTES``."""
        names = self._names
        by_group: Dict[tuple, List[torch.Tensor]] = {}
        for p in params:
            sharded = self.shardings[names[id(p)]].axis == "model"
            by_group.setdefault((sharded, p.grad.dtype), []).append(p.grad)
        for (sharded, _), grads in by_group.items():
            group, n = ((self.mesh.data_group, self.n_data) if sharded
                        else (dist.group.WORLD, world_size()))
            for bucket in _buckets(grads, BUCKET_BYTES):
                flat = all_reduce_(_flatten_dense_tensors(bucket), group).div_(n)
                for g, r in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
                    g.copy_(r)

    def grad_norms(self, grads: Dict[str, List[torch.Tensor]],
                   params: Dict[str, List[torch.nn.Parameter]]) -> Dict[str, torch.Tensor]:
        """Each part's global gradient norm: a sharded parameter's squared
        norm summed over 'model', a replicated one's counted once."""
        names, norms, shard_sq = self._names, {}, []
        for part, gs in grads.items():
            flags = [self.shardings[names[id(p)]].axis == "model" for p in params[part]]
            rep = [g.float().square().sum() for g, f in zip(gs, flags) if not f]
            shd = [g.float().square().sum() for g, f in zip(gs, flags) if f]
            norms[part] = torch.stack(rep).sum() if rep else torch.zeros((), device=gs[0].device)
            shard_sq.append(torch.stack(shd).sum() if shd else None)
        if any(s is not None for s in shard_sq):
            zero = torch.zeros((), device=next(iter(norms.values())).device)
            total = all_reduce_(torch.stack([zero if s is None else s for s in shard_sq]),
                                self.mesh.model_group)
            for (part, sq), s in zip(list(norms.items()), total):
                norms[part] = sq + s
        return {part: sq.sqrt() for part, sq in norms.items()}

    def reduce_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The step's 0-d metrics averaged over 'data' in one call. Those that
        are not means over equal shards were reduced in the forward already,
        so the average leaves them as they are."""
        keys = sorted(metrics)
        stacked = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
        stacked = all_reduce_(stacked, self.mesh.data_group).div_(self.n_data)
        return dict(zip(keys, stacked.unbind()))

    # -- batches ----------------------------------------------------------

    def share_batch(self, item):
        """The model group's batch: its first rank's ``(batch, wid, stats)``
        on every rank of the group (the others pass None), so tensor-parallel
        ranks step on identical data even when a replay reload lands at
        another time on each of them."""
        if self.n_model == 1:
            return item
        first = self.mesh.model_ranks[0]
        if self.mesh.rank == first:
            batch, wid, stats = item
            meta = [(wid, stats, {k: (tuple(v.shape), v.dtype) for k, v in batch.items()})]
        else:
            meta = [None]
        dist.broadcast_object_list(meta, src=first, group=self.mesh.model_group)
        wid, stats, shapes = meta[0]
        if self.mesh.rank != first:
            batch = {k: torch.empty(s, dtype=dt, device=self.device) for k, (s, dt) in shapes.items()}
        for k in shapes:
            broadcast_(batch[k], first, self.mesh.model_group)
        return batch, wid, stats

    def gather_batch(self, tree: Dict[str, torch.Tensor], dim: int = 1
                     ) -> Dict[str, torch.Tensor]:
        """Every data rank's block of each (T, B_local, ...) host tensor,
        concatenated along ``dim``: the global batch (JAX's ``fetch_all`` of
        the dumps). A collective of the data group; the keys go in sorted order,
        the same on every rank whatever the order of the dicts."""
        blocks = Sharding("data", dim)
        out = {}
        for k, v in sorted(tree.items()):
            if v.dtype == torch.bool:  # gathered as bytes
                out[k] = blocks.gather(self.mesh, v.to(torch.uint8)).bool()
            else:
                out[k] = blocks.gather(self.mesh, v)
        return out

