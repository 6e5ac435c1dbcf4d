"""Convert a JAX params tree (nested dicts of arrays) to the port's state_dict and back.

The port's module names follow the JAX param tree, so a parameter's
state_dict key is its JAX path with these rules:

* the flax ``params`` collection levels are dropped;
* the inner flax module of a wrapper (``Dense_0`` inside ``Dense``,
  ``LayerNorm_0`` inside ``Norm``) is dropped;
* the top-level ``actor``, ``critic`` and ``critic_target`` live under ``ac``;
* leaves: Dense ``kernel`` (in,out) -> Linear ``weight`` (out,in); LayerNorm
  ``scale`` -> ``weight``; Conv ``kernel`` HWIO -> OIHW; ConvTranspose
  (``deconv_*``) ``kernel`` HWIO -> PyTorch's (in,out,kh,kw) with a spatial
  flip, because ``lax.conv_transpose`` (``transpose_kernel=False``) correlates
  the dilated input with the kernel as it is while ``conv_transpose2d``
  correlates with the flipped kernel; attention (flax
  ``MultiHeadDotProductAttention``, children ``query``/``key``/``value``/
  ``out`` of an ``attn_*`` module): the 3-D kernels ``(D, heads, head_dim)``
  and, for ``out``, ``(heads, head_dim, D)`` -> Linear ``weight`` over all
  heads, the ``(heads, head_dim)`` biases -> flat. The GRU cells keep JAX's
  names and (in,3H) layout with r,u,n gate columns: ``weight_ih``, ``weight_hh``,
  ``bias_ih``/``bias_hh``, ``ln_scale``/``ln_bias`` (kernel cell) and
  ``lnorm/{scale,bias}`` (``_xla`` cell).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

__all__ = ["jax_to_state_dict", "state_dict_to_jax", "torch_key", "jax_leaf_shape",
           "jax_leaf_shapes", "jax_checkpoint_to_torch"]

_INNER = ("Dense_0", "LayerNorm_0")
_UNDER_AC = ("actor", "critic", "critic_target")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _kind(path: Tuple[str, ...], ndim: int) -> str:
    """How a leaf's array converts: 'linear', 'conv', 'deconv', 'attn_in',
    'attn_out', 'attn_bias' or 'same'."""
    leaf = path[-1]
    if len(path) >= 3 and path[-3].startswith("attn_") and ndim > 1:
        if leaf == "bias":
            return "attn_bias"
        return "attn_out" if path[-2] == "out" else "attn_in"
    if leaf == "kernel":
        if ndim == 2:
            return "linear"
        return "deconv" if path[-2].startswith("deconv_") else "conv"
    return "same"


def torch_key(path: Tuple[str, ...]) -> str:
    """state_dict key of the JAX leaf at ``path``."""
    segs = [s for s in path if s != "params"]
    if segs[0] in _UNDER_AC:
        segs = ["ac"] + segs
    if len(segs) >= 3 and segs[-2] in _INNER:
        del segs[-2]
    if segs[-1] in ("kernel", "scale"):
        segs[-1] = "weight"
    return ".".join(segs)


def jax_leaf_shape(key: str, shape: Tuple[int, ...], heads: int = 0) -> Tuple[int, ...]:
    """The shape of the JAX leaf that the port's parameter ``key`` (of
    ``shape``) converts from, by the rules above read backwards. ``heads``:
    the attention heads of an ``attn_*`` module's parameters."""
    segs, shape = key.split("."), tuple(shape)
    if len(segs) >= 3 and segs[-3].startswith("attn_"):
        if segs[-1] == "weight":
            if segs[-2] == "out":   # (D, heads*head_dim) <- (heads, head_dim, D)
                return (heads, shape[1] // heads, shape[0])
            return (shape[1], heads, shape[0] // heads)   # <- (D, heads, head_dim)
        if segs[-2] != "out":       # flat bias <- (heads, head_dim)
            return (heads, shape[0] // heads)
        return shape
    if segs[-1] == "weight" and len(shape) == 2:     # Linear (out,in) <- Dense (in,out)
        return shape[::-1]
    if segs[-1] == "weight" and len(shape) == 4:
        if segs[-2].startswith("deconv_"):            # (in,out,kh,kw) <- HWIO
            return (shape[2], shape[3], shape[0], shape[1])
        return (shape[2], shape[3], shape[1], shape[0])  # OIHW <- HWIO
    return shape


def jax_leaf_shapes(model: torch.nn.Module) -> Dict[str, Tuple[int, ...]]:
    """``jax_leaf_shape`` of every parameter of ``model``; an ``attn_*``
    module's heads are its ``nhead``."""
    out = {}
    for name, p in model.named_parameters():
        segs = name.split(".")
        heads = 0
        if len(segs) >= 3 and segs[-3].startswith("attn_"):
            heads = model.get_submodule(".".join(segs[:-2])).nhead
        out[name] = jax_leaf_shape(name, tuple(p.shape), heads)
    return out


def _to_torch(kind: str, x: np.ndarray) -> np.ndarray:
    if kind == "linear":
        return x.T
    if kind == "attn_in":   # (D, heads, head_dim) -> (heads*head_dim, D)
        return x.reshape(x.shape[0], -1).T
    if kind == "attn_out":  # (heads, head_dim, D) -> (D, heads*head_dim)
        return x.reshape(-1, x.shape[-1]).T
    if kind == "attn_bias":
        return x.reshape(-1)
    if kind == "conv":
        return x.transpose(3, 2, 0, 1)
    if kind == "deconv":
        return x.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    return x


def _to_jax(kind: str, x: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    if kind == "linear":
        return x.T
    if kind in ("attn_in", "attn_out"):
        return x.T.reshape(shape)
    if kind == "attn_bias":
        return x.reshape(shape)
    if kind == "conv":
        return x.transpose(2, 3, 1, 0)
    if kind == "deconv":
        return x[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
    return x


def _kind_of(path: Tuple[str, ...], ndim: int) -> str:
    segs = tuple(s for s in path if s != "params")
    if len(segs) >= 3 and segs[-2] in _INNER:
        segs = segs[:-2] + segs[-1:]
    return _kind(segs, ndim)


def jax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX params tree -> the port's state_dict (float32 CPU tensors)."""
    out = {}
    for path, leaf in _leaves(params):
        x = np.asarray(leaf)
        key = torch_key(path)
        if key in out:
            raise ValueError(f"two JAX leaves map to {key!r}")
        out[key] = torch.from_numpy(np.array(_to_torch(_kind_of(path, x.ndim), x), copy=True))
    return out


def _read_flax_msgpack(path) -> Dict[str, Any]:
    """A ``flax.serialization.msgpack_serialize`` file -> nested dicts of
    numpy arrays, without flax: an ndarray (and a numpy scalar) is msgpack
    ext record 1 (3) holding ``(shape, dtype name, C-order bytes)``; arrays
    over 2**30 bytes are split into ``{"__msgpack_chunked_array__", "shape",
    "chunks"}`` dicts."""
    import msgpack  # lazily: only the converter needs it

    def ext_hook(code, data):
        if code in (1, 3):
            shape, dtype, buf = msgpack.unpackb(data, raw=True)
            if dtype == b"bfloat16":
                raise ValueError("bfloat16 leaves are not supported; the learner saves float32")
            arr = np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)
            return arr if code == 1 else arr[()]
        return msgpack.ExtType(code, data)

    def unchunk(tree):
        if not isinstance(tree, dict):
            return tree
        if "__msgpack_chunked_array__" in tree:
            chunks = tree["chunks"]
            flat = np.concatenate([chunks[str(i)] for i in range(len(chunks))])
            return flat.reshape(tuple(tree["shape"][str(i)] for i in range(len(tree["shape"]))))
        return {k: unchunk(v) for k, v in tree.items()}

    with open(path, "rb") as f:
        return unchunk(msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False))


JAX_OPT_GROUPS = ("wm", "probe", "actor", "critic")


def jax_checkpoint_to_torch(path, trainstep) -> Dict[str, Any]:
    """A JAX learner checkpoint -> the port's checkpoint for ``trainstep``.

    The JAX file (``pydreamer_tpu/tracking.py::save_checkpoint_file``) is flax
    msgpack of ``{"step", "state": {"params", "opt_state"}}``. ``opt_state`` is
    ``optax.multi_transform``'s state: ``inner_states/<group>/inner_state`` is
    the group's ``chain(clip_by_global_norm, adamw)`` state, whose ``1/0`` is
    ``ScaleByAdamState(count, mu, nu)``; ``mu`` and ``nu`` are shaped like the
    whole params tree with the other groups' subtrees empty. The moments map
    through the parameters' own rule (a Linear moment is transposed like its
    weight, a deconv moment flipped like its kernel) onto AdamW's per-parameter
    ``exp_avg`` and ``exp_avg_sq``; the group's ``count`` becomes ``step``.

    AdamW's state is positional, so the optimizer state is laid out for
    ``trainstep.optimizer`` (its groups and parameter order). Returns
    ``{"step", "model", "optimizer"}``, the layout
    ``pydreamer_tpu_torch/tracking.py`` saves and loads.
    """
    payload = _read_flax_msgpack(path)
    state = payload["state"]
    model = trainstep.model
    model_sd = jax_to_state_dict(state["params"])
    moments = {}
    inner = state["opt_state"]["inner_states"]
    for group in JAX_OPT_GROUPS:
        adam = inner[group]["inner_state"]["1"]["0"]
        count = float(np.asarray(adam["count"]))
        nu = jax_to_state_dict(adam["nu"])
        for name, mu in jax_to_state_dict(adam["mu"]).items():
            moments[name] = {"step": torch.tensor(count), "exp_avg": mu, "exp_avg_sq": nu[name]}

    names = {id(p): n for n, p in model.named_parameters()}
    optimizer = trainstep.optimizer.state_dict()
    opt_state = {}
    for group, saved in zip(trainstep.optimizer.param_groups, optimizer["param_groups"]):
        for p, idx in zip(group["params"], saved["params"]):
            name = names[id(p)]
            if name not in moments:
                raise KeyError(f"the JAX optimizer state has no moments for {name!r}")
            opt_state[idx] = moments[name]
    optimizer["state"] = opt_state
    return {"step": int(payload["step"]), "model": model_sd, "optimizer": optimizer}


def state_dict_to_jax(state_dict: Mapping[str, torch.Tensor], like: Mapping) -> Dict[str, Any]:
    """The port's state_dict -> a JAX params tree shaped like ``like`` (numpy leaves)."""

    def fill(tree: Mapping, prefix: Tuple[str, ...]) -> Dict[str, Any]:
        out = {}
        for k, v in tree.items():
            path = prefix + (str(k),)
            if isinstance(v, Mapping):
                out[k] = fill(v, path)
                continue
            shape = tuple(np.shape(v))
            x = state_dict[torch_key(path)].detach().cpu().numpy()
            out[k] = np.ascontiguousarray(_to_jax(_kind_of(path, len(shape)), x, shape))
        return out

    return fill(like, ())
