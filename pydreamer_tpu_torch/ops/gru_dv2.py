"""Kernel K1: the fused DreamerV2 late-reset GRU cell, hand-written for Hopper.

Counterpart of ``pydreamer_tpu/ops/gru_pallas.py`` (the Pallas kernel
``_kernel``/``_forward`` at 49-84, exposed as ``fused_gru_dv2`` with a
``custom_vjp``). One GRU step:

  gates = x @ w_ih + h @ w_hh          (bf16 operands, f32 accumulate)
  gates = LayerNorm(gates)             (over 3H, eps 1e-3, learned scale/bias)
  r, u, n = split(gates)
  h' = sigmoid(u-1) * tanh(sigmoid(r)*n) + (1-sigmoid(u-1)) * h   (f32)

* :func:`gru_dv2_reference` is the plain PyTorch version (mirrors
  ``_reference_math``, gru_pallas.py:87-100): upcast to f32, then the same
  math. The CPU path and the tests use it.
* :func:`gru_dv2` dispatches on the tensors' device: on the CPU it runs the
  plain version; on a CUDA tensor it ALWAYS launches the CUDA kernel
  (``csrc/gru_dv2.cu``) through :class:`GRUDv2Function` — no shape fallback,
  and a build or launch error raises.
* The backward recomputes through the plain version (as JAX's ``_bwd``,
  gru_pallas.py:114-119, recomputes through plain XLA); there is no backward
  kernel.

The kernel is built from the repo's source at first use with ``nvcc`` for
``sm_90a`` into ``ops/_build/`` (listed in .gitignore) and loaded with ctypes
through a plain C interface, so the build needs neither ninja nor PyTorch's
headers. ``LAUNCHES.count`` counts kernel launches so a run can show that its
main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

__all__ = ["gru_dv2", "gru_dv2_reference", "gru_dv2_cuda", "GRUDv2Function",
           "LAUNCHES", "build", "SOURCE", "BUILD_DIR", "NVCC_FLAGS"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "gru_dv2.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LN_EPS = 1e-3


class _LaunchCounter:
    """Number of K1 launches since the last ``reset()``, in all and by row count M."""

    def __init__(self):
        self.count = 0
        self.by_rows: dict[int, int] = {}

    def add(self, rows: int) -> None:
        self.count += 1
        self.by_rows[rows] = self.by_rows.get(rows, 0) + 1

    def reset(self) -> None:
        self.count = 0
        self.by_rows = {}


LAUNCHES = _LaunchCounter()
_lib = None


def gru_dv2_reference(x, h, w_ih, w_hh, scale, bias) -> torch.Tensor:
    """Plain PyTorch late-reset GRU step -> new hidden state (M, H) float32."""
    gates = x.float() @ w_ih.float() + h.float() @ w_hh.float()
    mean = gates.mean(-1, keepdim=True)
    var = (gates - mean).square().mean(-1, keepdim=True)
    gates = (gates - mean) * torch.rsqrt(var + LN_EPS)
    gates = gates * scale.float() + bias.float()
    r, u, n = gates.chunk(3, -1)
    reset = torch.sigmoid(r)
    update = torch.sigmoid(u - 1.0)
    newval = torch.tanh(reset * n)
    return update * newval + (1.0 - update) * h.float()


def build() -> Path:
    """Compile ``csrc/gru_dv2.cu`` (if not built yet) and return the library path.

    The library name carries a hash of the source and flags, so an edited
    source is rebuilt. nvcc's output (``-Xptxas -v``: registers, shared
    memory, spills) is kept beside it as ``<name>.log``.
    """
    from torch.utils.cpp_extension import CUDA_HOME

    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libgru_dv2_{digest}.so"
    if lib_path.exists():
        return lib_path
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME or put nvcc on PATH)")
    nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    lib_path.with_suffix(".log").write_text(" ".join(cmd) + "\n" + log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, lib_path)
    return lib_path


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.gru_dv2_forward.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.gru_dv2_forward.restype = ctypes.c_int
        lib.gru_dv2_error_string.argtypes = [ctypes.c_int]
        lib.gru_dv2_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"gru_dv2: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"gru_dv2: {name} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"gru_dv2: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"gru_dv2: {name} must be contiguous")


def gru_dv2_cuda(x, h, w_ih, w_hh, scale, bias) -> torch.Tensor:
    """Launch K1 on CUDA tensors (no autograd). Returns h' (M, H) float32."""
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"gru_dv2_cuda takes CUDA tensors, got {device}")
    M, In = x.shape
    H = h.shape[-1]
    bf16 = torch.bfloat16
    _check("x", x, bf16, (M, In), device)
    _check("h", h, bf16, (M, H), device)
    _check("w_ih", w_ih, bf16, (In, 3 * H), device)
    _check("w_hh", w_hh, bf16, (H, 3 * H), device)
    _check("scale", scale, torch.float32, (3 * H,), device)
    _check("bias", bias, torch.float32, (3 * H,), device)
    lib = _load()
    gates = torch.empty((M, 3 * H), dtype=torch.float32, device=device)
    out = torch.empty((M, H), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.gru_dv2_forward(
            x.data_ptr(), h.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), gates.data_ptr(), out.data_ptr(),
            M, In, H, stream)
    if err != 0:
        raise RuntimeError(f"gru_dv2 kernel launch failed: {lib.gru_dv2_error_string(err).decode()}")
    LAUNCHES.add(M)
    return out


class GRUDv2Function(torch.autograd.Function):
    """Forward = the K1 kernel; backward = autograd through the plain version."""

    @staticmethod
    def forward(ctx, x, h, w_ih, w_hh, scale, bias):
        ctx.save_for_backward(x, h, w_ih, w_hh, scale, bias)
        return gru_dv2_cuda(x, h, w_ih, w_hh, scale, bias)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = ctx.saved_tensors
        wanted = [i for i, need in enumerate(ctx.needs_input_grad) if need]
        grads = [None] * len(inputs)
        if not wanted:
            return tuple(grads)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(i in wanted) for i, t in enumerate(inputs)]
            out = gru_dv2_reference(*leaves)
            got = torch.autograd.grad(out, [leaves[i] for i in wanted], grad_out)
        for i, g in zip(wanted, got):
            grads[i] = g
        return tuple(grads)


def gru_dv2(x, h, w_ih, w_hh, scale, bias) -> torch.Tensor:
    """Fused late-reset GRU step -> new hidden state (M, H) float32.

    CPU tensors take the plain version; CUDA tensors always launch K1.
    """
    if x.device.type == "cpu":
        return gru_dv2_reference(x, h, w_ih, w_hh, scale, bias)
    if x.device.type == "cuda":
        return GRUDv2Function.apply(x, h, w_ih, w_hh, scale, bias)
    raise ValueError(f"gru_dv2 has no path for device {x.device}")
