"""Kernel K1: the fused DreamerV2 late-reset GRU cell, hand-written for Hopper.

Counterpart of ``pydreamer_tpu/ops/gru_pallas.py`` (the Pallas kernel
``_kernel``/``_forward`` at 49-84, exposed as ``fused_gru_dv2`` with a
``custom_vjp``). One GRU step:

  gates = x @ w_ih + h @ w_hh          (f32 accumulate)
  gates = LayerNorm(gates)             (over 3H, eps 1e-3, learned scale/bias)
  r, u, n = split(gates)
  h' = sigmoid(u-1) * tanh(sigmoid(r)*n) + (1-sigmoid(u-1)) * h   (f32)

* :func:`gru_dv2_reference` is the plain PyTorch version (mirrors
  ``_reference_math``, gru_pallas.py:87-100): upcast to f32, then the same
  math. The CPU path and the tests use it.
* :func:`gru_dv2` dispatches on the tensors' device: on the CPU it runs the
  plain version; on a CUDA tensor it ALWAYS launches a K1 schedule
  (``csrc/gru_dv2.cu``) through :class:`GRUDv2Function`, and a build or
  launch error raises.
* The backward (:class:`GRUDv2Function`, in the ``pd.k1_backward`` span of
  ``tracing.py``) recomputes the gates, as JAX's ``_bwd`` (gru_pallas.py:
  114-119) does, and follows the operands' dtype. bf16 operands take
  :func:`k1_backward`, at the forward's precision: the forward's own
  schedule stopped before its LayerNorm pass recomputes the gates on the
  tensor cores (C entry ``gru_dv2_gates``), one kernel takes the LayerNorm
  and gate backward (``gru_dv2_backward``: the gate gradient dG in bf16,
  the direct term of dh, d_scale and d_bias summed in a fixed order), and
  three products with bf16 operands and f32 sums make dx, dh and dW from
  dG, each only where autograd asks for it. No float32 copy of a weight is
  made; a width whose 4 x 3H floats a block pass the 227 KB of shared
  memory a block may hold (H > 4842) raises at launch, as the forward does
  on a failed launch. float32 operands take autograd through the plain
  version, as before. ``K1_BACKWARDS`` counts the calls by route and rows.
* The weight gradient of an unroll is summed once (:class:`DWBatch`). While
  ``dw_batches()`` is open (``RSSMCore.forward``'s T loop), a K1 cell whose
  weights take a gradient, on the bf16 route on the card, reads its weights
  once, through one :class:`DWSum` node, and hands each step the batch.
  Each step's backward writes its dG into its slot of the batch's stash and
  makes no dW; DWSum's backward, which autograd runs after every step's
  backward (each consumes its outputs), makes ``dW_ih = X^T dG`` and
  ``dW_hh = H^T dG`` over the T*M stacked rows, f32 sums rounded once to
  bf16, and hands them to autograd like any weight gradient (``CopyUse``
  adds each into ``.grad`` in one pass). Every other call (the dream's
  frozen weights, no grad, float32, a lone call) makes its own dW. ``K1_DW``
  counts the calls that needed dW by how it was made, and the sums made.

Schedules. :func:`plan` picks one from (M, In, H, dtype) alone (see the
header of ``csrc/gru_dv2.cu`` for what bounds each and how it is built):

* ``skinny`` - bf16, M <= 64, In % 8 == 0, H % 64 == 0 (the posterior scan,
  M=32): split-N x split-K weight streaming, then a LayerNorm/gate pass;
* ``wide`` - bf16, M > 64, In % 8 == 0, H % 128 == 0 (the dream scan,
  M=1536): warp-specialised wgmma fed by TMA, LayerNorm combined across a
  thread-block cluster when H <= 1024, else a LayerNorm/gate pass;
* ``generic`` - bf16, every other shape: a WMMA GEMM with bounds-checked
  tiles, then the LayerNorm/gate pass;
* ``skinny_f32`` - f32, M <= 64, In % 4 == 0, H % 4 == 0: ``skinny``'s
  split-N x split-K weight streaming over 16-byte cp.async, products in
  3xTF32 on the tensor cores; bound by the f32 weights' bytes (24.9 MB at
  the flagship shape);
* ``wide_f32`` - f32, M > 64, In % 4 == 0, H % 4 == 0: a 128 (or 64) x 96
  tiled GEMM over a 4-stage cp.async ring, 3xTF32 ``mma.sync``, each 32-deep
  slice added into f32 totals, then the pass; bound by
  operations (3 x 19.1 GFLOP of TF32 at M=1536). ``wgmma`` takes .tf32
  operands K-major only, and the weights are MN-major, so it would need a
  transposed copy of them;
* ``f32`` - f32, every other shape (e.g. In=37, H=50): the first design, a
  full-f32 FFMA GEMM, then the pass.

3xTF32 splits each f32 operand v into ``hi = tf32(v)`` and ``lo = tf32(v -
hi)`` (round to nearest, ties away) and sums ``a_lo.b_hi + a_hi.b_lo +
a_hi.b_hi`` in f32: close to f32 accuracy, where one TF32 pass keeps about
three digits (``tests/test_torch_k1_f32_split.py`` emulates it). No
schedule replaces more of JAX than the Pallas kernel ``_kernel``.

The kernels are built from the repo's source at first use with ``nvcc`` for
``sm_90a`` into ``ops/_build/`` (listed in .gitignore) and loaded with ctypes
through a plain C interface, so the build needs neither ninja nor PyTorch's
headers. ``LAUNCHES`` counts launches, in all, by row count and by schedule,
so a run can show that its main path went through the kernel; its fields are
registered with ``tracing.TALLIES``, so a replayed train step credits them.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
import hashlib
import math
import os
import subprocess
from dataclasses import dataclass
from pathlib import Path

import torch

from ..tracing import TALLIES, span

__all__ = ["gru_dv2", "gru_dv2_reference", "gru_dv2_cuda", "GRUDv2Function",
           "LAUNCHES", "K1_BACKWARDS", "SCHEDULES", "Plan", "plan", "pick_schedule", "build",
           "SOURCE", "BUILD_DIR", "NVCC_FLAGS", "backward_route", "backward_rows",
           "k1_backward", "ln_gate_backward_reference", "K1_DW", "KERNEL_DEVICES", "DWBatch",
           "DWSum", "dw_batches", "step_weights"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "gru_dv2.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-ldl")
LN_EPS = 1e-3

# In the order of the C side's Schedule enum.
SCHEDULES = ("generic", "skinny", "wide", "f32", "skinny_f32", "wide_f32")
SKINNY_MAX_ROWS = 64   # at most four m16 row tiles
SKINNY_MAX_KC = 512    # weight rows per skinny block
SKINNY_F32_MAX_KC = 256  # weight rows per skinny_f32 block: three blocks to an SM
WIDE_HB = 128          # hidden units per wide block
WIDE_MAX_CLUSTER = 8   # blocks of a row tile in one cluster (the portable maximum)
BACKWARD_BLOCKS = 256  # blocks of the LayerNorm/gate backward over many rows
KERNEL_DEVICES = ("cuda",)  # the device types on which gru_dv2 launches K1


@dataclass(frozen=True)
class Plan:
    """How one K1 launch runs: its schedule, the K split of ``skinny`` and
    ``skinny_f32`` (``nsplit`` blocks of ``kc`` rows of [w_ih; w_hh]) and
    the f32 workspace it needs, in elements."""
    schedule: str
    nsplit: int = 1
    kc: int = 0
    workspace: int = 0


def pick_schedule(M: int, In: int, H: int, *dtypes: torch.dtype) -> str:
    """The K1 schedule for x (M, In), h (M, H) and operands of ``dtypes``."""
    if len(set(dtypes)) != 1:
        raise TypeError(f"gru_dv2: x, h, w_ih and w_hh must share one dtype, got {dtypes}")
    dtype = dtypes[0]
    if dtype == torch.float32:
        if In % 4 or H % 4:  # the 16-byte copies of skinny_f32 and wide_f32
            return "f32"
        return "skinny_f32" if M <= SKINNY_MAX_ROWS else "wide_f32"
    if dtype != torch.bfloat16:
        raise TypeError(f"gru_dv2: the kernel takes bfloat16 or float32 operands, got {dtype}")
    if In % 8 == 0 and H % 64 == 0 and M <= SKINNY_MAX_ROWS:
        return "skinny"
    if In % 8 == 0 and H % WIDE_HB == 0 and M > SKINNY_MAX_ROWS:
        return "wide"
    return "generic"


@functools.lru_cache(maxsize=256)
def plan(M: int, In: int, H: int, *dtypes: torch.dtype) -> Plan:
    """The schedule, K split and workspace of a launch; cached, as the
    train step asks for the same few shapes every step."""
    schedule = pick_schedule(M, In, H, *dtypes)
    gates = M * 3 * H
    if schedule in ("skinny", "skinny_f32"):
        # kc: the fewest blocks of at most max_kc rows, evened out, in
        # multiples of 64 rows (skinny) or of one 32-row ring stage (skinny_f32).
        K = In + H
        max_kc, step = (SKINNY_MAX_KC, 64) if schedule == "skinny" else (SKINNY_F32_MAX_KC, 32)
        kc = step * math.ceil(K / math.ceil(K / max_kc) / step)
        nsplit = math.ceil(K / kc)
        return Plan(schedule, nsplit, kc, nsplit * gates)
    if schedule == "wide":
        return Plan(schedule, workspace=0 if H // WIDE_HB <= WIDE_MAX_CLUSTER else gates)
    return Plan(schedule, workspace=gates)


class _LaunchCounter:
    """Number of K1 launches since the last ``reset()``: in all, by row count
    M and by schedule."""

    def __init__(self):
        self.reset()

    def add(self, rows: int, schedule: str) -> None:
        self.count += 1
        self.by_rows[rows] = self.by_rows.get(rows, 0) + 1
        self.by_schedule[schedule] = self.by_schedule.get(schedule, 0) + 1

    def reset(self) -> None:
        self.count = 0
        self.by_rows: dict[int, int] = {}
        self.by_schedule: dict[str, int] = {}


class _BackwardCounter:
    """K1 backward calls since the last ``reset()``, by route (``kernel``: the
    bf16 pass of :func:`k1_backward`; ``plain``: autograd through the plain
    version) and by row count M."""

    def __init__(self):
        self.reset()

    def add(self, rows: int, route: str) -> None:
        self.by_route[route] = self.by_route.get(route, 0) + 1
        self.by_rows[rows] = self.by_rows.get(rows, 0) + 1

    def reset(self) -> None:
        self.by_route: dict[str, int] = {}
        self.by_rows: dict[int, int] = {}


class _DWCounter:
    """Since the last ``reset()``: K1 backward calls that needed a weight
    gradient, by how it was made (``by_path``: ``batched``, a slot of an
    unroll's :class:`DWBatch`; ``per_call``, the call's own products), and
    ``products``, the batches summed (each one dW_ih and one dW_hh)."""

    def __init__(self):
        self.reset()

    def add(self, path: str) -> None:
        self.by_path[path] = self.by_path.get(path, 0) + 1

    def reset(self) -> None:
        self.by_path: dict[str, int] = {}
        self.products = 0


LAUNCHES = TALLIES.register(_LaunchCounter(), "count", "by_rows", "by_schedule")
K1_BACKWARDS = TALLIES.register(_BackwardCounter(), "by_route", "by_rows")
K1_DW = TALLIES.register(_DWCounter(), "by_path", "products")
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


def build(source: Path = SOURCE) -> Path:
    """Compile ``source`` (``csrc/gru_dv2.cu`` by default; if not built yet)
    and return the library path.

    The library name carries a hash of the source and flags, so an edited
    source is rebuilt. nvcc's output (``-Xptxas -v``: registers, shared
    memory, spills) is kept beside it as ``<name>.log``.
    """
    from torch.utils.cpp_extension import CUDA_HOME

    src = source.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{source.stem}_{digest}.so"
    if lib_path.exists():
        return lib_path
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME or put nvcc on PATH)")
    nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)]
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
        lib.gru_dv2_forward.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                                        + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.gru_dv2_forward.restype = ctypes.c_int
        lib.gru_dv2_gates.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                                      + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.gru_dv2_gates.restype = ctypes.c_int
        lib.gru_dv2_backward.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 8
                                         + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.gru_dv2_backward.restype = ctypes.c_int
        lib.gru_dv2_error_string.argtypes = [ctypes.c_int]
        lib.gru_dv2_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"gru_dv2: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"gru_dv2: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"gru_dv2: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"gru_dv2: {name} must be contiguous")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or a copy when its data does not start on 16 bytes (TMA
    and 16-byte cp.async need that; a view into a larger tensor may not)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def gru_dv2_cuda(x, h, w_ih, w_hh, scale, bias) -> torch.Tensor:
    """Launch K1 on CUDA tensors (no autograd). Returns h' (M, H) float32."""
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"gru_dv2_cuda takes CUDA tensors, got {device}")
    M, In = x.shape
    H = h.shape[-1]
    p = plan(M, In, H, x.dtype, h.dtype, w_ih.dtype, w_hh.dtype)
    dt = x.dtype
    _check("x", x, dt, (M, In), device)
    _check("h", h, dt, (M, H), device)
    _check("w_ih", w_ih, dt, (In, 3 * H), device)
    _check("w_hh", w_hh, dt, (H, 3 * H), device)
    _check("scale", scale, torch.float32, (3 * H,), device)
    _check("bias", bias, torch.float32, (3 * H,), device)
    return _launch(p, *map(_aligned, (x, h, w_ih, w_hh)), scale, bias)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _call(entry: str, what: str, device, *args) -> None:
    """Call the library's ``entry`` with ``args`` and the current stream of
    ``device``, on that device; raise on an error code."""
    lib = _load()
    args = (*args, torch.cuda.current_stream(device).cuda_stream)
    if device.index in (None, torch.cuda.current_device()):
        err = getattr(lib, entry)(*args)
    else:  # the kernels launch on the current device
        with torch.cuda.device(device):
            err = getattr(lib, entry)(*args)
    if err != 0:
        raise RuntimeError(f"gru_dv2 {what} launch failed: {lib.gru_dv2_error_string(err).decode()}")


def _launch(p: Plan, x, h, w_ih, w_hh, scale, bias) -> torch.Tensor:
    """Launch the schedule of ``p`` on checked CUDA tensors."""
    device, (M, In), H = x.device, x.shape, h.shape[-1]
    work = torch.empty((p.workspace,), dtype=torch.float32, device=device) if p.workspace else None
    out = torch.empty((M, H), dtype=torch.float32, device=device)
    _call("gru_dv2_forward", p.schedule, device, SCHEDULES.index(p.schedule), x.data_ptr(),
          h.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), scale.data_ptr(), bias.data_ptr(),
          _ptr(work), out.data_ptr(), M, In, H, p.nsplit, p.kc)
    LAUNCHES.add(M, p.schedule)
    return out


def backward_route(dtype: torch.dtype) -> str:
    """K1's backward for operands of ``dtype``: ``kernel`` (the bf16 pass,
    :func:`k1_backward`) for bfloat16, else ``plain`` (autograd through the
    plain version)."""
    return "kernel" if dtype == torch.bfloat16 else "plain"


def backward_rows(M: int) -> int:
    """Rows one block of the LayerNorm/gate backward takes: one for the few
    rows of the posterior loop (each row its block), else enough rows that
    about ``BACKWARD_BLOCKS`` blocks cover M (the dream's 1024-1536)."""
    return 1 if M <= SKINNY_MAX_ROWS else math.ceil(M / BACKWARD_BLOCKS)


def _recompute_gates(x, h, w_ih, w_hh) -> torch.Tensor:
    """K1's pre-norm gates x @ w_ih + h @ w_hh on bf16 CUDA operands, from the
    schedule K1's forward runs at the shape, stopped before its LayerNorm
    pass -> (nsplit, M, 3H) float32 partial sums (``skinny``'s K split; one
    for ``wide`` and ``generic``): the sums the forward normalised."""
    M, In = x.shape
    H = h.shape[-1]
    p = plan(M, In, H, x.dtype, h.dtype, w_ih.dtype, w_hh.dtype)
    parts = torch.empty((p.nsplit, M, 3 * H), dtype=torch.float32, device=x.device)
    x, h, w_ih, w_hh = map(_aligned, (x, h, w_ih, w_hh))
    _call("gru_dv2_gates", f"{p.schedule} gates", x.device, SCHEDULES.index(p.schedule),
          x.data_ptr(), h.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), parts.data_ptr(),
          M, In, H, p.nsplit, p.kc)
    return parts


def _ln_gate_backward_cuda(parts, h, scale, bias, grad_out, want_dh: bool, want_params: bool,
                           dG=None):
    """The LayerNorm/gate backward kernel -> dG (M, 3H) bf16 (into ``dG``
    where given, contiguous), the direct dh term (M, H) f32 or None, d_scale
    and d_bias (3H) f32 or None."""
    M, H = h.shape
    N, device = 3 * H, h.device
    rows = backward_rows(M)
    blocks = math.ceil(M / rows)
    if dG is None:
        dG = torch.empty((M, N), dtype=torch.bfloat16, device=device)
    dh = torch.empty((M, H), dtype=torch.float32, device=device) if want_dh else None
    param_parts = dparams = None
    if want_params:
        param_parts = torch.empty((blocks, 2, N), dtype=torch.float32, device=device)
        dparams = torch.empty((2, N), dtype=torch.float32, device=device)
    _call("gru_dv2_backward", "LayerNorm/gate backward", device, parts.data_ptr(), parts.shape[0],
          h.data_ptr(), scale.data_ptr(), bias.data_ptr(), grad_out.data_ptr(), dG.data_ptr(),
          _ptr(dh), _ptr(param_parts), _ptr(dparams), M, H, rows)
    return (dG, dh) + ((dparams[0], dparams[1]) if want_params else (None, None))


def ln_gate_backward_reference(gates, h, scale, bias, grad_out):
    """Plain version of the LayerNorm/gate backward kernel, in float32: from
    the pre-norm gates (M, 3H), h, scale, bias and dL/dh' -> the gate
    gradient dG (M, 3H), the direct term of dh ``(1 - update) * dL/dh'``
    (M, H), d_scale and d_bias (3H)."""
    g = gates.float()
    mean = g.mean(-1, keepdim=True)
    rstd = torch.rsqrt((g - mean).square().mean(-1, keepdim=True) + LN_EPS)
    gn = (g - mean) * rstd
    r, u, n = (gn * scale.float() + bias.float()).chunk(3, -1)
    reset = torch.sigmoid(r)
    update = torch.sigmoid(u - 1.0)
    t = torch.tanh(reset * n)
    go = grad_out.float()
    dt = go * update * (1.0 - t * t)
    dy = torch.cat([dt * n * reset * (1.0 - reset),
                    go * (t - h.float()) * update * (1.0 - update),
                    dt * reset], -1)
    dgn = dy * scale.float()
    dG = rstd * (dgn - dgn.mean(-1, keepdim=True) - gn * (dgn * gn).mean(-1, keepdim=True))
    return dG, (1.0 - update) * go, (dy * gn).sum(0), dy.sum(0)


def _mm_f32(a, b, acc=None) -> torch.Tensor:
    """a @ b (+ acc) as float32: the operands' own dtype on the tensor cores,
    f32 sums, an f32 result."""
    if a.is_cuda and a.dtype != torch.float32:
        if acc is None:
            return torch.mm(a, b, out_dtype=torch.float32)
        return torch.addmm(acc, a, b, out_dtype=torch.float32)
    out = a.float() @ b.float()  # the CPU's plain version
    return out if acc is None else out + acc


def _dw(a, dG) -> torch.Tensor:
    """a^T dG in the operands' dtype: cuBLAS sums in f32 and rounds once; the
    CPU's plain version likewise."""
    return torch.mm(a.t(), dG) if a.is_cuda else _mm_f32(a.t(), dG).to(a.dtype)


def k1_backward(x, h, w_ih, w_hh, scale, bias, grad_out, needs, dG_out=None) -> list:
    """K1's backward at the operands' precision -> the gradients of (x, h,
    w_ih, w_hh, scale, bias), None where ``needs`` (autograd's
    ``needs_input_grad``) does not ask for one.

    The gates are recomputed as the forward computed them; the LayerNorm and
    gate backward gives dG, rounded to the operands' dtype, the one new
    rounding; then dx = dG w_ih^T, dh = (1 - update) dL/dh' + dG w_hh^T,
    dw_ih = x^T dG and dw_hh = h^T dG, with f32 sums, each rounded once to
    its leaf's dtype. On CUDA (bf16) the first two steps are K1's kernels; on
    the CPU their plain versions, the same arithmetic. dG is written into
    ``dG_out`` (M, 3H) where given (a slot of a :class:`DWBatch`).
    """
    grads = [None] * 6
    dt = x.dtype
    if x.is_cuda:
        dG, dh_term, d_scale, d_bias = _ln_gate_backward_cuda(
            _recompute_gates(x, h, w_ih, w_hh), h, scale, bias, grad_out.float().contiguous(),
            needs[1], needs[4] or needs[5], dG_out)
    else:
        gates = _mm_f32(x, w_ih) + _mm_f32(h, w_hh)
        dG, dh_term, d_scale, d_bias = ln_gate_backward_reference(gates, h, scale, bias, grad_out)
        dG = dG.to(dt) if dG_out is None else dG_out.copy_(dG)
    if needs[0]:
        grads[0] = _mm_f32(dG, w_ih.t()).to(dt)
    if needs[1]:
        grads[1] = _mm_f32(dG, w_hh.t(), dh_term).to(dt)
    for i, a in ((2, x), (3, h)):
        if needs[i]:  # K = M rows
            grads[i] = _dw(a, dG)
    if needs[4]:
        grads[4] = d_scale
    if needs[5]:
        grads[5] = d_bias
    return grads


class DWBatch:
    """One K1 cell's weight gradient over an unroll, summed once: the steps'
    inputs x and h (``take``, in the forward) and a stash of their gate
    gradients, slot t for step t (``slot``, in each step's backward; zeros
    where a step's backward never ran), which ``sum`` turns into dW_ih and
    dW_hh. It holds no tensor with autograd history, so no reference cycle
    runs through the graph."""

    def __init__(self):
        self.xs, self.hs = [], []
        self.stash = None

    def take(self, x, h) -> int:
        """Note step t's operands -> t."""
        if self.xs and x.shape != self.xs[0].shape:
            raise ValueError(f"a K1 batch takes one shape a step: {tuple(x.shape)} after "
                             f"{tuple(self.xs[0].shape)}")
        self.xs.append(x.detach())
        self.hs.append(h.detach())
        return len(self.xs) - 1

    def slot(self, t: int, dG_shape, dtype, device) -> torch.Tensor:
        """Step t's (M, 3H) slot of the stash, made (zeros) at the first call."""
        if self.stash is None:
            self.stash = torch.zeros((len(self.xs), *dG_shape), dtype=dtype, device=device)
        return self.stash[t]

    def sum(self, needs) -> list:
        """[X^T dG, H^T dG] over the stacked T*M rows, None where ``needs``
        does not ask or no step's backward ran; the stash goes, so that a
        second backward starts from zeros."""
        if self.stash is None:
            return [None, None]
        dG = self.stash.flatten(0, 1)
        self.stash = None
        K1_DW.products += 1
        return [_dw(torch.cat(rows), dG) if need else None
                for rows, need in ((self.xs, needs[0]), (self.hs, needs[1]))]


class DWSum(torch.autograd.Function):
    """The node through which an unroll's K1 weights enter its loop: forward,
    the weights themselves; backward, after every step's (each consumes
    them, and hands back no weight gradient), the batch's one sum
    (:meth:`DWBatch.sum`) in a ``pd.k1_backward`` span."""

    @staticmethod
    def forward(ctx, batch, w_ih, w_hh):
        ctx.batch = batch
        ctx.set_materialize_grads(False)
        return w_ih, w_hh

    @staticmethod
    def backward(ctx, *grads):
        with span("pd.k1_backward"):
            return (None, *ctx.batch.sum(ctx.needs_input_grad[1:]))


_UNROLL: contextvars.ContextVar = contextvars.ContextVar("k1_unroll", default=None)


@contextlib.contextmanager
def dw_batches():
    """Open for an unroll's loop: each K1 cell stepped inside takes its
    weights from ``step_weights`` once, with a :class:`DWBatch`."""
    token = _UNROLL.set({})
    try:
        yield
    finally:
        _UNROLL.reset(token)


def step_weights(key, x, masters, weights) -> tuple:
    """(w_ih, w_hh, batch) for one step of the K1 cell ``key``, whose
    ``weights()`` gives its gate weights in x's dtype and ``masters`` are the
    parameters behind them. Inside ``dw_batches()``, on the bf16 route of a
    device that launches K1, with a gradient asked of a master: the weights
    read once an unroll, through :class:`DWSum`, and the cell's batch, the
    same at every step. Otherwise ``weights()`` at each step, and None."""
    unroll = _UNROLL.get()
    if (unroll is None or x.device.type not in KERNEL_DEVICES
            or backward_route(x.dtype) != "kernel" or not torch.is_grad_enabled()
            or not any(p.requires_grad for p in masters)):
        return (*weights(), None)
    if key not in unroll:
        batch = DWBatch()
        unroll[key] = (*DWSum.apply(batch, *weights()), batch)
    return unroll[key]


class GRUDv2Function(torch.autograd.Function):
    """Forward = the K1 kernel; backward = :func:`k1_backward` for bf16
    operands, autograd through the plain version otherwise
    (:func:`backward_route`). With a ``batch`` (:class:`DWBatch`) the step
    writes its dG into its slot and returns no weight gradient: the batch's
    :class:`DWSum` makes it."""

    @staticmethod
    def forward(ctx, x, h, w_ih, w_hh, scale, bias, batch=None):
        ctx.save_for_backward(x, h, w_ih, w_hh, scale, bias)
        ctx.batch, ctx.slot = batch, None if batch is None else batch.take(x, h)
        return gru_dv2_cuda(x, h, w_ih, w_hh, scale, bias)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = ctx.saved_tensors
        needs = ctx.needs_input_grad[:6]
        wanted = [i for i, need in enumerate(needs) if need]
        grads = [None] * (len(inputs) + 1)
        if not wanted:
            return tuple(grads)
        route = backward_route(inputs[0].dtype)
        K1_BACKWARDS.add(grad_out.shape[0], route)
        batch = ctx.batch
        if needs[2] or needs[3]:
            K1_DW.add("per_call" if batch is None else "batched")
        with span("pd.k1_backward"):
            if route == "kernel":
                if batch is None:
                    return (*k1_backward(*inputs, grad_out, needs), None)
                x, w_ih = inputs[0], inputs[2]
                dG = batch.slot(ctx.slot, (x.shape[0], w_ih.shape[1]), x.dtype, x.device)
                return (*k1_backward(*inputs, grad_out, (*needs[:2], False, False, *needs[4:]),
                                     dG), None)
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(i in wanted) for i, t in enumerate(inputs)]
                out = gru_dv2_reference(*leaves)
                got = torch.autograd.grad(out, [leaves[i] for i in wanted], grad_out)
        for i, g in zip(wanted, got):
            grads[i] = g
        return tuple(grads)


def gru_dv2(x, h, w_ih, w_hh, scale, bias, batch=None) -> torch.Tensor:
    """Fused late-reset GRU step -> new hidden state (M, H) float32.

    CPU tensors take the plain version; tensors of ``KERNEL_DEVICES`` (CUDA)
    always launch K1, with ``batch`` (:func:`step_weights`) where given.
    """
    if x.device.type in KERNEL_DEVICES:
        return GRUDv2Function.apply(x, h, w_ih, w_hh, scale, bias, batch)
    if x.device.type == "cpu":
        return gru_dv2_reference(x, h, w_ih, w_hh, scale, bias)
    raise ValueError(f"gru_dv2 has no path for device {x.device}")
