"""Native (C++) host components, loaded via ctypes.

``load_npz`` is the parallel npz reader backed by ``native/npz_reader.cc``
(a copy of the JAX package's source; host code, not a device kernel). The
shared library is built with ``g++`` at first use into ``native/_build/``
(git-ignored), named by a hash of the source. Where it cannot be built or
loaded (no compiler, no zlib headers) ``np.load`` reads the files instead;
``reader_name()`` says which reader is in use, and the choice is logged once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..tools import logger

__all__ = ["load_npz", "native_available", "reader_name"]

_SRC = Path(__file__).parent / "npz_reader.cc"
BUILD_DIR = Path(__file__).parent / "_build"
_lock = threading.Lock()
_lib = None
_lib_failed = False


def _build_lib() -> Optional[ctypes.CDLL]:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so_path = BUILD_DIR / f"libnpz_reader_{digest}.so"
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Build under a private name, then rename: concurrent processes never
        # load a half-written library.
        tmp = so_path.with_suffix(f".tmp{os.getpid()}.so")
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
               str(_SRC), "-o", str(tmp), "-lz", "-lpthread"]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            logger.warning("Native npz reader build failed (%s); using np.load", e)
            return None
        os.replace(tmp, so_path)
        logger.info("Built native npz reader: %s", so_path)
    try:
        lib = ctypes.CDLL(str(so_path))
    except OSError as e:
        logger.warning("Native npz reader load failed (%s); using np.load", e)
        return None
    lib.npz_open.restype = ctypes.c_void_p
    lib.npz_open.argtypes = [ctypes.c_char_p]
    lib.npz_count.restype = ctypes.c_int
    lib.npz_count.argtypes = [ctypes.c_void_p]
    lib.npz_name.restype = ctypes.c_char_p
    lib.npz_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.npz_uncomp_size.restype = ctypes.c_longlong
    lib.npz_uncomp_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.npz_read_all.restype = ctypes.c_int
    lib.npz_read_all.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_void_p), ctypes.c_int]
    lib.npz_close.argtypes = [ctypes.c_void_p]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is None and not _lib_failed:
            _lib = _build_lib()
            _lib_failed = _lib is None
            logger.info("npz reader in use: %s", reader_name())
    return _lib


def native_available() -> bool:
    return _get_lib() is not None


def reader_name() -> str:
    """``"native"`` or ``"np.load"``: the reader ``load_npz`` uses."""
    return "native" if native_available() else "np.load"


def _parse_npy(buf: bytes) -> np.ndarray:
    """Parse a .npy byte buffer (header + data) into an ndarray view."""
    import ast
    if buf[:6] != b"\x93NUMPY":
        raise ValueError("not an npy stream")
    major = buf[6]
    if major == 1:
        hlen = int.from_bytes(buf[8:10], "little")
        off = 10 + hlen
        header = buf[10:off]
    else:
        hlen = int.from_bytes(buf[8:12], "little")
        off = 12 + hlen
        header = buf[12:off]
    meta = ast.literal_eval(header.decode("latin1").strip())
    dtype = np.dtype(meta["descr"])
    shape = tuple(meta["shape"])
    arr = np.frombuffer(buf, dtype=dtype, count=int(np.prod(shape)) if shape else 1,
                        offset=off)
    arr = arr.reshape(shape)
    if meta.get("fortran_order"):
        arr = arr.reshape(shape[::-1]).T
    return arr


def _np_load(path) -> Dict[str, np.ndarray]:
    with np.load(path) as npz:
        return {k: npz[k] for k in npz.files}


def load_npz(path, nthreads: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Load an npz with parallel native inflate; np.load where the native
    reader is unavailable or rejects the file.

    ``nthreads=None`` takes one thread per entry, at most cpu_count-1.
    Episode files are dominated by one big image entry (one zlib stream, not
    splittable), so extra threads only help multi-entry files.
    """
    lib = _get_lib()
    if lib is None:
        return _np_load(path)
    handle = lib.npz_open(str(path).encode())
    if not handle:
        return _np_load(path)
    try:
        n = lib.npz_count(handle)
        names = [lib.npz_name(handle, i).decode() for i in range(n)]
        sizes = [lib.npz_uncomp_size(handle, i) for i in range(n)]
        bufs = [bytearray(s) for s in sizes]
        ptrs = (ctypes.c_void_p * n)(*[
            ctypes.cast((ctypes.c_char * len(b)).from_buffer(b), ctypes.c_void_p)
            for b in bufs])
        if nthreads is None:
            nthreads = max(1, min(n, (os.cpu_count() or 2) - 1))
        rc = lib.npz_read_all(handle, ptrs, nthreads)
        if rc != 0:
            logger.warning("Native npz read failed rc=%d for %s; using np.load", rc, path)
            return _np_load(path)
        out = {}
        for name, buf in zip(names, bufs):
            key = name[:-4] if name.endswith(".npy") else name
            out[key] = _parse_npy(buf)  # zero-copy view over the bytearray
        return out
    finally:
        lib.npz_close(handle)
