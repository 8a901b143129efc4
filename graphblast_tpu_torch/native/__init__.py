"""ctypes bindings for the native C++ ingest runtime (counterpart of
graphblast_tpu/native; the source is this package's own graphio.cpp).

The library compiles with g++ at its first use into graphblast_tpu_torch/
_build/ (not tracked by git), under a file name that hashes the source and
the flags, so an edited source is rebuilt and a current library is reused.
A failed build or load raises, with the compiler's output. GRB_NATIVE=0 (or
"false") in the environment, read at each call, turns the native path off:
every entry then returns None, and io.mmio takes its NumPy path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "graphio.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None

_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)


def disabled() -> bool:
    """Whether GRB_NATIVE turns the native path off."""
    return os.environ.get("GRB_NATIVE", "1") in ("0", "false")


def library_path() -> str:
    """Where the library is built: its name hashes the flags and the
    source."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libgraphio-{h.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    """Compile graphio.cpp to `out` through a temporary file, so a process
    that loads the library at the same time never reads half of it."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        run = subprocess.run(["g++", *GXX_FLAGS, _SRC, "-o", tmp],
                             capture_output=True, text=True, timeout=300)
        if run.returncode != 0:
            raise RuntimeError(f"g++ failed to build {_SRC} (exit "
                               f"{run.returncode}):\n{run.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    """The loaded native library, built first if needed; None when
    GRB_NATIVE turns it off. Raises when it does not build or load."""
    global _lib
    if disabled():
        return None
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        lib.gb_read_mtx.restype = ctypes.c_int
        lib.gb_read_mtx.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            _i64p, _i64p, _i64p,
            ctypes.POINTER(_i64p), ctypes.POINTER(_i64p),
            ctypes.POINTER(_f64p)]
        lib.gb_canonicalize.restype = ctypes.c_int64
        lib.gb_canonicalize.argtypes = [
            _i64p, _i64p, _f64p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(_i64p), ctypes.POINTER(_i64p),
            ctypes.POINTER(_f64p)]
        lib.gb_free.restype = None
        lib.gb_free.argtypes = [ctypes.c_void_p]
        lib.gb_coo_to_csr.restype = ctypes.c_int
        lib.gb_coo_to_csr.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            _i64p, _i64p, _f64p, _i64p, _i64p, _f64p]
        _lib = lib
        return _lib


def _steal(lib, ptr, n, np_dtype, ct):
    """Copy n entries of a malloc'd array the library returned, then free
    it."""
    arr = np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ct)),
                                shape=(n,)).copy() if n else np.empty(
                                    0, np_dtype)
    lib.gb_free(ptr)
    return arr.astype(np_dtype, copy=False)


def read_mtx_native(path: str, directed: int = 0,
                    remove_self_loops: bool = True):
    """Native readMtx (reference: util.hpp:364-430 semantics): (rows, cols,
    vals, nrows, ncols) of the canonical COO, int64, int64, float64; None
    when the native path is off or the library refuses the file (an array
    format, a bad banner), so that the NumPy path reads it or says why
    not."""
    lib = get_lib()
    if lib is None:
        return None
    nr, nc, nv = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    rp, cp, vp = _i64p(), _i64p(), _f64p()
    rc = lib.gb_read_mtx(path.encode(), directed, int(remove_self_loops),
                         ctypes.byref(nr), ctypes.byref(nc), ctypes.byref(nv),
                         ctypes.byref(rp), ctypes.byref(cp), ctypes.byref(vp))
    if rc != 0:
        return None
    n = nv.value
    rows = _steal(lib, rp, n, np.int64, ctypes.c_int64)
    cols = _steal(lib, cp, n, np.int64, ctypes.c_int64)
    vals = _steal(lib, vp, n, np.float64, ctypes.c_double)
    return rows, cols, vals, nr.value, nc.value


def canonicalize_native(rows, cols, vals, undirected: bool,
                        remove_self_loops: bool):
    """Native canonicalize_coo: (rows, cols, vals) int64, int64, float64;
    None when the native path is off."""
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(vals, np.float64)
    rp, cp, vp = _i64p(), _i64p(), _f64p()
    n = lib.gb_canonicalize(
        rows.ctypes.data_as(_i64p), cols.ctypes.data_as(_i64p),
        vals.ctypes.data_as(_f64p), len(rows), int(undirected),
        int(remove_self_loops), ctypes.byref(rp), ctypes.byref(cp),
        ctypes.byref(vp))
    r = _steal(lib, rp, n, np.int64, ctypes.c_int64)
    c = _steal(lib, cp, n, np.int64, ctypes.c_int64)
    v = _steal(lib, vp, n, np.float64, ctypes.c_double)
    return r, c, v


def coo_to_csr_native(rows, cols, vals, nrows: int, ncols: int):
    """Native O(m + n) radix coo2csr (reference: util.hpp:501-559):
    (row_ptr int64, cols int64, vals float64), rows sorted by column
    within; None when the native path is off or an id lies outside
    nrows × ncols."""
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals64 = np.ascontiguousarray(vals, np.float64)
    m = len(rows)
    row_ptr = np.zeros(nrows + 1, np.int64)
    cols_out = np.empty(m, np.int64)
    vals_out = np.empty(m, np.float64)
    rc = lib.gb_coo_to_csr(
        m, nrows, ncols,
        rows.ctypes.data_as(_i64p), cols.ctypes.data_as(_i64p),
        vals64.ctypes.data_as(_f64p), row_ptr.ctypes.data_as(_i64p),
        cols_out.ctypes.data_as(_i64p), vals_out.ctypes.data_as(_f64p))
    if rc != 0:
        return None
    return row_ptr, cols_out, vals_out
