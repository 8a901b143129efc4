"""Builds the package's CUDA sources with nvcc and loads them with ctypes.

Each source under graphblast_tpu_torch/csrc/ compiles on its own into a
shared library with a plain C interface, in graphblast_tpu_torch/_build/
(not tracked by git). The library's file name carries a hash of its own
source, the csrc/ headers it includes and the flags, so an edited source or
header is rebuilt, a current library is reused, and adding or editing one
source leaves the others' libraries as they are. `build()` starts one nvcc
per missing library, all at once, and waits for all of them. `launcher` is
how every wrapper calls its kernel. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# library name -> its source in csrc/
SOURCES = {"bitmap_pull": "bitmap_pull.cu", "value_pull": "value_pull.cu",
           "monoid_pull": "monoid_pull.cu", "gather": "gather.cu",
           "orpull_csum": "orpull_csum.cu", "minmax_pull": "minmax_pull.cu",
           "masked_intersect": "masked_intersect.cu",
           "bitmap_push": "bitmap_push.cu"}

_loaded: dict = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {path}); "
                           "the CUDA kernels build on a machine with the "
                           "CUDA toolkit")
    return path


def _sources_of(src: str, seen: dict) -> dict:
    """{file name: text} of csrc/`src` and every csrc/ header it includes
    with `#include "..."`, directly or through another header."""
    with open(os.path.join(CSRC_DIR, src), "rb") as f:
        seen[src] = text = f.read()
    for inc in re.findall(rb'^\s*#include\s+"([^"]+)"', text, re.M):
        if inc.decode() not in seen:
            _sources_of(inc.decode(), seen)
    return seen


def library_path(name: str) -> str:
    """Where library `name` is built: its file name hashes the flags, its
    source and the headers of csrc/ that the source includes."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src, text in sorted(_sources_of(SOURCES[name], {}).items()):
        h.update(src.encode() + b"\0" + text)
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names=None) -> dict:
    """Compile each named library (all by default) that is not built yet,
    in parallel. Returns {name: compiler output} for what was compiled
    (ptxas reports registers and spills per kernel); raises if any
    compile failed."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        reports[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            os.unlink(tmp)
            failed.append(name)
    if failed:
        detail = "\n".join(f"--- {n}\n{reports[n]}" for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{detail}")
    return reports


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed. `signatures` maps
    each C function to (argtypes, restype)."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(library_path(name))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib


# torch's current device and raw current-stream pointer, looked up at the
# first launch (a CPU-only torch lacks both)
_get_device = _raw_stream = None


def _stream_api():
    global _get_device, _raw_stream
    torch.cuda.init()
    _get_device = torch._C._cuda_getDevice
    _raw_stream = torch._C._cuda_getCurrentRawStream


def launcher(library: str, signatures: dict, entry: str, error: str):
    """How a wrapper calls C entry `entry` of `library` on the current
    stream of a device: `launch(device_index, *args)`, the stream pointer
    appended as the last argument. The library is built and loaded, and
    the entry and its error-string function `error` resolved, at the first
    call only; a call enters the device only when it is not the current
    one, and raises with the library's message when the entry returns an
    error code. It makes no Python object of its own per call."""
    fn = error_string = None

    def launch(device: int, *args) -> None:
        nonlocal fn, error_string
        if fn is None:
            if _get_device is None:
                _stream_api()
            lib = load(library, signatures)
            error_string = getattr(lib, error)
            fn = getattr(lib, entry)
        if device == _get_device():
            err = fn(*args, _raw_stream(device))
        else:
            with torch.cuda.device(device):
                err = fn(*args, _raw_stream(device))
        if err:
            raise RuntimeError(f"{entry} launch failed: "
                               + error_string(err).decode())

    return launch
