"""Build and load the port's hand-written CUDA kernels.

At first use every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) —
one ``nvcc`` process per source, all started together — and the objects
are linked into one shared library with a plain C interface, loaded with
``ctypes``.  The library is cached under ``build/kernels/`` at the repo
root (listed in ``.gitignore``), keyed by a hash of the sources and
flags, so a second process reuses it.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None

#: the C entry points and their ``ctypes`` signatures (pointers and the
#: stream as ``c_void_p``: plain ints would be cut to 32 bits)
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {
    "rmsnorm_bf16": [_P, _P, _P, _P, _I, _I, _F, _P],
    "paged_ragged_attention_bf16": [_P, _L, _L, _L, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "paged_ragged_attention_int8": [_P, _L, _L, _L, _P, _P, _P, _P, _P, _P,
                                    _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                                    _P],
    "w4a16_gemm_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"libreprotorch_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the sources if the cached library is missing; returns its
    path.  ``verbose`` adds ``-Xptxas -v`` (registers, shared memory and
    spills per kernel) and prints the compiler's output."""
    out = library_path()
    if out.exists() and not verbose:
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        objs, errors = [], []
        for src, obj, proc in procs:
            log, _ = proc.communicate()
            if verbose and log:
                print(f"[nvcc {src.name}]\n{log}", flush=True)
            if proc.returncode != 0:
                errors.append(f"{src.name}:\n{log}")
            objs.append(str(obj))
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_so = Path(tmp) / out.name
        subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o",
                        str(tmp_so)], check=True, capture_output=True,
                       text=True)
        os.replace(tmp_so, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(status: int, name: str):
    """Raise if a C entry point reported a CUDA error at launch."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
