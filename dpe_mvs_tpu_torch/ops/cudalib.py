"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` at first use into ``dpe_mvs_tpu_torch/_build/`` (a
shared library named after the source and a hash of its text and flags) and
loaded with ``ctypes``. :func:`build_many` starts one ``nvcc`` per stale
source at once and waits for all of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: cannot build the CUDA kernels "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return cand


def library_path(source: Path) -> Path:
    tag = hashlib.sha256(source.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{tag}.so"


def build_many(sources: Sequence[Path], verbose: bool = False):
    """Compile every source whose cached library is stale, all ``nvcc``
    processes at once; returns the libraries' paths. Raises on a failed
    build (after every process has ended)."""
    sos = [library_path(s) for s in sources]
    todo = [(s, so) for s, so in zip(sources, sos) if not so.exists()]
    if not todo:
        return sos
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src, so in todo:
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(src)]
        procs.append((src, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for src, so, tmp, proc in procs:
        _out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src.name} ({proc.returncode}):\n"
                          f"{err}")
            continue
        if verbose:
            print(f"{src.name}:\n{err.strip()}")
        os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))
    return sos


def load(source: Path, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``source`` (built if needed), with the given
    ``{function: argtypes}``; every function returns a cudaError_t int."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build_many([source])[0]))
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[source] = lib
    return lib
