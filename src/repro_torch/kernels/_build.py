"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles on its own with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded through ``ctypes`` — no PyTorch
headers, so a build takes seconds.  All sources compile in parallel at
first use, into ``build/kernels/`` at the repository root; a library's file
name carries a hash of its source and the flags, so a changed source never
loads a stale build.  Every C entry point returns ``cudaGetLastError()``
after its launches, and :func:`check` raises on a nonzero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("stats", "encode_fused", "decode", "orthogonalize", "quantize")
# No --use_fast_math: logf, IEEE division and separate multiply/add
# (-fmad=false) keep each kernel's arithmetic equal to its plain PyTorch
# version on the card.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return found


def _target(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, str]:
    """Compile every source that has no current build, all at once.

    Returns ``{name: ptxas report}`` (register and shared-memory use per
    kernel) for every source, read from the log kept beside each library.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        so = _target(name)
        if so.exists():
            continue
        tmp = so.with_suffix(f".tmp{os.getpid()}.so")
        procs[name] = (so, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (so, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
            continue
        so.with_suffix(".log").write_text(out)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {name: _target(name).with_suffix(".log").read_text() for name in SOURCES}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _libs:
        so = _target(name)
        if not so.exists():
            build_all()
        _libs[name] = ctypes.CDLL(str(so))
    return _libs[name]


def bind(name: str, fn: str, argtypes: list):
    """Declare and return C entry point ``fn`` of library ``name``."""
    if (name, fn) not in _fns:
        f = getattr(library(name), fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _fns[name, fn] = f
    return _fns[name, fn]


def check(code: int, what: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` returned by a launch."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {code}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
