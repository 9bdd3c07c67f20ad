"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles on its own with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, which is loaded with ``ctypes``: pointers
go in as ``c_void_p`` (``tensor.data_ptr()``), the stream as
``torch.cuda.current_stream().cuda_stream``. The first use of any kernel
builds every source that is missing, all ``nvcc`` processes started
together, into ``dora_tpu_torch/_build/``; a library is named after the hash
of its source, the shared headers and the flags, so an edit rebuilds it and
an unchanged tree reuses it. A failed build raises with the compiler's
output; every C entry returns ``cudaGetLastError()`` of its launches and
:func:`check` raises on a nonzero code.

``compiler="host"`` builds the same sources with the host C++ compiler
against the stand-in headers of ``csrc/emu/`` (one OS thread per CUDA
thread), so the kernels' indexing can be checked on a machine without a
card. Only the emulation checks use it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: one shared library per kernel family
SOURCES = ("mlp", "lm_head", "paged_attention")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
HOST_FLAGS = (
    "-x", "c++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
    "-DDORA_EMULATE",
)

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

_LOADED: dict[tuple[str, str], ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _command(name: str, compiler: str, out: Path) -> list[str]:
    src = str(CSRC / f"{name}.cu")
    if compiler == "nvcc":
        return [_nvcc(), *NVCC_FLAGS, "-o", str(out), src]
    if compiler == "host":
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("no host C++ compiler for the emulated build")
        return [cxx, *HOST_FLAGS, "-I", str(CSRC / "emu"), "-o", str(out), src]
    raise ValueError(f"unknown compiler {compiler!r}")


def library_path(name: str, compiler: str = "nvcc") -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")) + sorted((CSRC / "emu").glob("*.h")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS if compiler == "nvcc" else HOST_FLAGS).encode())
    tag = "" if compiler == "nvcc" else "-host"
    return BUILD_DIR / f"lib{name}{tag}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES, compiler: str = "nvcc") -> dict[str, Path]:
    """Compile every library of ``names`` that is not built yet, all at
    once; returns name -> library path. The compiler's report (registers,
    shared memory, spills with nvcc) is kept beside each library as
    ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n, compiler) for n in names}
    procs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        log = open(path.with_suffix(".log"), "w")
        procs[name] = (
            subprocess.Popen(
                _command(name, compiler, tmp), stdout=log,
                stderr=subprocess.STDOUT,
            ),
            tmp, path, log,
        )
    failed = []
    for name, (proc, tmp, path, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name}: exit {rc}\n{path.with_suffix('.log').read_text()}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def library(name: str, signatures: dict, compiler: str = "nvcc") -> ctypes.CDLL:
    """The loaded library ``name``, built first (with every other missing
    source) if needed; ``signatures`` maps each C entry to its argtypes."""
    key = (name, compiler)
    lib = _LOADED.get(key)
    if lib is None:
        if not library_path(name, compiler).exists():
            build(SOURCES, compiler)
        lib = ctypes.CDLL(str(library_path(name, compiler)))
        _LOADED[key] = lib
    for fn, argtypes in signatures.items():
        f = getattr(lib, fn)
        if f.argtypes is None:
            f.argtypes = argtypes
            f.restype = ctypes.c_int
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_of(t):
    """The current CUDA stream for a tensor's device (None on the CPU,
    where only the emulated build runs)."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream if t.is_cuda else None
