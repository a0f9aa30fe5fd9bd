"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by
`nvcc` for Hopper (`sm_90a`) into its own shared library under
`build/paddle_tpu_torch/` at the repository root (listed in .gitignore).
A library is built at first use and rebuilt when its source is newer;
`build_all()` builds every source at once, one `nvcc` process per file,
all started together. Libraries are loaded with `ctypes`: every pointer
and the CUDA stream cross as `c_void_p`, and each C entry point returns
`cudaGetLastError()` after its launch, which `check()` turns into an
exception.

Nothing here runs at import time: the CPU-only test machines import every
module of the port and have no `nvcc`.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["SOURCES", "BUILD_DIR", "build_all", "load", "check",
           "nvcc_path"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "paddle_tpu_torch"
SOURCES = ("flash_fwd", "flash_bwd", "paged_decode", "ragged_paged",
           "gather_rows")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# ptxas register / shared-memory report of the last build of each source
BUILD_LOGS: Dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else
    /usr/local/cuda/bin/nvcc. Raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "(the port's CUDA kernels are built at first use)")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    src_mtime = max(p.stat().st_mtime
                    for p in [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    return lib.stat().st_mtime < src_mtime


def _compile(names: Iterable[str]) -> None:
    """One nvcc per source, all started together; raises with the
    compiler's output if any fails. Output goes to a temporary name and
    is renamed into place, so a half-written library is never loaded."""
    names = list(names)
    if not names:
        return
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOGS[name] = out
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(name))
    if errors:
        raise RuntimeError("\n".join(errors))


def build_all(force: bool = False) -> float:
    """Build every kernel library that is missing or stale (all of them
    with `force`). Returns the wall seconds spent."""
    t0 = time.perf_counter()
    with _LOCK:
        todo = [n for n in SOURCES if force or _stale(n)]
        _compile(todo)
        for n in todo:
            _LIBS.pop(n, None)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it first when it
    is missing or stale."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if _stale(name):
                _compile([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
    return lib


def check(err: int, what: str, lib: Optional[ctypes.CDLL] = None) -> None:
    """Raise if a C entry point reported a CUDA error (its return value is
    `cudaGetLastError()` after the launch)."""
    if err != 0:
        msg = ""
        if lib is not None and hasattr(lib, "ptt_error_string"):
            lib.ptt_error_string.restype = ctypes.c_char_p
            lib.ptt_error_string.argtypes = [ctypes.c_int]
            msg = ": " + lib.ptt_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed with CUDA error {err}{msg}")
