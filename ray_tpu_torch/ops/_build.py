"""Build and load the hand-written CUDA kernels (``ray_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its
own by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``ray_tpu_torch/_build/`` (listed in ``.gitignore``), then loaded with
``ctypes``.  Pointers and the stream cross as ``c_void_p``; every C
entry returns ``cudaGetLastError()`` after its launch, which
``check`` turns into an exception.

The library name carries a hash of the sources it was built from (its
``.cu`` and every header), so an edited kernel never loads a stale
build.  Nothing is built at
import: ``library(name)`` builds on first use, ``build_all()`` builds
every source at once (one ``nvcc`` each, all started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("paged_decode", "paged_append", "paged_append_quantized",
           "flash_fwd", "ragged_attention", "ragged_append",
           "ragged_append_quantized", "fused_decode", "fused_ragged",
           "flash_bwd", "mamba_ssd")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each build.
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built on this machine")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for src in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start one nvcc into a temporary file (renamed into place when it
    succeeds, so a concurrent loader never sees a half-written
    library); None when the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", tmp,
         str(CSRC_DIR / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.tmp_path = tmp  # type: ignore[attr-defined]
    proc.out_path = out  # type: ignore[attr-defined]
    return proc


def _finish(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        os.unlink(proc.tmp_path)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(proc.tmp_path, proc.out_path)


def build_all(names: Optional[List[str]] = None) -> float:
    """Build every kernel source in parallel; returns wall seconds."""
    t0 = time.perf_counter()
    with _lock:
        names = list(names or SOURCES)
        procs = {n: _start(n) for n in names}
        errors = []
        for n, p in procs.items():
            try:
                _finish(n, p)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _finish(name, _start(name))
            _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
