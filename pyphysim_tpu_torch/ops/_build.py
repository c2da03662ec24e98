"""Build and load the port's CUDA kernels.

Every ``ops/csrc/*.cu`` is compiled by ``nvcc`` into ONE shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds, not minutes, and needs no ``ninja``). The library's
name carries a hash of the sources and flags, so the first use after a
change rebuilds it; builds go to ``ops/_build/`` (git-ignored).

Nothing here runs at import time: :func:`load` is called by a kernel
wrapper the first time it launches.

Calling convention of the exported functions: pointers and the CUDA stream
(``torch.cuda.current_stream().cuda_stream``) are ``c_void_p``, ints
``c_int`` / ``c_longlong``, floats ``c_float``; each returns
``cudaGetLastError()`` right after its launch, and none synchronises or
allocates.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

__all__ = ["NVCC_FLAGS", "build", "load", "check"]

_OPS_DIR = Path(__file__).resolve().parent
SRC_DIR = _OPS_DIR / "csrc"
BUILD_DIR = _OPS_DIR / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_vp, _i, _ll, _f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_float)
_SIGNATURES = {
    "mc_ofdm_tdl_prng": [_vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _f, _f, _f,
                         _f, ctypes.c_uint, _ll, _vp],
    "mc_ofdm_tdl_inject": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i,
                           _i, _i, _f, _f, _f, _f, _ll, _ll, _ll, _ll, _vp],
    "philox_fill": [_vp, _vp, _vp, _ll, _vp],
    "block_fir": [_vp, _vp, _vp, _i, _i, _i, _vp, _vp],
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of this process's build


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")
    return found


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpyphysim_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them already exists;
    returns its path. The compiler's output (with ``-Xptxas -v``: each
    kernel's registers, shared memory and spills) is kept beside it as
    ``.log``. Raises ``RuntimeError`` with nvcc's output on failure."""
    global build_seconds
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(SRC_DIR), "-o", str(tmp),
           *(str(s) for s in sorted(SRC_DIR.glob("*.cu")))]
    tic = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.time() - tic
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent process sees all or nothing
    return lib


def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every exported
    function's argument and return types."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
