"""Build and load the port's CUDA kernels.

Every ``ops/csrc/*.cu`` is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into ONE shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds, not minutes, and needs no ``ninja``). The library's name
carries a hash of the sources and flags, so the first use after a change
rebuilds it; builds go to ``ops/_build/`` (git-ignored).

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

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -split-compile=0: nvcc optimizes a source's kernels in parallel threads
# (mc_bd.cu instantiates 30 large kernels, mc_ia.cu 10)
NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-split-compile=0"]

_vp, _i, _ll, _f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_float)
_SIGNATURES = {
    "mc_ofdm_tdl_prng": [_vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _f, _f,
                         _f, _f, _i, ctypes.c_uint, _ll, _vp],
    "mc_ofdm_tdl_inject": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i,
                           _i, _i, _i, _f, _f, _f, _f, _i, _ll, _ll, _ll, _ll,
                           _vp],
    "philox_fill": [_vp, _vp, _vp, _ll, _vp],
    "philox_stream_fill": [_vp, _ll, _ll, _ll, _i, ctypes.c_uint, _vp, _vp],
    "block_fir": [_vp, _vp, _vp, _i, _i, _i, _vp, _vp],
    "block_fir_plan": [_i, _i, _i, _i, _vp],
    "mc_alamouti_prng": [_vp, _i, _i, _i, _i, _f, ctypes.c_uint, _ll, _vp],
    "mc_alamouti_inject": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i,
                           _f, _ll, _ll, _ll, _ll, _vp],
    "mc_bd_num_parts": [_i, _i],
    "mc_bd_prng": [_vp, _vp, _i, _i, _i, _i, _i, _i, _i, _f, _f,
                   ctypes.c_uint, _ll, _vp],
    "mc_bd_inject": [_vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _f, _f, _ll,
                     _ll, _vp],
    "mc_ia_num_parts": [_i, _i, _i, _i],
    "mc_ia_prng": [_vp, _vp, _i, _i, _i, _i, _i, _i, _i, _i, _i, _f, _f,
                   ctypes.c_uint, _ll, _vp],
    "mc_ia_inject": [_vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _i, _i, _f,
                     _f, _ll, _ll, _vp],
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
    returns its path. One ``nvcc -c`` per source runs in parallel, then
    one link. The compilers' output (with ``-Xptxas -v``: each kernel's
    registers, shared memory and spills) is kept beside the library as
    ``.log``. Raises ``RuntimeError`` with nvcc's output on failure."""
    global build_seconds
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{lib.stem}.{os.getpid()}"
    tic = time.time()
    jobs = []
    for src in sorted(SRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        log = obj.with_suffix(".log")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-I", str(SRC_DIR), "-o", str(obj),
               str(src)]
        with open(log, "w") as f:
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
        jobs.append((cmd, obj, log, proc))
    text, failed = [], False
    for cmd, obj, log, proc in jobs:
        rc = proc.wait()
        text.append(f"$ {' '.join(cmd)}\n{log.read_text()}")
        log.unlink()
        failed |= rc != 0
    objs = [str(obj) for _, obj, _, _ in jobs]
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        cmd = [nvcc, *_ARCH, "-shared", "-o", str(tmp), *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        text.append(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        failed = proc.returncode != 0
    for obj in objs:
        Path(obj).unlink(missing_ok=True)
    build_seconds = time.time() - tic
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(text))
    lib.with_suffix(".log").write_text("\n".join(text))
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
