"""Build and load the port's CUDA kernels.

Every ``ops/csrc/*.cu`` is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into ONE shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds, not minutes, and needs no ``ninja``). The library's name
carries a hash of the sources and flags, so the first use after a change
rebuilds it; builds go to ``ops/_build/`` (git-ignored).

Nothing here runs at import time: :func:`load` is called by a kernel
wrapper the first time it launches.

The prebuilt library instantiates the Monte Carlo kernels ``mc_bd.cu`` and
``mc_ia.cu`` at a few geometries. Any other geometry gets a library of its
own on its first launch (``load(geometry)``): one ``nvcc -shared`` of
that source alone with the geometry as ``-D`` defines (``MC_BD_K``,
``MC_BD_NR``; ``MC_IA_K``, ``MC_IA_N``, ``MC_IA_NS``), named by the sources'
hash and the geometry, in ``ops/_build/`` too, and cached in the process.
:func:`build` can start such builds beside the prebuilt library's.

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
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

__all__ = ["NVCC_FLAGS", "build", "load", "library_path", "check",
           "state_buffer", "launch_info"]

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
    "mc_ofdm_tdl_plan": [_i, _i, _i, _i, _i, _i, _i, _vp],
    "mc_ofdm_tdl_launch_info": [_i, _i, _i, _i, _i, _i, _i, _i, _vp],
    "mc_ofdm_tdl_prng": [_vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _f, _f,
                         _f, _f, _i, _vp, ctypes.c_uint, _ll, _i, _i, _vp,
                         _vp],
    "mc_ofdm_tdl_inject": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i,
                           _i, _i, _i, _f, _f, _f, _f, _i, _vp, _ll, _ll, _ll,
                           _ll, _i, _i, _vp, _vp],
    "philox_fill": [_vp, _vp, _vp, _ll, _vp],
    "philox_stream_fill": [_vp, _ll, _ll, _ll, _i, ctypes.c_uint, _vp, _vp],
    "block_fir": [_vp, _vp, _vp, _i, _i, _i, _vp, _vp, _vp],
    "block_fir_plan": [_i, _i, _i, _i, _i, _vp],
    "block_fir_launch_info": [_i, _i, _i, _i, _i, _vp],
    "mc_alamouti_prng": [_vp, _i, _i, _i, _i, _f, ctypes.c_uint, _ll, _vp],
    "mc_alamouti_inject": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i,
                           _f, _ll, _ll, _ll, _ll, _vp],
    "mc_bd_num_parts": [_i, _i],
    "mc_bd_scratch_bytes": [_i, _i, _i, _i],
    "mc_bd_launch_info": [_i, _i, _i, _vp],
    "mc_bd_prng": [_vp, _vp, _i, _i, _i, _i, _i, _i, _i, _f, _f,
                   ctypes.c_uint, _ll, _vp, _vp],
    "mc_bd_inject": [_vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _f, _f, _ll,
                     _ll, _vp, _vp],
    "mc_ia_num_parts": [_i, _i, _i, _i, _i],
    "mc_ia_scratch_bytes": [_i, _i, _i, _i],
    "mc_ia_launch_info": [_i, _i, _i, _vp],
    "mc_ia_prng": [_vp, _vp, _i, _i, _i, _i, _i, _i, _i, _i, _i, _f, _f,
                   ctypes.c_uint, _ll, _vp, _vp],
    "mc_ia_inject": [_vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _i, _i, _f,
                     _f, _ll, _ll, _vp, _vp],
    "mimo_mmse": [_vp, _vp, _vp, _vp, _vp, _i, _ll, _i, _i, _i, _f, _vp],
    "sc_mmse_eq": [_vp, _vp, _vp, _vp, _vp, _i, _ll, _i, ctypes.c_uint, _i,
                   _i, _vp],
    "sc_decide": [_vp, _vp, _vp, _vp, _i, _i, _ll, _i, _vp],
    "qam_map": [_vp, _vp, _ll, _i, _f, _f, _i, _vp],
}
_RESTYPES = {"mc_bd_scratch_bytes": _ll, "mc_ia_scratch_bytes": _ll}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of this process's build
# each geometry's loaded library, by (source, defines): a launch finds it
# without hashing the sources again
_geometry_libs: Dict[Tuple[str, Tuple[Tuple[str, int], ...]],
                     ctypes.CDLL] = {}
# wall time of each geometry library this process built, by file name
geometry_build_seconds: Dict[str, float] = {}


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


def _sources_hash(*extra: str) -> str:
    h = hashlib.sha256(" ".join([*NVCC_FLAGS, *extra]).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


# One geometry's library: (source stem, -D defines), e.g.
# ("mc_bd", {"MC_BD_K": 7, "MC_BD_NR": 2})
Geometry = Tuple[str, Mapping[str, int]]


def _defines(defines: Mapping[str, int]) -> List[str]:
    return [f"-D{k}={int(v)}" for k, v in sorted(defines.items())]


def library_path(geometry: Optional[Geometry] = None) -> Path:
    """Where the library for the current sources and flags lives: the
    prebuilt one, or that of ``ops/csrc/<source>.cu`` built for one
    ``geometry``."""
    if geometry is None:
        return BUILD_DIR / f"libpyphysim_kernels_{_sources_hash()}.so"
    source, defines = geometry
    tag = "_".join(f"{k.rsplit('_', 1)[-1]}{int(v)}"
                   for k, v in sorted(defines.items()))
    return BUILD_DIR / (f"lib{source}_{tag}_"
                        f"{_sources_hash(source, *_defines(defines))}.so")


def _run(jobs: Sequence[Tuple[List[str], Path]], tic: float
         ) -> List[Tuple[bool, str, float]]:
    """Run the commands of ``(cmd, output)`` jobs all at once; for each,
    whether it succeeded, its command and output, and the seconds from
    ``tic`` to its end."""
    running = []
    for cmd, out in jobs:
        log = out.with_suffix(out.suffix + ".log")
        with open(log, "w") as f:
            running.append((cmd, log, subprocess.Popen(
                cmd, stdout=f, stderr=subprocess.STDOUT)))
    ends: Dict[int, float] = {}
    while len(ends) < len(running):
        for i, (_, _, proc) in enumerate(running):
            if i not in ends and proc.poll() is not None:
                ends[i] = time.time() - tic
        time.sleep(0.05)
    results = []
    for i, (cmd, log, proc) in enumerate(running):
        results.append((proc.returncode == 0,
                        f"$ {' '.join(cmd)}\n{log.read_text()}", ends[i]))
        log.unlink()
    return results


def build(geometries: Sequence[Geometry] = (), prebuilt: bool = True
          ) -> Path:
    """Compile the sources unless the library for them already exists;
    returns its path. One ``nvcc -c`` per source runs in parallel, then
    one link. The compilers' output (with ``-Xptxas -v``: each kernel's
    registers, shared memory and spills) is kept beside the library as
    ``.log``. ``geometries``: libraries of single geometries (see
    :func:`load`) to build at the same time, each by its own
    ``nvcc``; each one's seconds go to ``geometry_build_seconds``
    (``prebuilt=False``: those alone). Raises ``RuntimeError`` with nvcc's
    output on failure."""
    global build_seconds
    lib = library_path()
    wanted = [(library_path((src, d)), src, d) for src, d in geometries]
    wanted = [w for w in wanted if not w[0].exists()]
    prebuilt = prebuilt and not lib.exists()
    if not (prebuilt or wanted):
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    tic = time.time()
    objs = [] if not prebuilt else [
        (src, BUILD_DIR / f"{lib.stem}.{pid}.{src.stem}.o")
        for src in sorted(SRC_DIR.glob("*.cu"))]
    jobs = [([nvcc, *NVCC_FLAGS, "-c", "-I", str(SRC_DIR), "-o", str(obj),
              str(src)], obj) for src, obj in objs]
    jobs += [([nvcc, *NVCC_FLAGS, *_defines(d), "-shared", "-I",
               str(SRC_DIR), "-o", str(path.with_suffix(f".{pid}.tmp")),
               str(SRC_DIR / f"{src}.cu")], path.with_suffix(f".{pid}.tmp"))
             for path, src, d in wanted]
    results = _run(jobs, tic)
    errors = []
    for (path, _, _), (ok, text, seconds) in zip(wanted, results[len(objs):]):
        tmp = path.with_suffix(f".{pid}.tmp")
        geometry_build_seconds[path.name] = seconds
        if ok:
            path.with_suffix(".log").write_text(text)
            os.replace(tmp, path)
        else:
            tmp.unlink(missing_ok=True)
            errors.append(text)
    if objs:
        text = [t for _, t, _ in results[:len(objs)]]
        failed = not all(ok for ok, _, _ in results[:len(objs)])
        tmp = lib.with_suffix(f".{pid}.tmp")
        if not failed:
            cmd = [nvcc, *_ARCH, "-shared", "-o", str(tmp),
                   *(str(obj) for _, obj in objs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            text.append(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            failed = proc.returncode != 0
        for _, obj in objs:
            obj.unlink(missing_ok=True)
        build_seconds = time.time() - tic
        if failed:
            tmp.unlink(missing_ok=True)
            errors[:0] = text
        else:
            lib.with_suffix(".log").write_text("\n".join(text))
            os.replace(tmp, lib)  # atomic: a concurrent process sees all
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return lib


def _declare(lib: ctypes.CDLL, names) -> ctypes.CDLL:
    """Declare the argument and return types of ``lib``'s ``names``."""
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib


def load(geometry: Optional[Geometry] = None) -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every exported
    function's argument and return types. ``geometry``: the library of
    ``ops/csrc/<source>.cu`` alone for one geometry, built from the sources
    on its first use (one ``nvcc -shared``, its ``-Xptxas -v`` log beside
    it), exporting that source's C functions with the prebuilt library's
    signatures, and cached in the process by the geometry (the sources'
    hash is taken on the first launch only). Raises ``RuntimeError`` with
    nvcc's output if a build fails."""
    global _lib
    if geometry is None:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(build())), _SIGNATURES)
        return _lib
    key = (geometry[0], tuple(sorted(geometry[1].items())))
    lib = _geometry_libs.get(key)
    if lib is None:
        path = library_path(geometry)
        if not path.exists():
            build([geometry], prebuilt=False)
        names = [n for n in _SIGNATURES if n.startswith(geometry[0] + "_")]
        lib = _geometry_libs[key] = _declare(ctypes.CDLL(str(path)), names)
    return lib


def state_buffer(nbytes: int, device, what: str):
    """The device buffer of a wide-form launch (``ops/csrc/wide.cuh``)
    whose per-element state is past shared memory: ``nbytes`` from the
    library's ``*_scratch_bytes`` (an empty tensor, a null pointer, where
    that is 0). Raises if the library could not read the device, or if the
    card's memory cannot hold the buffer (``what`` names the launch)."""
    import torch
    if nbytes < 0:
        raise RuntimeError(f"{what}: the kernel library could not read the "
                           "device's multiprocessor count")
    try:
        return torch.empty(nbytes, dtype=torch.uint8, device=device)
    except torch.cuda.OutOfMemoryError as err:
        raise RuntimeError(
            f"{what}: the per-element state of this geometry needs a "
            f"{nbytes}-byte device buffer, more than the card has free"
        ) from err


def check(rc: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


# mc_bd_launch_info / mc_ia_launch_info's ints (wide::launch_info), in order
_LAUNCH_INFO = ("threads", "shared_bytes", "elems", "lanes", "scratch",
                "blocks_per_sm")


def launch_info(fn, *args) -> Dict[str, object]:
    """What a library's ``mc_*_launch_info`` function ``fn`` reports for a
    geometry on the current device: threads and dynamic shared bytes a
    block, elements a block, lanes an element, whether the state is in the
    scratch buffer, resident blocks a SM, and ``warps_per_sm``; raises on
    a CUDA error."""
    info = (ctypes.c_int * len(_LAUNCH_INFO))()
    check(fn(*args, ctypes.addressof(info)), "launch_info")
    out: Dict[str, object] = dict(zip(_LAUNCH_INFO, info))
    out["scratch"] = bool(out["scratch"])
    out["warps_per_sm"] = out["blocks_per_sm"] * out["threads"] // 32
    return out
