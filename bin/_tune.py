"""What the kernel tuners (``bin/tune_*_kernel.py``) share: variants of a
CUDA source made by substituting lines, each built by its own ``nvcc``
into a library of its own under ``ops/_build/tune/`` with every ``nvcc``
started together, their ``-Xptxas -v`` lines read as ``chip_smoke.py``
reads the main library's, and their launches timed in turns on one card.
"""

import ctypes
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import best_ms, ptxas_info  # noqa: E402

Subs = Sequence[Tuple[str, str]]
MAX_JOBS = 24                # nvcc processes at once


def substitute(name: str, text: str, subs: Subs) -> str:
    """``text`` with each ``(old, new)`` of ``subs`` replaced, in order;
    raises if an ``old`` is not in the text (the source moved on)."""
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"{name}: the source has no {old!r}")
        text = text.replace(old, new)
    return text


def build_variants(sources: Dict[str, tuple], stem: str,
                   kernel: str) -> Dict[str, Tuple[Path, Dict[str, str]]]:
    """Build each ``name: (CUDA text, include directory[, -D defines])`` of
    ``sources`` into ``ops/_build/tune/lib{stem}{k}.so``, every ``nvcc``
    started together: ``{name: (library path, ptxas_info of the instances
    of the kernel named by the regex kernel)}``."""
    from pyphysim_tpu_torch.ops import _build
    out_dir = _build.BUILD_DIR / "tune"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs, running = {}, []
    for k, (name, (text, include, *defines)) in enumerate(sources.items()):
        while len(running) >= MAX_JOBS:   # bounds the builds' memory
            running = [p for p in running if p.poll() is None]
            time.sleep(0.1)
        cu = out_dir / f"{stem}{k}.cu"
        cu.write_text(text)
        lib = out_dir / f"lib{stem}{k}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS,
               *_build._defines(defines[0] if defines else {}), "-shared",
               "-I", str(include), "-o", str(lib), str(cu)]
        log = out_dir / f"lib{stem}{k}.log"
        with open(log, "w") as f:
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
        jobs[name] = (lib, log, proc)
        running.append(proc)
    built = {}
    for name, (lib, log, proc) in jobs.items():
        proc.wait()
        text = log.read_text()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{text}")
        built[name] = (lib, ptxas_info(text, kernel))
    return built


def function(lib_path: Path, name: str, argtypes=None):
    """The exported C function ``name`` of a variant's library, typed as
    the main library's (``_build._SIGNATURES``, ``_RESTYPES``) or by
    ``argtypes`` (an older interface)."""
    from pyphysim_tpu_torch.ops import _build
    fn = getattr(ctypes.CDLL(str(lib_path)), name)
    fn.argtypes = argtypes or _build._SIGNATURES[name]
    fn.restype = _build._RESTYPES.get(name, ctypes.c_int)
    return fn


def time_in_turns(calls: List[Callable[[], object]]) -> List[float]:
    """Each call's best time in ms over 3 rounds of 10 launches, the calls
    timed in turns (forward, backward, forward) so that drift hits all
    alike."""
    ms = [float("inf")] * len(calls)
    for k in range(3):
        order = range(len(calls)) if k % 2 == 0 else \
            reversed(range(len(calls)))
        for i in order:
            ms[i] = min(ms[i], best_ms(calls[i], repeat=1, inner=10))
    return ms
