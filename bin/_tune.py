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
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import best_ms, ptxas_info  # noqa: E402

Subs = Sequence[Tuple[str, str]]


def substitute(name: str, text: str, subs: Subs) -> str:
    """``text`` with each ``(old, new)`` of ``subs`` replaced, in order;
    raises if an ``old`` is not in the text (the source moved on)."""
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"{name}: the source has no {old!r}")
        text = text.replace(old, new)
    return text


def build_variants(sources: Dict[str, Tuple[str, Path]], stem: str,
                   kernel: str) -> Dict[str, Tuple[Path, Dict[str, str]]]:
    """Build each ``name: (CUDA text, include directory)`` of ``sources``
    into ``ops/_build/tune/lib{stem}{k}.so``, every ``nvcc`` started
    together: ``{name: (library path, ptxas_info of the instances of the
    kernel named by the regex kernel)}``."""
    from pyphysim_tpu_torch.ops import _build
    out_dir = _build.BUILD_DIR / "tune"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for k, (name, (text, include)) in enumerate(sources.items()):
        cu = out_dir / f"{stem}{k}.cu"
        cu.write_text(text)
        lib = out_dir / f"lib{stem}{k}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
               str(include), "-o", str(lib), str(cu)]
        jobs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for name, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        built[name] = (lib, ptxas_info(log, kernel))
    return built


def function(lib_path: Path, name: str):
    """The exported C function ``name`` of a variant's library, typed as
    the main library's (``_build._SIGNATURES``)."""
    from pyphysim_tpu_torch.ops import _build
    fn = getattr(ctypes.CDLL(str(lib_path)), name)
    fn.argtypes = _build._SIGNATURES[name]
    fn.restype = ctypes.c_int
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
