"""Instruction counts of a built kernel, per issue pipe, from its SASS.

The bound of a kernel that reads nothing per element (the Monte Carlo
kernels in PRNG mode) is set by the instructions it issues. This module
reads them from the library that ``ops/_build.py`` built: ``cuobjdump
-sass`` (CUDA toolkit) disassembles it, :func:`function_sass` picks one
kernel's listing, :func:`pipe_counts` sorts its instructions into the
pipes of a Hopper SM, and :func:`issue_bound_ms` turns the counts into
the least time the card could take. :func:`kernel_sass` finds the listing
a wrapper's ``prng_kernel_profile`` names, in the prebuilt library or in
the library of one geometry built on its first use.

Counting rules, per thread (a warp issues each instruction once for its
32 threads):

  * the body runs up to its last unconditional ``EXIT``; what nvcc places
    after it (out-of-line routines, reached only by ``CALL``) counts only
    through the rules below;
  * a loop (a backward branch) counts its trips: ``loop_trips`` for every
    loop, or one number per backward branch in listing order (a loop inside
    another counts the product of both). A backward branch after the last
    ``EXIT`` is no loop of the body: it is out-of-line code like the rest
    (e.g. the jump back from a warp shuffle's fallback for a diverged warp,
    which ``BRA.DIV`` reaches) and counts 0 times;
  * the slow path of a division (the few instructions around a ``CALL``
    that a range check branches over) counts 0 times:
    for an IEEE f32 division it runs only for denormal or near-overflow
    operands, for a 64-bit integer one only for divisors of 2^32 or more.
    A ``CALL`` anywhere else raises;
  * the tail of ``erfinvf`` (taken when ``log2(1 - x^2) < -8.2``) counts
    ``ERFINV_TAIL`` times, the chance that a uniform ``x`` on (-1, 1)
    takes it: the kernels feed it uniform draws;
  * every other instruction counts once, both arms of any other forward
    branch included (the guards of a full-width launch, a block's
    reduction);
  * uniform-datapath instructions (``U*``, ``R2UR``, ``S2UR``) take an
    issue slot but no vector lanes.

Rates per SM and clock, from the CUDA C++ Programming Guide's table of
arithmetic instruction throughput for compute capability 9.0: 128 f32
add / multiply / FMA, 64 32-bit integer multiply-add (``IMAD*``, on the
FMA-heavy half of the FMA pipe), 64 integer add / logic / shift / compare
and f32 compare / min / max / select (the ALU), 16 special functions,
conversions and popcounts (the XU). Each of the SM's four schedulers
issues one warp instruction per clock: 128 thread-instructions per SM,
the FMA pipe's own rate, so that pipe never sets the bound alone.
"""

from __future__ import annotations

import functools
import math
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

__all__ = ["PIPE_RATES", "SMS", "CLOCK_HZ", "ERFINV_TAIL", "function_sass",
           "kernel_sass", "loop_ops", "pipe_counts", "issue_bound_ms"]

SMS = 132                 # H100 SXM
CLOCK_HZ = 1.98e9         # boost clock (67 TFLOP/s f32 = 132 * 128 * 2 * it)
# thread-operations per SM per clock
PIPE_RATES = {"issue": 128, "fmaheavy": 64, "alu": 64, "xu": 16}
# P(log2(1 - x^2) < -8.2) for x uniform on (-1, 1)
ERFINV_TAIL = 1.0 - math.sqrt(1.0 - 2.0 ** -8.2)

_FP32 = {"FFMA", "FADD", "FMUL", "FFMA32I", "FADD32I", "FMUL32I", "HFMA2",
         "HADD2", "HMUL2"}
_IMAD = {"IMAD", "IMAD32I", "IMUL", "IMUL32I", "IDP", "IMADSP"}
_ALU = {"IADD3", "IADD", "IADD32I", "LOP3", "LOP", "LOP32I", "SHF", "SHL",
        "SHR", "LEA", "ISCADD", "ISETP", "ICMP", "IMNMX", "VIMNMX", "VIADD",
        "IABS", "SEL", "FSEL", "FSETP", "FMNMX", "FSET", "FCHK", "PLOP3",
        "P2R", "R2P", "MOV", "MOV32I", "PRMT", "SGXT", "BMSK", "I2FP",
        "F2IP", "F2FP", "HSETP2", "HMNMX2"}
_XU = {"MUFU", "POPC", "FLO", "BREV", "I2F", "F2I", "F2F", "I2I", "FRND"}
_PIPES = ("fp32", "imad", "alu", "xu", "uniform", "other")

_INSN = re.compile(r"/\*([0-9a-f]+)\*/\s+(?:(@!?U?P[T0-9]+)\s+)?"
                   r"([A-Z][A-Z0-9_]*)([.A-Z0-9_]*)([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b")
_ERFINV_SPLIT = re.compile(r"(P\d), PT, R\d+, -8\.19999980")
_SLOW_PATH_MAX = 12       # instructions between a range check and its join
# instructions from erfinvf's range check to its branch (more where the
# compiler interleaves several symbols' epilogues)
_ERFINV_BRANCH_WINDOW = 24


def pipe(op: str) -> str:
    """The pipe an opcode (without its modifiers) issues to."""
    if op.startswith("U") or op in ("R2UR", "S2UR"):
        return "uniform"
    if op in _FP32:
        return "fp32"
    if op in _IMAD:
        return "imad"
    if op in _ALU:
        return "alu"
    if op in _XU:
        return "xu"
    return "other"      # memory, shuffles, barriers, branches, S2R, NOP


def _cuobjdump() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "cuobjdump")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("cuobjdump")
    if found is None:
        raise RuntimeError("cuobjdump not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")
    return found


@functools.lru_cache(maxsize=16)
def _listings(library: Path) -> Tuple[str, ...]:
    """``cuobjdump -sass`` of the library, split into (name, listing, ...):
    one run per library (the prebuilt one and each geometry's), as the
    whole dump of the prebuilt one takes seconds."""
    text = subprocess.run([_cuobjdump(), "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    return tuple(re.split(r"^\s*Function : (\S+)\s*$", text,
                          flags=re.M)[1:])


def function_sass(library: Path, pattern: str) -> str:
    """The SASS listing of the one kernel of ``library`` whose mangled name
    matches the regex ``pattern``. Raises unless exactly one matches."""
    parts = _listings(Path(library))
    found = [(name, body) for name, body in zip(parts[0::2], parts[1::2])
             if re.search(pattern, name)]
    if len(found) != 1:
        raise RuntimeError(f"{len(found)} kernels of {library.name} match "
                           f"{pattern!r}: {[n for n, _ in found]}")
    return found[0][1]


def kernel_sass(profile: Dict[str, object]) -> str:
    """The listing of the kernel instance that a wrapper's
    ``prng_kernel_profile`` names (``pattern``), in the library it names
    (``library``: a geometry's own), else in the prebuilt library."""
    from . import _build
    library = profile.get("library") or _build.library_path()
    return function_sass(Path(library), str(profile["pattern"]))


class _Insn:
    __slots__ = ("addr", "pred", "op", "text", "target")

    def __init__(self, addr, pred, op, text, target):
        self.addr, self.pred, self.op = addr, pred, op
        self.text, self.target = text, target


def _parse(sass: str) -> List[_Insn]:
    insns: List[_Insn] = []
    labels: Dict[str, int] = {}
    pending: List[str] = []
    for line in sass.splitlines():
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for name in pending:
            labels[name] = addr
        pending = []
        op, rest = m.group(3), m.group(5)
        target: Optional[object] = None
        if op in ("BRA", "CALL"):
            t = _TARGET.search(rest)
            if t:
                target = t.group(1) or int(t.group(2), 16)
        insns.append(_Insn(addr, m.group(2), op, rest, target))
    for i in insns:
        if isinstance(i.target, str):
            i.target = labels[i.target]
    return insns


def _body(sass: str) -> Tuple[List[_Insn], int]:
    """The instructions before the terminating self-branch, and the address
    of the last unconditional ``EXIT``."""
    insns = _parse(sass)
    end = next((i.addr for i in insns
                if i.op == "BRA" and i.target == i.addr), None)
    if end is None:
        raise ValueError("no terminating self-branch in the listing")
    body = [i for i in insns if i.addr < end]
    exits = [i.addr for i in body if i.op == "EXIT" and i.pred is None]
    if not exits:
        raise ValueError("no unconditional EXIT in the listing")
    return body, exits[-1]


def loop_ops(sass: str) -> List[Dict[str, int]]:
    """The loops of one kernel's listing as :func:`pipe_counts` sees them
    (backward branches up to the last ``EXIT``, in listing order): for
    each, how many of each opcode its range holds, nested loops' included.
    A kernel whose loop structure follows its shape (unrolled copies,
    remainders) can name its loops' trips from their contents."""
    body, main_end = _body(sass)
    out = []
    for i in body:
        if i.op == "BRA" and i.target is not None and \
                i.target <= i.addr <= main_end:
            ops: Dict[str, int] = {}
            for j in body:
                if i.target <= j.addr <= i.addr:
                    ops[j.op] = ops.get(j.op, 0) + 1
            out.append(ops)
    return out


def pipe_counts(sass: str, loop_trips: Union[float, Sequence[float]] = 1,
                loops: int = 0) -> Dict[str, float]:
    """Instructions issued per thread, by pipe (``fp32``, ``imad``,
    ``alu``, ``xu``, ``uniform``, ``other``) and in all (``total``), of
    one kernel's listing under the module's counting rules. ``loops`` is
    the number of backward branches the caller expects; another number,
    or a listing the rules do not cover, raises, so a change of the
    compiled code cannot change the count unnoticed. ``loop_trips`` is one
    trip count for every loop, or a sequence of ``loops`` of them, one per
    backward branch in listing order (a trip may be fractional: the mean
    over the threads counted)."""
    body, main_end = _body(sass)
    nxt = {a.addr: b.addr for a, b in zip(body, body[1:])}
    by_addr = {i.addr: i for i in body}

    weight = {i.addr: 0.0 if i.addr > main_end else 1.0 for i in body}

    def scale(lo, hi, w):          # [lo, hi)
        for a in weight:
            if lo <= a < hi:
                weight[a] *= w

    back = [(i.target, i.addr) for i in body
            if i.op == "BRA" and i.target is not None and
            i.target <= i.addr <= main_end]
    if len(back) != loops:
        raise ValueError(f"{len(back)} loops in the listing, expected "
                         f"{loops}")
    trips = ([loop_trips] * loops if isinstance(loop_trips, (int, float))
             else list(loop_trips))
    if len(trips) != loops:
        raise ValueError(f"{len(trips)} trip counts for {loops} loops")
    for (lo, hi), n in zip(back, trips):
        scale(lo, hi + 1, n)

    for k, i in enumerate(body):
        if i.addr > main_end:
            break
        if i.op == "BRA" and i.pred is not None and i.target > i.addr:
            if i.target > main_end:
                raise ValueError(f"branch at {i.addr:#x} leaves the body")
            span = [j for j in body if i.addr < j.addr < i.target]
            # the slow path of a division: a few moves and its call, then
            # the join or a jump over the fast path
            if 0 < len(span) <= _SLOW_PATH_MAX and \
                    [j.op for j in span].count("CALL") == 1 and \
                    all(j.pred is None for j in span):
                scale(nxt[i.addr], i.target, 0.0)
        m = _ERFINV_SPLIT.search(i.text) if i.op == "FSETP" else None
        if m:
            br = next((j for j in body[k + 1:k + _ERFINV_BRANCH_WINDOW]
                       if j.op == "BRA" and j.pred == "@!" + m.group(1)),
                      None)
            if br is None:
                raise ValueError(f"erfinvf split at {i.addr:#x} without "
                                 f"its branch")
            prev = [a for a in by_addr if a < br.target][-1]
            join = by_addr[prev]
            if join.op != "BRA" or join.pred is not None or \
                    join.target <= br.target:
                raise ValueError(f"erfinvf tail at {br.target:#x} without "
                                 f"its join")
            scale(br.target, join.target, ERFINV_TAIL)

    for i in body:
        if i.op == "CALL" and weight[i.addr] != 0.0:
            raise ValueError(f"call at {i.addr:#x} on the common path")
        if i.op == "CALL" and i.target <= main_end:
            raise ValueError(f"call at {i.addr:#x} into the body")

    counts = dict.fromkeys(_PIPES, 0.0)
    for i in body:
        counts[pipe(i.op)] += weight[i.addr]
    counts["total"] = sum(counts.values())
    return counts


def issue_bound_ms(counts: Dict[str, float],
                   threads: int) -> Tuple[float, str]:
    """The least time ``threads`` threads of a kernel with per-thread
    ``counts`` (:func:`pipe_counts`) take, and the limit that sets it:
    for each limit, the thread-operations it serves over its rate per SM
    and clock times the SMs and the clock; the largest wins."""
    need = {
        "issue": counts["total"],
        "fmaheavy": counts["imad"],
        "alu": counts["alu"],
        "xu": counts["xu"],
    }
    times = {k: threads * v / (PIPE_RATES[k] * SMS * CLOCK_HZ) * 1e3
             for k, v in need.items()}
    limit = max(times, key=times.get)
    return times[limit], limit
