#!/usr/bin/env python3
"""How long the BD wide form and the IA general body take to build at
large geometries, and whether what builds runs right.

Both kernels unroll their solve over the matrix sizes (a BD user's M =
(K - 1) Nr_u rows, an IA user's N), so the code and its build time grow
with the geometry. For each geometry given the script builds that
geometry's library as ``ops/_build.py`` does (``_build.build``, in a child
process of its own, all started together) and stops a build, with every
process it started, after ``--timeout`` seconds. A JSON line a geometry:

  * ``seconds`` of the build, or ``"stopped"``; the registers and spill
    bytes of each kernel instance (``-Xptxas -v``);
  * on a card, for what built: the launch its library reports
    (``mc_*_launch_info``: threads and shared bytes a block, the scratch
    buffer, resident warps a SM) and a check: ``CHECK_REPS`` reps of one
    tile of 8 x ``CHECK_LANE`` PRNG solves (BD normalized; IA 10
    iterations at noise 0.1) against the plain PyTorch version, rel 2e-4 a
    (rep, tile) sum as ``chip_smoke.py`` holds it, the same bits on a
    rerun, and the kernel's time. ``--no-plain`` leaves the plain version
    out: its LDL^H runs ~M^3 / 6 small torch operations a user, some ten
    minutes at BD M = 120.

Run from the repository root: ``python3 bin/probe_wide_builds.py --bd 16,2
61,2 --ia 15,4,2 --timeout 600 [--no-plain] [--json PATH]``. Needs nvcc.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_ROOT))

CHECK_REPS, CHECK_LANE = 2, 256
REL_TOL = 2e-4
SEED = 4242
IA_ITERS, IA_NV = 10, 0.1


def kernel_of(source, geometry, device):
    """The wrapper of ``source`` at ``geometry`` on ``device``."""
    if source == "mc_bd":
        from pyphysim_tpu_torch.ops.bd_kernel import MonteCarloBD
        return MonteCarloBD(tile=8, lane=CHECK_LANE, K=geometry[0],
                            Nr_u=geometry[1], device=device)
    from pyphysim_tpu_torch.ops.ia_kernel import MonteCarloMaxSinr
    return MonteCarloMaxSinr(tile=8, lane=CHECK_LANE, iterations=IA_ITERS,
                             K=geometry[0], N=geometry[1], Ns=geometry[2],
                             device=device)


def start(geometry_build):
    """A child process that builds one geometry's library."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from pyphysim_tpu_torch.ops import _build; "
            "_build.build([(sys.argv[2], eval(sys.argv[3]))], prebuilt=False)")
    return subprocess.Popen(
        [sys.executable, "-c", code, str(_ROOT), geometry_build[0],
         repr(geometry_build[1])], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)


def wait_all(procs, timeout):
    """Seconds each build took, or None where it was stopped at
    ``timeout`` (its whole process group killed)."""
    tic = time.time()
    out = {}
    while len(out) < len(procs):
        for key, proc in procs.items():
            if key not in out and proc.poll() is not None:
                out[key] = time.time() - tic
        if time.time() - tic > timeout:
            for key, proc in procs.items():
                if key not in out:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
                    out[key] = None
        time.sleep(0.5)
    return out


def check(mc, plain=True):
    """The launch, parity with the plain version (if ``plain``), a rerun
    and the time of one PRNG call of ``mc`` on the card."""
    import torch
    from chip_smoke import best_ms
    run = mc.build(CHECK_REPS, 1)
    args = (SEED, 0) if hasattr(mc, "Nr_u") else (SEED, IA_NV, 0)
    got = run(*args).clone()
    again = run(*args).clone()
    same = bool(torch.equal(got, again))
    out = {"launch": mc.launch_info(), "rerun_bitwise_equal": same,
           "kernel_ms": best_ms(lambda: run(*args)),
           "solves": CHECK_REPS * 8 * CHECK_LANE, "finite": bool(
               torch.isfinite(got).all()), "ok": same}
    if plain:
        want = (mc.prng_reference(CHECK_REPS, 1, SEED, 0)
                if hasattr(mc, "Nr_u")
                else mc.prng_reference(CHECK_REPS, 1, SEED, IA_NV, 0))
        torch.cuda.synchronize()
        rel = float(((got - want).abs() / want.abs()).max())
        out.update(max_rel_cell_diff=rel, ok=same and rel <= REL_TOL)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--bd", nargs="*", default=[], help="K,Nr_u ...")
    parser.add_argument("--ia", nargs="*", default=[], help="K,N,Ns ...")
    parser.add_argument("--timeout", type=float, default=600.0)
    parser.add_argument("--json", help="also write the results here")
    parser.add_argument("--no-plain", action="store_true",
                        help="no comparison with the plain version")
    args = parser.parse_args()

    import torch
    from chip_smoke import card, ptxas_info
    from pyphysim_tpu_torch.ops import _build
    points = [("mc_bd", tuple(map(int, g.split(",")))) for g in args.bd]
    points += [("mc_ia", tuple(map(int, g.split(",")))) for g in args.ia]
    smi = card() if torch.cuda.is_available() else None
    print(smi, flush=True)
    builds = {p: kernel_of(*p, "cpu").geometry_build() for p in points}
    procs = {p: start(b) for p, b in builds.items()}
    seconds = wait_all(procs, args.timeout)
    results = []
    for point in points:
        source, geometry = point
        path = _build.library_path(builds[point])
        log = path.with_suffix(".log")
        row = {"source": source, "geometry": list(geometry),
               "seconds": seconds[point] if path.exists() else "stopped",
               "library": path.name}
        if seconds[point] is not None and not path.exists():
            row["seconds"] = "failed"
            row["nvcc"] = procs[point].stdout.read()[-2000:]
        row["ptxas"] = ptxas_info(log.read_text() if log.exists() else "",
                                  "mc_(?:bd|ia)_(?:wide_|general_)?kernel")
        if path.exists() and smi is not None:
            row.update(check(kernel_of(source, geometry, "cuda"),
                             not args.no_plain))
        print(json.dumps(row), flush=True)
        results.append(row)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": smi, "timeout_s": args.timeout,
                       "results": results}, f, indent=1)
    return 0 if all(r.get("ok", True) and r["seconds"] != "failed"
                    for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
