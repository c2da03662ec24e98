#!/usr/bin/env python3
"""The BD and IA wide forms beside another checkout's, timed on one card.

For each geometry the script builds, every ``nvcc`` started together
(``bin/_tune.py``), each into a library of its own under
``ops/_build/tune/``:

  * the tree's library as ``ops/_build.py`` builds it (``mc_bd.cu`` /
    ``mc_ia.cu`` with the geometry's ``-D`` defines; at a point the
    prebuilt library holds, the whole source);
  * with ``--parent DIR``, the parent checkout's, built the same way from
    DIR's sources (the same C interface but ``mc_ia_num_parts``, which took
    no K before);
  * with ``--grid``, the tree's variants: every pair of lanes a user's
    solve (``Lu``) and users solved at once (``U``), each set in the
    source's text in place of its rule (struct Wide of ``mc_bd.cu``,
    struct GroupIA of ``mc_ia.cu``; the committed pair is timed again
    among them, a check of the timing's spread), and 1 or 2 warps a block
    (``wide::kMaxWarps``, in a copy of the headers under
    ``ops/_build/tune/``).

At the bench chunk (128 reps x 4 tiles x 8 x 512 PRNG solves, BD
normalized, IA 10 iterations at noise 0.1) it prints for every geometry
and variant:

  * registers and spill bytes of the PRNG instance (``-Xptxas -v``), and
    for the tree's libraries the launch they report
    (``mc_*_launch_info``: threads and shared bytes a block, resident warps
    a SM);
  * the kernel time, best of 3 rounds of 10 launches, a geometry's variants
    timed in turns (forward, backward, forward) so that drift hits all
    alike, and the share of the f32-operation bound
    (``chip_smoke.bd_solve_flops`` / ``ia_solve_flops`` at 67 TFLOP/s);
  * the largest relative difference of its per-rep capacity sums from the
    plain PyTorch version on the chunk's first ``CHECK_REPS`` reps.

Run from the repository root: ``python3 bin/tune_wide_kernel.py [--parent
DIR] [--json PATH] [--only bd|ia] [--grid]``. Needs a CUDA device and
nvcc.
"""

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

import _tune

TILE, LANE, NUM_TILES, REPS = 8, 512, 4, 128
CHECK_REPS = 8
IA_ITERS, IA_NV = 10, 0.1
SEED = 4242
BD_POINTS = ((5, 2), (7, 2), (8, 2), (11, 2))
IA_POINTS = ((2, 3, 1), (3, 4, 1), (2, 4, 2), (3, 4, 2), (4, 4, 2))
LANES = {"mc_bd": (4, 8, 16), "mc_ia": (2, 4, 8)}   # a user's solve
USERS = (1, 2, 4, 8)         # users solved at once
MAX_ROWS = 4                 # rows a lane at most in a lanes variant
_WARPS = "constexpr int kMaxWarps = 4;"
# the lanes-a-user and users-at-once rules of each source, as written there
_RULES = {"mc_bd": ("static constexpr int Lu = wide::lanes_for((NT + 3) / 4, "
                    "4);", "static constexpr int U = default_users();"),
          "mc_ia": ("static constexpr int Lu = wide::lanes_for((N + 1) / 2, "
                    "1);", "static constexpr int U = Lu < 32 ? 2 : 1;")}
# the parent's mc_ia_num_parts(tile, lane, N, Ns)
_OLD_IA_PARTS = [ctypes.c_int] * 4


def _warps(n):
    return (_WARPS, f"constexpr int kMaxWarps = {n};")


def _pair(source, lanes, users):
    """The substitutions in ``source``'s text that set Lu and U."""
    lu, u = _RULES[source]
    return [(lu, f"static constexpr int Lu = {lanes};"),
            (u, f"static constexpr int U = {users};")]


def variants(source, geometry, prebuilt, grid=False):
    """``{name: (defines, substitutions in the source, substitutions in
    wide.cuh)}`` at one geometry: the committed source; with ``grid`` also
    every pair of ``LANES`` lanes a user's solve (at most ``MAX_ROWS`` rows
    a lane) and ``USERS`` users at once (within a warp, below 2 K), and 1
    or 2 warps a block. BD varies in a library of one geometry, IA also in
    the prebuilt library (its text reaches every general-body
    instance)."""
    if prebuilt and source == "mc_bd":
        return {"committed": ({}, [], [])}
    if source == "mc_bd":
        K, NR = geometry
        rows = K * NR
        defines = {"MC_BD_K": K, "MC_BD_NR": NR}
    else:
        K, rows, NS = geometry
        defines = {} if prebuilt else {"MC_IA_K": K, "MC_IA_N": rows,
                                       "MC_IA_NS": NS}
    out = {"committed": (defines, [], [])}
    if not grid:
        return out
    for n in LANES[source]:
        for u in USERS:
            if -(-rows // n) <= MAX_ROWS and n * u <= 32 and u < 2 * K:
                out[f"{n} lanes a user, {u} users at once"] = (
                    defines, _pair(source, n, u), [])
    out["1 warp a block"] = (defines, [], [_warps(1)])
    out["2 warps a block"] = (defines, [], [_warps(2)])
    return out


def headers(subs):
    """The include directory of a variant: the sources' own, or a copy of
    their headers under ``ops/_build/tune/`` with ``wide.cuh``
    substituted."""
    from pyphysim_tpu_torch.ops import _build
    if not subs:
        return _build.SRC_DIR
    out = _build.BUILD_DIR / "tune" / ("csrc_" + "_".join(
        new.split()[-1].strip(";") for _, new in subs))
    out.mkdir(parents=True, exist_ok=True)
    for header in _build.SRC_DIR.glob("*.cuh"):
        text = header.read_text()
        if header.name == "wide.cuh":
            text = _tune.substitute(header.name, text, subs)
        (out / header.name).write_text(text)
    return out


def sources(parent, only, grid=False):
    """``{(source, geometry, variant): (CUDA text, include directory,
    defines)}`` of every library to build; a prebuilt point's library is
    built once for all the points it holds."""
    from pyphysim_tpu_torch.ops import _build, bd_kernel, ia_kernel
    points = []
    if only in (None, "bd"):
        points += [("mc_bd", g, g in bd_kernel.PREBUILT) for g in BD_POINTS]
    if only in (None, "ia"):
        points += [("mc_ia", g, g in ia_kernel.PREBUILT) for g in IA_POINTS]
    out = {}
    for source, geometry, prebuilt in points:
        key_geo = "prebuilt" if prebuilt else geometry
        for name, (defines, rules, subs) in variants(
                source, geometry, prebuilt, grid).items():
            text = _tune.substitute(
                f"{source}.cu",
                (_build.SRC_DIR / f"{source}.cu").read_text(), rules)
            out[source, key_geo, name] = (text, headers(subs), defines)
        if parent:
            src = Path(parent) / "pyphysim_tpu_torch" / "ops" / "csrc"
            defines = variants(source, geometry, prebuilt)["committed"][0]
            out[source, key_geo, "parent"] = (
                (src / f"{source}.cu").read_text(), src, defines)
    return points, out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tune_wide_kernel: no CUDA device", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a checkout whose mc_bd.cu and "
                        "mc_ia.cu are timed beside the tree's")
    parser.add_argument("--json", help="also write the results here")
    parser.add_argument("--only", choices=("bd", "ia"))
    parser.add_argument("--grid", action="store_true", help="also every "
                        "pair of lanes a user and users at once, and 1 or 2 "
                        "warps a block")
    args = parser.parse_args()

    from chip_smoke import bd_solve_flops, bound_ms, card, ia_solve_flops
    from pyphysim_tpu_torch.ops import _build
    from pyphysim_tpu_torch.ops.bd_kernel import MODES, MonteCarloBD
    from pyphysim_tpu_torch.ops.ia_kernel import MonteCarloMaxSinr

    smi = card()
    print(smi, flush=True)
    points, srcs = sources(args.parent, args.only, args.grid)
    keys = list(srcs)
    built = _tune.build_variants({str(i): srcs[k] for i, k in
                                  enumerate(keys)}, "wide_variant",
                                 "mc_(?:bd|ia)_(?:wide_|general_)?kernel")
    built = {k: built[str(i)] for i, k in enumerate(keys)}
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    results = []
    for source, geometry, prebuilt in points:
        key_geo = "prebuilt" if prebuilt else geometry
        names = [n for (s, g, n) in keys if (s, g) == (source, key_geo)]
        bd = source == "mc_bd"
        mc = (MonteCarloBD(tile=TILE, lane=LANE, K=geometry[0],
                           Nr_u=geometry[1], device=dev) if bd else
              MonteCarloMaxSinr(tile=TILE, lane=LANE, iterations=IA_ITERS,
                                K=geometry[0], N=geometry[1],
                                Ns=geometry[2], device=dev))
        if bd:
            want = mc.prng_reference(CHECK_REPS, NUM_TILES, SEED, 0)
            flops = bd_solve_flops(*geometry)
            pattern = (f"mc_bd_wide_kernelILi{geometry[0]}ELi{geometry[1]}"
                       f"ELi0ELb0E")
        else:
            want = mc.prng_reference(CHECK_REPS, NUM_TILES, SEED, IA_NV, 0)
            flops = ia_solve_flops(*geometry, IA_ITERS, mc.init_iters)
            pattern = "mc_ia_(?:wide|general)_kernelILi{}ELi{}ELi{}ELb0E" \
                .format(*geometry)
        want = want.sum(dim=1)
        calls, rows = [], []
        for name in names:
            lib_path, ptxas = built[source, key_geo, name]
            fn = _tune.function(lib_path, f"{source}_prng")
            if bd:
                parts = _tune.function(lib_path, "mc_bd_num_parts")(TILE,
                                                                    LANE)
            elif name == "parent":
                parts = _tune.function(lib_path, "mc_ia_num_parts",
                                       _OLD_IA_PARTS)(TILE, LANE,
                                                      *geometry[1:])
            else:
                parts = _tune.function(lib_path, "mc_ia_num_parts")(
                    TILE, LANE, *geometry)
            nbytes = _tune.function(lib_path, f"{source}_scratch_bytes")(
                REPS, NUM_TILES, TILE, LANE)
            scratch = _build.state_buffer(nbytes, dev, f"{source} {name}")
            partial = torch.empty(REPS * NUM_TILES * parts,
                                  dtype=torch.float32, device=dev)
            out = torch.empty((REPS, NUM_TILES), dtype=torch.float32,
                              device=dev)
            if bd:
                ipu, nv = mc._scalars(None, None)
                args_ = (REPS, NUM_TILES, TILE, LANE, *geometry,
                         MODES.index(mc.mode), ipu, nv, SEED, 0)
            else:
                args_ = (REPS, NUM_TILES, TILE, LANE, *geometry, IA_ITERS,
                         mc.init_iters, float(mc.P), IA_NV, SEED, 0)

            def call(fn=fn, out=out, partial=partial, scratch=scratch,
                     args_=args_, name=name):
                _build.check(fn(out.data_ptr(), partial.data_ptr(), *args_,
                                scratch.data_ptr(), stream), name)
                return out
            got = call()[:CHECK_REPS].sum(dim=1)
            torch.cuda.synchronize()
            info = next((v for k, v in ptxas.items()
                         if re.fullmatch(pattern, k)), "")
            row = {"source": source, "geometry": list(geometry),
                   "variant": name, "ptxas": info,
                   "max_rel_rep_diff": float(((got - want).abs() /
                                              want.abs()).max())}
            if name != "parent":
                fn_info = _tune.function(lib_path, f"{source}_launch_info")
                row["launch"] = _build.launch_info(
                    fn_info, *geometry, *([0] if bd else []))
            calls.append(call)
            rows.append(row)
        solves = REPS * NUM_TILES * TILE * LANE
        bound, _ = bound_ms(flops=flops * solves)
        for row, ms in zip(rows, _tune.time_in_turns(calls)):
            row.update(ms=ms, bound_ms=bound, share_of_bound=bound / ms,
                       solves_per_s=solves / ms * 1e3)
            print(json.dumps(row), flush=True)
            results.append(row)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": smi, "shape": f"reps={REPS},tiles={NUM_TILES},"
                       f"tile={TILE},lane={LANE}; BD normalized; IA "
                       f"{IA_ITERS} iterations, noise {IA_NV}",
                       "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
