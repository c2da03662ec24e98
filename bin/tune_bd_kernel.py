#!/usr/bin/env python3
"""Variants of the BD capacity kernel, timed in turns on one card.

Each variant is the committed ``pyphysim_tpu_torch/ops/csrc/mc_bd.cu`` with
a few lines substituted (the register cap that ``__launch_bounds__`` sets,
the threads of a block, whether the compiler unrolls the user loop), or,
with ``--parent DIR``, the ``mc_bd.cu`` of another checkout (the same C
interface). Every variant is cut to its
(K, Nr_u) = (3, 2) PRNG-mode instances and built by its own ``nvcc`` into a
library of its own under ``ops/_build/tune/``, all started together. At the
bench chunk (128 reps x 4 tiles x 8 x 512 solves, normalized) the script
prints for every variant (``bin/_tune.py`` builds and times them):

  * registers and spill bytes per thread (``-Xptxas -v``);
  * the kernel time, best of 3 rounds of 10 launches, the variants timed in
    turns (forward, backward, forward) so that drift hits all alike;
  * its instruction-issue bound from its own SASS (``ops/sass.py``) and the
    share of that bound it reaches, and its share of the bound of the
    fewest instructions known for the function
    (``chip_smoke.BD_FEWEST_SASS_PER_SOLVE``);
  * the largest relative difference of its per-rep capacity sums from the
    plain PyTorch version on the same Philox bits.

Run from the repository root: ``python3 bin/tune_bd_kernel.py [--parent
DIR] [--json PATH]``. Needs a CUDA device and nvcc.
"""

import argparse
import json
import re
import sys
from pathlib import Path

import _tune

TILE, LANE, NUM_TILES, REPS = 8, 512, 4, 128
K, NR, NT = 3, 2, 6
CALLS = 2 * NT * NT // 4
SEED = 4242
_BOUNDS = "__launch_bounds__(kThreads, min_blocks<K * NR>())"
_THREADS = "constexpr int kThreads = 128;"
_UNROLLED = "#pragma unroll  // "
# cut every variant to the (3, 2) PRNG instances
_ONLY_3_2 = [(f"  if (K == {k} && NR == {n}) return launch_mode<{k}, {n}, "
              f"kInject>(p, mode, blocks, s);\n", "")
             for k, n in ((2, 1), (2, 2), (4, 1), (4, 2))] + [
    ("? launch_geometry<true>(p, K, NR, mode, (int)blocks, s)",
     "? (int)cudaErrorInvalidValue")]


def _threads(n):
    return (_THREADS, f"constexpr int kThreads = {n};")


def _rolled(loop):
    return (_UNROLLED + loop, "#pragma unroll 1  // " + loop)


_COMMITTED_TRIPS = [CALLS] + [NT] * (2 * K)  # Philox calls, 2 passes a user

# name: (substitutions, the loops' trips in listing order)
VARIANTS = {
    "committed": ([], _COMMITTED_TRIPS),
    "no register cap": ([(_BOUNDS, "__launch_bounds__(kThreads)")],
                        _COMMITTED_TRIPS),
    "64 threads a block": ([_threads(64)], _COMMITTED_TRIPS),
    "256 threads a block": ([_threads(256)], _COMMITTED_TRIPS),
    "users rolled": ([_rolled("users")], [CALLS, NT, NT, K]),
}


def build_variants(parent):
    """{name: (library path, ptxas of the (3, 2) instances, elements a
    thread)}; every nvcc started together."""
    from pyphysim_tpu_torch.ops import _build
    sources, per_thread = {}, {}
    variants = [(name, _build.SRC_DIR, subs)
                for name, (subs, _) in VARIANTS.items()]
    if parent:
        variants.append(("parent", Path(parent) / "pyphysim_tpu_torch" /
                         "ops" / "csrc", []))
    for name, src, subs in variants:
        text = _tune.substitute(name, (src / "mc_bd.cu").read_text(),
                                list(subs) + _ONLY_3_2)
        sources[name] = (text, src)
        # one element a thread, or kElemsPerThread (an older design)
        m = re.search(r"constexpr int kElemsPerThread = (\d+);", text)
        per_thread[name] = int(m.group(1)) if m else 1
    built = _tune.build_variants(sources, "bd_variant", "mc_bd_kernel")
    return {name: (lib, ptxas, per_thread[name])
            for name, (lib, ptxas) in built.items()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tune_bd_kernel: no CUDA device", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a checkout whose mc_bd.cu is "
                        "timed beside the variants")
    parser.add_argument("--json", help="also write the results here")
    args = parser.parse_args()

    from chip_smoke import BD_FEWEST_SASS_PER_SOLVE, card
    from pyphysim_tpu_torch.ops import _build, sass
    from pyphysim_tpu_torch.ops.bd_kernel import MODES, MonteCarloBD

    smi = card()
    print(smi, flush=True)
    built = build_variants(args.parent)
    dev = torch.device("cuda")
    mc = MonteCarloBD(tile=TILE, lane=LANE, device=dev)
    want = mc.prng_reference(REPS, NUM_TILES, SEED, 0).sum(dim=1)
    ipu, nv = mc._scalars(None, None)
    mode = MODES.index(mc.mode)
    pattern = mc.prng_kernel_profile(REPS, NUM_TILES)["pattern"]
    calls, results = [], []
    for name, (lib_path, ptxas, per_thread) in built.items():
        fn = _tune.function(lib_path, "mc_bd_prng")
        parts = _tune.function(lib_path, "mc_bd_num_parts")(TILE, LANE)
        partial = torch.empty(REPS * NUM_TILES * parts, dtype=torch.float32,
                              device=dev)
        out = torch.empty((REPS, NUM_TILES), dtype=torch.float32, device=dev)

        def call(fn=fn, out=out, partial=partial):
            _build.check(fn(out.data_ptr(), partial.data_ptr(), REPS,
                            NUM_TILES, TILE, LANE, K, NR, mode, ipu, nv, SEED,
                            0, torch.cuda.current_stream().cuda_stream),
                         name)
            return out
        got = call().sum(dim=1)
        torch.cuda.synchronize()
        rel = float(((got - want).abs() / want.abs()).max())
        # every loop runs all of its trips; the parent's kernel unrolled
        # all but its element loop
        trips = VARIANTS[name][1] if name in VARIANTS else [per_thread]
        try:
            counts = sass.pipe_counts(sass.function_sass(lib_path, pattern),
                                      loop_trips=trips, loops=len(trips))
            issue_ms, pipe = sass.issue_bound_ms(
                counts, REPS * NUM_TILES * TILE * LANE // per_thread)
        except ValueError as exc:     # a listing of another shape
            counts, issue_ms, pipe = {"total": float("nan")}, \
                float("nan"), str(exc)
        calls.append(call)
        info = ptxas.get(pattern[:-1], "")   # the instance's ptxas_info key
        results.append({"variant": name, "ptxas": info,
                        "registers": int(info.split()[0]) if info else None,
                        "sass_per_thread": round(counts["total"], 1),
                        "bound_ms": issue_ms, "bound_pipe": pipe,
                        "max_rel_rep_diff": rel})
    for row, ms in zip(results, _tune.time_in_turns(calls)):
        row["ms"] = ms
    solves = REPS * NUM_TILES * TILE * LANE
    fewest_ms = sass.issue_bound_ms(BD_FEWEST_SASS_PER_SOLVE, solves)[0]
    for row in results:
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["share_of_fewest_bound"] = fewest_ms / row["ms"]
        row["solves_per_s"] = solves / row["ms"] * 1e3
        print(json.dumps(row), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": smi, "shape": f"reps={REPS},tiles={NUM_TILES},"
                       f"tile={TILE},lane={LANE},K=3,Nr_u=2,normalized",
                       "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
