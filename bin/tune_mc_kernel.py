#!/usr/bin/env python3
"""Block-shape variants of the flagship Monte Carlo kernel, timed in turns
on one card.

Each variant is the committed ``pyphysim_tpu_torch/ops/csrc/mc_ofdm_tdl.cu``
with a few lines substituted (rows per block, the unrolling of the row
loop, a register cap for four blocks of 320 threads per SM, the
equalizer's two divisions instead of one reciprocal), built by
its own ``nvcc`` into a library of its own under ``ops/_build/tune/``
(``bin/_tune.py``). At
the flagship chunk (32 reps x 4 tiles x 1,024 symbols x 300 bins, PRNG
mode) the script prints for every variant and channel-product type:

  * registers per thread (``-Xptxas -v``);
  * the kernel time, best of 3 rounds of 10 launches, the variants timed
    in turns (forward, backward, forward) so that drift hits all alike;
  * the error counts' largest and summed difference from the committed
    kernel on the same Philox bits (rows per block and unrolling leave
    every count as it is; the divisions may flip a few decisions).

Run from the repository root: ``python3 bin/tune_mc_kernel.py [--json
PATH]``. Needs a CUDA device and nvcc.
"""

import argparse
import json
import sys

import _tune

TILE, NUM_TILES, REPS = 1024, 4, 32
SEED, SNR = 1234567, 10 ** 1.5
_ROWS = "constexpr int kRows = 64;"
_ROW_LOOP = "#pragma unroll 1\n    for (int r = 0; r < nrows; ++r) {"
_EQ = ("  const float inv = 1.0f / (hr * hr + hi * hi + 1e-30f);\n"
       "  const float eqr = (yr * hr + yi * hi) * inv;\n"
       "  const float eqi = (yi * hr - yr * hi) * inv;\n")
_EQ_TWO_DIVISIONS = (
    "  const float den = hr * hr + hi * hi + 1e-30f;\n"
    "  const float eqr = (yr * hr + yi * hi) / den;\n"
    "  const float eqi = (yi * hr - yr * hi) / den;\n")

_BOUNDS = "__launch_bounds__(kMaxThreads)"
_UNROLL2 = (_ROW_LOOP, _ROW_LOOP.replace("unroll 1", "unroll 2"))
_FOUR_BLOCKS = (_BOUNDS, "__launch_bounds__(320, 4)")   # <= 51 registers


def _rows(n):
    return (_ROWS, f"constexpr int kRows = {n};")


VARIANTS = {
    "committed (64 rows)": [],
    "16 rows": [_rows(16)],
    "32 rows": [_rows(32)],
    "128 rows": [_rows(128)],
    "64 rows, row loop unrolled 2": [_UNROLL2],
    "32 rows, row loop unrolled 2": [_rows(32), _UNROLL2],
    "64 rows, 4 blocks of 320 a SM": [_FOUR_BLOCKS],
    "32 rows, 4 blocks of 320 a SM": [_rows(32), _FOUR_BLOCKS],
    "64 rows, two divisions": [(_EQ, _EQ_TWO_DIVISIONS)],
}


def build_variants():
    """{name: (library path, {dtype: registers})}; every nvcc started
    together."""
    from pyphysim_tpu_torch.ops import _build
    src = (_build.SRC_DIR / "mc_ofdm_tdl.cu").read_text()
    sources = {name: (_tune.substitute(name, src, subs), _build.SRC_DIR)
               for name, subs in VARIANTS.items()}
    built = _tune.build_variants(sources, "variant", "mc_ofdm_tdl_kernel")
    # the PRNG-mode instances at 16 taps, by channel-product type
    instances = {"float32": "mc_ofdm_tdl_kernelILi16ELb0ELb0E",
                 "bfloat16": "mc_ofdm_tdl_kernelILi16ELb0ELb1E"}
    return {name: (lib, {dtype: int(ptxas[inst].split()[0])
                         for dtype, inst in instances.items()
                         if inst in ptxas})
            for name, (lib, ptxas) in built.items()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tune_mc_kernel: no CUDA device", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write the results here")
    args = parser.parse_args()

    from apps.ofdm.ofdm_mc_kernel_torch import OfdmMcKernelSimulationRunner
    from chip_smoke import card
    from pyphysim_tpu_torch.ops import _build
    from pyphysim_tpu_torch.ops.mc_kernel import MonteCarloOfdmTdl

    smi = card()
    print(smi, flush=True)
    built = build_variants()
    dev = torch.device("cuda")
    r = OfdmMcKernelSimulationRunner(device=dev, read_command_line_args=False)
    results = []
    for dtype in ("float32", "bfloat16"):
        mc = MonteCarloOfdmTdl(r.ofdm, r.channel, M=16, tile=TILE,
                               matmul_dtype=dtype, device=dev)
        amp = mc.amp(SNR)
        want = mc.build(REPS, NUM_TILES)(SEED, SNR, 0)
        calls, mine = [], []
        for name, (lib, regs) in built.items():
            fn = _tune.function(lib, "mc_ofdm_tdl_prng")
            out = torch.zeros((REPS, NUM_TILES), dtype=torch.int32,
                              device=dev)
            g_re, g_im, o, *geom = mc._common_args(out, REPS, NUM_TILES, amp)

            def call(fn=fn, out=out, g_re=g_re, g_im=g_im, o=o, geom=geom):
                out.zero_()
                _build.check(fn(g_re, g_im, o, *geom, SEED, 0,
                                torch.cuda.current_stream().cuda_stream),
                             "variant")
                return out
            diff = (call().to(torch.int64) - want.to(torch.int64)).abs()
            calls.append(call)
            mine.append({"variant": name, "dtype": dtype,
                         "registers": regs.get(dtype),
                         "max_abs_count_diff": int(diff.max()),
                         "sum_abs_count_diff": int(diff.sum())})
        syms = REPS * NUM_TILES * TILE * mc.used
        for row, ms in zip(mine, _tune.time_in_turns(calls)):
            row["ms"] = ms
            row["sym_per_s"] = syms / ms * 1e3
            print(json.dumps(row), flush=True)
        results += mine
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": smi, "shape": f"reps={REPS},tiles={NUM_TILES},"
                       f"tile={TILE},used=300", "results": results}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
