#!/usr/bin/env python3
"""Variants of the flagship Monte Carlo kernel, timed in turns on one card.

Each variant is the committed ``pyphysim_tpu_torch/ops/csrc/mc_ofdm_tdl.cu``
with a few lines substituted, built by its own ``nvcc`` into a library of
its own under ``ops/_build/tune/`` (``bin/_tune.py``); with ``--parent
DIR`` the ``mc_ofdm_tdl.cu`` of another checkout is built and timed beside
them, called through its own C interface (an earlier one without the
launch's tile range, whose general form reads G_tap padded to 32 taps and
folds every tile into one launch). Shapes (``--shapes``, one after the
other on the same libraries, PRNG mode, both channel-product types):

  * ``flagship``: 32 reps x 4 tiles x 1,024 symbols x 300 bins, COST259-TU
    16 taps x 16 rays (the fast instance; its variants: rows per block,
    the row loop's unrolling, a register cap for four blocks of 320
    threads per SM, the equalizer's two divisions instead of one
    reciprocal; with f1, ``LAYOUT_VARIANTS``: the launch's first tile
    elsewhere in the kernels' parameters);
  * ``f1``: the same chunk under the IEEE 802.11 exponential profile at
    Trms = 250 ns (51 taps) x 32 rays (the general form; its variants,
    ``GENERAL_VARIANTS``: taps of G_tap a chunk, rows a group, bins a
    block, blocks a SM its registers allow);
  * ``f2tiles``: 2 reps x 70,000 tiles of 8 symbols, 16 taps x 16 rays
    (the fast instance over two launches; the parent's general form).

For every variant, shape and type the script prints registers per thread
(``-Xptxas -v``), resident blocks a SM where the library reports them
(``mc_ofdm_tdl_launch_info``), the kernel time (best of 3 rounds of 10
calls, the variants timed in turns: forward, backward, forward) and the
error counts' largest and summed difference from the committed kernel on
the same Philox bits (block shapes and chunking leave every count as it
is; the divisions may flip a few decisions).

Run from the repository root: ``python3 bin/tune_mc_kernel.py [--parent
DIR] [--shapes flagship,f1,f2tiles] [--json PATH]``. Needs a CUDA device
and nvcc.
"""

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

import _tune

TILE, NUM_TILES, REPS = 1024, 4, 32
SEED, SNR = 1234567, 10 ** 1.5
# --shapes: name -> (reps, tiles, tile, profile)
SHAPES = {"flagship": (REPS, NUM_TILES, TILE, "cost259_tu"),
          "f1": (REPS, NUM_TILES, TILE, "exponential"),
          "f2tiles": (2, 70000, 8, "cost259_tu")}
_vp, _i, _ll, _f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_float)
# mc_ofdm_tdl_prng's arguments before the launch's tile range was added
EARLIER_ARGTYPES = [_vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _f, _f, _f,
                    _f, _i, _vp, ctypes.c_uint, _ll, _vp, _vp]
EARLIER_PAD = 32      # the earlier general form's G_tap: taps padded to 32
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


def _gen(name, old, new):
    return (f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


# the general form's constants, timed at f1
GENERAL_VARIANTS = {
    "general: chunks of 16 taps": [_gen("kChunk", 8, 16)],
    "general: chunks of 32 taps": [_gen("kChunk", 8, 32)],
    "general: groups of 4 rows": [_gen("kGroup", 8, 4)],
    "general: 384 bins a block": [_gen("kGenThreads", 320, 384)],
    "general: 1 block a SM": [_gen("kGenMinBlocks", 2, 1)],
    "general: 3 blocks a SM": [_gen("kGenMinBlocks", 2, 3)],
}

# where the launch's first tile sits in Params, timed at the flagship and
# at f1: the field's place moves both forms' code
_NUM_TILES = "  int num_tiles;   // tiles of the call: a rep's row of out\n"
_HALF_BITS = "  int M, Lq, half_bits;\n"
_END = "  long long start;\n};"
_NO_TILE0 = ("  int tile0;\n" + _HALF_BITS, _HALF_BITS)
LAYOUT_VARIANTS = {
    "tile0 after num_tiles": [_NO_TILE0,
                              (_NUM_TILES, _NUM_TILES + "  int tile0;\n")],
    "tile0 at the end of Params": [
        _NO_TILE0, (_END, "  long long start;\n  int tile0;\n};")],
}

COMMITTED = "committed (64 rows)"
VARIANTS = {
    COMMITTED: [],
    "16 rows": [_rows(16)],
    "32 rows": [_rows(32)],
    "128 rows": [_rows(128)],
    "64 rows, row loop unrolled 2": [_UNROLL2],
    "32 rows, row loop unrolled 2": [_rows(32), _UNROLL2],
    "64 rows, 4 blocks of 320 a SM": [_FOUR_BLOCKS],
    "32 rows, 4 blocks of 320 a SM": [_rows(32), _FOUR_BLOCKS],
    "64 rows, two divisions": [(_EQ, _EQ_TWO_DIVISIONS)],
}


def sources(parent, shapes=("flagship",)):
    """{name: (CUDA text, include directory)} of the committed source, of
    the variants timed at ``shapes`` (``VARIANTS`` at the flagship,
    ``GENERAL_VARIANTS`` at f1, ``LAYOUT_VARIANTS`` at either) and of the
    parent's."""
    from pyphysim_tpu_torch.ops import _build
    src = (_build.SRC_DIR / "mc_ofdm_tdl.cu").read_text()
    variants = {COMMITTED: [],
                **(VARIANTS if "flagship" in shapes else {}),
                **(GENERAL_VARIANTS if "f1" in shapes else {}),
                **(LAYOUT_VARIANTS if {"flagship", "f1"} & set(shapes)
                   else {})}
    out = {name: (_tune.substitute(name, src, subs), _build.SRC_DIR)
           for name, subs in variants.items()}
    if parent:
        csrc = Path(parent) / "pyphysim_tpu_torch" / "ops" / "csrc"
        out["parent"] = ((csrc / "mc_ofdm_tdl.cu").read_text(), csrc)
    return out


def builder(shape, dtype, dev):
    """The shape's ``MonteCarloOfdmTdl`` in one channel-product type."""
    from apps.ofdm.ofdm_mc_kernel_torch import OfdmMcKernelSimulationRunner
    from chip_smoke import EXP_RAYS, EXP_TRMS_F1, exponential_profile
    from pyphysim_tpu_torch.channels import JakesSampleGenerator, TdlChannel
    from pyphysim_tpu_torch.ops.mc_kernel import MonteCarloOfdmTdl
    r = OfdmMcKernelSimulationRunner(device=dev, read_command_line_args=False)
    channel = r.channel
    if SHAPES[shape][3] == "exponential":
        channel = TdlChannel(
            JakesSampleGenerator(Fd=30.0, Ts=1 / 20e6, L=EXP_RAYS,
                                 device=dev),
            exponential_profile(EXP_TRMS_F1, 1 / 20e6))
    return MonteCarloOfdmTdl(r.ofdm, channel, M=16, tile=SHAPES[shape][2],
                             matmul_dtype=dtype, device=dev)


def padded_pairs(mc, pad):
    """``mc``'s G_tap pairs with zero taps up to a multiple of ``pad``."""
    import torch
    pairs = torch.zeros((-(-mc.taps // pad) * pad, mc.used, 2),
                        dtype=torch.float32, device=mc.g_tap_pairs.device)
    pairs[:mc.taps] = mc.g_tap_pairs[:mc.taps]
    return pairs


def variant_call(name, lib, text, mc, reps, tiles, amp, out):
    """A call of the variant's ``mc_ofdm_tdl_prng`` as its wrapper makes
    it: the committed interface once a launch slice, with G_tap padded to
    the variant's chunk (``kChunk``); the parent's earlier one in one
    launch (its general form folds the tiles) with G_tap padded to 32
    taps."""
    import torch
    from pyphysim_tpu_torch.ops import _build
    stream = torch.cuda.current_stream().cuda_stream
    if "int tile0" in text:
        fn = _tune.function(lib, "mc_ofdm_tdl_prng")
        chunk = int(re.search(r"constexpr int kChunk = (\d+);",
                              text).group(1))
        pairs = padded_pairs(mc, chunk)
        launches = []
        for r0, r1, t0, t1 in mc._launches(reps, tiles):
            *args, _ = mc._common_args(out[r0:r1], r1 - r0, tiles, amp)
            launches.append((r0, t0, t1, args))

        def call(pairs=pairs):
            out.zero_()
            for r0, t0, t1, (g_re, g_im, o, *geom) in launches:
                _build.check(fn(g_re, g_im, o, *geom, pairs.data_ptr(), SEED,
                                r0, t0, t1 - t0, None, stream), name)
            return out
        return call
    fn = _tune.function(lib, "mc_ofdm_tdl_prng", EARLIER_ARGTYPES)
    pairs = padded_pairs(mc, EARLIER_PAD)
    g_re, g_im, o, *geom = mc._common_args(out, reps, tiles, amp)
    geom[-1] = pairs.data_ptr()

    def call(pairs=pairs):
        out.zero_()
        _build.check(fn(g_re, g_im, o, *geom, SEED, 0, None, stream), name)
        return out
    return call


def launch_info(lib, mc, reps, tiles):
    """The variant's ``mc_ofdm_tdl_launch_info`` of the first launch, or
    None where its library has none."""
    try:
        fn = _tune.function(lib, "mc_ofdm_tdl_launch_info")
    except AttributeError:
        return None
    out = (ctypes.c_int * 4)()
    if fn(min(reps, 65535), min(tiles, 65535), mc.tile, mc.used, mc.TL,
          mc.taps, tiles, int(mc.bf16), out):
        return None
    return dict(zip(("registers", "local_bytes", "static_smem_bytes",
                     "blocks_per_sm"), out))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tune_mc_kernel: no CUDA device", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a checkout whose mc_ofdm_tdl.cu "
                        "is timed beside the variants")
    parser.add_argument("--shapes", default="flagship",
                        help="comma-separated names of SHAPES")
    parser.add_argument("--json", help="also write the results here")
    args = parser.parse_args()

    from chip_smoke import card

    smi = card()
    print(smi, flush=True)
    shapes = args.shapes.split(",")
    texts = sources(args.parent, shapes)
    built = _tune.build_variants(texts, "variant", "mc_ofdm_tdl_\\w*kernel")
    dev = torch.device("cuda")
    results = []
    for shape in shapes:
        reps, tiles, _, _ = SHAPES[shape]
        # the variants that differ at this shape: the fast instance's at
        # the flagship, the general form's at f1, the layouts at both, none
        # at f2tiles
        extra = {"flagship": {**VARIANTS, **LAYOUT_VARIANTS},
                 "f1": {**GENERAL_VARIANTS, **LAYOUT_VARIANTS}}.get(shape, {})
        names = [n for n in built
                 if n in ("parent", COMMITTED) or n in extra]
        for dtype in ("float32", "bfloat16"):
            mc = builder(shape, dtype, dev)
            amp = mc.amp(SNR)
            want = mc.build(reps, tiles)(SEED, SNR, 0)
            calls, mine = [], []
            for name in names:
                lib, ptxas = built[name]
                out = torch.zeros((reps, tiles), dtype=torch.int32,
                                  device=dev)
                call = variant_call(name, lib, texts[name][0], mc, reps,
                                    tiles, amp, out)
                diff = (call().to(torch.int64) - want.to(torch.int64)).abs()
                # the PRNG-mode instances of this product type
                regs = {k: v.split(",")[0] for k, v in ptxas.items()
                        if f"Lb0ELb{int(mc.bf16)}E" in k}
                calls.append(call)
                mine.append({"shape": shape, "variant": name,
                             "dtype": dtype, "registers": regs,
                             "launch": launch_info(lib, mc, reps, tiles),
                             "max_abs_count_diff": int(diff.max()),
                             "sum_abs_count_diff": int(diff.sum())})
            syms = reps * tiles * mc.tile * mc.used
            for row, ms in zip(mine, _tune.time_in_turns(calls)):
                row["ms"] = ms
                row["sym_per_s"] = syms / ms * 1e3
                print(json.dumps(row), flush=True)
            results += mine
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": smi, "shapes": {
                k: f"reps={SHAPES[k][0]},tiles={SHAPES[k][1]},tile="
                   f"{SHAPES[k][2]},used=300,{SHAPES[k][3]}"
                for k in shapes}, "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
