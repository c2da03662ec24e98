#!/usr/bin/env python3
"""Variants of the block-static FIR kernel, timed in turns on one card.

Each variant is the committed ``pyphysim_tpu_torch/ops/csrc/block_fir.cu``
with a few lines substituted (row buffers a warp, i.e. rows in flight;
output chunks a lane; rows a warp; warps a block), or, with ``--parent
DIR``, the ``block_fir.cu`` of another checkout (the same C interface, or
the earlier one without the device offsets, called as it was).
Every variant is built by its own ``nvcc`` into a library of its own under
``ops/_build/tune/``, all started together (``bin/_tune.py``), and plans
its own launch (its ``block_fir_plan``, read by ``ops/fir.py``
``kernel_plan``; the parent's form has none). At the
flagship geometry (8,192 rows of 564 samples, the 16 COST259-TU taps over
44 samples) the script prints for every variant:

  * registers and spill bytes per thread (``-Xptxas -v``);
  * the kernel time, best of 3 rounds of 10 launches, the variants timed
    in turns (forward, backward, forward) so that drift hits all alike,
    and its share of the bound (at the flagship the bytes, 77.8 MB at
    3.35 TB/s);
  * the largest difference from the plain PyTorch version over max |y|.

``--shape ROWS,BLOCK,MHZ`` times another shape instead: ROWS rows of BLOCK
samples under COST259-HT discretized at MHZ MHz (its bound then the larger
of its bytes and its f32 operations); ``--shapes`` times named shapes one
after the other on the same libraries: ``b1`` (81 consecutive taps, the
IEEE 802.11 exponential profile at Trms = 400 ns and 20 MHz, over 8,192
rows of 564), ``ht20`` (COST259-HT at 20 MHz over 1,024 rows of 8,192),
``ht100`` (at 100 MHz over 256 rows of 16,384): the segments form's
shapes, where the segments form's variants (``SEG_VARIANTS``) are timed
in place of the rows form's, and two diagnostic ones
(``DIAGNOSTIC_VARIANTS``: its loads alone, its compute alone; their
outputs are wrong and their difference from the plain version says so).
``--variants A,B`` times only the variants named (``parent`` among them
where ``--parent`` is given).

Run from the repository root: ``python3 bin/tune_fir_kernel.py [--parent
DIR] [--shape ROWS,BLOCK,MHZ | --shapes b1,ht20,ht100] [--variants A,B]
[--json PATH]``. Needs a CUDA device and nvcc.
"""

import argparse
import ctypes
import json
import sys
from pathlib import Path

import _tune

ROWS = 8192
# block_fir's arguments before the device copy of the offsets was added
EARLIER_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + \
    [ctypes.c_void_p] * 2


def _const(name, old, new):
    return (f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


VARIANTS = {
    "committed": [],
    "1 row in flight (no ring)": [_const("kStages", 2, 1)],
    "3 row buffers a warp": [_const("kStages", 2, 3)],
    "4 row buffers a warp": [_const("kStages", 2, 4)],
    "2 chunks a lane": [_const("kChunks", 4, 2)],
    "8 chunks a lane": [_const("kChunks", 4, 8)],
    "2 rows a warp": [_const("kRowsPerWarp", 8, 2)],
    "4 rows a warp": [_const("kRowsPerWarp", 8, 4)],
    "16 rows a warp": [_const("kRowsPerWarp", 8, 16)],
    "2 warps a block": [_const("kWarps", 4, 2)],
    "8 warps a block": [_const("kWarps", 4, 8)],
}
# the segments form's constants (block_fir.cu), timed at --shapes
SEG_VARIANTS = {
    "segments: 4 warps a block": [_const("kSegWarps", 8, 4)],
    "segments: 16 warps a block": [_const("kSegWarps", 8, 16)],
    "segments: 1 stage a block": [_const("kSegStages", 2, 1)],
    "segments: 3 stages a block": [_const("kSegStages", 2, 3)],
    "segments: stages for 1 block a SM": [_const("kSegBlocksPerSm", 2, 1)],
    "segments: stages for 3 blocks a SM": [_const("kSegBlocksPerSm", 2, 3)],
    "segments: at most 4 rows an item": [_const("kSegMaxRows", 16, 4)],
    "segments: 4 outputs a lane (sparse)": [_const("kSegChunks", 16, 4)],
    "segments: 8 outputs a lane (sparse)": [_const("kSegChunks", 16, 8)],
    "segments: 5 outputs a lane (dense)": [_const("kDenseOut", 7, 5)],
    "segments: a window of 8 taps (dense)": [_const("kDenseTaps", 16, 8)],
    "segments: a window of 24 taps (dense)": [_const("kDenseTaps", 16, 24)],
    "segments: 3 stages a block and stages for 1 block a SM": [
        _const("kSegStages", 2, 3), _const("kSegBlocksPerSm", 2, 1)],
    "segments: at most 8 rows an item": [_const("kSegMaxRows", 16, 8)],
    "segments: registers for 1 block a SM": [(
        "__launch_bounds__(kSegWarps * 32, kSegBlocksPerSm)",
        "__launch_bounds__(kSegWarps * 32, 1)")],
    "segments: dense chunk loop unrolled 2": [(
        "#pragma unroll 1\n  for (; i + U <= g.num_taps; i += U) {",
        "#pragma unroll 2\n  for (; i + U <= g.num_taps; i += U) {")],
    "segments: sparse tap loop unrolled 8": [(
        "#pragma unroll 4\n  for (int i = 0; i < g.num_taps; ++i) {\n"
        "    const float2 t = row_st[i];",
        "#pragma unroll 8\n  for (int i = 0; i < g.num_taps; ++i) {\n"
        "    const float2 t = row_st[i];")],
    "segments: sparse tap loop unrolled 2": [(
        "#pragma unroll 4\n  for (int i = 0; i < g.num_taps; ++i) {\n"
        "    const float2 t = row_st[i];",
        "#pragma unroll 2\n  for (int i = 0; i < g.num_taps; ++i) {\n"
        "    const float2 t = row_st[i];")],
}
# the segments form with half its work cut out (wrong outputs, timed only):
# its loads without the compute, and its compute on the first items' loads
DIAGNOSTIC_VARIANTS = {
    "diagnostic: loads only": [(
        "    for (int w = warp; w < nrows * units; w += kSegWarps) {",
        "    for (int w = warp; w < 0; w += kSegWarps) {")],
    "diagnostic: compute only": [(
        "    if (ahead < sg.items) {\n      load_item(stages + ((k + kS - 1)",
        "    if (ahead < sg.items && k < 0) {\n      load_item(stages + "
        "((k + kS - 1)")],
}
# --shapes: name -> (rows, block_size, profile, MHz)
SHAPES = {"b1": (8192, 564, "exponential", 20),
          "ht20": (1024, 8192, "ht", 20),
          "ht100": (256, 16384, "ht", 100)}


def sources(parent, only=None, segments=False):
    """{name: (CUDA text, include directory)} of every variant of the rows
    form (``VARIANTS``) or, with ``segments``, of the segments form
    (``SEG_VARIANTS``, ``DIAGNOSTIC_VARIANTS``: the rows form's constants
    change nothing at its shapes), or of those named in ``only``."""
    from pyphysim_tpu_torch.ops import _build
    text = (_build.SRC_DIR / "block_fir.cu").read_text()
    variants = ({"committed": [], **SEG_VARIANTS, **DIAGNOSTIC_VARIANTS}
                if segments else VARIANTS)
    out = {name: (_tune.substitute(name, text, subs), _build.SRC_DIR)
           for name, subs in variants.items()}
    if parent:
        src = Path(parent) / "pyphysim_tpu_torch" / "ops" / "csrc"
        out["parent"] = ((src / "block_fir.cu").read_text(), src)
    if only is not None:
        missing = set(only) - set(out)
        if missing:
            raise ValueError(f"no variant {sorted(missing)}")
        out = {name: out[name] for name in only}
    return out


def shape(arg):
    """(rows, block_size, offsets) of ``--shape ROWS,BLOCK,MHZ``, of a name
    of ``SHAPES``, or the flagship's with None."""
    if arg is None:
        from chip_smoke import fir_geometry
        return (ROWS, *fir_geometry())
    if arg in SHAPES:
        rows, block, kind, mhz = SHAPES[arg]
        from chip_smoke import shape_profile
        delays = shape_profile(kind, mhz * 1e6).get_discretize_profile(
            1 / (mhz * 1e6)).tap_delays
        return rows, block, [int(d) for d in delays]
    from pyphysim_tpu_torch.channels import COST259_HTx
    rows, block, mhz = arg.split(",")
    delays = COST259_HTx.get_discretize_profile(1 / (float(mhz) * 1e6)
                                                ).tap_delays
    return int(rows), int(block), [int(d) for d in delays]


def time_shape(built, texts, dev, rows, block_size, offsets):
    """Every built variant at one shape: its plan, registers, difference
    from the plain version and time, timed in turns; and the shape's
    bound."""
    import torch
    from chip_smoke import bound_ms as card_bound_ms
    from chip_smoke import fir_bytes, fir_inputs
    from pyphysim_tpu_torch.ops import _build, fir
    x, taps, offsets, block_size = fir_inputs(dev, rows,
                                              block_size=block_size,
                                              offsets=offsets)
    want = fir.block_fir_reference(x, taps, offsets, block_size)
    scale = float(want.abs().max())
    host_offsets = (ctypes.c_int * len(offsets))(*offsets)
    offs_ptr = ctypes.cast(host_offsets, ctypes.c_void_p)
    dev_offsets = torch.tensor(offsets, dtype=torch.int32, device=dev)
    calls, results = [], []
    for name, (lib_path, ptxas) in built.items():
        y = torch.empty_like(want)
        # a parent from before the device offsets takes one pointer fewer
        earlier = "dev_offsets" not in texts[name][0]
        fn = _tune.function(lib_path, "block_fir",
                            EARLIER_ARGTYPES if earlier else None)
        plan = None if name == "parent" else fir.kernel_plan(
            rows, block_size, offsets,
            _tune.function(lib_path, "block_fir_plan"))
        launch = (x.data_ptr(), taps.data_ptr(), y.data_ptr(), rows,
                  block_size, len(offsets), offs_ptr,
                  *(() if earlier else (dev_offsets.data_ptr(),)),
                  torch.cuda.current_stream().cuda_stream)

        def call(fn=fn, launch=launch, y=y, name=name):
            _build.check(fn(*launch), name)
            return y
        call()
        torch.cuda.synchronize()
        calls.append(call)
        instance = None if plan is None else (
            f"block_fir_kernelILi{plan['tap_bound']}ELb{int(plan['full'])}"
            f"ELi{plan['stages']}E" if plan["form"] == "rows" else
            f"block_fir_seg_kernelILi{plan['stages']}ELb"
            f"{int(plan['dense'])}E" if plan["form"] == "segments" else None)
        results.append({
            "variant": name, "ptxas": ptxas.get(instance),
            "plan": None if plan is None else {
                k: plan[k] for k in ("form", "stages", "warps",
                                     "rows_per_warp", "kChunks", "blocks",
                                     "smem_bytes", "rows_per_item",
                                     "segment", "segments", "unit", "dense",
                                     "items")},
            "max_diff_over_max_y": float((y - want).abs().max()) / scale})
    bound_ms, bound_by = card_bound_ms(
        nbytes=fir_bytes(rows, block_size, offsets),
        flops=8 * rows * block_size * len(offsets))
    for row, ms in zip(results, _tune.time_in_turns(calls)):
        row["ms"] = ms
        row["share_of_bound"] = bound_ms / ms
        print(json.dumps(row), flush=True)
    return {"shape": f"rows={rows},block_size={block_size},taps="
            f"{len(offsets)},span={offsets[-1] + 1}", "bound_ms": bound_ms,
            "bound_by": bound_by, "geometry": offsets, "results": results}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tune_fir_kernel: no CUDA device", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a checkout whose block_fir.cu is "
                        "timed beside the variants")
    parser.add_argument("--shape", help="ROWS,BLOCK,MHZ: COST259-HT at "
                        "MHZ MHz over ROWS rows of BLOCK samples")
    parser.add_argument("--shapes", help="comma-separated names of SHAPES, "
                        "timed one after the other")
    parser.add_argument("--variants", help="comma-separated variants to "
                        "time (default: all)")
    parser.add_argument("--json", help="also write the results here")
    args = parser.parse_args()

    from chip_smoke import card

    smi = card()
    print(smi, flush=True)
    names = args.shapes.split(",") if args.shapes else [args.shape]
    texts = sources(args.parent, args.variants and args.variants.split(","),
                    segments=bool(args.shapes))
    built = _tune.build_variants(texts, "fir_variant",
                                 "block_fir_(?:seg_)?kernel")
    dev = torch.device("cuda")
    shapes = []
    for name in names:
        print(f"# shape {name}", flush=True)
        shapes.append({"name": name, **time_shape(built, texts, dev,
                                                  *shape(name))})
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": smi, "shapes": shapes}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
