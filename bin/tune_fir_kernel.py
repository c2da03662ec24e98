#!/usr/bin/env python3
"""Variants of the block-static FIR kernel, timed in turns on one card.

Each variant is the committed ``pyphysim_tpu_torch/ops/csrc/block_fir.cu``
with a few lines substituted (row buffers a warp, i.e. rows in flight;
output chunks a lane; rows a warp; warps a block), or, with ``--parent
DIR``, the ``block_fir.cu`` of another checkout (the same C interface).
Every variant is built by its own ``nvcc`` into a library of its own under
``ops/_build/tune/``, all started together (``bin/_tune.py``), and plans
its own launch (its ``block_fir_plan``, read by ``ops/fir.py``
``kernel_plan``; the parent's form has none). At the
flagship geometry (8,192 rows of 564 samples, the 16 COST259-TU taps over
44 samples) the script prints for every variant:

  * registers and spill bytes per thread (``-Xptxas -v``);
  * the kernel time, best of 3 rounds of 10 launches, the variants timed
    in turns (forward, backward, forward) so that drift hits all alike,
    and its share of the byte bound (77.8 MB at 3.35 TB/s);
  * the largest difference from the plain PyTorch version over max |y|.

Run from the repository root: ``python3 bin/tune_fir_kernel.py [--parent
DIR] [--json PATH]``. Needs a CUDA device and nvcc.
"""

import argparse
import ctypes
import json
import sys
from pathlib import Path

import _tune

ROWS = 8192


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


def sources(parent):
    """{name: (CUDA text, include directory)} of every variant."""
    from pyphysim_tpu_torch.ops import _build
    text = (_build.SRC_DIR / "block_fir.cu").read_text()
    out = {name: (_tune.substitute(name, text, subs), _build.SRC_DIR)
           for name, subs in VARIANTS.items()}
    if parent:
        src = Path(parent) / "pyphysim_tpu_torch" / "ops" / "csrc"
        out["parent"] = ((src / "block_fir.cu").read_text(), src)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tune_fir_kernel: no CUDA device", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a checkout whose block_fir.cu is "
                        "timed beside the variants")
    parser.add_argument("--json", help="also write the results here")
    args = parser.parse_args()

    from chip_smoke import card, fir_bytes, fir_geometry, fir_inputs
    from pyphysim_tpu_torch.ops import _build, fir

    smi = card()
    print(smi, flush=True)
    texts = sources(args.parent)
    built = _tune.build_variants(texts, "fir_variant", "block_fir_kernel")
    dev = torch.device("cuda")
    x, taps, offsets, block_size = fir_inputs(dev, ROWS)
    want = fir.block_fir_reference(x, taps, offsets, block_size)
    scale = float(want.abs().max())
    host_offsets = (ctypes.c_int * len(offsets))(*offsets)
    offs_ptr = ctypes.cast(host_offsets, ctypes.c_void_p)
    calls, results = [], []
    for name, (lib_path, ptxas) in built.items():
        y = torch.empty_like(want)
        fn = _tune.function(lib_path, "block_fir")
        plan = None if name == "parent" else fir.kernel_plan(
            ROWS, block_size, offsets,
            _tune.function(lib_path, "block_fir_plan"))
        launch = (x.data_ptr(), taps.data_ptr(), y.data_ptr(), ROWS,
                  block_size, len(offsets), offs_ptr,
                  torch.cuda.current_stream().cuda_stream)

        def call(fn=fn, launch=launch, y=y, name=name):
            _build.check(fn(*launch), name)
            return y
        call()
        torch.cuda.synchronize()
        calls.append(call)
        results.append({
            "variant": name,
            "ptxas": ptxas.get(f"block_fir_kernelILi{plan['tap_bound']}ELb1"
                               f"ELi{plan['stages']}E") if plan else None,
            "plan": None if plan is None else {
                k: plan[k] for k in ("stages", "warps", "rows_per_warp",
                                     "kChunks", "blocks", "smem_bytes")},
            "max_diff_over_max_y": float((y - want).abs().max()) / scale})
    bound_ms = fir_bytes(ROWS, block_size, offsets) / 3.35e12 * 1e3
    for row, ms in zip(results, _tune.time_in_turns(calls)):
        row["ms"] = ms
        row["share_of_byte_bound"] = bound_ms / ms
        print(json.dumps(row), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": smi, "shape": f"rows={ROWS},block_size="
                       f"{block_size},taps={len(offsets)},span="
                       f"{offsets[-1] + 1}", "bound_ms": bound_ms,
                       "geometry": list(fir_geometry()[1]),
                       "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
