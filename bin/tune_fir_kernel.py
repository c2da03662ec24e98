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
of its bytes and its f32 operations); ``--variants A,B`` times only the
variants named (``parent`` among them where ``--parent`` is given).

Run from the repository root: ``python3 bin/tune_fir_kernel.py [--parent
DIR] [--shape ROWS,BLOCK,MHZ] [--variants A,B] [--json PATH]``. Needs a
CUDA device and nvcc.
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


def sources(parent, only=None):
    """{name: (CUDA text, include directory)} of every variant, or of those
    named in ``only``."""
    from pyphysim_tpu_torch.ops import _build
    text = (_build.SRC_DIR / "block_fir.cu").read_text()
    out = {name: (_tune.substitute(name, text, subs), _build.SRC_DIR)
           for name, subs in VARIANTS.items()}
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
    """(rows, block_size, offsets) of ``--shape ROWS,BLOCK,MHZ``, or the
    flagship's with None."""
    if arg is None:
        from chip_smoke import fir_geometry
        return (ROWS, *fir_geometry())
    from pyphysim_tpu_torch.channels import COST259_HTx
    rows, block, mhz = arg.split(",")
    delays = COST259_HTx.get_discretize_profile(1 / (float(mhz) * 1e6)
                                                ).tap_delays
    return int(rows), int(block), [int(d) for d in delays]


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
    parser.add_argument("--variants", help="comma-separated variants to "
                        "time (default: all)")
    parser.add_argument("--json", help="also write the results here")
    args = parser.parse_args()

    from chip_smoke import bound_ms as card_bound_ms
    from chip_smoke import card, fir_bytes, fir_inputs
    from pyphysim_tpu_torch.ops import _build, fir

    smi = card()
    print(smi, flush=True)
    rows, block_size, offsets = shape(args.shape)
    texts = sources(args.parent, args.variants and args.variants.split(","))
    built = _tune.build_variants(texts, "fir_variant", "block_fir_kernel")
    dev = torch.device("cuda")
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
        results.append({
            "variant": name,
            "ptxas": ptxas.get(f"block_fir_kernelILi{plan['tap_bound']}ELb1"
                               f"ELi{plan['stages']}E") if plan else None,
            "plan": None if plan is None else {
                k: plan[k] for k in ("form", "stages", "warps",
                                     "rows_per_warp", "kChunks", "blocks",
                                     "smem_bytes")},
            "max_diff_over_max_y": float((y - want).abs().max()) / scale})
    bound_ms, bound_by = card_bound_ms(
        nbytes=fir_bytes(rows, block_size, offsets),
        flops=8 * rows * block_size * len(offsets))
    for row, ms in zip(results, _tune.time_in_turns(calls)):
        row["ms"] = ms
        row["share_of_bound"] = bound_ms / ms
        print(json.dumps(row), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": smi, "shape": f"rows={rows},block_size="
                       f"{block_size},taps={len(offsets)},span="
                       f"{offsets[-1] + 1}", "bound_ms": bound_ms,
                       "bound_by": bound_by, "geometry": offsets,
                       "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
