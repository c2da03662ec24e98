#!/usr/bin/env python3
"""The readings that a cell's limits for ``correct`` are set from (not run
by the benchmark's own runs).

    python3 perfbench/limits.py --workload <cell> --seeds 12
        --control-seeds 3 [--seconds 1] [--json PATH]

For each seed, in one process on the cell's card(s): a short window at the
cell's own load that runs at least the judged sweep, then the check of
``correct``, printing each number compared. The first ``--seeds`` seeds
run the program as the configuration states (the sound readings); the next
``--control-seeds`` run it with the traffic's ``control_dtype``, the
program's own lower-precision path (the kernel's bf16 channel product, or
the chain's bf16 signal), which has to come out as not correct.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cfg, wl, seeds, dtypes, seconds, device):
    """``[{seed, dtype, compare, notes, judge_s}]`` of each (seed, dtype)."""
    from perfbench.harness import judge as judging
    from perfbench.harness.window import run_process
    out = []
    for seed, dtype in zip(seeds, dtypes):
        res = run_process(cfg, wl, seed, seconds, False, device, dtype)
        tic = time.perf_counter()
        correct, compare, notes = judging.judge(cfg, wl, res["judged"],
                                                device)
        row = {"seed": seed, "dtype": dtype or wl["dtype"],
               "sweeps": res["host"]["sweeps"], "correct": correct,
               "judge_s": time.perf_counter() - tic,
               "compare": {k: v["value"] for k, v in compare.items()},
               "notes": notes[:5]}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3_000_000_017)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--json", default=None)
    args = p.parse_args()

    import torch

    from perfbench.harness import cells
    bench = cells.load_benchmark()
    entry = cells.cell(bench, args.workload)
    wl = cells.workload(entry["name"])
    cfg = cells.config(entry["config"])
    n = args.seeds + args.control_seeds
    seeds = [args.first_seed + 7919 * i for i in range(n)]
    dtypes = [None] * args.seeds + [wl["control_dtype"]] * args.control_seeds
    rows = readings(cfg, wl, seeds, dtypes, args.seconds, "cuda:0")
    summary = {"workload": entry["name"], "card": torch.cuda.get_device_name(0),
               "rows": rows}
    for dtype in sorted({r["dtype"] for r in rows}):
        mine = [r["compare"] for r in rows if r["dtype"] == dtype]
        summary[dtype] = {k: [min(m[k] for m in mine), max(m[k] for m in mine)]
                          for k in mine[0]}
        print(json.dumps({"dtype": dtype, "min_max": summary[dtype]}),
              flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
