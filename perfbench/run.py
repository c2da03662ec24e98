#!/usr/bin/env python3
"""The benchmark of pyphysim_tpu_torch: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. It sets up the cell that ``BENCHMARK.json``
names (its traffic ``perfbench/workloads/<cell>.json``, its configuration
``perfbench/configs/<config>.json``), warms up every shape the traffic
uses, runs sweeps back to back for ``--seconds``, checks what the timed
path produced against the plain reference (``perfbench/reference/``), and
prints one JSON line: the cell's end-to-end metrics, or with ``--trace 1``
its per-layer metrics, each read by ``perfbench/metrics/<metric>.py``.
The numbers compared for ``correct`` close standard error, each beside its
limit, and close the JSON line under ``compare``.

It needs the cards the cell asks for (``torch.cuda``) and exits with 2
without them; it exits with 3, printing no result, if the process holds
``jax``, ``jaxlib``, ``flax`` or ``pyphysim_tpu`` once the window has
closed. The kernels' build cache is the program's own,
``pyphysim_tpu_torch/ops/_build/`` inside the checkout.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "pyphysim_tpu")


def forbidden_modules(modules=None):
    """The top-level names among ``modules`` (the loaded ones by default)
    that are one of ``FORBIDDEN``, compared whole: ``pyphysim_tpu_torch``
    is not ``pyphysim_tpu``."""
    names = list(sys.modules) if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def run_cell(bench, entry, wl, cfg, seed, seconds, trace, device="cuda",
             dtype=None):
    """One run of a cell, as the dict the JSON line is made of (with
    ``compare`` and ``notes``). ``device`` ``"cpu"`` runs the program's
    CPU routes (the tests' rehearsal); ``dtype`` the control's lower
    precision."""
    from perfbench.harness import cells, judge, stats, trace as tracing
    from perfbench.harness.window import run_process
    if int(entry["chips"]) != 1:
        raise ValueError(f"{entry['name']} asks for {entry['chips']} cards; "
                         "this harness runs a cell on one")
    dev = "cuda:0" if device == "cuda" else device
    out = run_process(cfg, wl, seed, seconds, trace, dev, dtype=dtype)
    correct, compare, notes = judge.judge(cfg, wl, out["judged"], dev)
    host = out["host"]
    ctx = cells.Context(entry, wl, cfg, host, out["trace"],
                        out["traced_calls"])
    # a point is a request: failed where rep_max, not the stop target,
    # ended it (the stated accuracy was not reached)
    finished = stats.point_seconds(host)
    unreached = [p for p in host["unreached"] if p[1] <= host["t_end"]]
    result = {"correct": bool(correct), "attempted": len(finished),
              "failed": len(unreached),
              "metrics": cells.read_metrics(
                  cells.metrics_for(bench, entry["name"], trace), ctx),
              "device": {"platform": "gpu" if device == "cuda" else device,
                         "kind": out["device_name"], "count": 1,
                         "memory_peak_bytes": out["memory_peak"]}}
    tr = out["trace"]
    if trace and tr is not None:
        result["device"]["busy_s"] = tr.busy_us() * 1e-6
        result["device"]["window_s"] = tr.window_us * 1e-6
        result["breakdown"] = {
            "device_ops": [[n, v] for n, v in tracing.top_device_ops(tr)],
            "idle_gaps": sorted(([n, v] for n, v in tracing.idle_by_host_span(
                tr).items()), key=lambda nv: -nv[1])}
    result["compare"] = compare
    quarters = [sum(sym for t0, _, _, sym, done in host["calls"]
                    if done is not None and
                    host["t0"] + q * host["seconds"] / 4 <= t0 and
                    done <= host["t0"] + (q + 1) * host["seconds"] / 4)
                for q in range(4)]
    probe = host["probe"]
    result["notes"] = notes + [
        f"sweeps in the window: {host['sweeps']}",
        f"symbols a quarter of the window: {quarters}",
        "host in the loop's "
        f"{host['t_last'] - host['t0']:.3f} s: " + ", ".join(
            f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in probe.items()),
        f"points in the window: {len(finished)}",
        "card clocks (clocks.sm, power.draw, power.limit) in the window: "
        + "; ".join(out["clocks"][:40])]
    return result


def emit(result, out=sys.stdout, err=sys.stderr):
    """Notes and the compared numbers on standard error (the numbers
    last), then the JSON line, ``compare`` its last key."""
    for note in result.pop("notes", []):
        print(note, file=err)
    for name, c in result["compare"].items():
        print(f"compare {name} = {c['value']!r} limit {c['limit']!r}",
              file=err)
    err.flush()
    compare = result.pop("compare")
    result["compare"] = compare
    print(json.dumps(result), file=out)
    out.flush()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from perfbench.harness import cells
    bench = cells.load_benchmark()
    entry = cells.cell(bench, args.workload)
    wl = cells.workload(entry["name"])
    cfg = cells.config(entry["config"])
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(entry["chips"]):
        print(f"{entry['name']} needs {entry['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = run_cell(bench, entry, wl, cfg, args.seed, args.seconds,
                      bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: no result", file=sys.stderr)
        return 3
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
