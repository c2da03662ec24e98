"""One process's run of a cell: set-up, warm-up, the measured window, the
traced window, and what the check of ``correct`` needs.

The window is a closed loop of whole sweeps: a researcher's sweep enqueues
its next chunk when the runner has accounted the last one, and the next
sweep starts when the last one ends. Sweeps run until the window's seconds
have passed; the sweep that is running then finishes, but only the work
whose counts reached the host, and the points that finished, inside the
window are counted.

Sweep ``i`` takes its base seed from ``--seed`` and ``i``
(:func:`sweep_seed`), so the window never repeats a stream; the warm-up
sweep is sweep -1. The judged sweeps (``judge.sweeps`` of them, at
positions drawn from the seed among the window's first
``judge.first_sweeps``) are those whose calls the check of ``correct``
compares.

Around the window the harness records what the host did: the main
thread's CPU time and its time waiting for a CPU, its involuntary context
switches, the machine's steal time and the garbage collector's pauses
(:class:`HostProbe`). Set-up's objects are frozen out of the collector
(``gc.freeze``) before the window, so a collection in the window walks only
what the window made.
"""

from __future__ import annotations

import gc
import os
import random
import time
from typing import Dict, List, Optional

from . import program
from .spans import Recorder

WARMUP_SWEEP = -1


def sweep_seed(seed: int, index: int) -> int:
    """A runner ``base_seed``: sweep ``index`` of ``seed``."""
    return (int(seed) * 2654435761 + int(index) + 1) % (2 ** 31)


def judged_sweeps(seed: int, wl: Dict) -> List[int]:
    """The sweeps whose work the check of ``correct`` compares: drawn from
    the seed among the first ``judge.first_sweeps`` of the window."""
    j = wl["judge"]
    rng = random.Random(int(seed) ^ 0x5A17)
    return sorted(rng.sample(range(int(j["first_sweeps"])),
                             int(j["sweeps"])))


def process_age() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def point_results(runner) -> List[Dict]:
    """The runner's Results of its last sweep, a dict a point."""
    res = runner.results
    return [{"bit_errors": int(be._value), "ber_value": float(b._value),
             "ber_total": float(b._total), "reps": int(r)}
            for be, b, r in zip(res["bit_errors"], res["ber"],
                                runner.runned_reps)]


def _sweeps(runner, rec: Recorder, seed: int, first: int, seconds: float,
            keep: Dict, through: int = -1) -> int:
    """Whole sweeps from ``first`` until ``seconds`` have passed and sweep
    ``through`` has run; returns the next index."""
    t0 = time.perf_counter()
    i = first
    while True:
        runner.base_seed = sweep_seed(seed, i)
        rec.begin_sweep(i)
        runner.simulate()
        rec.end_sweep()
        if i in rec.judged:
            keep[i] = {"base_seed": runner.base_seed,
                       "points": point_results(runner)}
        i += 1
        if not (time.perf_counter() - t0 < seconds or i <= through):
            return i


def _host_copy(value):
    import torch
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return value


class HostProbe:
    """What the host did in a span of time: the process's CPU seconds,
    ``/proc/thread-self/schedstat`` (the calling thread's seconds on a CPU
    and waiting for one),
    ``/proc/thread-self/status`` (its involuntary context switches),
    ``/proc/stat`` (the machine's steal seconds, summed over its CPUs) and
    the garbage collector's pauses (``gc.callbacks``). Readings that the
    host does not offer are left out."""

    def __init__(self) -> None:
        self.gc_s, self.gc_runs = 0.0, [0, 0, 0]
        self._gc_t0: Optional[float] = None
        self._start = self._read()
        gc.callbacks.append(self._gc)

    def _gc(self, phase: str, info: Dict) -> None:
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.gc_s += time.perf_counter() - self._gc_t0
            self.gc_runs[int(info["generation"])] += 1
            self._gc_t0 = None

    @staticmethod
    def _read() -> Dict[str, float]:
        out: Dict[str, float] = {"cpu_s": time.process_time()}
        try:
            with open("/proc/thread-self/schedstat") as f:
                on_cpu, waiting = f.read().split()[:2]
            out.update(on_cpu_s=int(on_cpu) * 1e-9,
                       wait_s=int(waiting) * 1e-9)
        except (OSError, ValueError):
            pass
        try:
            with open("/proc/thread-self/status") as f:
                for line in f:
                    if line.startswith("nonvoluntary_ctxt_switches"):
                        out["preempted"] = int(line.split()[1])
        except (OSError, ValueError):
            pass
        try:
            with open("/proc/stat") as f:
                out["steal_s"] = int(f.readline().split()[8]) / \
                    os.sysconf("SC_CLK_TCK")
        except (OSError, IndexError, ValueError):
            pass
        return out

    def stop(self) -> Dict[str, float]:
        gc.callbacks.remove(self._gc)
        end = self._read()
        out = {k: end[k] - self._start[k] for k in end if k in self._start}
        out.update(gc_s=self.gc_s, gc_runs=list(self.gc_runs))
        return out


def run_process(cfg: Dict, wl: Dict, seed: int, seconds: float,
                trace: bool, device, dtype: Optional[str] = None) -> Dict:
    """One run of a cell in this process. Returns plain data: the host's
    spans of the window (clock of ``time.perf_counter``), counters, the
    memory peak, the reduced trace, and the judged sweeps' calls and
    Results."""
    import torch

    from . import trace as tracing
    dev = torch.device(device)
    judged = judged_sweeps(seed, wl)
    runner, rec = program.make_runner(cfg, wl, dev, judged, dtype)

    # warm-up: one sweep under its own seed, then every shape the traffic
    # can ask for, so that nothing is first built inside the window
    kept: Dict[int, Dict] = {}
    _sweeps(runner, rec, seed, WARMUP_SWEEP, 0.0, kept)
    program.path(wl["path"]).warm(runner, wl)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    rec.calls.clear()
    rec.points.clear()
    rec._pending = 0
    before = program.counters(runner)
    gc.collect()
    gc.freeze()

    smi = _ClockSampler(dev) if dev.type == "cuda" else None
    age0 = process_age()
    probe = HostProbe()
    t0 = time.perf_counter()
    next_sweep = _sweeps(runner, rec, seed, 0, seconds, kept,
                         through=max(judged))
    t_last = time.perf_counter()
    host_probe = probe.stop()
    after = program.counters(runner)
    clocks = smi.stop() if smi else []
    host = {"t0": t0, "t_end": t0 + seconds, "t_last": t_last,
            "seconds": seconds, "setup_s": age0,
            "calls": [(c.t0, c.t1, c.n, c.symbols, c.done)
                      for c in rec.calls],
            "points": [(p.t0, p.t1, p.snr_db) for p in rec.points],
            "unreached": [(p.t0, p.t1) for p in rec.points if not p.reached],
            "sweeps": next_sweep, "probe": host_probe,
            "counters": {k: after[k] - before[k] for k in after}}

    reduced = None
    traced_calls: List[int] = []
    if trace:
        from torch.profiler import ProfilerActivity, profile
        rec.calls.clear()
        rec.points.clear()
        rec._pending = 0
        rec.judged = set()
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            rec.tracing = True
            _sweeps(runner, rec, seed, next_sweep,
                    float(wl["trace_seconds"]), {})
            rec.tracing = False
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        reduced = tracing.reduce_profile(prof)
        traced_calls = [c.n for c in rec.calls]
        del prof

    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    calls = {s: [(c.point, c.snr_db, _host_copy(c.attempts), c.n,
                  _host_copy(c.counts)) for c in cs]
             for s, cs in rec.kept.items()}
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    del runner, rec
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"host": host, "trace": reduced, "traced_calls": traced_calls,
            "memory_peak": memory_peak,
            "judged": {s: dict(kept[s], calls=calls.get(s, []))
                       for s in judged if s in kept},
            "device_name": name, "clocks": clocks}


class _ClockSampler:
    """``nvidia-smi`` sampling the card's SM clock and power every two
    seconds while the window runs, in a process of its own."""

    QUERY = "clocks.sm,power.draw,power.limit"
    PERIOD_MS = 2000

    def __init__(self, dev) -> None:
        import shutil
        import subprocess
        self.proc = None
        exe = shutil.which("nvidia-smi")
        if exe is None:
            return
        self.proc = subprocess.Popen(
            [exe, f"--query-gpu={self.QUERY}", "--format=csv,noheader",
             "-i", str(dev.index or 0), "-lms", str(self.PERIOD_MS)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def stop(self) -> List[str]:
        if self.proc is None:
            return []
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=10)
        return [line.strip() for line in out.splitlines() if line.strip()]
