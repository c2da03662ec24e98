"""Tiny CPU versions of the benchmark's cells, and the faults the check of
``correct`` must catch, planted underneath the timed path.

A fault is a function that patches the program in the process that calls
it."""

from __future__ import annotations

import copy
from typing import Callable, Dict

SEED = 2 ** 31 + 977


def tiny_cell(name: str, limits: Dict = None, **traffic):
    """``(bench, entry, workload, config)`` of a cell at a size the CPU
    runs in seconds (its path's ``tiny``): the cell's own limits unless
    ``limits`` is given; ``traffic`` overrides keys of the traffic mix."""
    from perfbench.harness import cells, program
    bench = cells.load_benchmark()
    wl = copy.deepcopy(cells.workload(name))
    entry = {"name": name, "config": wl["config"], "chips": wl["chips"]}
    cfg = cells.config(entry["config"])
    program.path(wl["path"]).tiny(wl)
    wl.update(stop=["bit_errors", 3000], trace_seconds=0.2,
              judge={"sweeps": 1, "first_sweeps": 2})
    wl.update(traffic)
    if limits is not None:
        wl["limits"] = dict(limits)
    return bench, entry, wl, cfg


def run_tiny(name: str, trace: bool = False, dtype=None,
             limits: Dict = None, seconds: float = 0.2, **traffic):
    """A run of the tiny cell on the CPU, through ``run.run_cell``."""
    from perfbench import run
    bench, entry, wl, cfg = tiny_cell(name, limits, **traffic)
    return run.run_cell(bench, entry, wl, cfg, SEED, seconds, trace,
                        device="cpu", dtype=dtype)


# -- faults of the bulk kernel's call (ops/mc_kernel.py build) ---------------

def _patch_bulk(alter: Callable) -> None:
    from pyphysim_tpu_torch.ops.mc_kernel import MonteCarloOfdmTdl
    orig = MonteCarloOfdmTdl.build

    def build(self, reps, num_tiles, *args, **kwargs):
        run = orig(self, reps, num_tiles, *args, **kwargs)
        return lambda seed, snr, start=0: alter(run, seed, snr, start)
    MonteCarloOfdmTdl.build = build


def bulk_state_unchanged() -> None:
    """Every call simulates the attempts of the point's first call."""
    _patch_bulk(lambda run, seed, snr, start: run(seed, snr, 0))


def bulk_half_batch() -> None:
    """The second half of a call's attempts left out, their counts the
    mean of the first half's."""
    def alter(run, seed, snr, start):
        out = run(seed, snr, start)
        half = max(out.shape[0] // 2, 1)
        out[half:] = out[:half].float().mean(0).round().to(out.dtype)
        return out
    _patch_bulk(alter)


def bulk_answer_altered() -> None:
    """The first attempt's counts of every call altered where they are
    produced."""
    def alter(run, seed, snr, start):
        out = run(seed, snr, start)
        out[0] = out[0] * 2 + 1
        return out
    _patch_bulk(alter)


# -- faults of the per-key chain step (chain.py ChainStep.step) --------------

def _patch_perkey(alter: Callable) -> None:
    from pyphysim_tpu_torch.chain import ChainStep
    orig = ChainStep.step

    def step(self, streams, snr_linear):
        return alter(lambda s: orig(self, s, snr_linear), streams)
    ChainStep.step = step


def perkey_state_unchanged() -> None:
    from pyphysim_tpu_torch.ops.streams import AttemptStreams

    def alter(step, streams):
        return step(AttemptStreams.from_range(
            streams.seed, 0, streams.n, streams.attempts.device))
    _patch_perkey(alter)


def perkey_half_batch() -> None:
    import torch

    def alter(step, streams):
        half = max(streams.n // 2, 1)
        out = step(streams[:half])
        rest = out.float().mean().round().to(out.dtype)
        return torch.cat([out, rest.repeat(streams.n - half)])
    _patch_perkey(alter)


def perkey_answer_altered() -> None:
    def alter(step, streams):
        out = step(streams)
        out[0] = out[0] * 2 + 1
        return out
    _patch_perkey(alter)
