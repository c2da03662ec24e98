#!/usr/bin/env python
"""Multiprocess progressbar demo, on the PyTorch port.

The counterpart of ``apps/testing_multiprocessing_progressbar.py``: N
worker processes each register a proxy progressbar with the port's
``ProgressbarMultiProcessServer``; a daemon thread in the parent sums the
counts into one bar. Each worker inverts products of random 3x3 matrices
on ``--device``, from its own seeded generator.

Run: ``python apps/testing_multiprocessing_progressbar_torch.py
[--device cuda]``.
"""

import argparse
import multiprocessing
import sys

sys.path.insert(0, ".")

import torch  # noqa: E402

from pyphysim_tpu_torch._device import require_cuda  # noqa: E402
from pyphysim_tpu_torch.progressbar import (  # noqa: E402
    ProgressbarMultiProcessServer)


def func(rep_max, progressbar, device="cuda", seed=0):
    """The worker: ``rep_max`` inversions of a product of two random 3x3
    matrices on ``device``, reporting its count every 100."""
    dev = require_cuda(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = None
    for i in range(rep_max):
        a = torch.randn(3, 3, generator=gen, device=dev)
        b = torch.randn(3, 3, generator=gen, device=dev)
        c = torch.linalg.inv(a @ b)
        if i % 100 == 0:
            progressbar.progress(i)
    progressbar.progress(rep_max)
    return c


def run(num_process=4, rep_max=20000, device="cuda"):
    """Run ``num_process`` spawned workers under one bar; returns the
    server's total count once they have ended."""
    require_cuda(device)
    pb = ProgressbarMultiProcessServer(message="Running")
    ctx = multiprocessing.get_context("spawn")
    try:
        procs = [ctx.Process(target=func, args=(
            rep_max, pb.register_client_and_get_proxy_progressbar(rep_max),
            str(device), seed)) for seed in range(num_process)]
        for proc in procs:
            proc.start()
        pb.start_updater()
        for proc in procs:
            proc.join()
        if any(proc.exitcode != 0 for proc in procs):
            raise RuntimeError("a worker failed: exit codes "
                               f"{[proc.exitcode for proc in procs]}")
        return pb._get_total_count()
    finally:
        pb.close()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    run(device=args.device)
    print()


if __name__ == "__main__":
    main()
