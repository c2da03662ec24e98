"""Start a process group on one host: ``world`` spawned processes, one per
rank, joined over a ``file://`` store (no port, no network). ``gloo`` on
the CPU, which is how the CPU tests run the port's collectives with
several ranks on one machine; NCCL with one card a rank
(``cuda:{rank}``), which is how ``bin/weak_scaling_curve_torch.py
--device cuda`` runs them over the cards of a node.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

__all__ = ["run_ranks"]

TIMEOUT_S = 300.0      # a whole run, and each collective's gloo timeout


def _rank_main(fn, rank: int, world: int, args: Sequence[Any], store: str,
               device_type: str, results) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    if device_type == "cuda":
        # the ranks share one host: its loopback is the interface they
        # are sure of
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist

    from .mesh import _backend
    torch.set_num_threads(1)     # the ranks share the host's cores
    try:
        device_id = None
        if device_type == "cuda":
            device_id = torch.device("cuda", rank)
            torch.cuda.set_device(device_id)
        dist.init_process_group(
            _backend(device_type), init_method=f"file://{store}",
            world_size=world, rank=rank, device_id=device_id,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            results.put((rank, True, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, world: int, args: Sequence[Any] = (),
              store_dir: Optional[str] = None,
              device: str = "cpu") -> List[Any]:
    """``fn(rank, world, *args)`` on each of ``world`` spawned ranks of one
    group (``device="cpu"``: gloo; ``"cuda"``: NCCL, rank ``r`` on
    ``cuda:r``); returns the ranks' results in rank order.

    ``fn`` and ``args`` are pickled (``fn`` by its import path) and each
    rank returns its result through a queue, so both must be picklable.
    ``store_dir`` holds the store's file (a fresh temporary directory by
    default). A rank that raises or dies ends every rank, and the error
    (with the rank's traceback) is raised here; so does a run longer than
    ``TIMEOUT_S``.
    """
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    store_dir = store_dir or tempfile.mkdtemp(prefix="pyphysim_ranks_")
    store = os.path.join(store_dir, f"store_{os.getpid()}_{time.time_ns()}")
    results = ctx.Queue()
    # not daemonic: a rank may start processes of its own (a progress
    # server's manager)
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, rank, world, tuple(args), store, device,
                               results))
             for rank in range(world)]
    for p in procs:
        p.start()
    out: dict = {}
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in out]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} ended without a "
                                       "result")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks still running after "
                                       f"{TIMEOUT_S} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10 if len(out) == world else 0)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]
