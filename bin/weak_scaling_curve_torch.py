#!/usr/bin/env python
"""Weak-scaling curve of the port's sharded Monte Carlo step, and the
sharded paths held against their unsharded runs over a real group.

The counterpart of ``bin/weak_scaling_curve.py``: the reps a rank computes
are held constant while the group grows 1 -> 2 -> 4 ranks (one process a
rank, started by ``pyphysim_tpu_torch.parallel.launch.run_ranks``), so
ideal weak scaling is flat reps/s a rank. The step is the flagship
kernel's sharded PRNG build (``MonteCarloOfdmTdl.build(..., mesh=)``):
each rank simulates its shard of the call's reps from its own absolute
attempt, then the counts are all-gathered. Each rank also checks that the
gathered counts equal the unsharded build's on its own device, bit for
bit.

Then, at 2 and 4 ranks, each rank holds the Alamouti, BD and IA sharded
PRNG builds bit for bit against their unsharded builds, and
``corrupt_data_time_sharded`` (its halo sent rank to rank) against the
unsharded ``corrupt_data`` within ``TS_ATOL``; at 4 ranks it also times
one per-key chunk of the PSK runner under the mesh, and the gather of its
outputs packed into one all-gather against one all-gather an output.
Last, the flagship runner sweeps 5 / 15 / 30 dB through
``simulate_in_parallel`` over the largest group, against ``simulate()`` on
rank 0's device alone: the bit errors must be equal, and the two walls
give the sweep's speed-up.

``--device cuda`` (default): NCCL ranks, one card each, up to the cards
present, at the flagship widths (tiles of 1,024 OFDM symbols, 4 a rep)
and ``bench.py``'s shapes for the other kernels. ``--device cpu``: a
rehearsal on ``gloo`` ranks of one torch thread each, with the kernels'
plain versions at small shapes. The ranks then share the machine's
cores, so the absolute numbers mean nothing and flatness holds only while
cores outnumber ranks.

Run:  python bin/weak_scaling_curve_torch.py [reps_per_rank] [iters]
[--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

# (tile, tiles a rep, default reps a rank, default calls) by device
SHAPES = {"cpu": (16, 1, 16, 10), "cuda": (1024, 4, 128, 100)}
# the sweep's (reps a point, chunk) by device
SWEEPS = {"cpu": (64, 16), "cuda": (8192, 2048)}
# the other kernels' (tile, lane, tiles a rep, reps a call) by device;
# cuda: bench.py's
FAMILIES = {"cpu": {"alamouti": (16, 128, 1, 8), "bd": (8, 128, 1, 8),
                    "ia": (8, 128, 1, 8)},
            "cuda": {"alamouti": (64, 256, 4, 512), "bd": (8, 512, 4, 128),
                     "ia": (8, 512, 4, 128)}}
# the time-sharded stream: OFDM symbols with CP (564 samples each)
TS_BLOCKS = {"cpu": 64, "cuda": 4096}
TS_ATOL = 2e-5      # tests/test_parallel.py's tolerance
# the per-key PSK chunk: attempts a chunk
PERKEY_CHUNK = {"cpu": 64, "cuda": 4096}


def _flagship(device):
    from pyphysim_tpu_torch.channels import (COST259_TUx,
                                             JakesSampleGenerator, TdlChannel)
    from pyphysim_tpu_torch.modulators import OFDM
    from pyphysim_tpu_torch.ops.mc_kernel import MonteCarloOfdmTdl
    jakes = JakesSampleGenerator(Fd=30.0, Ts=1.0 / 20e6, L=16, device=device)
    return MonteCarloOfdmTdl(OFDM(512, 52, 300, device=device),
                             TdlChannel(jakes, COST259_TUx), M=16,
                             tile=SHAPES[device][0], device=device)


def _rank_sweep(rank, world, device):
    """(bit errors a point of the sweep through ``simulate_in_parallel``
    over the group, the seconds of its first and second runs, and on rank
    0 the errors and seconds of ``simulate()`` on rank 0's device alone,
    run last)."""
    import time

    import numpy as np
    import torch
    import torch.distributed as dist

    from apps.ofdm.ofdm_mc_kernel_torch import OfdmMcKernelSimulationRunner
    from pyphysim_tpu_torch.parallel import gather_rows, make_mesh

    mesh = make_mesh(device=device)
    # the mesh's group sets up its communicator on its first collective:
    # outside the timed sweeps
    gather_rows(mesh, "mc", torch.zeros(1, device=device))
    reps, chunk = SWEEPS[device]

    def sweep(run):
        r = OfdmMcKernelSimulationRunner(device=device,
                                         read_command_line_args=False)
        r.params.add("SNR", np.array([5.0, 15.0, 30.0]))
        r.params.set_unpack_parameter("SNR")
        r.rep_max, r.batch_size = reps, chunk
        r.tile, r.num_tiles = SHAPES[device][:2]
        r.mc = _flagship(device)
        r.update_progress_function_style = None
        r.mc.build(world, r.num_tiles)(1, 10.0)      # load the kernels
        tic = time.perf_counter()
        run(r)
        seconds = time.perf_counter() - tic
        return ([int(v) for v in r.results.get_result_values_list(
            "bit_errors")], seconds)

    errors, first = sweep(lambda r: r.simulate_in_parallel(mesh))
    dist.barrier()
    _, second = sweep(lambda r: r.simulate_in_parallel(mesh))
    dist.barrier()
    alone = sweep(lambda r: r.simulate()) if rank == 0 else None
    return errors, (first, second), alone


def _family(name, device):
    """The Monte Carlo kernel ``name`` at this device's shapes, with its
    PRNG run's arguments before ``start``."""
    tile, lane = FAMILIES[device][name][:2]
    if name == "alamouti":
        from pyphysim_tpu_torch.ops.alamouti_kernel import \
            MonteCarloAlamouti
        return MonteCarloAlamouti(tile=tile, lane=lane, device=device), \
            (77, 10.0)
    if name == "bd":
        from pyphysim_tpu_torch.ops.bd_kernel import MonteCarloBD
        k, nr_u = (3, 2) if device == "cuda" else (2, 1)
        return MonteCarloBD(tile=tile, lane=lane, K=k, Nr_u=nr_u,
                            device=device), (77,)
    from pyphysim_tpu_torch.ops.ia_kernel import MonteCarloMaxSinr
    k, iterations = (3, 10) if device == "cuda" else (2, 1)
    return MonteCarloMaxSinr(tile=tile, lane=lane, iterations=iterations,
                             K=k, device=device), (77, 0.1)


def _timed(fn, device, repeats=20):
    """The least wall time of ``fn()`` in ms over ``repeats`` calls, the
    device synchronised around each."""
    import time

    import torch
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    fn()
    best = float("inf")
    for _ in range(repeats):
        sync()
        tic = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - tic)
    return best * 1e3


def _rank_parity(rank, world, device):
    """On every rank: whether each of the Alamouti, BD and IA sharded PRNG
    builds equals its unsharded build bit for bit; the time-sharded
    channel's largest distance to the unsharded ``corrupt_data`` (this
    rank's samples, its head with the received halo, and its per-block
    response); and the per-key chunk's times in ms: the whole sharded
    chunk, its outputs' one packed all-gather, one all-gather an output
    (each converted and moved to the device as the runner did before it
    packed them, scalar totals expanded to rows), the count of those and
    the chunk."""
    import numpy as np
    import torch

    from apps.awgn_modulators.simulate_psk_torch import \
        VerySimplePskSimulationRunner
    from pyphysim_tpu_torch.channels import (COST259_TUx, JakesSampleGenerator,
                                             JakesState, TdlChannel)
    from pyphysim_tpu_torch.ops.streams import AttemptStreams
    from pyphysim_tpu_torch.parallel import (corrupt_data_time_sharded,
                                             gather_rows, make_mesh)
    from pyphysim_tpu_torch.simulations import runner as runner_module

    mesh = make_mesh(device=device)
    out = {"builds": {}}
    for name, (_, _, tiles, reps) in FAMILIES[device].items():
        mc, args = _family(name, device)
        sharded = mc.build(reps, tiles, mesh=mesh)(*args, 1000)
        whole = mc.build(reps, tiles)(*args, 1000)
        out["builds"][name] = bool(torch.equal(sharded, whole))

    block, blocks = 564, TS_BLOCKS[device]
    n = block * blocks

    def channel(dev):
        return TdlChannel(JakesSampleGenerator(Fd=30.0, Ts=1 / 20e6, L=16,
                                               device=dev), COST259_TUx)

    # the same state and signal on every rank, drawn on the host
    g = torch.Generator().manual_seed(42)
    state = JakesState(*(t.to(device) for t in
                         channel("cpu").init_state(g)))
    x = torch.randn(n, dtype=torch.complex64, generator=g).to(device)
    ch = channel(device)
    want, want_ir, _ = ch.corrupt_data(state, x, block_size=block)
    time_mesh = make_mesh(axis_name="time", device=device)
    got, ir, _ = corrupt_data_time_sharded(ch, state, x, block, time_mesh)
    n_local, halo = n // world, ch.num_taps_with_padding - 1
    mine = want[rank * n_local:(rank + 1) * n_local]
    blocks_local = blocks // world
    out["timeshard"] = (
        float((got - mine).abs().max()),
        float((got[:halo] - mine[:halo]).abs().max()),
        float((ir.tap_values_sparse - want_ir.tap_values_sparse[
            ..., rank * blocks_local:(rank + 1) * blocks_local]).abs().max()))

    if world == 4:
        psk = VerySimplePskSimulationRunner(device=device,
                                            read_command_line_args=False)
        params = psk.params.get_unpacked_params_list()[0]
        kernel = psk._gen_simulation_kernel(params)
        chunk = PERKEY_CHUNK[device]
        psk.mesh = mesh
        executor = psk._make_chunk_executor(kernel, 5, torch.device(device))
        n_shard = chunk // world
        local = kernel(AttemptStreams.from_range(5, rank * n_shard, n_shard,
                                                 device))

        def packed():
            return runner_module._gather_outputs(mesh, "mc", local, n_shard,
                                                 device)

        def rows(v):
            t = torch.as_tensor(np.asarray(v)) if not \
                isinstance(v, torch.Tensor) else v
            return (t.expand(n_shard) if t.dim() == 0 else t).to(device)

        leaves = [v for value in local.values()
                  for v in (value if isinstance(value, tuple) else (value,))]

        def each():
            return [gather_rows(mesh, "mc", rows(v)) for v in leaves]

        out["perkey"] = (_timed(lambda: executor(0, chunk, 0.0), device),
                         _timed(packed, device), _timed(each, device),
                         len(leaves), chunk)
    return out


def _rank_time(rank, world, reps_per_rank, iters, device):
    """(seconds for ``iters`` sharded calls of ``reps_per_rank * world``
    reps after one warm-up call, whether the first call's gathered counts
    equal the unsharded build's, this rank's device name)."""
    import time

    import torch
    import torch.distributed as dist

    from pyphysim_tpu_torch.parallel import make_mesh

    tiles = SHAPES[device][1]
    mesh = make_mesh(device=device)
    mc = _flagship(device)
    reps = reps_per_rank * world
    run = mc.build(reps, tiles, mesh=mesh)
    equal = bool(torch.equal(run(1234, 10.0, 0),
                             mc.build(reps, tiles)(1234, 10.0, 0)))
    dist.barrier()
    tic = time.perf_counter()
    errors = 0
    for i in range(iters):
        errors += int(run(1234, 10.0, (i + 1) * reps).sum())
    seconds = time.perf_counter() - tic
    if errors <= 0:
        raise RuntimeError("the sharded step counted no bit errors")
    name = torch.cuda.get_device_name() if device == "cuda" else "cpu"
    return seconds, equal, name


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("reps_per_rank", nargs="?", type=int)
    parser.add_argument("iters", nargs="?", type=int)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return parser.parse_args(argv)


def curve(reps_per_rank=None, iters=None, device="cuda"):
    """Print the curve, the parity checks and the sweep (see the module's
    docstring); raise if a gathered result differs or a distance exceeds
    its limit."""
    import torch

    from pyphysim_tpu_torch._device import require_cuda
    from pyphysim_tpu_torch.parallel.launch import run_ranks

    device = require_cuda(device).type
    tile, tiles, reps_default, iters_default = SHAPES[device]
    reps_per_rank = reps_per_rank or reps_default
    iters = iters or iters_default
    worlds = [1, 2, 4]
    if device == "cuda":
        worlds = [w for w in worlds if w <= torch.cuda.device_count()]
        import subprocess
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
    print(f"reps a rank a call: {reps_per_rank}, calls: {iters}, "
          f"tile {tile} x {tiles} a rep, {device}, "
          f"{os.cpu_count()} cores, torch {torch.__version__}")
    print(f"{'ranks':>6} {'reps/s':>12} {'reps/s a rank':>14} "
          f"{'vs 1 rank':>10} {'gathered = unsharded':>21}  device")
    base = None
    for world in worlds:
        ranks = run_ranks(_rank_time, world,
                          args=(reps_per_rank, iters, device),
                          device=device)
        seconds = max(r[0] for r in ranks)
        equal = all(r[1] for r in ranks)
        rate = reps_per_rank * world * iters / seconds
        base = base or rate / world
        print(f"{world:>6} {rate:>12.2f} {rate / world:>14.2f} "
              f"{rate / world / base:>9.2f}x {str(equal):>21}  "
              f"{sorted({r[2] for r in ranks})}")
        if not equal:
            raise RuntimeError(f"{world} ranks: gathered counts differ "
                               "from the unsharded build's")

    for world in [w for w in worlds if w > 1]:
        ranks = run_ranks(_rank_parity, world, args=(device,), device=device)
        builds = {name: all(r["builds"][name] for r in ranks)
                  for name in ranks[0]["builds"]}
        err, halo_err, ir_err = (max(r["timeshard"][i] for r in ranks)
                                 for i in range(3))
        print(f"{world} ranks: sharded PRNG builds bitwise equal to the "
              f"unsharded ones {builds} (reps a call "
              f"{ {k: v[3] for k, v in FAMILIES[device].items()} }); "
              f"corrupt_data_time_sharded over {TS_BLOCKS[device]} blocks "
              f"of 564 samples: max |sharded - unsharded| {err!r}, in the "
              f"received halos {halo_err!r}, per-block response "
              f"{ir_err!r} (limit {TS_ATOL})")
        if not all(builds.values()) or max(err, ir_err) > TS_ATOL:
            raise RuntimeError(f"{world} ranks: a sharded path differs "
                               "from its unsharded run")
        if world == 4:
            chunk_ms, packed_ms, each_ms, leaves, chunk = \
                (max(r["perkey"][i] for r in ranks) for i in range(5))
            print(f"per-key PSK chunk of {chunk} attempts over {world} "
                  f"ranks: {chunk_ms!r} ms; its outputs gathered packed "
                  f"(1 all-gather) {packed_ms!r} ms, one all-gather an "
                  f"output ({leaves}) {each_ms!r} ms")

    reps, chunk = SWEEPS[device]
    ranks = run_ranks(_rank_sweep, worlds[-1], args=(device,),
                      device=device)
    alone_errors, alone_s = ranks[0][2]
    first, second = (max(r[1][i] for r in ranks) for i in (0, 1))
    equal = all(r[0] == alone_errors for r in ranks)
    print(f"sweep of 5 / 15 / 30 dB, {reps} reps a point in chunks of "
          f"{chunk}: simulate_in_parallel over {worlds[-1]} ranks "
          f"{first:.4f} s, again {second:.4f} s (ranks "
          f"{min(r[1][1] for r in ranks):.4f}-{second:.4f} s); simulate() "
          f"on one {alone_s:.4f} s ({alone_s / second:.2f}x the second); "
          f"bit errors {alone_errors}, equal on every rank: {equal}")
    if not equal:
        raise RuntimeError("the parallel sweep differs from simulate()")


def main(argv=None):
    args = parse_args(argv)
    curve(args.reps_per_rank, args.iters, args.device)


if __name__ == "__main__":
    main()
