"""Rank functions of the port's multi-process tests.

Each function runs on every rank of a ``gloo`` group that
``pyphysim_tpu_torch.parallel.launch.run_ranks`` starts, and returns plain
data (lists, numpy arrays, flags) that the test compares, in its own
process, with the port run in one process or with the JAX package. Nothing
here imports jax: the ranks are fresh interpreters that load only the
port.
"""

import threading

import numpy as np
import torch
import torch.distributed as dist

from pyphysim_tpu_torch.simulations import Result, SimulationRunner

QPSK_SNRS = np.array([0.0, 10.0])
QPSK_SYMBOLS = 256


def raises(exc_type, fn) -> bool:
    """Whether ``fn()`` raises ``exc_type``."""
    try:
        fn()
    except exc_type:
        return True
    return False


class QpskRunner(SimulationRunner):
    """QPSK over AWGN on the per-key path (the JAX tests'
    ``_BatchQpskRunner`` on attempt streams): ``QPSK_SYMBOLS`` symbols an
    attempt. ``gate``: an event the kernel waits on before its first
    chunk; ``fail``: the kernel raises ``ValueError``. ``mesh_seen`` records
    whether each kernel call ran under a mesh."""

    def __init__(self, rep_max=64, batch=16, stop=None, gate=None,
                 fail=False):
        super().__init__(read_command_line_args=False)
        self.params.add("SNR", QPSK_SNRS)
        self.params.set_unpack_parameter("SNR")
        self.rep_max, self.batch_size = rep_max, batch
        self.batch_stop_criterion = stop
        self.update_progress_function_style = None
        self.device = "cpu"
        self.batch_result_types = {"ber": Result.RATIOTYPE,
                                   "bit_errors": Result.SUMTYPE}
        self.gate, self.fail = gate, fail
        self.mesh_seen = []

    def _gen_simulation_kernel(self, current_parameters):
        from pyphysim_tpu_torch.modulators import QPSK
        from pyphysim_tpu_torch.utils.conversion import dB2Linear
        from pyphysim_tpu_torch.utils.misc import count_bit_errors, randn_c
        scale = float(np.sqrt(1.0 / dB2Linear(
            float(current_parameters["SNR"]))))
        mod = QPSK(device="cpu")

        def kernel(streams):
            self.mesh_seen.append(self.mesh is not None)
            if self.gate is not None:
                self.gate.wait(timeout=60)
            if self.fail:
                raise ValueError("kernel failure")
            s_data, s_noise = streams.split(2)
            data = s_data.integers(4, (QPSK_SYMBOLS,))
            rx = mod.modulate(data) + randn_c(s_noise, QPSK_SYMBOLS) * scale
            errors = count_bit_errors(data, mod.demodulate(rx), axis=-1)
            return {"ber": (errors, 2.0 * QPSK_SYMBOLS),
                    "bit_errors": errors}

        return kernel


def summary(runner):
    """A finished runner's BERs, bit errors and repetitions."""
    res = runner.results
    return {"ber": [float(v) for v in res.get_result_values_list("ber")],
            "bit_errors": [int(v) for v in
                           res.get_result_values_list("bit_errors")],
            "runned_reps": list(runner.runned_reps)}


STOP = ("bit_errors", 1500.0)    # trips at 0 dB (~80 errors an attempt)


# ---------------------------------------------------------------------------
# tests/test_torch_parallel_mesh.py: 4 ranks
# ---------------------------------------------------------------------------

def mesh_checks(rank, world):
    from pyphysim_tpu_torch.parallel import (gather_rows, init_multihost,
                                             make_host_chip_mesh, make_mesh,
                                             shard_batch)
    out = {}
    mesh = make_mesh(device="cpu")
    out["mesh"] = (mesh.mesh_dim_names, tuple(mesh.shape),
                   mesh.get_local_rank("mc"))
    sub = make_mesh(2, device="cpu")
    out["sub_mesh"] = (tuple(sub.shape), sub.get_coordinate() is not None)
    out["too_many"] = raises(ValueError,
                             lambda: make_mesh(world + 1, device="cpu"))
    hc = make_host_chip_mesh(num_hosts=2, device="cpu")
    out["host_chip"] = (hc.mesh_dim_names, tuple(hc.shape),
                        hc.get_local_rank("host"), hc.get_local_rank("chip"))
    x = torch.tensor([float(rank)])
    dist.all_reduce(x, group=hc.get_group("chip"))    # within a host
    out["chip_sum"] = float(x)
    out["default_hosts"] = tuple(make_host_chip_mesh(device="cpu").shape)
    out["three_hosts"] = raises(
        ValueError, lambda: make_host_chip_mesh(num_hosts=3, device="cpu"))
    batch = shard_batch(mesh, torch.arange(4.0 * world))
    out["shard"] = (batch.to_local().tolist(), batch.full_tensor().tolist())
    out["chip_shard"] = shard_batch(hc, torch.arange(8.0),
                                    "chip").to_local().tolist()
    init_multihost("localhost:1", world, rank, device="cpu")
    out["world_after_init"] = dist.get_world_size()
    out["gather"] = gather_rows(mesh, "mc",
                                torch.full((2, 1), rank)).tolist()
    out["gather_bool"] = gather_rows(
        mesh, "mc", torch.tensor([rank % 2 == 0])).tolist()
    out["cuda_mesh_raises"] = raises(RuntimeError,
                                     lambda: make_mesh(device="cuda"))

    runner = QpskRunner()
    runner.simulate_in_parallel(mesh)
    out["reset"] = runner.mesh is None
    out["blocking"] = summary(runner)

    gate = threading.Event()
    runner = QpskRunner(gate=gate)
    runner.simulate_in_parallel(mesh, block=False)
    second = raises(RuntimeError, lambda: runner.simulate_in_parallel(mesh))
    gate.set()
    runner.wait_parallel_simulation()
    out["async"] = (second, runner.mesh is None, summary(runner))

    runner = QpskRunner(fail=True)
    runner.simulate_in_parallel(mesh, block=False)
    out["async_error"] = raises(ValueError, runner.wait_parallel_simulation)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_parallel_runner.py: 2 ranks
# ---------------------------------------------------------------------------

def runner_checks(rank, world, shared):
    from pyphysim_tpu_torch.parallel import make_mesh
    from pyphysim_tpu_torch.simulations import (SimulationResults,
                                                simulate_do_what_i_mean)
    out = {}
    mesh = make_mesh(device="cpu")
    for key, stop in (("plain", None), ("stop", STOP)):
        runner = QpskRunner(stop=stop)
        runner.simulate_in_parallel(mesh)
        out[key] = summary(runner)

    saves = []
    save = SimulationResults.save_to_file

    def spy(self, *args, **kwargs):
        saves.append(1)
        return save(self, *args, **kwargs)

    SimulationResults.save_to_file = spy
    try:
        for rep_max in (8, 16):        # interrupted at 8, resumed to 16
            runner = QpskRunner(rep_max=rep_max, batch=4)
            runner.set_results_filename(f"{shared}/res")
            runner.partial_results_folder = f"{shared}/partial"
            runner.simulate_in_parallel(mesh)
            dist.barrier()             # rank 0's files are written
            out[f"resume_{rep_max}"] = summary(runner)
    finally:
        SimulationResults.save_to_file = save
    out["saves"] = len(saves)

    runner = QpskRunner()
    simulate_do_what_i_mean(runner)
    out["dwim"] = (summary(runner), all(runner.mesh_seen))
    import pyphysim_tpu_torch.progressbar as progressbar
    server_class = progressbar.ProgressbarMultiProcessServer
    servers = []

    class CountedServer(server_class):
        def __init__(self, *args, **kwargs):
            servers.append(1)
            super().__init__(*args, **kwargs)

    progressbar.ProgressbarMultiProcessServer = CountedServer
    try:
        pair = [QpskRunner(), QpskRunner(batch=32)]
        simulate_do_what_i_mean(pair)
    finally:
        progressbar.ProgressbarMultiProcessServer = server_class
    out["dwim_list"] = [(summary(r), all(r.mesh_seen)) for r in pair]
    out["servers"] = len(servers)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_parallel_kernels.py: 2 ranks
# ---------------------------------------------------------------------------

def kernel_builder(name: str):
    """The port's Monte Carlo builder ``name`` on the CPU, at the small
    grid the kernel tests use."""
    if name == "ofdm":
        from pyphysim_tpu_torch.channels import (COST259_TUx,
                                                 JakesSampleGenerator,
                                                 TdlChannel)
        from pyphysim_tpu_torch.modulators import OFDM
        from pyphysim_tpu_torch.ops.mc_kernel import MonteCarloOfdmTdl
        jakes = JakesSampleGenerator(Fd=30.0, Ts=1.0 / 20e6, L=16,
                                     device="cpu")
        return MonteCarloOfdmTdl(OFDM(512, 52, 300, device="cpu"),
                                 TdlChannel(jakes, COST259_TUx), M=16,
                                 tile=16, device="cpu")
    if name == "alamouti":
        from pyphysim_tpu_torch.ops.alamouti_kernel import \
            MonteCarloAlamouti
        return MonteCarloAlamouti(tile=16, lane=128, device="cpu")
    if name == "bd":
        from pyphysim_tpu_torch.ops.bd_kernel import MonteCarloBD
        return MonteCarloBD(tile=8, lane=128, K=2, Nr_u=1, device="cpu")
    from pyphysim_tpu_torch.ops.ia_kernel import MonteCarloMaxSinr
    return MonteCarloMaxSinr(tile=8, lane=128, iterations=1, K=2,
                             device="cpu")


# PRNG-mode arguments of each builder's run, ``start`` last
PRNG_ARGS = {"ofdm": (9, 10.0, 3), "alamouti": (9, 10.0, 3),
             "bd": (9, 3), "ia": (9, 0.1, 3)}


def kernel_checks(rank, world, inject, reps, num_tiles):
    """``inject``: {name: (bit arrays, trailing arguments)} of the four
    kernels' inject builds, the same on every rank."""
    from pyphysim_tpu_torch.parallel import make_mesh
    mesh = make_mesh(device="cpu")
    out = {}
    for name, (bits, rest) in inject.items():
        mc = kernel_builder(name)
        sharded = mc.build_inject(reps, num_tiles, mesh=mesh)(*bits, *rest)
        whole = mc.build_inject(reps, num_tiles)(*bits, *rest)
        args = PRNG_ARGS[name]
        prng = mc.build(reps, num_tiles, mesh=mesh)(*args)
        prng_whole = mc.build(reps, num_tiles)(*args)
        out[name] = {
            "inject": sharded.numpy(), "inject_whole": whole.numpy(),
            "prng": prng.numpy(), "prng_whole": prng_whole.numpy(),
            "indivisible": (
                raises(ValueError, lambda: mc.build(reps + 1, num_tiles,
                                                    mesh=mesh)),
                raises(ValueError, lambda: mc.build_inject(
                    reps + 1, num_tiles, mesh=mesh)))}
    out["app"] = flagship_app(mesh)
    return out


def flagship_app(mesh):
    """The flagship bulk app at a small tile under ``simulate_in_parallel``
    and under ``simulate()``, with and without a stop criterion."""
    from apps.ofdm.ofdm_mc_kernel_torch import OfdmMcKernelSimulationRunner
    from pyphysim_tpu_torch.ops.mc_kernel import MonteCarloOfdmTdl

    def runner(stop):
        r = OfdmMcKernelSimulationRunner(device="cpu",
                                         read_command_line_args=False)
        r.params.add("SNR", np.array([5.0, 15.0]))
        r.params.set_unpack_parameter("SNR")
        # every rung of the stop ladder (2, 4, 8, 16) splits over 2 ranks,
        # so both runs cut the sweep into the same chunks
        r.rep_max, r.batch_size = 32, 16
        r.batch_stop_criterion = stop
        r.num_stop_subchunks = 1
        r.tile, r.num_tiles = 8, 1
        r.mc = MonteCarloOfdmTdl(r.ofdm, r.channel, M=16, tile=8,
                                 device="cpu")
        r.update_progress_function_style = None
        return r

    out = {}
    for key, stop in (("plain", None), ("stop", ("bit_errors", 20000.0))):
        parallel, serial = runner(stop), runner(stop)
        parallel.simulate_in_parallel(mesh)
        serial.simulate()
        out[key] = (summary_bits(parallel), summary_bits(serial))
    return out


def summary_bits(runner):
    res = runner.results
    return {"bit_errors": [int(v) for v in
                           res.get_result_values_list("bit_errors")],
            "runned_reps": list(runner.runned_reps)}


# ---------------------------------------------------------------------------
# tests/test_torch_timeshard.py: 4 ranks (the first 2 form the 2-rank mesh)
# ---------------------------------------------------------------------------

def timeshard_channel():
    from pyphysim_tpu_torch.channels import (COST259_TUx,
                                             JakesSampleGenerator,
                                             TdlChannel)
    jakes = JakesSampleGenerator(Fd=50.0, Ts=1.0 / 20e6, L=12, device="cpu")
    return TdlChannel(jakes, COST259_TUx)


def timeshard_checks(rank, world, signal, state, block):
    """``signal``: complex64 numpy ``(N,)``; ``state``: the Jakes state's
    (phi, psi, t0) numpy arrays."""
    from pyphysim_tpu_torch.channels.fading_generators import JakesState
    from pyphysim_tpu_torch.parallel import (corrupt_data_time_sharded,
                                             make_mesh)
    channel = timeshard_channel()
    st = JakesState.from_numpy(*state, device="cpu")
    x = torch.from_numpy(signal)
    out = {}
    for n in (2, world):
        mesh = make_mesh(n, axis_name="time", device="cpu")
        if mesh.get_coordinate() is None:
            continue
        y, ir, new = corrupt_data_time_sharded(channel, st, x, block, mesh)
        out[n] = (y.numpy(), ir.tap_values_sparse.numpy(), float(new.t0))
    mesh = make_mesh(axis_name="time", device="cpu")
    def sharded(signal, block_size):
        return corrupt_data_time_sharded(channel, st, signal, block_size,
                                         mesh)

    out["bad_length"] = raises(ValueError, lambda: sharded(x[:-1], block))
    out["span_too_long"] = raises(ValueError,
                                  lambda: sharded(x[:world * 8], 8))
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_awgn_apps.py: 2 ranks
# ---------------------------------------------------------------------------

def parallel_psk_main(rank, world):
    from apps.awgn_modulators.simulate_parallel_psk_torch import main
    ber_s, ber_p = main(device="cpu")
    return ber_s, ber_p
