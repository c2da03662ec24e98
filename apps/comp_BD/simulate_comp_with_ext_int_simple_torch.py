#!/usr/bin/env python
"""CoMP (BD) transmission with external interference, on the PyTorch port.

The counterpart of ``apps/comp_BD/simulate_comp_with_ext_int_simple.py``:
a 3-cell cluster with users at 70 % of the cell border, 3GPP path loss,
EnhancedBD joint processing with a stream-sacrifice metric (the effective
throughput by default) against a rank-1 external interferer, and the whole
transmit chain (modulate, precode, the concatenated channel, the
block-diagonal receive filter, demodulate; SER / BER / PER / spectral
efficiency). Two engines:

* :func:`simulate`: one repetition at a time on the host solvers
  (``EnhancedBD`` on ``MultiUserChannelMatrixExtInt``), repetition ``r``'s
  channel drawn from a generator seeded ``r``;
* :func:`simulate_device`: the same scenario through the runner's per-key
  path, each chunk one batched call (``comm.enhanced_bd_batched``) with
  the ``__valid__`` mask of degenerate draws; attempt ``a`` draws from its
  ``AttemptStreams`` as in ``apps/comp_BD/simulate_comp_torch.py``.

Run: ``python apps/comp_BD/simulate_comp_with_ext_int_simple_torch.py
[--reps 100] [--pe-dbm 10] [--snr 15] [--metric ...] [--batched]
[--device cuda]``.
"""

import argparse
import os
import sys
from time import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from scipy.linalg import block_diag  # noqa: E402

from apps.comp_BD.simulate_comp_torch import (account_attempts,  # noqa: E402
                                              draw_attempts)
from pyphysim_tpu_torch._device import require_cuda  # noqa: E402
from pyphysim_tpu_torch.cell.cell import Grid  # noqa: E402
from pyphysim_tpu_torch.channels.multiuser import \
    MultiUserChannelMatrixExtInt  # noqa: E402
from pyphysim_tpu_torch.channels.pathloss import PathLoss3GPP1  # noqa: E402
from pyphysim_tpu_torch.comm.batched import \
    enhanced_bd_batched  # noqa: E402
from pyphysim_tpu_torch.comm.blockdiagonalization import \
    EnhancedBD  # noqa: E402
from pyphysim_tpu_torch.modulators import PSK  # noqa: E402
from pyphysim_tpu_torch.progressbar import ProgressbarText  # noqa: E402
from pyphysim_tpu_torch.simulations import (Result,  # noqa: E402
                                            SimulationRunner)
from pyphysim_tpu_torch.utils.conversion import (dB2Linear,  # noqa: E402
                                                 dBm2Linear)
from pyphysim_tpu_torch.utils.misc import (count_bit_errors,  # noqa: E402
                                           randn_c_RS)

NUM_CELLS, NR, NT = 3, 2, 2
M, PACKET_LENGTH, NSYMBS, N0_DBM, EXT_INT_RANK = 4, 60, 500, -116.4, 1


def scenario(snr_db: float, pe_dbm: float):
    """The fixed geometry: ``(pathloss (K, K), pathloss_int (K, 1),
    transmit power, noise variance, pe)``."""
    cell_radius = 1.0
    path_loss_obj = PathLoss3GPP1()
    noise_var = float(dBm2Linear(N0_DBM))
    transmit_power = float(dB2Linear(snr_db)) * noise_var / float(
        path_loss_obj.calc_path_loss(cell_radius))
    grid = Grid()
    grid.create_clusters(1, NUM_CELLS, cell_radius)
    cluster0 = grid._clusters[0]
    cluster0.delete_all_users()
    cluster0.add_border_users(np.arange(1, NUM_CELLS + 1),
                              np.array([210, -30, 90]), 0.7)
    pathloss = np.asarray(path_loss_obj.calc_path_loss(
        cluster0.calc_dist_all_users_to_each_cell()))
    dist_to_center = np.array(
        [cluster0.calc_dist(u) for u in cluster0.get_all_users()])
    pathloss_int = np.asarray(path_loss_obj.calc_path_loss(
        cluster0.external_radius - dist_to_center)).reshape(NUM_CELLS, 1)
    return (pathloss, pathloss_int, transmit_power, noise_var,
            float(dBm2Linear(pe_dbm)))


def _metric_args(metric, modulator):
    metric = None if metric in (None, "None") else metric
    if metric == "effective_throughput":
        return metric, {"modulator": modulator,
                        "packet_length": PACKET_LENGTH}
    if metric in ("naive", "fixed"):
        return metric, {"num_streams": 1}
    return metric, {}


def simulate(reps: int = 100, pe_dbm: float = 10.0, snr_db: float = 15.0,
             metric: str = "effective_throughput", verbose: bool = True,
             device="cuda"):
    """The host engine; returns ``(ser, ber, per, spectral_efficiency)``.

    ``metric``: EnhancedBD's stream-sacrifice metric, "effective_
    throughput", "capacity", "naive", "fixed" or "None"."""
    device = require_cuda(device)
    modulator = PSK(M, device=device)
    pathloss, pathloss_int, transmit_power, noise_var, pe = \
        scenario(snr_db, pe_dbm)
    metric_arg, extra = _metric_args(metric, modulator)
    channel = MultiUserChannelMatrixExtInt(device=device)
    rng = np.random.RandomState(0)
    pbar = ProgressbarText(
        reps, message=f"Simulating for SNR: {snr_db}, Pe_dBm: {pe_dbm}") \
        if verbose else None
    num_symbol_errors = num_symbols = num_bit_errors = num_bits = 0
    for rep in range(reps):
        channel.randomize(NR, NT, NUM_CELLS, EXT_INT_RANK,
                          generator=torch.Generator(device=device)
                          .manual_seed(rep))
        channel.set_pathloss(pathloss, pathloss_int)
        channel.noise_var = noise_var
        comp_obj = EnhancedBD(NUM_CELLS, transmit_power, noise_var, pe)
        comp_obj.set_ext_int_handling_metric(metric_arg, extra or None)
        MsPk_all, Wk_all, Ns_all = \
            comp_obj.block_diagonalize_no_waterfilling(channel)

        input_data = rng.randint(0, M, [int(np.sum(Ns_all)), NSYMBS])
        precoded = np.hstack(MsPk_all) @ modulator.modulate(input_data)
        ext_data = np.sqrt(pe) * randn_c_RS(rng, EXT_INT_RANK, NSYMBS)
        received = channel.corrupt_concatenated_data(
            np.vstack([precoded, ext_data]))
        decoded = modulator.demodulate(block_diag(*Wk_all) @ received)

        num_symbol_errors += int(np.sum(decoded != input_data))
        num_symbols += input_data.size
        num_bit_errors += int(count_bit_errors(input_data, decoded))
        num_bits += input_data.size * modulator.K
        if pbar is not None:
            pbar.progress(rep + 1)
    ser = num_symbol_errors / num_symbols
    ber = num_bit_errors / num_bits
    per = 1 - (1 - ber) ** PACKET_LENGTH
    return ser, ber, per, modulator.K * (1 - per)


def simulate_device(reps: int = 512, pe_dbm: float = 10.0,
                    snr_db: float = 15.0,
                    metric: str = "effective_throughput",
                    verbose: bool = True, device="cuda"):
    """The same scenario through the runner's per-key path, each chunk one
    batched call; returns ``(ser, ber, per, spectral_efficiency)``."""
    device = require_cuda(device)
    modulator = PSK(M, device=device)
    pathloss, pathloss_int, transmit_power, noise_var, pe = \
        scenario(snr_db, pe_dbm)
    metric_arg, kw = _metric_args(metric, modulator)
    spl = torch.as_tensor(np.sqrt(pathloss), dtype=torch.float32,
                          device=device)
    spl_i = torch.as_tensor(np.sqrt(pathloss_int[:, 0]),
                            dtype=torch.float32, device=device)

    class _Runner(SimulationRunner):
        def __init__(self):
            super().__init__(read_command_line_args=False)
            self.device = device
            self.params.add("SNR", np.array([snr_db]))
            self.params.set_unpack_parameter("SNR")
            self.rep_max = reps
            self.update_progress_function_style = \
                "text1" if verbose else None
            self.batch_result_types = {"ser_x": Result.RATIOTYPE,
                                       "ber_x": Result.RATIOTYPE}

        def _gen_simulation_kernel(self, p):
            def kernel(streams):
                n = streams.n
                draws = draw_attempts(
                    streams, spl.expand(n, -1, -1), spl_i.expand(n, -1),
                    NR, NT, EXT_INT_RANK, NSYMBS, M, pe, noise_var)
                MsPk, Wk, Ns, sinrs, valid = enhanced_bd_batched(
                    draws["H"], draws["R"], NUM_CELLS, transmit_power,
                    metric=metric_arg, **kw)
                out = account_attempts(
                    draws, {"x": (MsPk, Wk, Ns, sinrs)}, modulator,
                    PACKET_LENGTH)
                return {"ser_x": out["ser_x"], "ber_x": out["ber_x"],
                        "__valid__": valid}

            return kernel

    runner = _Runner()
    runner.simulate()
    ser = float(runner.results.get_result_values_list("ser_x")[0])
    ber = float(runner.results.get_result_values_list("ber_x")[0])
    per = 1 - (1 - ber) ** PACKET_LENGTH
    return ser, ber, per, modulator.K * (1 - per)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=100)
    parser.add_argument("--pe-dbm", type=float, default=10.0)
    parser.add_argument("--snr", type=float, default=15.0)
    parser.add_argument("--metric", default="effective_throughput",
                        help="None | naive | fixed | capacity | "
                             "effective_throughput")
    parser.add_argument("--batched", action="store_true",
                        help="run the batched per-key engine "
                             "(enhanced_bd_batched) instead of the host "
                             "repetition loop")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    tic = time()
    sim = simulate_device if args.batched else simulate
    ser, ber, per, se = sim(args.reps, args.pe_dbm, args.snr, args.metric,
                            device=args.device)
    print()
    print(f"SER: {ser}")
    print(f"BER: {ber}")
    print(f"PER: {per}")
    print(f"Spectral Efficiency: {se} bits/symbol")
    print(f"Elapsed: {time() - tic:.1f} s")


if __name__ == "__main__":
    main()
