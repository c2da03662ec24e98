#!/usr/bin/env python
"""LS and MMSE estimation of a SIMO channel from one pilot sequence, on
the PyTorch port: the empirical mean squared errors beside their
closed-form theory.

The estimation sweep of the JAX package's
``tests/test_reference_signals.py``
(``test_runner_estimation_sweep_matches_theory``) as a runner: each
realization draws an Nr x 1 CN(0, I) channel and the noise of the Nr
received pilot rows from its attempt's streams, and the LS and MMSE
estimates (``channel_estimation.estimators``, batched over the chunk's
realizations) are scored by their squared error. The default pilots are
the comb-2 SRS of 300 subcarriers (a Zadoff-Chu root of length 149,
cyclically extended to 150), at noise powers 0.1 and 1.0.

Run: ``python apps/channel_estimation_sweep_torch.py [--device cuda]``.
"""

import argparse
import sys

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pyphysim_tpu_torch._device import require_cuda  # noqa: E402
from pyphysim_tpu_torch.channel_estimation import (  # noqa: E402
    compute_ls_estimation, compute_mmse_estimation,
    compute_theoretical_ls_MSE, compute_theoretical_mmse_MSE)
from pyphysim_tpu_torch.reference_signals import (  # noqa: E402
    calcBaseZC, get_extended_ZF, get_srs_seq)
from pyphysim_tpu_torch.simulations import (Result,  # noqa: E402
                                            SimulationRunner)
from pyphysim_tpu_torch.utils.misc import (full_precision,  # noqa: E402
                                           randn_c)


def srs_pilots(num_subcarriers: int = 300, Nzc: int = 149, root: int = 1,
               shift: int = 4) -> np.ndarray:
    """The comb-2 SRS of ``num_subcarriers`` as a (1, num_pilots) pilot
    row (unit-magnitude values)."""
    return get_srs_seq(get_extended_ZF(calcBaseZC(Nzc, root),
                                       num_subcarriers // 2),
                       shift)[None, :].astype(np.complex64)


class EstimationSweepRunner(SimulationRunner):
    """Mean squared LS / MMSE estimation errors over ``noise_power``, on
    the per-key path; the channel covariance is the identity."""

    def __init__(self, Nr: int = 4, pilots=None, device="cuda",
                 read_command_line_args: bool = True):
        super().__init__(read_command_line_args=read_command_line_args)
        self.device = require_cuda(device)
        self.params.add("noise_power", np.array([0.1, 1.0]))
        self.params.set_unpack_parameter("noise_power")
        self.rep_max = 16384
        self.batch_size = 4096
        self.update_progress_function_style = None
        self.Nr = int(Nr)
        self.pilots = srs_pilots() if pilots is None else \
            np.asarray(pilots, np.complex64)
        self.batch_result_types = {"ls_mse": Result.RATIOTYPE,
                                   "mmse_mse": Result.RATIOTYPE}
        self.chunks_dispatched = 0

    @property
    def num_pilots(self) -> int:
        return self.pilots.shape[-1]

    def theory(self, noise_power: float):
        """The closed-form (LS, MMSE) mean squared errors."""
        return (compute_theoretical_ls_MSE(self.Nr, noise_power, 1.0, 1.0,
                                           self.num_pilots),
                compute_theoretical_mmse_MSE(self.Nr, noise_power, 1.0, 1.0,
                                             self.num_pilots,
                                             np.eye(self.Nr)))

    def _gen_simulation_kernel(self, current_parameters):
        npow = float(current_parameters["noise_power"])
        s = torch.as_tensor(self.pilots, device=self.device)
        C = torch.eye(self.Nr, dtype=torch.complex64, device=self.device)

        def kernel(streams):
            self.chunks_dispatched += 1
            s_h, s_noise = streams.split(2)
            h = randn_c(s_h, self.Nr, 1)                  # (n, Nr, 1)
            Y = full_precision(torch.matmul)(h, s) + \
                randn_c(s_noise, self.Nr, self.num_pilots) * \
                np.float32(np.sqrt(npow))
            ls = compute_ls_estimation(Y, s)
            mm = compute_mmse_estimation(Y, s, npow, C)
            return {"ls_mse": ((ls - h).abs().square().sum(dim=(-2, -1)),
                               1.0),
                    "mmse_mse": ((mm - h).abs().square().sum(dim=(-2, -1)),
                                 1.0)}

        return kernel


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args, _ = parser.parse_known_args()
    runner = EstimationSweepRunner(device=args.device)
    runner.simulate()
    ls = runner.results.get_result_values_list("ls_mse")
    mm = runner.results.get_result_values_list("mmse_mse")
    for npow, a, b in zip(runner.results.params["noise_power"], ls, mm):
        t_ls, t_mm = runner.theory(float(npow))
        print(f"noise {npow}: LS {a:.6g} (theory {t_ls:.6g}), "
              f"MMSE {b:.6g} (theory {t_mm:.6g})")


if __name__ == "__main__":
    main()
