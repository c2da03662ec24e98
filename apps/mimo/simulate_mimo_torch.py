#!/usr/bin/env python
"""Monte Carlo BER / SER of MIMO schemes over flat Rayleigh fading, on the
PyTorch / CUDA port.

The counterpart of ``apps/mimo/simulate_mimo.py``: Alamouti 2 x Nr, MRC
1 x Nr and BLAST Nr x Nr with MMSE detection, each chunk of repetitions one
batched call through the runner's per-key path (``_gen_simulation_kernel``).
Repetition ``a`` draws its data, channel and noise from three independent
splits of attempt ``a``'s streams, so results do not depend on the chunk
size. A variation stops early once ``max_bit_errors`` bit errors have
accumulated (``_keep_going``, checked between chunks).

Run: ``python apps/mimo/simulate_mimo_torch.py [--device cuda]``.
"""

import argparse
import sys

sys.path.insert(0, ".")

import numpy as np  # noqa: E402

from pyphysim_tpu_torch._device import require_cuda  # noqa: E402
from pyphysim_tpu_torch.mimo import MRC, Alamouti, Blast  # noqa: E402
from pyphysim_tpu_torch.modulators import QPSK  # noqa: E402
from pyphysim_tpu_torch.simulations import (Result,  # noqa: E402
                                            SimulationRunner)
from pyphysim_tpu_torch.utils.conversion import dB2Linear  # noqa: E402
from pyphysim_tpu_torch.utils.misc import (count_bit_errors,  # noqa: E402
                                           randn_c)

SCHEMES = ("alamouti", "mrc", "blast")


class MimoSimulationRunner(SimulationRunner):
    def __init__(self, scheme: str = "alamouti", Nr: int = 1,
                 device="cuda", read_command_line_args: bool = True):
        super().__init__(read_command_line_args=read_command_line_args)
        if scheme not in SCHEMES:
            raise ValueError(f"scheme must be one of {SCHEMES}")
        self.device = require_cuda(device)
        self.params.add("SNR", np.arange(0.0, 21.0, 3.0))
        self.params.set_unpack_parameter("SNR")
        self.rep_max = 1000
        self.NSymbs = 200
        self.scheme = scheme
        self.Nr = Nr
        self.modulator = QPSK(device=self.device)
        self.max_bit_errors = 3000
        self.progressbar_message = f"{scheme} simulation"
        self.update_progress_function_style = "text2"
        self.batch_result_types = {
            "bit_errors": Result.SUMTYPE,
            "ber": Result.RATIOTYPE,
            "ser": Result.RATIOTYPE,
        }
        self.chunks_dispatched = 0

    def draw(self, streams):
        """Each attempt's data (B, n), channel and noise, from three
        independent splits of its streams."""
        s_data, s_channel, s_noise = streams.split(3)
        n, nr = self.NSymbs, self.Nr
        data = s_data.integers(self.modulator.M, n)
        if self.scheme == "alamouti":
            return data, randn_c(s_channel, nr, 2), randn_c(s_noise, nr, n)
        if self.scheme == "mrc":
            return (data, randn_c(s_channel, nr)[..., None],
                    randn_c(s_noise, nr, n))
        return (data, randn_c(s_channel, nr, nr),
                randn_c(s_noise, nr, n // nr))

    def forward(self, data, h, noise, snr):
        """The chain on drawn inputs: modulate, encode, channel, AWGN at
        ``snr`` (linear), decode, demodulate, count errors."""
        mod, dev = self.modulator, self.device
        n = data.shape[-1]
        tx = mod.modulate(data)
        noise = noise * float(np.sqrt(1.0 / snr))
        if self.scheme == "alamouti":
            obj = Alamouti(h, device=dev)
            rx = h @ obj.encode(tx) + noise
        elif self.scheme == "mrc":
            obj = MRC(h, device=dev)
            rx = h * tx[..., None, :] + noise
        else:  # blast Nr x Nr with MMSE
            obj = Blast(h, device=dev)
            obj.set_noise_var(1.0 / float(snr))
            rx = h @ obj.encode(tx) + noise
        decided = mod.demodulate(obj.decode(rx))
        bit_errors = count_bit_errors(data, decided, axis=-1)
        sym_errors = (decided != data).sum(dim=-1)
        return {"bit_errors": bit_errors,
                "ber": (bit_errors, float(n * mod.K)),
                "ser": (sym_errors, float(n))}

    def _gen_simulation_kernel(self, current_parameters):
        snr = dB2Linear(float(current_parameters["SNR"]))

        def kernel(streams):
            self.chunks_dispatched += 1
            return self.forward(*self.draw(streams), snr)

        return kernel

    def _keep_going(self, current_params, current_sim_results, current_rep):
        if "bit_errors" in current_sim_results and \
                current_sim_results["bit_errors"]:
            return current_sim_results["bit_errors"][-1].get_result() < \
                self.max_bit_errors
        return True


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args, _ = parser.parse_known_args()
    for scheme, nr in [("alamouti", 1), ("alamouti", 2), ("mrc", 2),
                       ("blast", 2)]:
        runner = MimoSimulationRunner(scheme, nr, device=args.device)
        runner.simulate()
        print(f"\n{scheme} (Nr={nr}): elapsed {runner.elapsed_time}")
        print("  BER:", np.array(
            runner.results.get_result_values_list("ber")))


if __name__ == "__main__":
    main()
