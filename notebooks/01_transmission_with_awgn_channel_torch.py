# %% [markdown]
# # Transmission with an AWGN channel (PyTorch port)
#
# The port's counterpart of `01_transmission_with_awgn_channel.py`:
# simulate QPSK over AWGN with the Monte Carlo engine, compare against
# theory, stop early at an error budget. Every chunk of repetitions is one
# batched call on the device: repetition `a` draws its symbols and noise
# from the Philox streams of attempt `a` (`ops/streams.py`), so a run on
# the card and a run on the CPU see the same bits.
#
# Runs as a script or as percent-format notebook cells, on the card by
# default. To run it on the CPU, hand it `DEVICE`:
# `runpy.run_path(path, init_globals={"DEVICE": "cpu"})`.

# %%
import os
import sys

# the repository root: the parent of this file's folder, or of the working
# directory of a notebook server started in notebooks/
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    globals().get("__file__", "notebook")))))

import numpy as np

from pyphysim_tpu_torch._device import require_cuda
from pyphysim_tpu_torch.modulators import QPSK
from pyphysim_tpu_torch.simulations import Result, SimulationRunner
from pyphysim_tpu_torch.utils.conversion import dB2Linear
from pyphysim_tpu_torch.utils.misc import count_bit_errors, qfunc, randn_c

DEVICE = globals().get("DEVICE", "cuda")
require_cuda(DEVICE)      # no CPU fallback: without a card, say DEVICE="cpu"

# %%


class AwgnSimulator(SimulationRunner):
    """QPSK over AWGN with early stop at an accumulated-error budget."""

    def __init__(self, rep_max=500, num_symbols=1000):
        super().__init__(read_command_line_args=False)
        self.device = DEVICE
        self.params.add("SNR", np.arange(0.0, 18.0, 2.0))
        self.params.set_unpack_parameter("SNR")
        self.rep_max = rep_max
        self.num_symbols = num_symbols
        self.max_bit_errors = 2000
        self.modulator = QPSK(device=DEVICE)
        self.progressbar_message = "QPSK AWGN - SNR {SNR}"
        self.batch_result_types = {
            "bit_errors": Result.SUMTYPE,
            "ber": Result.RATIOTYPE,
            "ser": Result.RATIOTYPE,
        }

    def _gen_simulation_kernel(self, current_parameters):
        snr = dB2Linear(float(current_parameters["SNR"]))
        scale = float(np.sqrt(1.0 / snr))
        mod, n = self.modulator, self.num_symbols

        def kernel(streams):
            s_data, s_noise = streams.split(2)
            data = s_data.integers(mod.M, (n,))
            rx = mod.modulate(data) + randn_c(s_noise, n) * scale
            decided = mod.demodulate(rx)
            bits = count_bit_errors(data, decided, axis=-1)
            return {"bit_errors": bits,
                    "ber": (bits, float(n * mod.K)),
                    "ser": ((decided != data).sum(dim=-1), float(n))}

        return kernel

    def _keep_going(self, params, results, rep):
        if "bit_errors" in results and results["bit_errors"]:
            return results["bit_errors"][-1].get_result() < \
                self.max_bit_errors
        return True


# %% Run the sweep
runner = AwgnSimulator()
runner.simulate()
print("\nElapsed:", runner.elapsed_time)
print("Reps per SNR point:", runner.runned_reps)

# %% Compare with theory
snrs = np.asarray(runner.results.params["SNR"], dtype=float)
ber = np.array(runner.results.get_result_values_list("ber"))
bit_errors = np.array(runner.results.get_result_values_list("bit_errors"))
bits = np.array(runner.runned_reps) * runner.num_symbols * \
    runner.modulator.K
theory = qfunc(np.sqrt(dB2Linear(snrs)))  # QPSK BER = Q(sqrt(Es/N0))
for s, b, t in zip(snrs, ber, theory):
    print(f"SNR {s:5.1f} dB: BER {b:.3e} (theory {t:.3e})")

# %% Confidence intervals
cis = runner.results.get_result_values_confidence_intervals("ber", P=95)
print("\n95% confidence interval at", snrs[3], "dB:", cis[3])

# %% Resume demonstration: raise rep_max and simulate() again -> only the
# remaining repetitions run (requires set_results_filename for the
# checkpoint files; see docs/monte_carlo.md).

# %% Optional plot
try:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots()
    ax.semilogy(snrs, theory, "k-", label="theory")
    ax.semilogy(snrs, ber, "o", label="simulated")
    ax.set_xlabel("SNR (dB)")
    ax.set_ylabel("BER")
    ax.legend()
    ax.grid(True, which="both")
    fig.savefig("awgn_ber.png", dpi=100)
    print("\nSaved awgn_ber.png")
except ImportError:
    print("plotting skipped: matplotlib is not installed")
