#!/usr/bin/env python
"""The LTE-Advanced uplink's 4-layer PUSCH over ETU70, with a DMRS channel
estimate and a linear MMSE equalizer, on the PyTorch / CUDA port.

The link-level setting: one UE with 4 antennas sends 4 layers of uncoded
16-QAM to an eNB with 4 antennas; SC-FDMA (3GPP TS 36.211 §5.3.3:
transform precoding, an orthonormal DFT of each layer's 1,200 symbols in
each data symbol) on 20 MHz (100 PRB: 30.72 MHz sampling, a 2,048-point
FFT, 1,200 used subcarriers, a normal cyclic prefix of 144 samples, 14
SC-FDMA symbols a 1 ms subframe); the rank-4 precoder I / 2 (§5.3.3A.2);
each layer's DMRS in symbols 3 and 10 (§5.5.2.1.2): the Zadoff-Chu base
sequence of root 38 (length 1,193 extended to 1,200; sequence group 0,
no group or sequence hopping), cyclic shifts 0, 6, 3, 9 and cover codes
[1 1], [1 1], [1 -1], [1 -1] (Table 5.5.2.1.1-1, cyclic-shift field 000);
the Extended Typical Urban profile of TS 36.104 Annex B.2 at 70 Hz, low
MIMO correlation (the 16 links independent), Jakes fading with 16 rays,
the channel held over each SC-FDMA symbol. The eNB estimates each layer's
channel from the DMRS (pyphysim's ``CazacBasedWithOCCChannelEstimator``,
delays 0..100 of 1,200 kept), once a subframe, and equalizes each
subcarrier by MMSE on the estimate before the IDFT that undoes the
spreading. One attempt is one subframe: 4 x 12 x 1,200 = 57,600 data
symbols, 230,400 bits.

The chunks run through ``mimo_ofdm_tdl_torch.py``'s runner and the
per-key path: on CUDA each call after the first at an attempt count
replays one captured CUDA graph of ``pyphysim_tpu_torch/pusch_chain.py``'s
step. The sweep: 0 to 40 dB by 10, each point until 10,000 bit errors or
4,096 subframes, chunks of 256 as 8 sub-chunks of 32 under the stop rule.

Run: ``python apps/mimo/pusch_etu70_torch.py [--device cuda]``.
"""

import argparse
import sys

sys.path.insert(0, ".")

import numpy as np  # noqa: E402

from apps.mimo.mimo_ofdm_tdl_torch import \
    MimoOfdmTdlSimulationRunner  # noqa: E402
from pyphysim_tpu_torch._device import require_cuda  # noqa: E402
from pyphysim_tpu_torch.channels import (JakesSampleGenerator,  # noqa: E402
                                         TdlChannel, TdlChannelProfile)
from pyphysim_tpu_torch.pusch_chain import PuschChainStep  # noqa: E402

# 3GPP TS 36.104 Annex B.2: Extended Typical Urban
ETU_DELAYS_S = np.array([0, 50, 120, 200, 230, 500, 1600, 2300, 5000]) * 1e-9
ETU_POWERS_DB = np.array([-1.0, -1.0, -1.0, 0.0, 0.0, 0.0, -3.0, -5.0, -7.0])
DOPPLER_HZ = 70.0
JAKES_RAYS = 16
# TS 36.211 §5.5.1.1: q of sequence group 0 (v = 0) at N_ZC = 1,193
ROOT_INDEX = 38
# Table 5.5.2.1.1-1, cyclic-shift field 000, layers 0..3
CYCLIC_SHIFTS = (0, 6, 3, 9)
COVER_CODES = ((1, 1), (1, 1), (1, -1), (1, -1))
TAPS_TO_KEEP = 100


def etu_channel(num_rx: int, num_tx: int, bandwidth_hz: float = 30.72e6,
                device="cuda") -> TdlChannel:
    """A ``num_rx`` x ``num_tx`` ETU70 channel on a Jakes generator at the
    sampling rate ``bandwidth_hz``."""
    jakes = JakesSampleGenerator(Fd=DOPPLER_HZ, Ts=1.0 / bandwidth_hz,
                                 L=JAKES_RAYS, device=device)
    channel = TdlChannel(jakes, TdlChannelProfile(ETU_POWERS_DB,
                                                  ETU_DELAYS_S, "ETU"))
    channel.set_num_antennas(num_rx, num_tx)
    return channel


def pusch_step(device="cuda", signal_dtype=None) -> PuschChainStep:
    """The deployment's step: 4 layers, 4 receive antennas, one subframe
    of 20 MHz an attempt."""
    return PuschChainStep(
        4, 4, 16, 1200 * 12, 2048, 144, 1200, etu_channel(4, 4,
                                                          device=device),
        ROOT_INDEX, CYCLIC_SHIFTS, COVER_CODES, taps_to_keep=TAPS_TO_KEEP,
        signal_dtype=signal_dtype, device=device)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args, _ = parser.parse_known_args()
    device = require_cuda(args.device)
    runner = MimoOfdmTdlSimulationRunner(device=device,
                                         chain=pusch_step(device))
    runner.simulate()
    print("\nElapsed time:", runner.elapsed_time)
    print("SNR:", runner.results.params["SNR"])
    print("BER:", np.array(runner.results.get_result_values_list("ber")))
    print("subframes:", list(runner.runned_reps))


if __name__ == "__main__":
    main()
