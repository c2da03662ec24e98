#!/usr/bin/env python
"""Plot the power spectral density of OFDM modulated data, on the PyTorch
port.

The counterpart of ``apps/ofdm/plot_ofdm_PSD.py``: BPSK bits (from the JAX
app's ``RandomState(0)``) through an 802.11a-style OFDM(64, CP 16, 52 used
subcarriers) on ``--device``, then the Welch PSD of the time-domain signal
on the host. Without matplotlib it prints the signal's mean power instead,
as the JAX app does.

Run: ``python apps/ofdm/plot_ofdm_PSD_torch.py [--out ofdm_psd.png]
[--device cuda]``.
"""

import argparse
import sys

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pyphysim_tpu_torch.modulators.ofdm import OFDM  # noqa: E402


def ofdm_signal(device="cuda"):
    """``(ofdm, time-domain signal)``: 2,496 BPSK symbols (0 -> -1, 1 ->
    +1) from ``RandomState(0)`` modulated by OFDM(64, 16, 52) on
    ``device``."""
    rng = np.random.RandomState(0)
    ip_bits = rng.randint(0, 2, 2496)        # a multiple of 52 subcarriers
    ofdm_obj = OFDM(64, 16, 52, device=device)
    ip_mod = torch.as_tensor(2 * ip_bits - 1, device=ofdm_obj.device)
    return ofdm_obj, ofdm_obj.modulate(ip_mod.to(torch.complex64))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="ofdm_psd.png")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    ofdm_obj, ofdm_symbols = ofdm_signal(args.device)
    ofdm_symbols = ofdm_symbols.cpu().numpy()
    fs_mhz = 20e6
    try:
        from matplotlib import mlab
        from matplotlib import pyplot as plt
    except ImportError:
        print("matplotlib unavailable; printing total signal power instead")
        print("mean |x|^2 =", float(np.mean(np.abs(ofdm_symbols) ** 2)))
        return ofdm_symbols

    pxx, freqs = mlab.psd(ofdm_symbols, NFFT=ofdm_obj.fft_size, Fs=fs_mhz)
    plt.plot(freqs, 10 * np.log10(pxx))
    plt.xlabel("frequency, MHz")
    plt.ylabel("power spectral density")
    plt.title("Transmit spectrum OFDM (based on 802.11a)")
    plt.savefig(args.out, dpi=120)
    plt.close()
    print(f"Saved PSD plot to {args.out}")
    return ofdm_symbols


if __name__ == "__main__":
    main()
