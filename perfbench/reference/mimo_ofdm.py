"""The plain reference of the MIMO-OFDM chain: Nt layers of QAM with
Blast's 1/sqrt(Nt) split -> per-antenna OFDM with cyclic prefix -> the
Nr x Nt TDL channel with Jakes fading, held over each OFDM symbol -> AWGN
on each receive antenna -> FFT demodulation -> the MMSE filter on each
resource element (RE), from the true channel -> hard decisions -> bit
errors, per attempt.

Written from the chain's equations in plain PyTorch, in float64
(complex128) wherever the program computes in float32, on the random
variates the stream layouts of :mod:`.philox` define (as
:func:`.flagship.perkey_counts` reads them: the three sub-streams of
``split_salts(seed, 0, 3)``, the data symbols 32 // log2(M) to a word, the
Jakes angles and phases as float32-exact uniforms laid out (2, rays, taps,
Nr, Nt), the noise as Box-Muller normals laid out (2, Nr, samples)). It
imports nothing of the program and takes every constant from the
configuration's file: ``num_tx``, ``num_rx``, ``modulation``, ``ofdm``,
``bandwidth_hz``, ``doppler_hz``, ``jakes_rays``, ``channel`` and
``detector``.

The MMSE filter is ``mimo.Blast``'s: ``x = sqrt(Nt) (H^H H + s2 I)^-1 H^H
y`` by ``torch.linalg.solve`` in float64, where ``s2 = (used + cp) / (fft
* SNR)`` is the noise variance on one subcarrier after the demodulation's
division by ``sqrt(fft^2 / (used + cp))``, in H's units (time-domain
noise of variance 1 / SNR, summed over ``fft`` samples by the FFT). The
configuration's ``detector`` must be ``"mmse"``.

Departures from 3GPP TS 36.211 / TS 36.101 (the configuration's
``assumed``):

  * a cyclic prefix of 144 samples on every OFDM symbol (TS 36.211 gives
    the first symbol of each slot 160), so a subframe is 14 x 2,192
    samples;
  * the classical Doppler spectrum of TS 36.101 Annex B.2 by Jakes' sum of
    16 sinusoids a link and tap;
  * the channel held over each OFDM symbol (one Jakes evaluation a symbol);
  * the tap delays rounded to the 30.72 MHz sampling grid (EVA's nine
    delays fall on nine distinct samples, the last at 77);
  * low MIMO correlation (Annex B.2.3.1, alpha = beta = 0) as 16
    independent links;
  * perfect channel knowledge at the receiver (no reference signals);
  * uncoded QAM: no turbo code, no rate matching (pyphysim has no channel
    coding).

Computed in blocks of attempts on the attempts' device, with TF32 off.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from . import philox
from .flagship import Geometry, _bit_errors, _decide, _qam, _snr_linear


def perkey_counts(cfg: Dict, num_symbols: int, seed: int, snr_db: float,
                  attempts: torch.Tensor, block: int = 16) -> torch.Tensor:
    """(n,) int64 bit errors of the 1-D int64 ``attempts``, ``num_symbols``
    REs a layer (a whole number of OFDM symbols), summed over the layers;
    computed on ``attempts``' device in blocks of ``block`` attempts."""
    geo = Geometry.from_config(cfg)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return torch.cat([
            _block(geo, int(cfg["num_tx"]), int(cfg["num_rx"]),
                   cfg["detector"], num_symbols, int(seed), float(snr_db),
                   attempts[r0:r0 + block])
            for r0 in range(0, attempts.shape[0], block)])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _block(geo: Geometry, nt: int, nr: int, detector: str,
           num_symbols: int, seed: int, snr_db: float,
           att: torch.Tensor) -> torch.Tensor:
    if detector != "mmse":
        raise ValueError(f"the reference detects by MMSE, not {detector!r}")
    dev = att.device
    n = att.shape[0]
    T, L, used, spb, D = geo.taps, geo.rays, geo.used, geo.spb, geo.span
    nb = num_symbols // used
    s_data, s_channel, s_noise = philox.split_salts(seed, 0, 3)

    # the layers' symbols: row t is layer t
    per_word = 32 // geo.bits_per_symbol
    words = philox.stream_words(seed, s_data, att,
                                nt * num_symbols // per_word)
    shifts = torch.arange(per_word, dtype=torch.int64,
                          device=dev) * geo.bits_per_symbol
    sym = ((words[..., None] >> shifts) & (geo.M - 1)).reshape(
        n, nt, num_symbols)

    # Jakes: a state a (tap, rx, tx), evaluated at each OFDM symbol's start
    u = philox.words_to_uniform(philox.stream_words(
        seed, s_channel, att, 2 * L * T * nr * nt)).reshape(n, 2, L, T, nr,
                                                            nt)
    phi, psi = u[:, 0] * (2 * math.pi), u[:, 1] * (2 * math.pi)
    tb = torch.arange(nb, dtype=torch.float64, device=dev) * (spb * geo.ts)
    ph = (2 * math.pi * geo.doppler_hz * torch.cos(phi))[..., None] * tb + \
        psi[..., None]                              # (n, L, T, Nr, Nt, nb)
    gain = torch.tensor((geo.powers / L) ** 0.5, device=dev)
    h = torch.polar(torch.ones_like(ph), ph).sum(1) * \
        gain[:, None, None, None]                   # (n, T, Nr, Nt, nb)

    noise_len = nb * spb + D - 1
    m = 2 * nr * noise_len
    z = philox.words_to_normal(philox.stream_words(
        seed, s_noise, att, m + (m & 1)))[:, :m].reshape(n, 2, nr, noise_len)
    noise = torch.complex(z[:, 0], z[:, 1]) * math.sqrt(0.5)

    # OFDM with cyclic prefix, each transmit antenna
    scale = math.sqrt(geo.fft ** 2 / (used + geo.cp))
    bins = torch.as_tensor(geo.used_bins(), device=dev)
    x = _qam(geo, sym) / math.sqrt(nt)
    spectrum = torch.zeros((n, nt, nb, geo.fft), dtype=torch.complex128,
                           device=dev)
    spectrum[..., bins] = x.reshape(n, nt, nb, used)
    td = torch.fft.ifft(spectrum) * scale
    td = torch.cat([td[..., -geo.cp:], td], dim=-1)      # (n, Nt, nb, spb)

    # the sparse FIR of each link, one OFDM symbol at a time, summed over
    # the transmit antennas, then overlap-added
    yb = torch.zeros((n, nr, nb, spb + D - 1), dtype=torch.complex128,
                     device=dev)
    for t, d in enumerate(geo.delays):
        yb[..., d:d + spb] += torch.einsum("nrsb,nsbk->nrbk", h[:, t], td)
    rx = torch.zeros((n, nr, noise_len), dtype=torch.complex128, device=dev)
    for b in range(nb):
        rx[..., b * spb:b * spb + spb + D - 1] += yb[:, :, b]
    rx = rx + noise * math.sqrt(1.0 / _snr_linear(snr_db))

    r = rx[..., :nb * spb].reshape(n, nr, nb, spb)[..., geo.cp:]
    y = (torch.fft.fft(r) / scale)[..., bins]            # (n, Nr, nb, used)
    # per RE: H (Nr x Nt) from the taps' DFT at the used bins, and y (Nr)
    hf = torch.einsum("ntrsb,tu->nburs", h, geo.tap_dft(dev))
    yv = y.permute(0, 2, 3, 1)[..., None]                # (n, nb, used, Nr, 1)
    s2 = (used + geo.cp) / (geo.fft * _snr_linear(snr_db))
    hh = hf.mH
    eye = torch.eye(nt, dtype=torch.complex128, device=dev)
    est = torch.linalg.solve(hh @ hf + s2 * eye, hh @ yv)[..., 0] * \
        math.sqrt(nt)                                    # (n, nb, used, Nt)
    decided = _decide(geo, est)
    sent = sym.reshape(n, nt, nb, used).permute(0, 2, 3, 1)
    return _bit_errors(sent, decided, (1, 2, 3))
