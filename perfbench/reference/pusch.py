"""The plain reference of the uplink's spatially multiplexed PUSCH: Nt
layers of QAM, each spread by SC-FDMA's transform precoding, each layer's
DMRS in the pilot symbols -> the identity precoder 1/sqrt(Nt) ->
per-antenna OFDM with cyclic prefix -> the Nr x Nt TDL channel with Jakes
fading, held over each SC-FDMA symbol -> AWGN on each receive antenna ->
FFT demodulation -> the DMRS estimate with cyclic shifts and cover codes
-> the linear MMSE filter on each subcarrier, from the estimate ->
de-spreading -> per-layer unbiasing -> hard decisions -> bit errors, per
attempt (one subframe).

Written from the standards' equations in plain PyTorch, in float64
(complex128) wherever the program computes in float32, on the random
variates the stream layouts of :mod:`.philox` define, as
:func:`.mimo_ofdm.perkey_counts` reads them (the three sub-streams of
``split_salts(seed, 0, 3)``; the data symbols 32 // log2(M) to a word,
layer t's in row t; the Jakes angles and phases as float32-exact uniforms
laid out (2, rays, taps, Nr, Nt); the noise as Box-Muller normals laid out
(2, Nr, samples)). It imports nothing of the program and takes every
constant from the configuration's file: ``num_tx`` (the layers and UE
antennas), ``num_rx``, ``modulation``, ``ofdm``, ``bandwidth_hz``,
``doppler_hz``, ``jakes_rays``, ``channel``, ``dmrs`` and ``detector``.

3GPP TS 36.211:

  * §5.3.3, transform precoding: each layer's ``M = num_used`` symbols of
    a data symbol, ``z(k) = sum_i x(i) exp(-2 pi j i k / M) / sqrt(M)``;
  * §5.3.3A.2, precoding at rank Nt over Nt antennas: ``I / sqrt(Nt)``
    (at 4 layers the codebook's one entry, I / 2), data and DMRS alike;
  * §5.5.1, the base sequence of ``M >= 36`` subcarriers: the Zadoff-Chu
    sequence ``x_q(m) = exp(-j pi q m (m + 1) / N_ZC)`` of the largest
    prime ``N_ZC <= M``, extended cyclically to ``M``; the cyclic shift
    ``exp(j alpha n)``, ``alpha = 2 pi n_cs / 12``;
  * §5.5.2.1, layer l's DMRS in slot s: ``w_l(s) exp(j alpha_l n) r(n)``,
    with the cyclic shifts and cover codes of Table 5.5.2.1.1-1;
    §5.5.2.1.2, the DMRS in symbol 3 of each slot (``dmrs.symbols``).

The receiver is pyphysim v0.7.2's ``CazacBasedWithOCCChannelEstimator``
on each layer (the slots decoded with the layer's cover code and averaged,
times the conjugate of the layer's shifted sequence, an IFFT over the
subcarriers, the delays ``0..dmrs.taps_to_keep`` kept, an FFT back), one
estimate a subframe held over its data symbols; then per subcarrier the
MMSE filter ``W = (H^H H + s2 I)^-1 H^H`` by ``torch.linalg.solve``, with
``s2 = (used + cp) / (fft * SNR)`` the noise variance on one subcarrier
after the demodulation's division by ``sqrt(fft^2 / (used + cp))``;
``x = W y`` on each data symbol; per layer and data symbol the orthonormal
IDFT of ``x`` divided by ``mu_l``, the mean over the subcarriers of
``(W H)_ll``. The configuration's ``detector`` must be ``"mmse"``.

Departures from the standards are the configuration's ``assumed``, each
taken as the configuration states it. Computed in blocks of attempts on
the attempts' device, with TF32 off.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from . import philox
from .flagship import Geometry, _bit_errors, _decide, _qam, _snr_linear


def _largest_prime_at_most(n: int) -> int:
    def prime(x):
        return x > 1 and all(x % f for f in range(2, int(x ** 0.5) + 1))
    while not prime(n):
        n -= 1
    return n


def dmrs(cfg: Dict, device) -> torch.Tensor:
    """(Nt, slots, used) complex128: layer l's DMRS in each pilot symbol
    (§5.5.1, §5.5.2.1)."""
    d = cfg["dmrs"]
    used = int(cfg["ofdm"]["num_used"])
    nzc = _largest_prime_at_most(used)
    q = int(d["root_index"])
    m = torch.arange(nzc, dtype=torch.float64, device=device)
    base = torch.polar(torch.ones_like(m), -math.pi * q * m * (m + 1) / nzc)
    n = torch.arange(used, device=device)
    r = base[n % nzc]
    shifts = torch.tensor(d["cyclic_shifts"], dtype=torch.float64,
                          device=device)
    ramp = torch.polar(torch.ones(len(shifts), used, dtype=torch.float64,
                                  device=device),
                       2 * math.pi * shifts[:, None] / 12 * n.double())
    cover = torch.tensor(d["cover_codes"], dtype=torch.float64,
                         device=device)
    return (ramp * r)[:, None, :] * cover[..., None]


def perkey_counts(cfg: Dict, num_symbols: int, seed: int, snr_db: float,
                  attempts: torch.Tensor, block: int = 16) -> torch.Tensor:
    """(n,) int64 bit errors of the 1-D int64 ``attempts``, one subframe
    each of ``num_symbols`` data REs a layer, summed over the layers;
    computed on ``attempts``' device in blocks of ``block`` attempts."""
    return torch.cat([
        subframes(cfg, num_symbols, seed, snr_db, attempts[r0:r0 + block])
        ["bit_errors"] for r0 in range(0, attempts.shape[0], block)])


def subframes(cfg: Dict, num_symbols: int, seed: int, snr_db: float,
              att: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The attempts' subframes through the chain: ``estimate`` (n, Nr, Nt,
    used), ``equalized`` (n, Nt, data symbols, used) ``W y``,
    ``symbols`` the de-spread unbiased ones, ``bit_errors`` (n,)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _block(cfg, num_symbols, int(seed), float(snr_db), att)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _block(cfg: Dict, num_symbols: int, seed: int, snr_db: float,
           att: torch.Tensor) -> Dict[str, torch.Tensor]:
    if cfg["detector"] != "mmse":
        raise ValueError(f"the reference equalizes by MMSE, not "
                         f"{cfg['detector']!r}")
    geo = Geometry.from_config(cfg)
    nt, nr = int(cfg["num_tx"]), int(cfg["num_rx"])
    dev = att.device
    n = att.shape[0]
    T, L, K, spb, D = geo.taps, geo.rays, geo.used, geo.spb, geo.span
    ns = int(cfg["ofdm"]["symbols_per_subframe"])
    pilots = [int(s) for s in cfg["dmrs"]["symbols"]]
    data_syms = [s for s in range(ns) if s not in pilots]
    nd = len(data_syms)
    if num_symbols != nd * K:
        raise ValueError(f"a subframe has {nd * K} data REs a layer")
    s_data, s_channel, s_noise = philox.split_salts(seed, 0, 3)

    per_word = 32 // geo.bits_per_symbol
    words = philox.stream_words(seed, s_data, att,
                                nt * num_symbols // per_word)
    shifts = torch.arange(per_word, dtype=torch.int64,
                          device=dev) * geo.bits_per_symbol
    sym = ((words[..., None] >> shifts) & (geo.M - 1)).reshape(
        n, nt, nd, K)

    # Jakes: a state a (tap, rx, tx), evaluated at each symbol's start
    u = philox.words_to_uniform(philox.stream_words(
        seed, s_channel, att, 2 * L * T * nr * nt)).reshape(n, 2, L, T, nr,
                                                            nt)
    phi, psi = u[:, 0] * (2 * math.pi), u[:, 1] * (2 * math.pi)
    tb = torch.arange(ns, dtype=torch.float64, device=dev) * (spb * geo.ts)
    ph = (2 * math.pi * geo.doppler_hz * torch.cos(phi))[..., None] * tb + \
        psi[..., None]                              # (n, L, T, Nr, Nt, ns)
    gain = torch.tensor((geo.powers / L) ** 0.5, device=dev)
    h = torch.polar(torch.ones_like(ph), ph).sum(1) * \
        gain[:, None, None, None]                   # (n, T, Nr, Nt, ns)

    noise_len = ns * spb + D - 1
    m = 2 * nr * noise_len
    z = philox.words_to_normal(philox.stream_words(
        seed, s_noise, att, m + (m & 1)))[:, :m].reshape(n, 2, nr, noise_len)
    noise = torch.complex(z[:, 0], z[:, 1]) * math.sqrt(0.5)

    # the subframe's grid: spread data and the pilots, precoded
    pilot = dmrs(cfg, dev)                                # (Nt, slots, K)
    grid = torch.zeros((n, nt, ns, K), dtype=torch.complex128, device=dev)
    grid[:, :, data_syms] = torch.fft.fft(_qam(geo, sym), norm="ortho")
    grid[:, :, pilots] = pilot
    grid = grid / math.sqrt(nt)

    # OFDM with cyclic prefix, each transmit antenna
    scale = math.sqrt(geo.fft ** 2 / (K + geo.cp))
    bins = torch.as_tensor(geo.used_bins(), device=dev)
    spectrum = torch.zeros((n, nt, ns, geo.fft), dtype=torch.complex128,
                           device=dev)
    spectrum[..., bins] = grid
    td = torch.fft.ifft(spectrum) * scale
    td = torch.cat([td[..., -geo.cp:], td], dim=-1)      # (n, Nt, ns, spb)

    # the sparse FIR of each link, one symbol at a time, summed over the
    # transmit antennas, then overlap-added
    yb = torch.zeros((n, nr, ns, spb + D - 1), dtype=torch.complex128,
                     device=dev)
    for t, d in enumerate(geo.delays):
        yb[..., d:d + spb] += torch.einsum("nrsb,nsbk->nrbk", h[:, t], td)
    rx = torch.zeros((n, nr, noise_len), dtype=torch.complex128, device=dev)
    for b in range(ns):
        rx[..., b * spb:b * spb + spb + D - 1] += yb[:, :, b]
    rx = rx + noise * math.sqrt(1.0 / _snr_linear(snr_db))
    r = rx[..., :ns * spb].reshape(n, nr, ns, spb)[..., geo.cp:]
    y = (torch.fft.fft(r) / scale)[..., bins]            # (n, Nr, ns, K)

    # the estimate: each layer's cover code over the slots, its sequence
    # (the first slot's with its sign), delays 0..taps_to_keep
    keep = int(cfg["dmrs"]["taps_to_keep"])
    cover = torch.tensor(cfg["dmrs"]["cover_codes"], dtype=torch.float64,
                         device=dev)                      # (Nt, slots)
    ref = pilot[:, 0] * cover[:, :1]                      # (Nt, K)
    decoded = (y[:, :, None, pilots] * cover[:, :, None]).mean(dim=-2)
    delays = torch.fft.ifft(decoded * ref.conj())         # (n, Nr, Nt, K)
    est = torch.fft.fft(delays[..., :keep + 1], n=K)

    # MMSE on each subcarrier, x = W y on each data symbol
    s2 = (K + geo.cp) / (geo.fft * _snr_linear(snr_db))
    hk = est.permute(0, 3, 1, 2)                          # (n, K, Nr, Nt)
    hh = hk.mH
    eye = torch.eye(nt, dtype=torch.complex128, device=dev)
    w = torch.linalg.solve(hh @ hk + s2 * eye, hh)        # (n, K, Nt, Nr)
    mu = torch.diagonal(w @ hk, dim1=-2, dim2=-1).real.mean(dim=1)
    yd = y[:, :, data_syms].permute(0, 3, 1, 2)           # (n, K, Nr, nd)
    x = (w @ yd).permute(0, 2, 3, 1)                      # (n, Nt, nd, K)
    symbols = torch.fft.ifft(x, norm="ortho") / mu[:, :, None, None]
    decided = _decide(geo, symbols)
    return {"estimate": est, "equalized": x, "symbols": symbols,
            "bit_errors": _bit_errors(sym, decided, (1, 2, 3))}

