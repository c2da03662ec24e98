"""The plain reference of the flagship chain: 16-QAM -> OFDM -> TDL with
Jakes fading, the channel held over each OFDM symbol -> AWGN -> one-tap
equalizer -> hard decisions -> bit errors, per attempt.

Written from the chain's equations in plain PyTorch, in float64 (complex128)
wherever the program computes in float32, on the random variates the stream
layouts of :mod:`.philox` define (uniforms and the noise's inverse-CDF input
are float32 values there, and are taken as such). It imports nothing of the
program and takes nothing the program made: the profile, G and every
constant come from the configuration's file.

Two forms of one chain, as the program runs it:

  * :func:`bulk_counts`, the Monte Carlo kernel's form: the ray sum and the
    sparse tap DFT are one product per OFDM symbol and bin, and the
    time-domain noise is its post-demodulation equivalent scaled by
    ``sqrt((used + cp) / fft)`` (exact for a CP that covers the channel's
    span). The arithmetic follows the plain version of the kernel,
    ``pyphysim_tpu_torch/ops/mc_kernel.py:165-193, 296-403`` at commit
    8958300, with E computed directly instead of by row doubling.
  * :func:`perkey_counts`, the per-key chain: time-domain OFDM with cyclic
    prefix, the block-static sparse FIR with overlap-add, FFT demodulation
    and the equalizer on the taps' DFT, as ``pyphysim_tpu_torch/chain.py:
    111-153``, ``channels/fading.py:463-485, 635-680``,
    ``modulators/ofdm.py:95-176`` and ``utils/misc.py:87-144`` at commit
    8958300 compute it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from . import philox
from .profiles import discretize, raw_profile

_F32_CLAMP = 0.99999994       # the inverse CDF's input clamp (float32)


@dataclass
class Geometry:
    """The chain's constants, worked out from a configuration's file."""
    M: int
    fft: int
    cp: int
    used: int
    delays: np.ndarray          # tap delays in samples
    powers: np.ndarray          # linear, summing to 1
    rays: int
    doppler_hz: float
    ts: float

    @classmethod
    def from_config(cls, cfg: Dict) -> "Geometry":
        ts = 1.0 / float(cfg["bandwidth_hz"])
        delays, powers = discretize(*raw_profile(cfg["channel"]), ts)
        o = cfg["ofdm"]
        return cls(int(cfg["modulation"]["M"]), int(o["fft_size"]),
                   int(o["cp_size"]), int(o["num_used"]), delays, powers,
                   int(cfg["jakes_rays"]), float(cfg["doppler_hz"]), ts)

    @property
    def taps(self) -> int:
        return int(self.delays.size)

    @property
    def span(self) -> int:
        return int(self.delays[-1]) + 1

    @property
    def bits_per_symbol(self) -> int:
        return int(round(math.log2(self.M)))

    @property
    def spb(self) -> int:
        return self.fft + self.cp

    def used_bins(self) -> np.ndarray:
        """FFT bins of the used subcarriers in data order: the negative
        frequencies first, then the positive ones, DC skipped."""
        half = self.used // 2
        return np.hstack([np.arange(self.fft - half, self.fft),
                          np.arange(1, half + 1)])

    def tap_dft(self, device) -> torch.Tensor:
        """(T, used) complex128: exp(-2 pi j d_t b_k / fft)."""
        phase = (-2.0 * np.pi / self.fft) * np.outer(self.delays,
                                                     self.used_bins())
        return torch.tensor(np.exp(1j * phase), device=device)


def _gray_inverse(p: torch.Tensor) -> torch.Tensor:
    out, sh = p, 1
    while sh < 8:
        out = out ^ (out >> sh)
        sh *= 2
    return out


def _qam(geo: Geometry, idx: torch.Tensor) -> torch.Tensor:
    """Square Gray-mapped QAM of unit mean energy: index ``(r << h) | c``
    at grid position (gray(c), gray(r)), real part rising with the column,
    imaginary part falling with the row."""
    lq = int(round(math.sqrt(geo.M)))
    half = geo.bits_per_symbol // 2
    col, row = idx & (lq - 1), idx >> half
    scale = math.sqrt((geo.M - 1) * 2.0 / 3.0)
    re = (2 * (col ^ (col >> 1)) - (lq - 1)).to(torch.float64) / scale
    im = ((lq - 1) - 2 * (row ^ (row >> 1))).to(torch.float64) / scale
    return torch.complex(re, im)


def _decide(geo: Geometry, eq: torch.Tensor) -> torch.Tensor:
    """The nearest constellation point's index (the per-axis slicer)."""
    lq = int(round(math.sqrt(geo.M)))
    half = geo.bits_per_symbol // 2
    scale = math.sqrt((geo.M - 1) * 2.0 / 3.0)
    col = torch.clamp(torch.floor((eq.real * scale + (lq - 1)) * 0.5 + 0.5),
                      0, lq - 1).to(torch.int64)
    row = torch.clamp(torch.floor(((lq - 1) - eq.imag * scale) * 0.5 + 0.5),
                      0, lq - 1).to(torch.int64)
    return (_gray_inverse(row) << half) | _gray_inverse(col)


def _bit_errors(a: torch.Tensor, b: torch.Tensor, dims) -> torch.Tensor:
    diff = (a.to(torch.int64) ^ b.to(torch.int64))
    errs = torch.zeros_like(diff)
    for k in range(8):
        errs += (diff >> k) & 1
    return errs.sum(dim=dims)


def _snr_linear(snr_db: float) -> float:
    return 10.0 ** (float(snr_db) / 10.0)


# -- the Monte Carlo kernel's form -------------------------------------------

def bulk_counts(cfg: Dict, tile: int, num_tiles: int, seed: int,
                snr_db: float, start: int, n: int, device,
                max_elements: int = 1 << 25) -> torch.Tensor:
    """(n,) int64 bit errors of attempts ``[start, start + n)``, each
    ``num_tiles * tile`` OFDM symbols sharing one set of Jakes rays, from
    the stream seed ``seed``. Computed in blocks of attempts of at most
    ``max_elements`` (symbol, tap-ray pair) phases."""
    geo = Geometry.from_config(cfg)
    S = num_tiles * tile
    block = max(1, min(n, max_elements // (S * geo.taps * geo.rays)))
    out = []
    for r0 in range(0, n, block):
        att = torch.arange(start + r0, start + min(n, r0 + block),
                           dtype=torch.int64, device=device)
        out.append(_bulk_block(geo, att, tile, num_tiles, int(seed),
                               float(snr_db)))
    return torch.cat(out)


def _bulk_block(geo: Geometry, att: torch.Tensor, tile: int,
                num_tiles: int, seed: int, snr_db: float) -> torch.Tensor:
    dev = att.device
    T, L, used = geo.taps, geo.rays, geo.used
    S = num_tiles * tile
    pb = philox.phase_stream_bits(seed, att, T * L)
    # the stream layout's uniforms are float32 values: signed bits scaled
    u_phi = pb[:, 0].to(torch.float32) * 2.0 ** -32 + 0.5
    u_psi = pb[:, 1].to(torch.float32) * 2.0 ** -32 + 0.5
    phi = u_phi.double() * (2 * math.pi)                     # (b, TL)
    psi = u_psi.double() * (2 * math.pi)
    c = 2 * math.pi * geo.doppler_hz * geo.ts * geo.spb      # rad a symbol
    w = c * torch.cos(phi)
    s = torch.arange(S, dtype=torch.float64, device=dev)
    phase = s[None, :, None] * w[:, None, :] + psi[:, None, :]  # (b, S, TL)
    e = torch.polar(torch.ones_like(phase), phase)
    h_tap = e.reshape(att.shape[0], S, T, L).sum(-1)          # (b, S, T)
    del phase, e
    gain = torch.tensor(np.sqrt(geo.powers / L), device=dev)
    g = gain[:, None] * geo.tap_dft(dev)                      # (T, used)
    h = h_tap @ g                                             # (b, S, used)

    db, n1, n2 = philox.symbol_stream_bits(seed, att, num_tiles, tile, used)
    idx = (db & (geo.M - 1)).to(torch.int64)
    x = _qam(geo, idx)
    z = [torch.clamp(b.to(torch.float32) * 2.0 ** -31, -_F32_CLAMP,
                     _F32_CLAMP).double() for b in (n1, n2)]
    noise = torch.complex(torch.erfinv(z[0]), torch.erfinv(z[1])) * \
        math.sqrt(2.0)
    noise_gain = math.sqrt((used + geo.cp) / geo.fft)
    amp = math.sqrt(0.5 / _snr_linear(snr_db)) * noise_gain
    y = x * h + amp * noise
    decided = _decide(geo, y / h)
    return _bit_errors(idx, decided, (1, 2))


# -- the per-key chain ---------------------------------------------------------

def perkey_counts(cfg: Dict, num_symbols: int, seed: int, snr_db: float,
                  attempts: torch.Tensor, block: int = 64) -> torch.Tensor:
    """(n,) int64 bit errors of the 1-D int64 ``attempts`` through the
    per-key chain of ``num_symbols`` 16-QAM symbols an attempt (a whole
    number of OFDM symbols), the channel held over each OFDM symbol;
    computed on ``attempts``' device in blocks of ``block`` attempts."""
    geo = Geometry.from_config(cfg)
    return torch.cat([_perkey_block(geo, num_symbols, int(seed),
                                    float(snr_db), attempts[r0:r0 + block])
                      for r0 in range(0, attempts.shape[0], block)])


def _perkey_block(geo: Geometry, num_symbols: int, seed: int,
                  snr_db: float, att: torch.Tensor) -> torch.Tensor:
    dev = att.device
    n = att.shape[0]
    T, L, used, spb, D = geo.taps, geo.rays, geo.used, geo.spb, geo.span
    k = geo.bits_per_symbol
    n_ofdm = num_symbols // used
    s_data, s_channel, s_noise = philox.split_salts(seed, 0, 3)

    per_word = 32 // k
    words = philox.stream_words(seed, s_data, att, num_symbols // per_word)
    shifts = torch.arange(per_word, dtype=torch.int64, device=dev) * k
    sym = ((words[..., None] >> shifts) & (geo.M - 1)).reshape(n, -1)

    u = philox.words_to_uniform(philox.stream_words(
        seed, s_channel, att, 2 * L * T)).reshape(n, 2, L, T)
    phi, psi = u[:, 0] * (2 * math.pi), u[:, 1] * (2 * math.pi)
    tb = torch.arange(n_ofdm, dtype=torch.float64, device=dev) * (spb *
                                                                  geo.ts)
    ph = (2 * math.pi * geo.doppler_hz * torch.cos(phi))[..., None] * tb + \
        psi[..., None]                                     # (n, L, T, blocks)
    amp = torch.tensor(np.sqrt(geo.powers / L), device=dev)
    h = torch.polar(torch.ones_like(ph), ph).sum(1) * amp[:, None]

    noise_len = n_ofdm * spb + D - 1
    m = 2 * noise_len
    z = philox.words_to_normal(philox.stream_words(
        seed, s_noise, att, m + (m & 1)))[:, :m].reshape(n, 2, noise_len)
    noise = torch.complex(z[:, 0], z[:, 1]) * math.sqrt(0.5)

    scale = math.sqrt(geo.fft ** 2 / (used + geo.cp))   # the IFFT's power
    bins = torch.as_tensor(geo.used_bins(), device=dev)
    spectrum = torch.zeros((n, n_ofdm, geo.fft), dtype=torch.complex128,
                           device=dev)
    spectrum[..., bins] = _qam(geo, sym).reshape(n, n_ofdm, used)
    td = torch.fft.ifft(spectrum) * scale
    td = torch.cat([td[..., -geo.cp:], td], dim=-1)           # (n, b, spb)

    yb = torch.zeros((n, n_ofdm, spb + D - 1), dtype=torch.complex128,
                     device=dev)
    for t, d in enumerate(geo.delays):
        yb[..., d:d + spb] += h[:, t, :, None] * td
    rx = torch.zeros((n, noise_len), dtype=torch.complex128, device=dev)
    for b in range(n_ofdm):
        rx[:, b * spb:b * spb + spb + D - 1] += yb[:, b]
    rx = rx + noise * math.sqrt(1.0 / _snr_linear(snr_db))

    r = rx[:, :n_ofdm * spb].reshape(n, n_ofdm, spb)[..., geo.cp:]
    data = (torch.fft.fft(r) / scale)[..., bins]              # (n, b, used)
    hf = h.transpose(1, 2) @ geo.tap_dft(dev)                 # (n, b, used)
    decided = _decide(geo, data / hf).reshape(n, -1)
    return _bit_errors(sym, decided, (1,))
