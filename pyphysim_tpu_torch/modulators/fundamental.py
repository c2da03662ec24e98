"""Fundamental digital modulators: M-PSK, M-QAM, BPSK, QPSK.

Counterpart of ``pyphysim_tpu/modulators/fundamental.py``, with the same
constellations and Gray mappings. A modulator holds its constellation
table twice: as numpy complex128 on the host (exact) and as a complex64
tensor on its device. ``modulate`` maps integer tensors of any shape
(leading batch dimensions included) to complex64 points; ``demodulate`` is
the nearest-neighbour decision; ``QAM.demodulate_hard`` the per-axis
slicer, which gives the same decisions at O(1) cost per symbol.

Numpy input gives numpy output through the float64 table (host
convenience, as in the JAX package); tensor input stays on its device.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch

from .._device import DeviceLike, require_cuda
from ..utils.conversion import binary2gray, dB2Linear, gray2binary
from ..utils.misc import level2bits, qfunc

__all__ = ["Modulator", "PSK", "QPSK", "BPSK", "QAM"]

NumberOrArray = Union[float, np.ndarray]


class Modulator:
    """Base modulator defined by a constellation table."""

    def __init__(self, constellation: Optional[np.ndarray] = None,
                 device: DeviceLike = "cuda") -> None:
        self.device = require_cuda(device)
        self._constellation: Optional[np.ndarray] = None
        self._table: Optional[torch.Tensor] = None
        self._M = 0
        self._K = 0
        if constellation is not None:
            self.setConstellation(constellation)

    def setConstellation(self, symbols: np.ndarray) -> None:
        """Install a constellation table (size must be a power of two)."""
        symbols = np.asarray(symbols, dtype=np.complex128)
        self._M = symbols.size
        self._K = level2bits(self._M)
        self._constellation = symbols
        self._table = torch.tensor(symbols.astype(np.complex64),
                                   device=self.device)

    def plotConstellation(self) -> None:  # pragma: no cover
        """Scatter-plot the constellation with each point's binary and
        decimal label (matplotlib, imported here: nothing else needs
        it)."""
        import matplotlib.pyplot as plt
        _, ax = plt.subplots()
        ax.scatter(self.symbols.real, self.symbols.imag)
        ax.axis("equal")
        ax.grid()
        for index, symbol in enumerate(self.symbols):
            ax.text(symbol.real, symbol.imag + 0.03,
                    f"{index:0{self._K}b} ({index})",
                    verticalalignment="bottom",
                    horizontalalignment="center")
        plt.show()

    @property
    def M(self) -> int:
        """Constellation cardinality."""
        return self._M

    @property
    def K(self) -> int:
        """Bits per symbol (log2 M)."""
        return self._K

    @property
    def symbols(self) -> np.ndarray:
        """The (host-side) constellation table."""
        return self._constellation

    @property
    def name(self) -> str:
        return f"{self.__class__.__name__.split('.')[-1]}-{self._M}"

    def __repr__(self) -> str:
        return f"{self.name} object"

    def modulate(self, input_data):
        """Map integer symbols in [0, M) to constellation points: a gather
        from the table (numpy in, numpy out; a tensor stays on its
        device)."""
        if isinstance(input_data, (np.ndarray, int)):
            idx = np.asarray(input_data)
            if idx.size and (idx.max() >= self._M or idx.min() < 0):
                raise ValueError(
                    f"Input data must be between 0 and {self._M - 1}")
            return self._constellation[idx]
        return self._table.to(input_data.device)[input_data.long()]

    def demodulate(self, received_data):
        """Nearest-neighbour hard decision ``argmin_k |rx - c_k|`` over
        every leading dimension."""
        if isinstance(received_data, np.ndarray):
            d = np.abs(received_data[..., None] -
                       self._constellation[None, :])
            return np.argmin(d, axis=-1)
        table = self._table.to(received_data.device)
        d = received_data[..., None] - table
        metric = d.real * d.real + d.imag * d.imag
        return torch.argmin(metric, dim=-1)

    # -- theoretical curves ------------------------------------------------

    def calcTheoreticalSER(self, SNR: NumberOrArray) -> NumberOrArray:
        raise NotImplementedError

    def calcTheoreticalBER(self, SNR: NumberOrArray) -> NumberOrArray:
        raise NotImplementedError

    def calcTheoreticalPER(self, SNR: NumberOrArray,
                           packet_length: int) -> NumberOrArray:
        """Theoretical packet error rate ``1 - (1 - BER)^L``."""
        ber = self.calcTheoreticalBER(SNR)
        return 1.0 - (1.0 - ber) ** packet_length

    def calcTheoreticalSpectralEfficiency(
            self, SNR: NumberOrArray,
            packet_length: Optional[int] = None) -> NumberOrArray:
        """``K * (1 - PER)`` bits per symbol; ``K * (1 - BER)`` without a
        packet length."""
        if packet_length is None:
            return self._K * (1.0 - self.calcTheoreticalBER(SNR))
        return self._K * (1.0 - self.calcTheoreticalPER(SNR, packet_length))


class PSK(Modulator):
    """Gray-mapped M-PSK on the unit circle."""

    def __init__(self, M: int, phaseOffset: float = 0.0,
                 device: DeviceLike = "cuda") -> None:
        super().__init__(device=device)
        if 2 ** round(math.log2(M)) != M:
            raise ValueError("M must be a power of 2")
        self._phase_offset = phaseOffset
        symbols = self._createConstellation(M, phaseOffset)
        # index i sits at angular position gray2binary(i): neighbours
        # differ in one bit
        self.setConstellation(symbols[gray2binary(np.arange(M))])

    @staticmethod
    def _createConstellation(M: int, phaseOffset: float) -> np.ndarray:
        phases = 2.0 * np.pi / M * np.arange(M) + phaseOffset
        re = np.cos(phases)
        im = np.sin(phases)
        re[np.abs(re) < 1e-15] = 0.0
        im[np.abs(im) < 1e-15] = 0.0
        return re + 1j * im

    def setPhaseOffset(self, phaseOffset: float) -> None:
        """Rotate the constellation: rebuild the Gray-mapped table (host
        and device) with the new offset."""
        self._phase_offset = phaseOffset
        symbols = self._createConstellation(self._M, phaseOffset)
        self.setConstellation(symbols[gray2binary(np.arange(self._M))])

    def calcTheoreticalSER(self, SNR):
        """High-SNR approximation ``2 Q(sqrt(2 snr) sin(pi/M))``."""
        snr = dB2Linear(SNR)
        return 2.0 * qfunc(_sqrt(2.0 * snr) * math.sin(np.pi / self._M))

    def calcTheoreticalBER(self, SNR):
        """Gray-coding approximation ``SER / K``."""
        return self.calcTheoreticalSER(SNR) / level2bits(self._M)


class QPSK(PSK):
    """4-PSK with a pi/4 offset."""

    def __init__(self, device: DeviceLike = "cuda") -> None:
        super().__init__(4, np.pi / 4.0, device=device)

    @property
    def name(self) -> str:
        return "QPSK"


class BPSK(Modulator):
    """Binary PSK: bit 0 -> +1, bit 1 -> -1."""

    def __init__(self, device: DeviceLike = "cuda") -> None:
        super().__init__(np.array([1.0 + 0j, -1.0 + 0j]), device=device)

    @property
    def name(self) -> str:
        return "BPSK"

    def demodulate(self, received_data):
        """Threshold on the real part."""
        if isinstance(received_data, np.ndarray):
            return (received_data.real < 0).astype(np.int64)
        return (received_data.real < 0).long()

    def calcTheoreticalSER(self, SNR):
        """``Q(sqrt(2 snr))`` exactly."""
        return qfunc(_sqrt(2.0 * dB2Linear(SNR)))

    def calcTheoreticalBER(self, SNR):
        return self.calcTheoreticalSER(SNR)


class QAM(Modulator):
    """Square Gray-mapped M-QAM normalized to unit average energy.

    The point of index ``(r << h) | c`` (``h`` = half the bits) sits at
    grid position ``(gray(r), gray(c))``: real part increasing left to
    right, imaginary part decreasing top to bottom.

    >>> import numpy as np
    >>> qam = QAM(16, device="cpu")
    >>> qam.modulate(np.array([0]))
    array([-0.9486833+0.9486833j])
    >>> qam.demodulate(qam.modulate(np.array([0, 5, 10])))
    array([ 0,  5, 10])
    """

    def __init__(self, M: int, device: DeviceLike = "cuda") -> None:
        super().__init__(device=device)
        power = math.log2(M)
        if power != int(power) or int(power) % 2 != 0:
            raise ValueError("M must be a square power of 2")
        L = int(round(math.sqrt(M)))
        self._L = L
        symbols = self._createConstellation(M)
        self.setConstellation(symbols[self._calculateGrayMappingIndexQAM(L)])
        self._scale = math.sqrt((M - 1) * 2.0 / 3.0)

    @staticmethod
    def _createConstellation(M: int) -> np.ndarray:
        L = int(round(math.sqrt(M)))
        jj, ii = np.meshgrid(np.arange(L), np.arange(L))
        symbols = (-(L - 1) + jj * 2) + 1j * ((L - 1) - ii * 2)
        return (symbols / math.sqrt((M - 1) * 2.0 / 3.0)).reshape(M)

    @staticmethod
    def _calculateGrayMappingIndexQAM(L: int) -> np.ndarray:
        col = binary2gray(np.arange(L))
        row = col.reshape(L, 1)
        half_bits = level2bits(L * L) // 2
        return ((row << half_bits) + col[None, :]).reshape(L * L)

    def modulate(self, input_data):
        """Arithmetic QAM mapping for tensors (no table): the I/Q levels
        come from the Gray codes of the index's column and row bits."""
        if isinstance(input_data, (np.ndarray, int)):
            return Modulator.modulate(self, input_data)
        L = self._L
        half_bits = level2bits(L * L) // 2
        col = input_data & (L - 1)
        row = input_data >> half_bits
        jj = col ^ (col >> 1)
        ii = row ^ (row >> 1)
        inv_scale = 1.0 / self._scale
        re = (2 * jj - (L - 1)).to(torch.float32) * inv_scale
        im = ((L - 1) - 2 * ii).to(torch.float32) * inv_scale
        return torch.complex(re, im)

    def demodulate_hard(self, received_data: torch.Tensor) -> torch.Tensor:
        """O(1)-per-symbol slicer: round I and Q to the nearest PAM level
        (clipped), then rebuild the Gray-mapped index. The same decisions
        as the nearest-neighbour search (rectangular regions)."""
        L = self._L
        half_bits = level2bits(L * L) // 2
        col_pos = torch.clamp(torch.round(
            (received_data.real * self._scale + (L - 1)) / 2.0),
            0, L - 1).to(torch.int64)
        row_pos = torch.clamp(torch.round(
            ((L - 1) - received_data.imag * self._scale) / 2.0),
            0, L - 1).to(torch.int64)
        return (_inv_gray(row_pos) << half_bits) | _inv_gray(col_pos)

    def _calcTheoreticalSingleCarrierErrorRate(self, SNR):
        snr = dB2Linear(SNR)
        return (2.0 * (1.0 - 1.0 / math.sqrt(self._M)) *
                qfunc(_sqrt(snr * 3.0 / (self._M - 1.0))))

    def calcTheoreticalSER(self, SNR):
        """``1 - (1 - Psc)^2`` with the per-carrier error rate Psc."""
        Psc = self._calcTheoreticalSingleCarrierErrorRate(SNR)
        return 1.0 - (1.0 - Psc) ** 2

    def calcTheoreticalBER(self, SNR):
        """Gray-coding approximation ``2 Psc / K``."""
        return (2.0 * self._calcTheoreticalSingleCarrierErrorRate(SNR) /
                level2bits(self._M))


def _inv_gray(p: torch.Tensor) -> torch.Tensor:
    """Inverse Gray code by xor-prefix, exact below 8 bits."""
    out = p
    sh = 1
    while sh < 8:
        out = out ^ (out >> sh)
        sh *= 2
    return out


def _sqrt(x):
    """Square root of a host number / array or of a tensor (on its
    device), for the theoretical curves."""
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else np.sqrt(x)
