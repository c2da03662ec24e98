"""The uplink's spatially multiplexed PUSCH as a per-key step: Nt layers of
QAM, each spread by SC-FDMA's transform precoding, with each layer's DMRS
in the pilot symbols -> the identity precoder over Nt antennas ->
per-antenna OFDM -> Nr x Nt TDL (Jakes, the channel held over each
SC-FDMA symbol) -> AWGN on each receive antenna -> per-antenna OFDM
demodulation -> the DMRS channel estimate (cyclic shift and orthogonal
cover code) -> per-subcarrier linear MMSE on the estimate -> de-spreading
-> per-layer unbiasing -> hard decisions -> bit-error count.

3GPP TS 36.211 §5.3.3 (transform precoding), §5.3.3A (precoding for
spatial multiplexing: at rank Nt = Nr the codebook's identity
``I / sqrt(Nt)``), §5.5.2.1 (the PUSCH DMRS: layer ``l``'s sequence is the
root sequence with its cyclic shift, times its cover code's entry in each
slot) and §5.5.2.1.2 (the DMRS in symbol 3 of each slot). The step is
:class:`~pyphysim_tpu_torch.mimo_chain.MimoChainStep` with another
transmitter and receiver around the same draws, OFDM, channel and noise
(``MimoChainStep._transmit``), so it keeps that step's contract: three
sub-streams, attempt ``a``'s counts from (seed, unpack index, a) alone, and
on a CUDA device one replay of the step's captured graph a call.

Per attempt (one subframe of ``symbols_per_subframe`` SC-FDMA symbols of
``num_used`` subcarriers, ``num_symbols`` data REs a layer):

  * ``data`` (Nt, num_symbols) indices from the data sub-stream; QAM, then
    for each layer and data symbol the orthonormal DFT over its
    ``num_used`` symbols, ``z[k] = sum_i x[i] exp(-2 pi j i k / M) /
    sqrt(M)``;
  * layer ``l``'s DMRS in the symbols ``dmrs_symbols``:
    ``reference_signals.DmrsUeSequence(RootSequence(root_index,
    num_used), cyclic_shifts[l], cover_codes[l])``, slot ``s``'s row in
    pilot symbol ``s``;
  * the identity precoder, ``1 / sqrt(Nt)`` (the split of
    ``MimoChainStep``), data and pilots alike, then ``_transmit``;
  * the estimate: the pilot symbols of each receive antenna through
    :class:`~pyphysim_tpu_torch.reference_signals.LayeredOCCChannelEstimator`
    (each layer's cover code decoded over the slots, its sequence's
    conjugate, an IFFT, the delays ``0..taps_to_keep`` kept, an FFT):
    ``H`` (Nr, Nt, num_used), the layers' channel with the precoder, one a
    subframe, held over its data symbols;
  * ``ops/mimo_detect.py`` :func:`sc_mmse_eq`: per subcarrier ``W = (H^H H
    + s2 I)^-1 H^H`` and ``x = W y`` on each data symbol, with the gains
    ``Re (W H)[l][l]``; ``s2`` is ``MimoChainStep``'s noise variance;
  * per layer and data symbol the orthonormal IDFT of ``x``; then
    ``ops/mimo_detect.py`` :func:`sc_decide`: each layer's symbols divided
    by ``mu_l``, the mean of its gains over the subcarriers (the unbiased
    MMSE), QAM hard decisions, and the bit errors against ``data``, summed
    over the layers and REs.

Under ``torch.profiler`` the eager step records the spans ``chain.estimate``
(the estimator) and ``chain.equalize`` (the equalizer, the de-spreading,
the unbiasing, the decisions and the count) inside its ``chain.forward``.

``signal_dtype=torch.bfloat16`` rounds where ``MimoChainStep`` does: the
antennas' symbols after the precoder, the OFDM modulate and demodulate
outputs, the channel output, the noise, its scaled value and the noisy
sum; the estimate, the equalizer and the de-spreading stay float32.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ._device import DeviceLike
from .chain import ReplayedStep
from .channels import TdlChannel
from .mimo_chain import MimoChainStep
from .ops.mimo_detect import sc_decide, sc_mmse_eq
from .ops.qam import qam_map
from .reference_signals import (DmrsUeSequence, LayeredOCCChannelEstimator,
                                RootSequence)
from .tracing import span

__all__ = ["PuschChainOutput", "PuschChainStep"]


class PuschChainOutput(NamedTuple):
    """Per-attempt results of one step (leading dimension = attempts)."""
    bit_errors: torch.Tensor   # (n,) int64, summed over layers and REs
    received: torch.Tensor     # (n, Nr, NS * K) complex64, demodulated
    estimate: torch.Tensor     # (n, Nr, Nt, K) complex64, the DMRS estimate
    equalized: torch.Tensor    # (n, Nt, ND, K) complex64, W y
    symbols: torch.Tensor      # (n, Nt, ND, K) complex64, de-spread


class PuschChainStep(MimoChainStep):
    """``num_layers`` layers of ``M``-QAM over ``num_layers`` x
    ``num_rx`` antennas, one subframe an attempt: ``symbols_per_subframe``
    SC-FDMA symbols of ``num_used`` subcarriers, the DMRS in
    ``dmrs_symbols`` and data in the others (``num_symbols`` data REs a
    layer), through ``channel`` (made MIMO with ``set_num_antennas(num_rx,
    num_layers)``). ``root_index``, ``cyclic_shifts`` (one a layer, in
    twelfths of a turn) and ``cover_codes`` (a row of ``len(dmrs_symbols)``
    signs a layer) make the DMRS; the estimator keeps the delays
    ``0..taps_to_keep``. ``signal_dtype`` as ``MimoChainStep``'s."""

    counted_kernels = ReplayedStep.counted_kernels + (sc_mmse_eq, sc_decide,
                                                      qam_map)

    def __init__(self, num_layers: int, num_rx: int, M: int,
                 num_symbols: int, fft_size: int, cp_size: int,
                 num_used: int, channel: TdlChannel, root_index: int,
                 cyclic_shifts: Sequence[int],
                 cover_codes: Sequence[Sequence[int]],
                 dmrs_symbols: Sequence[int] = (3, 10),
                 symbols_per_subframe: int = 14, taps_to_keep: int = 100,
                 signal_dtype=None, device: DeviceLike = "cuda") -> None:
        super().__init__(num_layers, num_rx, M, num_symbols, fft_size,
                         cp_size, num_used, channel,
                         signal_dtype=signal_dtype, device=device)
        pilots = sorted(int(s) for s in dmrs_symbols)
        ns = int(symbols_per_subframe)
        if len(set(pilots)) != len(pilots) or pilots[0] < 0 or \
                pilots[-1] >= ns:
            raise ValueError(f"dmrs_symbols {dmrs_symbols} must be distinct "
                             f"symbols of the {ns}")
        if num_symbols != (ns - len(pilots)) * num_used:
            raise ValueError(f"num_symbols must be the subframe's data REs "
                             f"a layer, {(ns - len(pilots)) * num_used}")
        if len(cyclic_shifts) != num_layers or len(cover_codes) != \
                num_layers or any(len(c) != len(pilots) for c in cover_codes):
            raise ValueError("one cyclic shift and one cover code (a sign a "
                             "pilot symbol) a layer")
        if not 0 <= taps_to_keep < num_used:
            raise ValueError("taps_to_keep must lie in [0, num_used)")
        self.symbols_per_subframe = ns
        self.dmrs_symbols = tuple(pilots)
        self.data_symbols = tuple(s for s in range(ns) if s not in pilots)
        self.taps_to_keep = int(taps_to_keep)
        root = RootSequence(int(root_index), num_used)
        seqs = [DmrsUeSequence(root, int(c), np.asarray(cc))
                for c, cc in zip(cyclic_shifts, cover_codes)]
        self.estimator = LayeredOCCChannelEstimator(seqs)
        # the pilots as sent, (Nt, pilots, K), and where each of the
        # subframe's symbols comes from in [data symbols, pilots]
        self._dmrs = torch.as_tensor(
            np.stack([s.seq_array() for s in seqs]).astype(np.complex64),
            device=self.device)
        source = {s: i for i, s in enumerate(self.data_symbols + tuple(
            pilots))}
        self._order = torch.tensor([source[s] for s in range(ns)],
                                   dtype=torch.int64, device=self.device)
        self._pilot_index = torch.tensor(pilots, dtype=torch.int64,
                                         device=self.device)

    @property
    def num_ofdm_symbols(self) -> int:
        return self.symbols_per_subframe

    def forward_scaled(self, data: torch.Tensor, channel_state,
                       noise: torch.Tensor,
                       amp: torch.Tensor) -> PuschChainOutput:
        """``forward`` with the noise amplitude as a float32 0-dim tensor
        (``MimoChainStep.forward_scaled``'s contract)."""
        n, nr, nt = data.shape[0], self.num_rx, self.num_tx
        K, ns = self.ofdm.num_used_subcarriers, self.symbols_per_subframe
        nd = len(self.data_symbols)
        spread = torch.fft.fft(self.qam.modulate(data).reshape(n, nt, nd, K),
                               norm="ortho")
        pilots = self._dmrs.expand(n, -1, -1, -1)
        grid = torch.cat([spread, pilots], dim=2).index_select(2, self._order)
        tx = self._round(grid * self._split).reshape(n, nt, ns * K)
        rx, _ = self._transmit(tx, channel_state, noise, amp)
        frames = rx.reshape(n, nr, ns, K)
        with span("chain.estimate"):
            h = self.estimator.estimate_channel_freq_domain(
                frames.index_select(2, self._pilot_index), self.taps_to_keep)
        with span("chain.equalize"):
            x, gain = sc_mmse_eq(h, frames, amp * amp * self._var_scale,
                                 self.data_symbols)
            symbols = torch.fft.ifft(x, norm="ortho")
            errors = sc_decide(symbols, gain.mean(dim=-1), data, self.qam.M)
        return PuschChainOutput(errors, rx, h, x, symbols)
