#!/usr/bin/env python
"""Precoded SRS estimation of equivalent uplink channels, with SIC, on the
PyTorch port.

The counterpart of ``apps/simple_precoded_srs.py``: three UEs, each
precoding its sounding reference signal (distinct Zadoff-Chu roots, comb-2
pattern) toward its own access node over COST259 TDL channels (2 UE x 4 AN
antennas, Jakes with Fd = 0); every AN estimates the equivalent (precoded)
channel of ALL UEs by root correlation and delay-domain truncation
(``CazacBasedChannelEstimator``), and a successive interference
cancellation (SIC) pass re-estimates the cross channels after subtracting
the direct one. Reports the per-link estimation MSE and the SIC gain.

The nine links' impulse responses come from ONE batched ``TdlChannel``
call; the responses, the received signals and the estimates live on
``--device``. The UE precoders (the dominant left singular vector of a
2 x 4 block at one subcarrier) are computed on the host in numpy, as in
the JAX app, so the card and the CPU pick the same singular vector. As in
the JAX app, every link starts from the channel's seed-0 state unless the
caller passes the links' states.

Run: ``python apps/simple_precoded_srs_torch.py [--device cuda]``.
"""

import argparse
import sys

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pyphysim_tpu_torch._device import require_cuda  # noqa: E402
from pyphysim_tpu_torch.channels.fading import (COST259_TUx,  # noqa: E402
                                                TdlChannel)
from pyphysim_tpu_torch.channels.fading_generators import \
    JakesSampleGenerator  # noqa: E402
from pyphysim_tpu_torch.reference_signals.channel_estimation import \
    CazacBasedChannelEstimator  # noqa: E402
from pyphysim_tpu_torch.reference_signals.srs import get_srs_seq  # noqa: E402
from pyphysim_tpu_torch.reference_signals.zadoffchu import (  # noqa: E402
    calcBaseZC, get_extended_ZF)
from pyphysim_tpu_torch.utils.conversion import linear2dB  # noqa: E402
from pyphysim_tpu_torch.utils.misc import full_precision  # noqa: E402

K = 3
NUM_PRBS = 25
NSC = 12 * NUM_PRBS          # 300 subcarriers
NZC = 149
NUM_AN_ANT = 4
NUM_UE_ANT = 2
NUM_TAPS_TO_KEEP = 15        # delay-domain truncation window
SUBCARRIER_BAND = 15e3
TS = 1.0 / (NSC * SUBCARRIER_BAND)
FD = 0.0                     # static terminals, as the reference
L = 16
SHIFT_INDEX = 4
SC_IDX = 124                 # the subcarrier the precoders are taken at
PATHLOSS = np.array([[2.21e-08, 2.14e-09, 1.88e-08],
                     [3.45e-10, 2.17e-08, 4.53e-10],
                     [4.38e-10, 8.04e-10, 4.75e-08]])


def estimation_error_dB(H, Hest) -> float:
    H = np.asarray(H.cpu(), np.complex128)
    Hest = np.asarray(Hest.cpu(), np.complex128)
    return float(linear2dB(
        np.sum(np.abs(H - Hest) ** 2) / np.sum(np.abs(H) ** 2)))


def channel(device="cuda") -> TdlChannel:
    """The UE -> AN channel of every link (its generator on ``device``)."""
    jakes = JakesSampleGenerator(FD, TS, L, shape=(NUM_UE_ANT, NUM_AN_ANT),
                                 device=require_cuda(device))
    return TdlChannel(jakes, COST259_TUx)


def run(device="cuda", states=None):
    """Estimation MSEs (dB) of every link: ``{(an, ue): (plain, sic)}``.
    ``states``: the links' Jakes states, batch ``(K, K)`` ([an, ue]); None
    gives every link the channel's seed-0 state, as the JAX app."""
    ch = channel(device)
    dev = ch.device
    if states is None:
        one = ch.init_state(torch.Generator(device=dev).manual_seed(0))
        states = type(one)(*(v.expand((K, K) + v.shape) for v in one))
    ir, _ = ch.generate_impulse_response_f(states, 1)
    # (K, K, UeAnt, AnAnt, 1, Nsc) -> [an, ue] (Nsc, UeAnt, AnAnt)
    freq_resp = ir.get_freq_response(NSC)[..., 0, :].permute(0, 1, 4, 2, 3)

    precoders = []
    for ue in range(K):
        u_mat, _, _ = np.linalg.svd(freq_resp[ue, ue, SC_IDX].cpu().numpy())
        precoders.append(torch.as_tensor(u_mat[:, 0].conj(), device=dev))
    p = torch.stack(precoders)                               # (ue, UeAnt)
    scale = torch.as_tensor(np.sqrt(PATHLOSS), dtype=torch.float32,
                            device=dev)
    # [an, ue] (Nsc, AnAnt): the uplink block times the UE's precoder
    uH_eq = full_precision(torch.matmul)(
        freq_resp.transpose(-1, -2), p[None, :, None, :, None])[..., 0] * \
        scale[:, :, None, None]

    r = [torch.as_tensor(get_srs_seq(get_extended_ZF(
        calcBaseZC(NZC, u), NSC // 2), SHIFT_INDEX).astype(np.complex64),
        device=dev) for u in (1, 2, 3)]
    comb = torch.arange(0, NSC, 2, device=dev)
    # received comb-2 SRS at each AN: (AnAnt, Nsc / 2), summed over UEs
    Y = sum(uH_eq[:, ue, comb] * r[ue][:, None] for ue in range(K)) \
        .transpose(-1, -2)
    estimators = [CazacBasedChannelEstimator(seq.cpu().numpy())
                  for seq in r]

    def estimate(rx, ue):
        return estimators[ue].estimate_channel_freq_domain(
            rx, NUM_TAPS_TO_KEEP).transpose(-1, -2)     # (Nsc, AnAnt)

    out = {}
    for an in range(K):
        plain = [estimate(Y[an], ue) for ue in range(K)]
        # SIC: re-estimate the cross channels after subtracting the direct
        residual = Y[an] - (plain[an][comb] * r[an][:, None]).T
        sic = [plain[ue] if ue == an else estimate(residual, ue)
               for ue in range(K)]
        for ue in range(K):
            out[an, ue] = (estimation_error_dB(uH_eq[an, ue], plain[ue]),
                           estimation_error_dB(uH_eq[an, ue], sic[ue]))
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args, _ = parser.parse_known_args()
    mse = run(args.device)
    print(f"Nsc: {NSC}, comb-2 SRS, taps kept: {NUM_TAPS_TO_KEEP}")
    print(f"{'link':>8} {'plain MSE dB':>13} {'SIC MSE dB':>11} "
          f"{'SIC gain dB':>12}")
    for (an, ue), (mse_plain, mse_sic) in mse.items():
        tag = "direct" if an == ue else "cross"
        print(f"UE{ue + 1}->AN{an + 1} {mse_plain:13.2f} "
              f"{mse_sic:11.2f} {mse_plain - mse_sic:12.2f}  ({tag})")


if __name__ == "__main__":
    main()
