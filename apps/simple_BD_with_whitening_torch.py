#!/usr/bin/env python
"""Block diagonalization with external interference on the PyTorch port:
a minimal example.

The counterpart of ``apps/simple_BD_with_whitening.py``: a 3-user 2x2
MIMO interference channel with one rank-1 external interference source;
plain BD, whitening BD and EnhancedBD precoders are computed and the
plain BD's effective channel is checked to be block diagonal.

Run: ``python apps/simple_BD_with_whitening_torch.py [--device cuda]``.
"""

import os
import sys
from time import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pyphysim_tpu_torch._device import require_cuda  # noqa: E402
from pyphysim_tpu_torch.channels.multiuser import \
    MultiUserChannelMatrixExtInt  # noqa: E402
from pyphysim_tpu_torch.comm.blockdiagonalization import (  # noqa: E402
    BlockDiagonalizer, EnhancedBD, WhiteningBD)
from pyphysim_tpu_torch.modulators import PSK  # noqa: E402
from pyphysim_tpu_torch.utils.conversion import dBm2Linear  # noqa: E402


def offblock_energy(H, Nr, Nt) -> float:
    """Energy of ``H`` outside its (Nr[k], Nt[k]) diagonal blocks."""
    total, row = 0.0, 0
    for k in range(len(Nr)):
        col = 0
        for j in range(len(Nt)):
            if j != k:
                total += float(np.sum(
                    np.abs(H[row:row + Nr[k], col:col + Nt[j]]) ** 2))
            col += Nt[j]
        row += Nr[k]
    return total


def run(device="cuda", verbose: bool = True):
    """Compute the three precoders; returns a dict of what it prints."""
    device = require_cuda(device)
    tic = time()
    K = 3
    Nt = 2 * np.ones(K, dtype=int)
    Nr = 2 * np.ones(K, dtype=int)
    M = 4
    modulator = PSK(M, device=device)
    NSymbs = 500
    noise_var = float(dBm2Linear(-116.4))
    transmit_power = 1.0            # fixed at 1.0, as in the reference
    pe = float(dBm2Linear(-100.0))  # external interference power
    ext_int_rank = 1

    channel = MultiUserChannelMatrixExtInt(device=device)
    channel.randomize(Nr, Nt, K, ext_int_rank,
                      generator=torch.Generator(device=device)
                      .manual_seed(0))
    channel.noise_var = noise_var

    rng = np.random.RandomState(0)
    input_data = rng.randint(0, M, [int(np.sum(Nt)), NSymbs])
    symbols = modulator.modulate(input_data)

    bd = BlockDiagonalizer(K, transmit_power, noise_var)
    whitening_bd = WhiteningBD(K, transmit_power, noise_var, pe)
    enhanced_bd = EnhancedBD(K, transmit_power, noise_var, pe)

    H_no_ext = channel.big_H_no_ext_int.cpu().numpy()
    newH, Ms = bd.block_diagonalize_no_waterfilling(H_no_ext)
    Ms_w_all, Wk_w_all, Ns_w = \
        whitening_bd.block_diagonalize_no_waterfilling(channel)
    _, _, Ns_all = enhanced_bd.block_diagonalize_no_waterfilling(channel)
    out = {
        "symbols_shape": np.asarray(symbols).shape,
        "offblock_energy": offblock_energy(newH, Nr, Nt),
        "whitening_streams": Ns_w,
        "whitening_shapes": ([m.shape for m in Ms_w_all],
                             [w.shape for w in Wk_w_all]),
        "enhanced_streams": Ns_all,
        "bd_powers": [float(np.linalg.norm(Ms[:, k * 2:(k + 1) * 2]) ** 2)
                      for k in range(K)],
    }
    if verbose:
        print("Tx symbols shape:", out["symbols_shape"])
        print("BD off-block energy:        ", out["offblock_energy"])
        print("WhiteningBD streams per user:", Ns_w,
              "| precoder shapes:", out["whitening_shapes"][0],
              "| rx filter shapes:", out["whitening_shapes"][1])
        print("EnhancedBD streams per user: ", Ns_all)
        print("Precoder powers (BD):        ", out["bd_powers"])
        print("Elapsed:", time() - tic, "s")
    return out


def main():
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args, _ = parser.parse_known_args()
    run(args.device)


if __name__ == "__main__":
    main()
