#!/usr/bin/env python
"""Max-SINR IA with quantized (limited-feedback) channel knowledge, on the
PyTorch port.

The counterpart of ``apps/ia/simple_maxsinr_quantized.py``: each
cross-link channel block is quantized to the nearest codeword of a random
vector codebook (the CSI the transmitters would get over a limited
feedback link); Max-SINR IA is solved on the QUANTIZED channel while the
data goes over the TRUE channel, and the BER is compared with that of
perfect-CSI IA.

Quantization is one real contraction of every block against the whole
codebook, an argmax and a gather. The IA solve is the batched
fixed-iteration Max-SINR of ``pyphysim_tpu_torch.ia.batched``, with every
repetition of both CSI cases in one call. The draws come from the port's
Philox streams keyed from ``--seed`` (the codebook, then per repetition
the channel, the initial precoders, the bits and the noise), so the card
and the CPU see the same numbers.

Run: ``python apps/ia/simple_maxsinr_quantized_torch.py [--reps 300]
[--codebook-size 512] [--device cuda]``.
"""

import argparse
import math
import sys

sys.path.insert(0, ".")

import torch  # noqa: E402

from pyphysim_tpu_torch._device import require_cuda  # noqa: E402
from pyphysim_tpu_torch.ia import batched  # noqa: E402
from pyphysim_tpu_torch.ops.streams import AttemptStreams  # noqa: E402
from pyphysim_tpu_torch.utils.conversion import dB2Linear  # noqa: E402
from pyphysim_tpu_torch.utils.misc import (full_precision,  # noqa: E402
                                           randn_c)

K, NR, NT, NS = 3, 2, 2, 1
ITERATIONS = 60


def gen_codebook(streams: AttemptStreams, codebook_size: int,
                 dimension: int) -> torch.Tensor:
    """Random unit-norm codewords (codebook_size, dimension), complex64,
    one a row of ``streams``."""
    if streams.n != codebook_size:
        raise ValueError("one stream row per codeword")
    c = randn_c(streams, dimension)
    return c / c.abs().square().sum(dim=-1, keepdim=True).sqrt()


@full_precision
def quantize_channel(H: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Each (Nr, Nt) block of ``H`` (..., Nr, Nt) replaced by its nearest
    codeword after normalization: minimizing ``||v/||v|| - c||^2 = 2 - 2
    Re<v, c>`` maximizes ``Re<v, c>``, one real contraction against the
    whole codebook."""
    *lead, nr, nt = H.shape
    v = H.reshape(*lead, nr * nt)
    v = v / v.abs().square().sum(dim=-1, keepdim=True).sqrt()
    scores = torch.cat([v.real, v.imag], dim=-1) @ \
        torch.cat([codebook.real, codebook.imag], dim=-1).T
    return codebook[scores.argmax(dim=-1)].reshape(H.shape)


def bit_errors(H: torch.Tensor, F: torch.Tensor, U: torch.Tensor,
               bits: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Bit errors of each repetition's BPSK streams over the channel ``H``
    (reps, K, K, Nr, Nt): user ``k`` receives ``sum_l H_kl F_l x_l +
    noise_k``, filters it with ``U_k^H`` and decides on the sign of the
    real part. ``F`` (reps, K, Nt, Ns), ``U`` (reps, K, Nr, Ns), ``bits``
    (reps, K, Ns, n) and ``noise`` (reps, K, Nr, n), already scaled; the
    counts are (reps,) int64."""
    x = (2.0 * bits - 1.0).to(torch.complex64)
    rx = ((H @ F[:, None]) @ x[:, None]).sum(dim=2) + noise
    y = U.mH @ rx                                       # (reps, K, Ns, n)
    decided = (y.real < 0).long() ^ 1
    return (decided != bits).flatten(1).sum(dim=1)


def draws(reps: int, codebook_size: int, nsymbs: int, seed: int, device):
    """The app's draws from the Philox streams keyed by ``seed``: the
    codebook (a row a codeword), then for each repetition the channel
    ``H`` (reps, K, K, Nr, Nt), the streams of the initial precoders, the
    bits (reps, K, Ns, nsymbs) and unit-variance noise (reps, K, Nr,
    nsymbs)."""
    s_cb = AttemptStreams.from_range(seed, 0, codebook_size,
                                     device).split(2)[0]
    s_H, s_F, s_data, s_noise = AttemptStreams.from_range(
        seed, 0, reps, device).split(2)[1].split(4)
    codebook = gen_codebook(s_cb, codebook_size, NR * NT)
    H = randn_c(s_H, K, K, NR, NT)
    bits = s_data.integers(2, (K, NS, nsymbs))          # BPSK, one stream
    noise = randn_c(s_noise, K, NR, nsymbs)
    return codebook, H, s_F, bits, noise


@full_precision
def run(reps: int = 300, codebook_size: int = 512, snr: float = 15.0,
        nsymbs: int = 50, iterations: int = ITERATIONS, seed: int = 0,
        device="cuda"):
    """Bit errors with quantized and with perfect CSI over ``reps``
    repetitions: ``(errors_quantized, errors_perfect, bits_per_case)``,
    the counts as int64 tensors on the device."""
    dev = require_cuda(device)
    noise_var = 1.0 / dB2Linear(snr)
    codebook, H, s_F, bits, noise = draws(reps, codebook_size, nsymbs, seed,
                                          dev)
    # both CSI cases in one solve, from the same initial precoders
    csi = torch.cat([quantize_channel(H, codebook), H])
    both = AttemptStreams(s_F.seed, torch.cat([s_F.attempts] * 2), s_F.salt)
    F, U = batched.max_sinr_solve(csi, both, NS, 1.0, noise_var,
                                  iterations=iterations)
    # the data goes over the TRUE channel in both cases
    errors = bit_errors(torch.cat([H, H]), F, U, torch.cat([bits, bits]),
                        torch.cat([noise, noise]) * math.sqrt(noise_var))
    return errors[:reps].sum(), errors[reps:].sum(), reps * K * NS * nsymbs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=300)
    parser.add_argument("--codebook-size", type=int, default=512)
    parser.add_argument("--snr", type=float, default=15.0)
    parser.add_argument("--nsymbs", type=int, default=50)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    err_q, err_p, num_bits = run(args.reps, args.codebook_size, args.snr,
                                 args.nsymbs, seed=args.seed,
                                 device=args.device)
    print(f"SNR {args.snr} dB, {args.reps} reps, codebook size "
          f"{args.codebook_size}, {K} users {NR}x{NT}({NS})")
    print(f"BER with quantized CSI: {int(err_q) / num_bits:.5f}")
    print(f"BER with perfect CSI:   {int(err_p) / num_bits:.5f}")
    return int(err_q), int(err_p), num_bits


if __name__ == "__main__":
    main()
