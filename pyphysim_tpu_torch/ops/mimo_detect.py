"""Per-resource-element MMSE detection of spatially multiplexed QAM, fused
with the hard decision and the bit-error count.

Each resource element (RE) ``s`` of attempt ``a`` carries ``Nt`` QAM
layers through an ``Nr x Nt`` channel ``H``: ``y = H x + n`` with ``x`` the
layers' symbols after Blast's 1/sqrt(Nt) split. The detector is
``mimo.Blast``'s MMSE filter, ``(H^H H + s2 I)^-1 H^H``, times its gain
sqrt(Nt), then ``QAM.demodulate_hard``'s slicer; what comes back is each
attempt's bit errors against the sent indices, summed over its REs and
layers. Nothing per RE leaves the device.

Two versions of one function:

  * :func:`mimo_mmse`, the wrapper: on CUDA tensors one launch of the
    hand-written kernel ``ops/csrc/mimo_mmse.cu`` (its source note says
    what bounds it and how it is laid out), on CPU tensors the plain
    version. There is no fallback from one to the other. The launch
    synchronises nothing and allocates only its (n,) counts, so a CUDA
    graph captures it (``torch.linalg.solve``, Blast's route, reads its
    error info on the host and cannot be captured).
  * :func:`mimo_mmse_reference`, the plain PyTorch version: the kernel's
    steps (the Gram and ``H^H y``, an LDL^H factorisation without square
    roots, the two triangular solves, the slicer) as the same float32
    operations in the same order, each rounded on its own (the kernel
    contracts no multiply-add), so the two give the same counts bit for
    bit.

Layout (planar, the RE index innermost, as the kernel reads it): ``h``
(n, Nr, Nt, S) complex64, ``y`` (n, Nr, S) complex64, ``sent`` (n, Nt, S)
integer indices in [0, M), ``noise_var`` a 0-dim float32 tensor on the
same device (``s2``, read on the device: a captured step re-keys its SNR
by a write to it). ``mimo_mmse.launch_count`` counts kernel launches and
``mimo_mmse.reference_count`` calls of the plain version.
"""

from __future__ import annotations

import math

import torch

from ..utils.misc import count_bits

__all__ = ["SHAPES", "mimo_mmse", "mimo_mmse_reference"]

# (Nr, Nt) of the kernel's instances: 4 x 4 (the LTE configuration), 2 x 2
# (the small step) and the non-square 4 x 2 and 2 x 3
SHAPES = ((4, 4), (2, 2), (4, 2), (2, 3))


def _check(h: torch.Tensor, y: torch.Tensor, sent: torch.Tensor,
           noise_var: torch.Tensor, M: int):
    if h.dim() != 4:
        raise ValueError(f"h must be (n, Nr, Nt, S), got {tuple(h.shape)}")
    n, nr, nt, S = h.shape
    if tuple(y.shape) != (n, nr, S) or tuple(sent.shape) != (n, nt, S):
        raise ValueError(f"y {tuple(y.shape)} and sent {tuple(sent.shape)} "
                         f"do not match h {tuple(h.shape)}")
    if (nr, nt) not in SHAPES:
        raise ValueError(f"(Nr, Nt) must be one of {SHAPES}, got "
                         f"({nr}, {nt})")
    half = int(round(math.log2(M))) // 2
    if M < 4 or (1 << (2 * half)) != M or half > 4:
        raise ValueError(f"M must be a square QAM order up to 256, got {M}")
    if noise_var.dim() != 0 or noise_var.device != h.device or \
            {y.device, sent.device} != {h.device}:
        raise ValueError("h, y, sent and the 0-dim noise_var must be on one "
                         "device")
    return n, nr, nt, S


def mimo_mmse(h: torch.Tensor, y: torch.Tensor, sent: torch.Tensor,
              noise_var: torch.Tensor, M: int = 16) -> torch.Tensor:
    """(n,) int64 bit errors of each attempt's MMSE hard decisions against
    ``sent`` (the module docstring). The CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    n, nr, nt, S = _check(h, y, sent, noise_var, M)
    dev = h.device
    if dev.type == "cpu":
        return mimo_mmse_reference(h, y, sent, noise_var, M)
    if dev.type != "cuda":
        raise RuntimeError(f"no route for device {dev}")
    from . import _build
    if h.dtype != torch.complex64 or y.dtype != torch.complex64 or \
            noise_var.dtype != torch.float32:
        raise TypeError("the mimo_mmse kernel takes complex64 h and y and a "
                        "float32 noise_var")
    h, y = h.contiguous(), y.contiguous()
    sent = sent.to(torch.int64).contiguous()
    counts = torch.zeros(n, dtype=torch.int64, device=dev)
    _build.check(_build.load().mimo_mmse(
        h.data_ptr(), y.data_ptr(), sent.data_ptr(), noise_var.data_ptr(),
        counts.data_ptr(), n, S, nr, nt, int(M), math.sqrt(nt),
        torch.cuda.current_stream(dev).cuda_stream), "mimo_mmse")
    mimo_mmse.launch_count += 1
    return counts


mimo_mmse.launch_count = 0
mimo_mmse.reference_count = 0


def _level(v: torch.Tensor, scale: torch.Tensor, lq: int) -> torch.Tensor:
    """``QAM.demodulate_hard`` on one axis: the grid position nearest
    ``v`` (round half to even, clamped)."""
    return torch.clamp(torch.round((v * scale + (lq - 1)) / 2.0), 0,
                       lq - 1).to(torch.int64)


def _inv_gray(p: torch.Tensor) -> torch.Tensor:
    return p ^ (p >> 1) ^ (p >> 2) ^ (p >> 3)


# complex values as (real, imaginary) pairs of float32 tensors, each
# operation one torch call, rounded on its own as the kernel rounds it
def _mul(a, b):
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def _mulc(a, b):
    """conj(a) * b"""
    return a[0] * b[0] + a[1] * b[1], a[0] * b[1] - a[1] * b[0]


def _mul_conj(a, b):
    """a * conj(b)"""
    return a[0] * b[0] + a[1] * b[1], a[1] * b[0] - a[0] * b[1]


def _add(a, b):
    return a[0] + b[0], a[1] + b[1]


def _sub(a, b):
    return a[0] - b[0], a[1] - b[1]


def _scale(a, s):
    return a[0] * s, a[1] * s


def _abs2(a):
    return a[0] * a[0] + a[1] * a[1]


def mimo_mmse_reference(h: torch.Tensor, y: torch.Tensor,
                        sent: torch.Tensor, noise_var: torch.Tensor,
                        M: int = 16) -> torch.Tensor:
    """The plain PyTorch version of :func:`mimo_mmse` on any device: the
    kernel's float32 operations, each RE's Nt x Nt system unrolled over
    its entries, in the kernel's order, so the two give the same counts
    bit for bit."""
    n, nr, nt, S = _check(h, y, sent, noise_var, M)
    mimo_mmse.reference_count += 1
    h = h.to(torch.complex64)
    y = y.to(torch.complex64)
    s2 = noise_var.to(torch.float32)
    H = [[(h[:, r, t].real, h[:, r, t].imag) for t in range(nt)]
         for r in range(nr)]                                     # (n, S)
    Y = [(y[:, r].real, y[:, r].imag) for r in range(nr)]
    # A's diagonal (real) and upper triangle, b = H^H y, sums over r in
    # order
    Ad, Au, b = [], {}, []
    for i in range(nt):
        d, v = _abs2(H[0][i]), _mulc(H[0][i], Y[0])
        for r in range(1, nr):
            d = d + _abs2(H[r][i])
            v = _add(v, _mulc(H[r][i], Y[r]))
        Ad.append(d + s2)
        b.append(v)
        for j in range(i + 1, nt):
            u = _mulc(H[0][i], H[0][j])
            for r in range(1, nr):
                u = _add(u, _mulc(H[r][i], H[r][j]))
            Au[i, j] = u
    # A = L D L^H, L unit lower
    D, inv, L = [], [], {}
    for j in range(nt):
        d = Ad[j]
        for k in range(j):
            d = d - _abs2(L[j, k]) * D[k]
        D.append(d)
        inv.append(torch.reciprocal(d))
        for i in range(j + 1, nt):
            v = (Au[j, i][0], -Au[j, i][1])
            for k in range(j):
                v = _sub(v, _scale(_mul_conj(L[i, k], L[j, k]), D[k]))
            L[i, j] = _scale(v, inv[j])
    z = []
    for i in range(nt):
        v = b[i]
        for k in range(i):
            v = _sub(v, _mul(L[i, k], z[k]))
        z.append(v)
    x = [None] * nt
    for i in reversed(range(nt)):
        v = _scale(z[i], inv[i])
        for k in range(i + 1, nt):
            v = _sub(v, _mulc(L[k, i], x[k]))
        x[i] = v
    lq = int(round(math.sqrt(M)))
    half = int(round(math.log2(M))) // 2
    # the kernel's float32 constants: sqrtf(2 (M - 1) / 3) and sqrt(Nt)
    scale = torch.tensor((M - 1) * 2.0 / 3.0, dtype=torch.float32,
                         device=h.device).sqrt()
    gain = torch.tensor(math.sqrt(nt), dtype=torch.float32, device=h.device)
    errors = torch.zeros(n, dtype=torch.int64, device=h.device)
    for t in range(nt):
        col = _level(x[t][0] * gain, scale, lq)
        row = _level(-(x[t][1] * gain), scale, lq)
        got = (_inv_gray(row) << half) | _inv_gray(col)
        errors += count_bits(got ^ sent[:, t].to(torch.int64)).sum(dim=-1)
    return errors
