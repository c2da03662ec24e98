"""Per-resource-element MMSE detection of spatially multiplexed QAM, fused
with the hard decision and the bit-error count; and the per-subcarrier
MMSE equalizer of spatially multiplexed SC-FDMA (:func:`sc_mmse_eq`, at the
end of this module).

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
from .qam import qam_slice

__all__ = ["SC_SHAPES", "SHAPES", "mimo_mmse", "mimo_mmse_reference",
           "sc_decide", "sc_decide_reference", "sc_mmse_eq",
           "sc_mmse_eq_reference"]

# (Nr, Nt) of the kernel's instances: 4 x 4 (the LTE configuration), 2 x 2
# (the small step) and the non-square 4 x 2 and 2 x 3
SHAPES = ((4, 4), (2, 2), (4, 2), (2, 3))
# (Nr, Nt) of the SC-FDMA equalizer's instances: the 4-layer PUSCH and the
# small step of the tests
SC_SHAPES = ((4, 4), (2, 2))


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


def _slice_errors(re: torch.Tensor, im: torch.Tensor, sent: torch.Tensor,
                  M: int) -> torch.Tensor:
    """The bits in which the slicer's decision on ``(re, im)`` differs from
    the ``sent`` indices, element by element (``mmse.cuh``
    ``bit_errors``): ``QAM.demodulate_hard``'s slicer (``ops/qam.py``
    ``qam_slice``), whose float32 operations the kernels round alike."""
    return count_bits(qam_slice(torch.complex(re, im), M) ^
                      sent.to(torch.int64))


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


def _planes(h, nr, nt):
    """``h``'s (real, imaginary) planes as ``H[r][t]``."""
    return [[(h[:, r, t].real, h[:, r, t].imag) for t in range(nt)]
            for r in range(nr)]


def _gram(H, s2, nr, nt):
    """A = H^H H + s2 I: its real diagonal and its upper triangle, each
    sum over r in order (``mmse.cuh`` ``gram``)."""
    Ad, Au = [], {}
    for i in range(nt):
        d = _abs2(H[0][i])
        for r in range(1, nr):
            d = d + _abs2(H[r][i])
        Ad.append(d + s2)
        for j in range(i + 1, nt):
            u = _mulc(H[0][i], H[0][j])
            for r in range(1, nr):
                u = _add(u, _mulc(H[r][i], H[r][j]))
            Au[i, j] = u
    return Ad, Au


def _ldl(Ad, Au, nt):
    """A = L D L^H, L unit lower: (1 / D, L) (``mmse.cuh`` ``ldl``)."""
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
    return inv, L


def _solve(L, inv, b, nt):
    """A^-1 b from the factors: L z = b, then L^H x = z / D (``mmse.cuh``
    ``solve``)."""
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
    return x


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
    H = _planes(h, nr, nt)                                     # (n, S)
    Y = [(y[:, r].real, y[:, r].imag) for r in range(nr)]
    Ad, Au = _gram(H, s2, nr, nt)
    # b = H^H y, each sum over r in order
    b = []
    for i in range(nt):
        v = _mulc(H[0][i], Y[0])
        for r in range(1, nr):
            v = _add(v, _mulc(H[r][i], Y[r]))
        b.append(v)
    inv, L = _ldl(Ad, Au, nt)
    x = _solve(L, inv, b, nt)
    # the kernel's float32 gain sqrt(Nt)
    gain = torch.tensor(math.sqrt(nt), dtype=torch.float32, device=h.device)
    errors = torch.zeros(n, dtype=torch.int64, device=h.device)
    for t in range(nt):
        errors += _slice_errors(x[t][0] * gain, x[t][1] * gain, sent[:, t],
                                M).sum(dim=-1)
    return errors


# -- the SC-FDMA equalizer ----------------------------------------------------
#
# SC-FDMA spreads each layer's symbols over the subframe's allocation (a
# DFT), so the hard decision follows the equalizer's IDFT and cannot be
# fused into it as in mimo_mmse. Per subcarrier k, on the channel estimate
# H (Nr x Nt) held over the subframe: W = (H^H H + s2 I)^-1 H^H, the gain
# Re (W H)[t][t] that unbiases layer t, and x = W y on each data symbol.
#
# Layout (planar, the subcarrier innermost): ``h`` (n, Nr, Nt, K), ``y``
# (n, Nr, NS, K) the subframe's NS demodulated symbols (pilots included:
# ``data_symbols`` names those that carry data), ``noise_var`` a 0-dim
# float32 tensor on the same device. Out: ``x`` (n, Nt, ND, K) complex64,
# ND = len(data_symbols), and ``gain`` (n, Nt, K) float32.
# ``sc_mmse_eq.launch_count`` counts kernel launches and
# ``sc_mmse_eq.reference_count`` calls of the plain version.
#
# After the IDFT that undoes the spreading, :func:`sc_decide` divides each
# layer's symbols by ``mu`` (the mean of its gains over the subcarriers),
# slices them as ``QAM.demodulate_hard`` does and counts the bits that
# differ from the sent indices: one launch of ``sc_decide_kernel`` (in
# ``ops/csrc/sc_mmse_eq.cu``) on CUDA tensors, :func:`sc_decide_reference`
# on CPU tensors, equal bit for bit.


def _check_sc(h, y, noise_var, data_symbols):
    if h.dim() != 4 or y.dim() != 4:
        raise ValueError(f"h must be (n, Nr, Nt, K) and y (n, Nr, NS, K), "
                         f"got {tuple(h.shape)} and {tuple(y.shape)}")
    n, nr, nt, K = h.shape
    ns = y.shape[2]
    if (y.shape[0], y.shape[1], y.shape[3]) != (n, nr, K):
        raise ValueError(f"y {tuple(y.shape)} does not match h "
                         f"{tuple(h.shape)}")
    if (nr, nt) not in SC_SHAPES:
        raise ValueError(f"(Nr, Nt) must be one of {SC_SHAPES}, got "
                         f"({nr}, {nt})")
    symbols = [int(d) for d in data_symbols]
    if sorted(set(symbols)) != symbols or not symbols or symbols[0] < 0 \
            or symbols[-1] >= min(ns, 32):
        raise ValueError(f"data_symbols must increase within the {ns} "
                         f"symbols (at most 32), got {data_symbols}")
    if noise_var.dim() != 0 or {noise_var.device, y.device} != {h.device}:
        raise ValueError("h, y and the 0-dim noise_var must be on one "
                         "device")
    return n, nr, nt, K, ns, symbols


def sc_mmse_eq(h: torch.Tensor, y: torch.Tensor, noise_var: torch.Tensor,
               data_symbols):
    """``(x, gain)`` of the SC-FDMA equalizer (the section's comment):
    the CUDA kernel ``ops/csrc/sc_mmse_eq.cu`` for CUDA tensors (one
    launch, which synchronises nothing, so a CUDA graph captures it), the
    plain version for CPU tensors."""
    n, nr, nt, K, ns, symbols = _check_sc(h, y, noise_var, data_symbols)
    dev = h.device
    if dev.type == "cpu":
        return sc_mmse_eq_reference(h, y, noise_var, symbols)
    if dev.type != "cuda":
        raise RuntimeError(f"no route for device {dev}")
    from . import _build
    if h.dtype != torch.complex64 or y.dtype != torch.complex64 or \
            noise_var.dtype != torch.float32:
        raise TypeError("the sc_mmse_eq kernel takes complex64 h and y and "
                        "a float32 noise_var")
    h, y = h.contiguous(), y.contiguous()
    x = torch.empty((n, nt, len(symbols), K), dtype=torch.complex64,
                    device=dev)
    gain = torch.empty((n, nt, K), dtype=torch.float32, device=dev)
    mask = sum(1 << d for d in symbols)
    _build.check(_build.load().sc_mmse_eq(
        h.data_ptr(), y.data_ptr(), noise_var.data_ptr(), x.data_ptr(),
        gain.data_ptr(), n, K, ns, mask, nr, nt,
        torch.cuda.current_stream(dev).cuda_stream), "sc_mmse_eq")
    sc_mmse_eq.launch_count += 1
    return x, gain


sc_mmse_eq.launch_count = 0
sc_mmse_eq.reference_count = 0


def sc_mmse_eq_reference(h: torch.Tensor, y: torch.Tensor,
                         noise_var: torch.Tensor, data_symbols):
    """The plain PyTorch version of :func:`sc_mmse_eq` on any device: the
    kernel's float32 operations in the kernel's order (the Gram, its LDL^H
    factors, W's columns by the two triangular solves, the gains, W y), so
    the two agree bit for bit."""
    n, nr, nt, K, ns, symbols = _check_sc(h, y, noise_var, data_symbols)
    sc_mmse_eq.reference_count += 1
    h = h.to(torch.complex64)
    s2 = noise_var.to(torch.float32)
    H = _planes(h, nr, nt)                                     # (n, K)
    inv, L = _ldl(*_gram(H, s2, nr, nt), nt)
    # W[t][r]: column r solves A w = (row r of H)^H
    W = [[None] * nr for _ in range(nt)]
    for r in range(nr):
        w = _solve(L, inv, [(H[r][t][0], -H[r][t][1]) for t in range(nt)],
                   nt)
        for t in range(nt):
            W[t][r] = w[t]
    gains = []
    for t in range(nt):
        g = W[t][0][0] * H[0][t][0] - W[t][0][1] * H[0][t][1]
        for r in range(1, nr):
            g = g + (W[t][r][0] * H[r][t][0] - W[t][r][1] * H[r][t][1])
        gains.append(g)
    yd = y.to(torch.complex64)[:, :, symbols]                 # (n, Nr, ND, K)
    Y = [(yd[:, r].real, yd[:, r].imag) for r in range(nr)]
    Wb = [[(w[0][:, None], w[1][:, None]) for w in row] for row in W]
    x = []
    for t in range(nt):
        v = _mul(Wb[t][0], Y[0])
        for r in range(1, nr):
            v = _add(v, _mul(Wb[t][r], Y[r]))
        x.append(torch.complex(*v))
    return torch.stack(x, dim=1), torch.stack(gains, dim=1)


def _check_decide(symbols, mu, sent, M):
    if symbols.dim() < 3:
        raise ValueError(f"symbols must be (n, Nt, ...), got "
                         f"{tuple(symbols.shape)}")
    n, nt = symbols.shape[:2]
    S = symbols[0, 0].numel()
    if tuple(mu.shape) != (n, nt) or sent.shape[:2] != (n, nt) or \
            sent[0, 0].numel() != S:
        raise ValueError(f"mu {tuple(mu.shape)} and sent "
                         f"{tuple(sent.shape)} do not match symbols "
                         f"{tuple(symbols.shape)}")
    half = int(round(math.log2(M))) // 2
    if M < 4 or (1 << (2 * half)) != M or half > 4:
        raise ValueError(f"M must be a square QAM order up to 256, got {M}")
    if {mu.device, sent.device} != {symbols.device}:
        raise ValueError("symbols, mu and sent must be on one device")
    return n, nt, S


def sc_decide(symbols: torch.Tensor, mu: torch.Tensor, sent: torch.Tensor,
              M: int = 16) -> torch.Tensor:
    """(n,) int64 bit errors of each attempt's unbiased decisions on its
    de-spread ``symbols`` (n, Nt, ...) complex64, divided by ``mu`` (n, Nt)
    float32, against ``sent`` (n, Nt, ...) indices with as many symbols a
    layer. The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. With a unit ``mu`` (ones, by which the division is exact) it
    is the plain hard decision and bit count: ``chain.ChainStep``'s, with
    ``Nt`` = 1."""
    n, nt, S = _check_decide(symbols, mu, sent, M)
    dev = symbols.device
    if dev.type == "cpu":
        return sc_decide_reference(symbols, mu, sent, M)
    if dev.type != "cuda":
        raise RuntimeError(f"no route for device {dev}")
    from . import _build
    if symbols.dtype != torch.complex64 or mu.dtype != torch.float32:
        raise TypeError("the sc_decide kernel takes complex64 symbols and a "
                        "float32 mu")
    symbols, mu = symbols.contiguous(), mu.contiguous()
    sent = sent.to(torch.int64).contiguous()
    counts = torch.zeros(n, dtype=torch.int64, device=dev)
    _build.check(_build.load().sc_decide(
        symbols.data_ptr(), mu.data_ptr(), sent.data_ptr(),
        counts.data_ptr(), n, nt, S, int(M),
        torch.cuda.current_stream(dev).cuda_stream), "sc_decide")
    sc_decide.launch_count += 1
    return counts


sc_decide.launch_count = 0
sc_decide.reference_count = 0


def sc_decide_reference(symbols: torch.Tensor, mu: torch.Tensor,
                        sent: torch.Tensor, M: int = 16) -> torch.Tensor:
    """The plain PyTorch version of :func:`sc_decide` on any device: each
    part divided by ``mu`` in float32, then the kernel's slicer, so the two
    give the same counts bit for bit."""
    n, nt, S = _check_decide(symbols, mu, sent, M)
    sc_decide.reference_count += 1
    v = symbols.to(torch.complex64).reshape(n, nt, S)
    m = mu.to(torch.float32)[..., None]
    return _slice_errors(v.real / m, v.imag / m, sent.reshape(n, nt, S),
                         M).sum(dim=(1, 2))
