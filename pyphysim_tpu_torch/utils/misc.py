"""Core numeric utilities.

Counterpart of ``pyphysim_tpu/utils/misc.py``: complex Gaussian samples
and random symbols from an explicit random source, bit counting and
``xor`` on torch tensors, ``level2bits``, the Q function and its inverse,
confidence intervals, the host-side geometric mean decomposition (``gmd``,
for ``mimo.GMDMimo``), the bf16 rounding of complex values
(``round_bf16``, for the chain's bf16 signal path), the eigenvector
helpers (``peig`` / ``leig`` on the host, ``peig_h`` / ``leig_h`` batched
over Hermitian tensors or arrays), the host-side numpy helpers of the
interference-alignment solvers (``randn_c_RS``, ``update_inv_sum_diag``,
``get_principal_component_matrix``), autocorrelations, the linear algebra
of the block-diagonalization family (``pinv`` with the JAX package's
cutoff, ``least_right_singular_vectors``, ``calc_decorrelation_matrix``,
``calc_whitening_matrix``, ``calc_shannon_sum_capacity``), the float32
guard of matrix products (``full_precision``: TF32 off), and the
host-side formatting helpers the runner uses for file names and progress.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.streams import bits, normal

__all__ = [
    "randn_c",
    "randn_c_RS",
    "random_symbols",
    "round_bf16",
    "count_bits",
    "count_bit_errors",
    "qfunc",
    "qfunc_inv",
    "xor",
    "level2bits",
    "int2bits",
    "calc_confidence_interval",
    "gmd",
    "peig",
    "leig",
    "peig_h",
    "leig_h",
    "calc_unorm_autocorr",
    "calc_autocorr",
    "update_inv_sum_diag",
    "get_principal_component_matrix",
    "PINV_RCOND",
    "pinv",
    "least_right_singular_vectors",
    "calc_decorrelation_matrix",
    "calc_whitening_matrix",
    "calc_shannon_sum_capacity",
    "full_precision",
    "pretty_time",
    "get_range_representation",
    "get_mixed_range_representation",
    "replace_dict_values",
    "equal_dicts",
]


def full_precision(fn):
    """``fn`` run with TF32 matrix products switched off (restored after),
    so its products are float32 ones on the card too."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved

    return wrapper

# ---------------------------------------------------------------------------
# Random draws from an explicit source
# ---------------------------------------------------------------------------


def randn_c(source, *shape: int) -> torch.Tensor:
    """Circularly-symmetric complex normal samples CN(0, 1) as complex64:
    real and imaginary parts iid N(0, 1/2), so ``E|x|^2 = 1``.

    ``source`` is an explicit random source, never global state: an
    ``ops.streams.AttemptStreams`` (the result is (n, *shape), row ``i``
    from attempt ``i``'s stream) or a ``torch.Generator`` (the result is
    ``shape`` on the generator's device). float32 only.
    """
    both = normal(source, (2,) + tuple(shape))
    lead = both.dim() - len(shape) - 1       # 1 for streams, 0 otherwise
    re, im = both.unbind(dim=lead)
    return torch.complex(re, im) * np.float32(np.sqrt(0.5))


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` with each real and imaginary part rounded to bfloat16 (round
    to nearest, ties to even), kept in its own dtype (complex64 or
    float32).

    Torch has no complex bf16 dtype and ``torch.fft`` takes no bf16, so the
    port carries a bf16 signal as complex64 that holds bf16 values and
    computes in float32 between the points where the JAX package's value
    would be bf16 (``CArray.astype(jnp.bfloat16)``): these agree bit for
    bit with its casts.
    """
    if x.is_complex():
        return torch.view_as_complex(
            torch.view_as_real(x).to(torch.bfloat16).to(torch.float32))
    return x.to(torch.bfloat16).to(x.dtype)


def randn_c_RS(rs: np.random.RandomState, *shape: int) -> np.ndarray:
    """Host-side CN(0, 1) samples (complex64) from a numpy RandomState, for
    the host solvers and tools.

    >>> randn_c_RS(np.random.RandomState(0), 2, 3).shape
    (2, 3)
    """
    return (np.sqrt(0.5) *
            (rs.randn(*shape) + 1j * rs.randn(*shape))).astype(np.complex64)


def random_symbols(source, n: int, bits_per_symbol: int) -> torch.Tensor:
    """``n`` uniform integers in [0, 2**bits_per_symbol) (int64), unpacked
    from 32-bit random words, ``32 // bits_per_symbol`` symbols per word.
    ``n`` must be a multiple of that count. ``source`` is as in
    :func:`randn_c`."""
    per_word = 32 // bits_per_symbol
    if n % per_word != 0:
        raise ValueError(
            f"n must be a multiple of {per_word} for {bits_per_symbol}-bit "
            "symbols")
    words = bits(source, (n // per_word,))
    shifts = torch.arange(per_word, dtype=torch.int64,
                          device=words.device) * bits_per_symbol
    sym = (words[..., None] >> shifts) & ((1 << bits_per_symbol) - 1)
    return sym.reshape(words.shape[:-1] + (n,))


# ---------------------------------------------------------------------------
# Bit twiddling / error counting
# ---------------------------------------------------------------------------

_M1 = 0x5555555555555555
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F
_H01 = 0x0101010101010101


def count_bits(n):
    """Popcount of non-negative integer(s).

    Python ints give an int, numpy arrays an int64 array, and integer torch
    tensors an int64 tensor on the same device (SWAR popcount in int64,
    valid for values below 2**63).
    """
    if isinstance(n, (int, np.integer)):
        return int(bin(int(n)).count("1"))
    if isinstance(n, np.ndarray):
        return count_bits(torch.from_numpy(n.astype(np.int64))).numpy()
    x = n.to(torch.int64)
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    # the multiply wraps in int64; the count sits in the top byte
    return ((x * _H01) >> 56) & 0xFF


def xor(a, b):
    """Elementwise xor: ``torch.bitwise_xor`` on tensors, ``^`` on ints and
    numpy arrays.

    >>> xor(0b1100, 0b1010)
    6
    >>> xor(torch.tensor([3, 5]), torch.tensor([1, 1])).tolist()
    [2, 4]
    """
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return torch.bitwise_xor(torch.as_tensor(a), torch.as_tensor(b))
    return a ^ b


def count_bit_errors(first, second, axis=None):
    """Number of differing bits between integer arrays:
    ``sum(popcount(first ^ second))``. Numpy in, numpy out; tensors in,
    an int64 tensor out."""
    bits = count_bits(first ^ second)
    if isinstance(bits, (int, np.integer, np.ndarray)):
        return np.sum(bits, axis=axis)
    return bits.sum() if axis is None else bits.sum(dim=axis)


def level2bits(n: int) -> int:
    """Bits needed to represent ``n`` symbols / levels.

    Examples
    --------
    >>> [level2bits(m) for m in (2, 4, 16, 256)]
    [1, 2, 4, 8]
    """
    if n < 1:
        raise ValueError("level2bits: n must be a positive integer")
    return int2bits(n - 1)


def int2bits(n: int) -> int:
    """Bits needed to represent the integer ``n`` itself:
    int2bits(0) == 1, int2bits(1) == 1, int2bits(2) == 2."""
    if n < 0:
        raise ValueError("int2bits: n must be a non-negative integer")
    if n == 0:
        return 1
    return int(n).bit_length()


# ---------------------------------------------------------------------------
# Q function & confidence intervals
# ---------------------------------------------------------------------------


def qfunc(x):
    """Gaussian tail probability Q(x) = 0.5 erfc(x / sqrt(2)) on host
    numbers/arrays or torch tensors."""
    if isinstance(x, torch.Tensor):
        return 0.5 * torch.special.erfc(x / np.sqrt(2.0))
    import scipy.special
    return 0.5 * scipy.special.erfc(np.asarray(x) / np.sqrt(2.0))


def qfunc_inv(p):
    """Inverse Q function on the host, through scipy's ``erfcinv``.

    >>> round(float(qfunc(qfunc_inv(0.01))), 12)
    0.01
    """
    import scipy.special
    return np.sqrt(2.0) * scipy.special.erfcinv(2.0 * np.asarray(p))


def calc_confidence_interval(mean: float,
                             std: float,
                             n: int,
                             P: float = 95.0) -> Tuple[float, float]:
    """Normal-approximation confidence interval for a Monte Carlo mean.
    ``std`` is the *sample* standard deviation; any coverage probability
    ``P`` in (0, 100) is supported."""
    import scipy.stats
    if not 0.0 < P < 100.0:
        raise ValueError("calc_confidence_interval: P must be in (0, 100)")
    z = scipy.stats.norm.ppf(0.5 + P / 200.0)
    norm = z * std / np.sqrt(n)
    return mean - norm, mean + norm


# ---------------------------------------------------------------------------
# Linear algebra (host, numpy)
# ---------------------------------------------------------------------------


def gmd(U: np.ndarray,
        S: np.ndarray,
        V_H: np.ndarray,
        tol: float = 0.0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Geometric Mean Decomposition of one matrix, on the host.

    Given an SVD ``A = U @ diag(S) @ V_H``, return ``(Q, R, P)`` with
    ``A = Q @ R @ P.conj().T``, ``Q`` / ``P`` with orthonormal columns and
    ``R`` upper triangular with every diagonal entry equal to the geometric
    mean of the kept singular values (Jiang, Hager and Li, 2005): each step
    brings a pair straddling the mean onto the diagonal, mixes it with a
    right Givens rotation and re-triangularizes with a left one.

    >>> A = np.array([[2.0, 1.0], [0.5, 3.0]])
    >>> Q, R, P = gmd(*np.linalg.svd(A))
    >>> np.allclose(Q @ R @ P.conj().T, A)
    True
    >>> bool(np.isclose(R[0, 0].real, R[1, 1].real))
    True
    """
    S = np.asarray(S, dtype=float)
    keep = S > tol * S[0] if tol > 0 else slice(None)
    S = S[keep]
    K = S.shape[0]
    Q = np.array(U[:, :K] if U.shape[1] >= K else U, dtype=complex)
    P = np.array(V_H.conj().T[:, :K], dtype=complex)
    R = np.diag(S).astype(complex)
    sigma_bar = float(np.exp(np.mean(np.log(S))))

    d = S.copy()
    for k in range(K - 1):
        # a (>= mean, <= mean) pair into positions (k, k + 1)
        rest = d[k:]
        if d[k] >= sigma_bar:
            cand = np.nonzero(rest <= sigma_bar)[0]
            j = k + (int(cand[0]) if cand.size else int(np.argmin(rest)))
        else:
            cand = np.nonzero(rest >= sigma_bar)[0]
            j = k + (int(cand[0]) if cand.size else int(np.argmax(rest)))
        if j != k + 1:
            _gmd_swap(R, Q, P, d, k + 1, j)

        d1, d2 = d[k], d[k + 1]
        if abs(d1 - d2) < 1e-12 * max(abs(d1), 1.0):
            c, s = 1.0, 0.0
        else:
            c2 = (sigma_bar ** 2 - d2 ** 2) / (d1 ** 2 - d2 ** 2)
            c2 = min(max(c2, 0.0), 1.0)
            c = np.sqrt(c2)
            s = np.sqrt(1.0 - c2)
        # right rotation of columns (k, k + 1) of R and P
        G1 = np.array([[c, -s], [s, c]])
        R[:, [k, k + 1]] = R[:, [k, k + 1]] @ G1
        P[:, [k, k + 1]] = P[:, [k, k + 1]] @ G1
        # left rotation zeroing R[k + 1, k]
        a, b = R[k, k], R[k + 1, k]
        nrm = np.hypot(abs(a), abs(b))
        cl = (a / nrm).conj() if nrm > 0 else 1.0
        sl = (b / nrm).conj() if nrm > 0 else 0.0
        G2 = np.array([[cl, sl], [-np.conj(sl), np.conj(cl)]])
        R[[k, k + 1], :] = G2 @ R[[k, k + 1], :]
        Q[:, [k, k + 1]] = Q[:, [k, k + 1]] @ G2.conj().T
        R[k + 1, k] = 0.0
        d[k] = np.real(R[k, k])
        d[k + 1] = np.real(R[k + 1, k + 1])

    return Q, R, P


def _gmd_swap(R, Q, P, d, i, j):
    R[:, [i, j]] = R[:, [j, i]]
    R[[i, j], :] = R[[j, i], :]
    Q[:, [i, j]] = Q[:, [j, i]]
    P[:, [i, j]] = P[:, [j, i]]
    d[[i, j]] = d[[j, i]]


def peig(A: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """The ``n`` eigenvectors of ``A`` of largest |eigenvalue| and their
    eigenvalues, largest first (any square matrix, on the host).

    >>> V, D = peig(np.diag([1.0, 3.0, 2.0]), 2)
    >>> D.real.tolist()
    [3.0, 2.0]
    """
    V, D = _sorted_eig(A)
    return V[:, :n], D[:n]


def leig(A: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """The ``n`` eigenvectors of ``A`` of smallest |eigenvalue|, in the
    order of :func:`peig` (the smallest last).

    >>> V, D = leig(np.diag([1.0, 3.0, 2.0]), 2)
    >>> D.real.tolist()
    [2.0, 1.0]
    """
    V, D = _sorted_eig(A)
    return V[:, -n:], D[-n:]


def _sorted_eig(A: np.ndarray):
    D, V = np.linalg.eig(np.asarray(A))
    order = np.argsort(np.abs(D))[::-1]
    return V[:, order], D[order]


def _eigh(A):
    """``(w, v)`` of a (batched) Hermitian tensor or array, ascending."""
    if isinstance(A, torch.Tensor):
        return torch.linalg.eigh(A)
    return np.linalg.eigh(np.asarray(A))


def peig_h(A, n: int):
    """The ``n`` dominant eigenvectors of a (batched) Hermitian tensor or
    array and their eigenvalues, largest first.

    >>> V, D = peig_h(torch.diag(torch.tensor([1.0, 3.0, 2.0])), 2)
    >>> D.tolist(), V.abs().argmax(dim=0).tolist()
    ([3.0, 2.0], [1, 2])
    """
    w, v = _eigh(A)
    if isinstance(w, torch.Tensor):
        w, v = w.flip(-1), v.flip(-1)
    else:
        w, v = w[..., ::-1], v[..., ::-1]
    return v[..., :n], w[..., :n]


def leig_h(A, n: int):
    """The ``n`` least eigenvectors of a (batched) Hermitian tensor or
    array and their eigenvalues, smallest first.

    >>> V, D = leig_h(np.diag([1.0, 3.0, 2.0]), 1)
    >>> D.tolist(), np.abs(V[:, 0]).tolist()
    ([1.0], [1.0, 0.0, 0.0])
    """
    w, v = _eigh(A)
    return v[..., :n], w[..., :n]


def calc_unorm_autocorr(x) -> np.ndarray:
    """Unnormalized autocorrelation of a 1-D array, lags 0..N-1.

    >>> calc_unorm_autocorr(np.array([4, 2, 1, 3, 7, 3, 8])).tolist()
    [152, 79, 82, 53, 42, 28, 32]
    """
    x = np.asarray(x)
    return np.correlate(x, x, mode="full")[x.shape[0] - 1:]


def calc_autocorr(x) -> np.ndarray:
    """Autocorrelation of the mean-removed ``x`` over its (biased)
    variance: 1 at lag 0, zeros for a constant ``x``.

    >>> calc_autocorr(np.array([4, 2, 1, 3, 7, 3, 8])).round(3).tolist()
    [1.0, -0.025, 0.15, -0.175, -0.25, -0.2, 0.0]
    """
    x = np.asarray(x, dtype=float)
    var = x.var()
    N = x.shape[0]
    if var == 0:
        return np.zeros(N)
    return calc_unorm_autocorr(x - x.mean()) / (N * var)


def update_inv_sum_diag(invA: np.ndarray, diagonal) -> np.ndarray:
    """``inv(A + diag(diagonal))`` from ``inv(A)`` by one Sherman-Morrison
    update per diagonal entry (on the host).

    >>> A = np.array([[2.0, 1.0], [1.0, 3.0]])
    >>> bool(np.allclose(update_inv_sum_diag(np.linalg.inv(A), [1.0, 2.0]),
    ...                  np.linalg.inv(A + np.diag([1.0, 2.0]))))
    True
    """
    inv = invA
    diagonal = np.asarray(diagonal)
    for p in range(invA.shape[-1]):
        d = diagonal[..., p]
        col = inv[..., :, p]
        row = inv[..., p, :]
        denom = 1.0 + d * inv[..., p, p]
        inv = inv - (d / denom)[..., None, None] * (
            col[..., :, None] * row[..., None, :])
    return inv


def get_principal_component_matrix(A: np.ndarray,
                                   num_components: int) -> np.ndarray:
    """The matrix of the ``num_components`` most significant components
    of ``A``, with the dead dimensions removed: ``U S V^H`` cut to
    ``num_components`` singular values and columns (on the host).

    >>> A = np.array([[3.0, 0.0], [0.0, 1e-9]])
    >>> get_principal_component_matrix(A, 1).shape
    (2, 1)
    """
    u, s, vh = np.linalg.svd(A, full_matrices=False)
    n = num_components
    return (u[..., :n] * s[..., None, :n]) @ vh[..., :n, :n]


# ---------------------------------------------------------------------------
# Linear algebra of the block-diagonalization family (numpy or torch)
# ---------------------------------------------------------------------------

# Relative cutoff of every pseudo-inverse, the JAX package's
# (``ops/cplx.py`` ``pinv``): its float32 Gram-route SVD returns the zero
# singular values of a rank-deficient input at ~3e-4 of the largest, so
# anything conditioned worse than 1e3 is truncated there.
PINV_RCOND = 1e-3


def pinv(a, rcond: float = PINV_RCOND):
    """Moore-Penrose pseudo-inverse of ``a`` (..., m, n) that drops the
    singular values at or below ``rcond`` times the largest, as the JAX
    package's does. A tensor goes through ``torch.linalg.pinv`` (its SVD
    needs no refinement), numpy through ``np.linalg.pinv``; both keep a
    singular value only when it is strictly above the cutoff.

    >>> w = pinv(np.diag([1.0, 1e-4]))
    >>> w.tolist()                          # the weak direction is dropped
    [[1.0, 0.0], [0.0, 0.0]]
    """
    if isinstance(a, torch.Tensor):
        return torch.linalg.pinv(a, rtol=rcond)
    return np.linalg.pinv(np.asarray(a), rcond=rcond)


def least_right_singular_vectors(A, n: int):
    """Split the right singular vectors of ``A`` by singular value (on the
    host): ``(V0, V1, S)``, where ``V0`` holds the ``n`` least significant
    right singular vectors, ``V1`` the others and ``S`` the singular values
    of ``V1``'s columns, all in ASCENDING singular-value order (the columns
    of a full SVD without a singular value, the null space, come first).

    >>> A = np.array([[1.0, 0.0, 0.0], [0.0, 2.0, 0.0]])
    >>> V0, V1, S = least_right_singular_vectors(A, 1)
    >>> np.abs(V0[:, 0]).tolist(), S.tolist()
    ([0.0, 0.0, 1.0], [1.0, 2.0])
    """
    A = np.asarray(A)
    _, s, vh = np.linalg.svd(A, full_matrices=True)
    V = np.conj(vh.T)[:, ::-1]
    s_asc = s[::-1]
    num_null = V.shape[1] - s_asc.size
    return V[:, :n], V[:, n:], s_asc[max(n - num_null, 0):]


def calc_decorrelation_matrix(cov_matrix):
    """Matrix ``W`` with ``W^H R W`` diagonal: the eigenvectors of the
    Hermitian covariance ``R`` (a batched tensor or an array).

    >>> R = np.array([[2.0, 1.0], [1.0, 2.0]])
    >>> W = calc_decorrelation_matrix(R)
    >>> np.abs(W.T @ R @ W).round(12).tolist()
    [[1.0, 0.0], [0.0, 3.0]]
    """
    return _eigh(cov_matrix)[1]


def calc_whitening_matrix(cov_matrix):
    """Whitening matrix ``W`` with ``W^H R W = I``: ``W = V diag(w)^-1/2``
    from the eigendecomposition of the Hermitian covariance ``R`` (numpy or
    a batched tensor). Eigenvalues are floored at ``1e-12`` of the largest
    (and at a tiny absolute floor), so a singular covariance gives a finite
    whitener.

    >>> R = np.array([[4.0, 0.0], [0.0, 1.0]])
    >>> W = calc_whitening_matrix(R)
    >>> bool(np.allclose(W.conj().T @ R @ W, np.eye(2)))
    True
    """
    if isinstance(cov_matrix, torch.Tensor):
        w, v = torch.linalg.eigh(cov_matrix)
        floor = torch.clamp(w[..., -1:] * 1e-12, min=1e-37)
        w = torch.maximum(w, floor)
        return v * (w[..., None, :] ** -0.5).to(v.dtype)
    w, v = np.linalg.eigh(cov_matrix)
    floor = np.maximum(w[..., -1:] * 1e-12,
                       1e-300 if w.dtype == np.float64 else 1e-37)
    w = np.maximum(w, floor)
    return v * (w[..., None, :] ** -0.5)


def calc_shannon_sum_capacity(sinrs):
    """Sum of ``log2(1 + sinr)`` over all streams (numpy or a tensor).

    >>> float(calc_shannon_sum_capacity(np.array([1.0, 3.0])))
    3.0
    """
    if isinstance(sinrs, torch.Tensor):
        return torch.log2(1.0 + sinrs).sum()
    return np.sum(np.log2(1.0 + np.asarray(sinrs)))


# ---------------------------------------------------------------------------
# Host-side formatting helpers
# ---------------------------------------------------------------------------


def pretty_time(time_in_seconds: float) -> str:
    """Human-readable elapsed time.

    Examples
    --------
    >>> pretty_time(65)
    '1m:05s'
    >>> pretty_time(3723)
    '1h:02m:03s'
    """
    seconds = float(time_in_seconds)
    minutes = int(seconds // 60)
    seconds_int = int(round(seconds % 60))
    hours = minutes // 60
    minutes %= 60
    if hours > 0:
        return f"{hours}h:{minutes:02d}m:{seconds_int:02d}s"
    if minutes > 0:
        return f"{minutes}m:{seconds_int:02d}s"
    return f"{seconds:.2f}s"


def get_range_representation(array: np.ndarray,
                             filename_mode: bool = False) -> Optional[str]:
    """Compact arithmetic-progression representation of an array:
    ``[0, 5, 10, 15] -> '0:5:15'`` (or ``'0_(5)_15'`` in filename mode).
    Returns None if not an arithmetic progression."""
    array = np.asarray(array)
    if not np.issubdtype(array.dtype, np.number):
        return None  # string/object parameter sweeps have no range form
    if array.size == 1:
        return _fmt_num(array.flat[0])
    steps = np.diff(array.astype(float))
    if not np.allclose(steps, steps[0]):
        return None
    step = steps[0]
    lo, hi = array.flat[0], array.flat[-1]
    if filename_mode:
        return f"{_fmt_num(lo)}_({_fmt_num(step)})_{_fmt_num(hi)}"
    return f"{_fmt_num(lo)}:{_fmt_num(step)}:{_fmt_num(hi)}"


def get_mixed_range_representation(array: np.ndarray,
                                   filename_mode: bool = False) -> str:
    """Range representation with several arithmetic runs: each run of at
    least three values becomes ``start:step:stop``, the rest stay single.

    >>> get_mixed_range_representation(np.array([1, 2, 3, 4, 5, 10, 15, 20]))
    '1:1:5,10:5:20'
    >>> get_mixed_range_representation(np.array([0, 7, 8]))
    '0,7,8'
    """
    flat = np.asarray(array).astype(float).ravel()
    n = flat.size
    parts = []
    i = 0
    while i < n:
        # greedily extend an arithmetic run starting at i
        j = i + 1
        if j < n:
            step = flat[j] - flat[i]
            while j + 1 < n and np.isclose(flat[j + 1] - flat[j], step):
                j += 1
        if j < n and j - i + 1 >= 3:
            parts.append(get_range_representation(flat[i:j + 1],
                                                  filename_mode))
            i = j + 1
        else:
            parts.append(_fmt_num(flat[i]))
            i += 1
    return ",".join(parts)


def _fmt_num(x) -> str:
    xf = float(x)
    if xf == int(xf):
        return str(int(xf))
    return f"{xf:g}"


def replace_dict_values(name: str,
                        dictionary: Dict[str, Any],
                        filename_mode: bool = False) -> str:
    """Template substitution ``'results_{M}_{SNR}'`` with dict values, using
    compact range representations for arrays."""
    rep: Dict[str, Any] = {}
    for k, v in dictionary.items():
        if isinstance(v, np.ndarray):
            r = get_range_representation(v, filename_mode)
            if r is None:
                numeric = np.issubdtype(v.dtype, np.number)
                r = ",".join(_fmt_num(e) if numeric else str(e)
                             for e in v.ravel())
                if filename_mode:
                    r = r.replace(",", "_")
            rep[k] = f"[{r}]"
        else:
            rep[k] = v
    return name.format(**rep)


def equal_dicts(a: Dict[Any, Any],
                b: Dict[Any, Any],
                ignore_keys=()) -> bool:
    """Dict equality ignoring some keys; array-aware."""
    ka = set(a.keys()) - set(ignore_keys)
    kb = set(b.keys()) - set(ignore_keys)
    if ka != kb:
        return False
    for k in ka:
        va, vb = a[k], b[k]
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            if not np.array_equal(np.asarray(va), np.asarray(vb)):
                return False
        elif va != vb:
            return False
    return True
