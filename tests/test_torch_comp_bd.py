"""The port's stream-sacrifice BD (``comm.batched.enhanced_bd_batched``,
metrics None / naive / fixed) held against the JAX package on the same
numpy draws, and the pseudo-inverse cutoff both packages share.

Inputs, tolerances and checks: ``tests/torch_comp_bd_checks.py``.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))

from pyphysim_tpu.comm.batched import \
    bd_receive_filter_batched as j_rx  # noqa: E402
from pyphysim_tpu.comm.batched import \
    enhanced_bd_batched as j_ebd  # noqa: E402
from pyphysim_tpu.mimo import Blast as JBlast  # noqa: E402
from pyphysim_tpu.ops import cplx  # noqa: E402
from pyphysim_tpu_torch.comm.batched import (  # noqa: E402
    bd_receive_filter_batched, enhanced_bd_batched)
from pyphysim_tpu_torch.mimo import Blast  # noqa: E402
from pyphysim_tpu_torch.utils.misc import PINV_RCOND, pinv  # noqa: E402
from torch_comp_bd_checks import (K, NR, PT, check_against_jax,  # noqa: E402
                                  comp_bd_draws, jax_out, port_run)


@pytest.fixture(scope="module")
def square():
    H, R = comp_bd_draws(0)
    return H, R


@pytest.mark.parametrize("metric, kw", [
    (None, {}), ("naive", {"num_streams": 1}), ("fixed", {"num_streams": 1}),
    ("naive", {"num_streams": 2})])
def test_enhanced_bd_matches_jax(square, metric, kw):
    H, R = square
    got, exact = port_run(H, R, metric=metric, **kw)
    want = jax_out(j_ebd(cplx.carray(H), cplx.carray(R), K, PT,
                         metric=metric, **kw))
    check_against_jax(got, want, exact)
    assert got[4].all()       # every draw of these scales is healthy


def test_filters_block_diagonalize(square):
    """``W_k H_k Ms_j = delta_kj I``: each user's filter inverts its own
    stream channel and the other users' precoders are nulled at it."""
    H, R = square
    Ms, W, Ns, _, valid = enhanced_bd_batched(
        torch.from_numpy(H), torch.from_numpy(R), K, PT, metric=None)
    jMs, jW = jax_out(j_ebd(cplx.carray(H), cplx.carray(R), K, PT))[:2]
    Ht = torch.from_numpy(H)
    unit = np.arange(H.shape[0]) >= H.shape[0] - 16
    for k in range(K):
        Hk = Ht[:, k * NR:(k + 1) * NR, :]
        for j in range(K):
            prod = (W[:, k] @ Hk @ Ms[:, j]).numpy()
            if j == k:
                np.testing.assert_allclose(prod, np.broadcast_to(
                    np.eye(NR), prod.shape), atol=1e-4)
                continue
            cross = np.abs(prod).max(axis=(-2, -1))
            bound = (torch.linalg.matrix_norm(W[:, k]) *
                     torch.linalg.matrix_norm(Hk) *
                     torch.linalg.matrix_norm(Ms[:, j])).numpy()
            assert (cross <= 1e-5 * bound)[unit].all()
            jcross = np.abs(jW[:, k] @ H[:, k * NR:(k + 1) * NR, :] @
                            jMs[:, j]).max(axis=(-2, -1))
            assert (cross <= np.maximum(1e-5 * bound, 4 * jcross)).all()
    assert (Ns.numpy() == NR).all()


def test_bad_arguments_raise(square):
    H, R = (torch.from_numpy(x) for x in square)
    with pytest.raises(ValueError, match="unknown metric"):
        enhanced_bd_batched(H, R, K, PT, metric="bogus")
    with pytest.raises(ValueError, match="num_streams"):
        enhanced_bd_batched(H, R, K, PT, metric="fixed", num_streams=3)
    with pytest.raises(ValueError, match="modulator"):
        enhanced_bd_batched(H, R, K, PT, metric="effective_throughput")
    with pytest.raises(ValueError, match="Nt_total"):
        enhanced_bd_batched(H[..., :5], R, K, PT)


# -- the pseudo-inverse cutoff ---------------------------------------------

def cutoff_probe():
    """Four 4x4 complex64 matrices, one row of each scaled by 1e-4
    (condition number ~1e4): the JAX package drops that direction (its
    cutoff is 1e-3 of the largest singular value); a pseudo-inverse with
    torch's default cutoff (~1e-7 relative) keeps it."""
    rng = np.random.default_rng(7)
    A = (rng.standard_normal((4, 4, 4)) +
         1j * rng.standard_normal((4, 4, 4))).astype(np.complex64)
    A[:, 2, :] *= 1e-4
    return A


def test_pinv_drops_what_the_jax_package_drops():
    A = cutoff_probe()
    want = cplx.pinv(cplx.carray(A)).to_numpy()
    got = pinv(torch.from_numpy(A)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-5 * scale)
    # the weak direction is truncated: W A is a projector, not I
    assert np.abs(got @ A - np.eye(4)).max() > 0.5
    # the numpy route has the same semantics
    np.testing.assert_allclose(pinv(A.astype(np.complex128)), want,
                               atol=1e-5 * scale)
    assert PINV_RCOND == 1e-3


def test_bd_receive_filter_and_zero_forcing_cut_off_as_jax():
    """The two filters that took torch's default cutoff before the repair
    (the BD receive filter and BLAST's zero forcing) match the JAX
    package's on the cond ~1e4 probe; with the default they differed by
    the whole weak direction."""
    A = cutoff_probe()
    want = j_rx(cplx.carray(A)).to_numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(bd_receive_filter_batched(
        torch.from_numpy(A)).numpy(), want, atol=1e-5 * scale)
    jzf = JBlast._calcZeroForceFilter(cplx.carray(A)).to_numpy()
    zf = Blast._calcZeroForceFilter(torch.from_numpy(A)).numpy()
    np.testing.assert_allclose(zf, jzf, atol=1e-5 * np.abs(jzf).max())
    assert np.abs(torch.linalg.pinv(torch.from_numpy(A)).numpy() -
                  want).max() > 0.5 * scale
