"""The port's stream-count selection (``enhanced_bd_batched`` with the
capacity and effective-throughput metrics) and whitening BD
(``whitening_bd_batched``) held against the JAX package on the same numpy
draws, K = 3 users of 2x2.

Inputs, tolerances and checks: ``tests/torch_comp_bd_checks.py``. The
``argmax`` over candidate stream counts may flip where two candidates
nearly tie; a flip is allowed only on a draw whose two candidates' metric
values lie within 1e-3 of each other (none does on these draws).
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(__file__))

from pyphysim_tpu.comm.batched import \
    enhanced_bd_batched as j_ebd  # noqa: E402
from pyphysim_tpu.comm.batched import \
    whitening_bd_batched as j_wbd  # noqa: E402
from pyphysim_tpu.modulators import PSK as JPSK  # noqa: E402
from pyphysim_tpu.ops import cplx  # noqa: E402
from pyphysim_tpu_torch.comm.batched import (  # noqa: E402
    enhanced_bd_batched, whitening_bd_batched, whitening_matrix_batched)
from pyphysim_tpu_torch.modulators import PSK  # noqa: E402
from pyphysim_tpu_torch.utils.misc import calc_whitening_matrix  # noqa: E402
from torch_comp_bd_checks import (  # noqa: E402
    K, NR, PT, check_against_jax, check_whitening_against_jax,
    comp_bd_draws, jax_out, port_run)


@pytest.fixture(scope="module")
def square():
    return comp_bd_draws(1)


def candidate_values(H, R, metric, kw):
    """Each draw's metric value of the one-stream and the all-streams
    candidate (the ``fixed`` one-stream and the ``None`` result)."""
    out = []
    for m, extra in (("fixed", {"num_streams": 1}), (None, {})):
        s = enhanced_bd_batched(torch.from_numpy(H), torch.from_numpy(R),
                                K, PT, metric=m, **extra)[3]
        if metric == "capacity":
            out.append(torch.log2(1.0 + s).sum(dim=(-1)))
        else:
            ns = 1 if m == "fixed" else NR
            out.append(kw["modulator"].calcTheoreticalSpectralEfficiency(
                10 * torch.log10(s[..., :ns].clamp(min=1e-30)),
                kw["packet_length"]).sum(dim=-1))
    return [v.numpy() for v in out]


@pytest.mark.parametrize("metric", ["capacity", "effective_throughput"])
def test_stream_selection_matches_jax(square, metric):
    H, R = square
    kw, jkw = {}, {}
    if metric == "effective_throughput":
        kw = {"modulator": PSK(4, device="cpu"), "packet_length": 60}
        jkw = {"modulator": JPSK(4), "packet_length": 60}
    got, exact = port_run(H, R, metric=metric, **kw)
    want = jax_out(j_ebd(cplx.carray(H), cplx.carray(R), K, PT,
                         metric=metric, **jkw))
    check_against_jax(got, want, exact, ns_flips=2)
    v1, v2 = candidate_values(H, R, metric, kw)
    tie = np.abs(v1 - v2) <= 1e-3 * np.maximum(np.abs(v1), np.abs(v2))
    flips = (got[2].numpy() != want[2]).any(axis=-1)
    assert tie[flips].all()
    Ns = got[2].numpy()
    assert ((Ns == 1) | (Ns == NR)).all()
    # the selection sacrifices a stream somewhere, and keeps both elsewhere
    assert (Ns == 1).any() and (Ns == NR).any()
    # the selected candidate is the best one (ties aside)
    best = np.where(v1 > v2, 1, NR)
    assert ((Ns == best) | tie).all()


def test_whitening_bd_matches_jax(square):
    """Precoders and composite receive filters through their phase-free
    Gram forms, and the validity mask, by the rules of the checks module;
    the dropped streams (singular values of the whitened 6x6 channel at or
    below 1e-3 of its largest, as in the JAX package) are the same."""
    H, R = square
    got = [x.numpy() for x in whitening_bd_batched(
        torch.from_numpy(H), torch.from_numpy(R), K, PT)]
    exact = [x.numpy() for x in whitening_bd_batched(
        torch.from_numpy(H.astype(np.complex128)),
        torch.from_numpy(R.astype(np.complex128)), K, PT)]
    want = jax_out(j_wbd(cplx.carray(H), cplx.carray(R), K, PT))
    check_whitening_against_jax(got, want, exact)
    dropped = [np.abs(out[1]).max(axis=-1) == 0 for out in (got, want)]
    np.testing.assert_array_equal(*dropped)


def test_whitening_matrix_whitens(square):
    """``W^H R W = I`` for every user's covariance, batched, and the
    batched whitener is the host helper's."""
    _, R = square
    Rt = torch.from_numpy(R.astype(np.complex128))
    W = whitening_matrix_batched(Rt)
    eye = np.broadcast_to(np.eye(NR), W.shape)
    np.testing.assert_allclose((W.mH @ Rt @ W).numpy(), eye, atol=1e-9)
    np.testing.assert_allclose(calc_whitening_matrix(R[0, 0].astype(
        np.complex128)), W[0, 0].numpy(), rtol=1e-12)
