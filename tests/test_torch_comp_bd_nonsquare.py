"""The port's batched external-interference BD solvers on the non-square
geometry of ``apps/comp_BD/bd_config_file_nonsquare.txt`` (3 transmit
antennas a base station, 2 receive antennas a user: each user picks its 2
streams from a 5-dimensional null space), held against the JAX package on
the same numpy draws.

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
    enhanced_bd_batched as j_ebd  # noqa: E402
from pyphysim_tpu.comm.batched import \
    whitening_bd_batched as j_wbd  # noqa: E402
from pyphysim_tpu.ops import cplx  # noqa: E402
from pyphysim_tpu_torch.comm.batched import (  # noqa: E402
    enhanced_bd_batched, whitening_bd_batched)
from torch_comp_bd_checks import (  # noqa: E402
    K, NR, PT, check_against_jax, check_whitening_against_jax,
    comp_bd_draws, jax_out, port_run)

NT = 3


@pytest.fixture(scope="module")
def nonsquare():
    return comp_bd_draws(2, nt=NT)


@pytest.mark.parametrize("metric", [None, "capacity"])
def test_enhanced_bd_matches_jax(nonsquare, metric):
    H, R = nonsquare
    got, exact = port_run(H, R, metric=metric)
    want = jax_out(j_ebd(cplx.carray(H), cplx.carray(R), K, PT,
                         metric=metric))
    check_against_jax(got, want, exact, ns_flips=2)
    Ms = got[0]
    assert Ms.shape == (H.shape[0], K, K * NT, NR)
    # each user's precoder lies in the null space of the other users
    for k in range(K):
        for j in range(K):
            if j != k:
                leak = torch.from_numpy(
                    H[:, j * NR:(j + 1) * NR, :]) @ Ms[:, k]
                own = torch.from_numpy(H[:, j * NR:(j + 1) * NR, :]) @ \
                    Ms[:, j]
                assert (leak.abs().amax(dim=(-2, -1)) <=
                        1e-3 * own.abs().amax(dim=(-2, -1))).all()


def test_whitening_bd_matches_jax(nonsquare):
    H, R = nonsquare
    got = [x.numpy() for x in whitening_bd_batched(
        torch.from_numpy(H), torch.from_numpy(R), K, PT)]
    exact = [x.numpy() for x in whitening_bd_batched(
        torch.from_numpy(H.astype(np.complex128)),
        torch.from_numpy(R.astype(np.complex128)), K, PT)]
    want = jax_out(j_wbd(cplx.carray(H), cplx.carray(R), K, PT))
    check_whitening_against_jax(got, want, exact)
    assert got[0].shape == (H.shape[0], K, K * NT, NR)


def test_a_user_with_fewer_transmit_antennas_than_streams_raises():
    H, R = comp_bd_draws(3, B=2, nt=1, unit=0)
    with pytest.raises(ValueError, match="Nt_total"):
        enhanced_bd_batched(torch.from_numpy(H), torch.from_numpy(R), K,
                            PT)
