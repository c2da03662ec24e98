"""The port's batched stream searches (pyphysim_tpu_torch/ia/batched.py
``brute_force_stream_solve``, ``greedy_stream_solve``) held against
pyphysim_tpu.ia.batched on identical numpy channels.

Tolerances and why: the two packages reach the same matrices through other
decompositions (torch.linalg's LAPACK SVD / eigh / LU against the JAX
package's Gram-route SVD, closed-form or Jacobi eigh and real-embedded LU),
in float32, so eigenvectors differ by a phase (and within a degenerate
eigenspace by a rotation). Capacities and SINRs are held per channel at
rtol 2e-3 after a few iterations (a badly conditioned draw carries its
init's float32 differences through the recursion), projectors F F^H at
atol 2e-3; the stream searches must pick the same combination.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from pyphysim_tpu.ia import batched as jb  # noqa: E402
from pyphysim_tpu.ops import cplx  # noqa: E402
from pyphysim_tpu_torch.ia import batched as tb  # noqa: E402

B = 16
NV = 0.1
KEY = jax.random.PRNGKey(0)


def _crandn(rng, *shape):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            / np.sqrt(2)).astype(np.complex64)


def _np(x):
    if isinstance(x, cplx.CArray):
        return x.to_numpy()
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _jax(fn, *arrays):
    """``fn`` vmapped over the batch of numpy (complex) arrays, jitted."""
    args = [cplx.from_numpy(a) if np.iscomplexobj(a) else a for a in arrays]
    return jax.jit(jax.vmap(fn))(*args)


def test_brute_force_search_matches_jax():
    rng = np.random.default_rng(7)
    H = _crandn(rng, 8, 2, 2, 2, 2)
    assert tb.stream_combinations(2, 3) == jb.stream_combinations(2, 3)
    _, _, best, caps = tb.brute_force_stream_solve(
        torch.from_numpy(H), None, 2, 1.0, NV, 3)
    _, _, jbest, jcaps = _jax(lambda h: jb.brute_force_stream_solve(
        h, KEY, 2, 1.0, NV, 3), H)
    np.testing.assert_array_equal(best.numpy(), np.asarray(jbest))
    np.testing.assert_allclose(caps.numpy(), np.asarray(jcaps), rtol=2e-3)


def test_greedy_search_matches_jax():
    """The reference's 'fix' policy against the JAX package: the same
    capacity trajectory and the same streams kept per user (two streams of
    a user with equal SINRs may be deleted in either order)."""
    rng = np.random.default_rng(8)
    H = _crandn(rng, 8, 2, 2, 2, 2)
    _, _, mask, gcaps = tb.greedy_stream_solve(
        torch.from_numpy(H), None, 2, 1.0, NV, 3, candidate_init="fix")
    _, _, jmask, jgcaps = _jax(lambda h: jb.greedy_stream_solve(
        h, KEY, 2, 1.0, NV, 3, candidate_init="fix"), H)
    np.testing.assert_array_equal(mask.sum(-1).numpy(),
                                  np.asarray(jmask).sum(-1))
    np.testing.assert_allclose(gcaps.numpy(), np.asarray(jgcaps), rtol=2e-3)


def test_greedy_svd_policy_is_the_brute_force_solve():
    """With candidate_init='svd' every candidate is the solve the brute
    force search makes for its allocation, so greedy <= brute force."""
    rng = np.random.default_rng(9)
    H = torch.from_numpy(_crandn(rng, 8, 3, 3, 2, 2))
    _, _, _, caps = tb.brute_force_stream_solve(H, None, 2, 1.0, NV, 3)
    _, _, mask, gcaps = tb.greedy_stream_solve(H, None, 2, 1.0, NV, 3,
                                               candidate_init="svd")
    assert bool((gcaps.max(-1).values <= caps.max(-1).values *
                 (1 + 1e-5)).all())
    combos = tb.stream_combinations(2, 3)
    for b in range(8):
        kept = tuple(int(n) for n in mask[b].sum(-1))
        assert float(gcaps[b].max()) == pytest.approx(
            float(caps[b, combos.index(kept)]), rel=1e-5)
