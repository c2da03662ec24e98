"""The port's batched fixed-iteration Max-SINR solver and its 'svd' init
(pyphysim_tpu_torch/ia/batched.py) held against pyphysim_tpu.ia.batched on
identical numpy channels and identical inits ('svd' or 'fix'). The other
solvers are in test_torch_ia_solvers.py, the stream searches in
test_torch_ia_search.py.

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
from pyphysim_tpu_torch.ops.streams import AttemptStreams  # noqa: E402

B = 16
NV = 0.1
KEY = jax.random.PRNGKey(0)


def _crandn(rng, *shape):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            / np.sqrt(2)).astype(np.complex64)


def _unit(rng, *shape):
    f = _crandn(rng, *shape)
    return f / np.linalg.norm(f, axis=(-2, -1), keepdims=True)


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


def _proj(F):
    F = _np(F)
    return F @ np.conj(np.swapaxes(F, -1, -2))


@pytest.mark.parametrize("K,N,Ns,init", [(3, 2, 1, "svd"), (2, 4, 2, "svd"),
                                         (3, 4, (2, 1, 2), "fix")])
def test_max_sinr_matches_jax(K, N, Ns, init):
    rng = np.random.default_rng(K * N)
    H = _crandn(rng, B, K, K, N, N)
    ns_max = Ns if isinstance(Ns, int) else max(Ns)
    F0 = _unit(rng, B, K, N, ns_max)
    if not isinstance(Ns, int):
        F0[..., 1, :, 1] = 0.0                 # user 1 has one stream
        F0 /= np.linalg.norm(F0, axis=(-2, -1), keepdims=True)
    F, U = tb.max_sinr_solve(torch.from_numpy(H), None, Ns, 1.0, NV, 3, init,
                             torch.from_numpy(F0))
    jF, jU = _jax(lambda h, f: jb.max_sinr_solve(h, KEY, Ns, 1.0, NV, 3, init,
                                                 f), H, F0)
    sinr = tb.calc_sinrs(torch.from_numpy(H), F, U, NV, Ns=Ns).numpy()
    jsinr = np.asarray(_jax(lambda h, f, u: jb.calc_sinrs(h, f, u, NV,
                                                          Ns=Ns), H, _np(jF),
                            _np(jU)))
    np.testing.assert_allclose(sinr, jsinr, rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(_proj(F), _proj(jF), atol=2e-3)
    np.testing.assert_allclose(_proj(U), _proj(jU), atol=2e-3)


def test_svd_init_and_random_precoders():
    rng = np.random.default_rng(1)
    H = _crandn(rng, B, 3, 3, 4, 4)
    F = tb.svd_init_precoders(torch.from_numpy(H), (2, 1, 2))
    jF = _jax(lambda h: jb.svd_init_precoders(h, (2, 1, 2)), H)
    np.testing.assert_allclose(_proj(F), _proj(jF), atol=1e-4)
    assert float(F[:, 1, :, 1].abs().max()) == 0.0
    g = torch.Generator().manual_seed(3)
    R = tb.random_unit_precoders(g, 3, 4, (2, 1, 2), batch_shape=(5,))
    assert R.shape == (5, 3, 4, 2) and float(R[:, 1, :, 1].abs().max()) == 0
    np.testing.assert_allclose(
        (R.abs() ** 2).sum(dim=(-2, -1)).numpy(), 1.0, rtol=1e-5)
    S = tb.random_unit_precoders(AttemptStreams.from_range(7, 0, 4, "cpu"),
                                 3, 2, 1)
    assert S.shape == (4, 3, 2, 1)
