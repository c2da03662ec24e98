"""The general (K, N, Ns) body of the port's Max-SINR IA kernel
(pyphysim_tpu_torch/ops/ia_kernel.py, N = 4) held against the JAX package.

The JAX kernel's own general body takes ~20 s to compile on a CPU, so the
plain version is held against the JAX XLA solver ``max_sinr_solve(init=
'fix')`` + ``calc_sinrs`` fed the same orthogonal-iteration init, at rtol
5e-3: tests/test_ia_pallas.py's tolerance between the JAX general body and
that solver (LDL^H solves against the solver's LU on the real embedding).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from pyphysim_tpu.ia.batched import (calc_sinrs, max_sinr_solve,  # noqa: E402
                                     sum_capacity)
from pyphysim_tpu.ops import cplx  # noqa: E402
from pyphysim_tpu_torch.ops.ia_kernel import MonteCarloMaxSinr  # noqa: E402
from pyphysim_tpu_torch.ops.planes import orth_iter_init  # noqa: E402


def _bits(seed, mc, reps, num_tiles):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, (reps, num_tiles * mc.tile,
                                     mc.num_planes * mc.lane),
                        dtype=np.uint32)


@pytest.mark.parametrize("K,N,Ns", [(3, 4, 1), (2, 4, 2)])
def test_general_body_matches_jax_solver_fix_init(K, N, Ns):
    mc = MonteCarloMaxSinr(tile=8, lane=128, iterations=2, K=K, N=N, Ns=Ns,
                           init_iters=4, device="cpu")
    bits = _bits(100 + 10 * K + Ns, mc, 1, 1)
    got = mc.build_inject(1, 1)(bits, 0.1).numpy()

    H = mc.channels(torch.from_numpy(bits.view(np.int32))).reshape(
        -1, K, K, N, N)
    F0 = orth_iter_init(H.diagonal(dim1=-4, dim2=-3).movedim(-1, -3), Ns,
                        4) / np.sqrt(Ns)

    def one(h, f0):
        F, U = max_sinr_solve(h, jax.random.PRNGKey(0), Ns=Ns,
                              noise_var=0.1, iterations=2, init="fix", F0=f0)
        return sum_capacity(calc_sinrs(h, F, U, 0.1, 1.0, Ns=Ns))

    caps = np.asarray(jax.jit(jax.vmap(one))(
        cplx.from_numpy(H.numpy()), cplx.from_numpy(F0.numpy())))
    np.testing.assert_allclose(got, caps.reshape(1, 1, -1).sum(-1),
                               rtol=5e-3)
    mean = got.sum() / mc.solves_per_grid_step
    assert 1.0 < mean < 60.0, mean
