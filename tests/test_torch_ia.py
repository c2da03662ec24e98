"""The port's host IA solvers (pyphysim_tpu_torch/ia/algorithms.py,
iabase.py) and its MultiUserChannelMatrix (channels/multiuser.py) held
against the JAX package on the same numpy channels, and the alignment
properties of tests/test_ia.py on the port.

Tolerances and why: both packages run the same numpy code on the same
complex64 channel blocks and the same seeded RandomState inits, so
precoders, filters, SINRs and capacities agree to 1e-6 relative (numpy's
LAPACK in both); the channel matrix's own products run in float32 through
torch and through XLA, rtol 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pyphysim_tpu.channels import \
    MultiUserChannelMatrix as J_MU  # noqa: E402
from pyphysim_tpu import ia as jia  # noqa: E402
from pyphysim_tpu_torch import ia  # noqa: E402
from pyphysim_tpu_torch.channels import MultiUserChannelMatrix  # noqa: E402


def _crandn(rng, *shape):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            / np.sqrt(2)).astype(np.complex64)


def _pair(K=3, Nr=2, Nt=2, seed=0, noise_var=1e-4):
    """The same numpy channel in both packages' channel objects."""
    big = _crandn(np.random.default_rng(seed), K * Nr, K * Nt)
    mu = MultiUserChannelMatrix(device="cpu")
    mu.init_from_channel_matrix(big, Nr, Nt, K)
    mu.noise_var = noise_var
    jmu = J_MU()
    jmu.init_from_channel_matrix(big, Nr, Nt, K)
    jmu.noise_var = noise_var
    return mu, jmu


def _stack(objs):
    return np.concatenate([np.asarray(o).ravel() for o in objs])


@pytest.mark.parametrize("name,Ns,Nr", [
    ("ClosedFormIASolver", 1, 2), ("AlternatingMinIASolver", 1, 2),
    ("MinLeakageIASolver", 1, 2), ("MaxSinrIASolver", 1, 2),
    ("MMSEIASolver", 1, 2), ("MaxSinrIASolver", 2, 4)])
def test_host_solver_matches_jax(name, Ns, Nr):
    mu, jmu = _pair(Nr=Nr, Nt=Nr, seed=10 + Nr, noise_var=0.05)
    s, js = getattr(ia, name)(mu), getattr(jia, name)(jmu)
    for x in (s, js):
        x.set_precoder_seed(21)
        if name != "ClosedFormIASolver":
            x.max_iterations = 12
    s.solve(Ns, P=1.0)
    js.solve(Ns, P=1.0)
    np.testing.assert_allclose(_stack(s.calc_SINR()), _stack(js.calc_SINR()),
                               rtol=1e-6)
    assert s.calc_sum_capacity() == pytest.approx(js.calc_sum_capacity(),
                                                  rel=1e-6)
    np.testing.assert_allclose(_stack(s.F), _stack(js.F), rtol=1e-6,
                               atol=1e-7)
    assert s.get_cost() == pytest.approx(js.get_cost(), rel=1e-6, abs=1e-9)


def test_meta_solvers_match_jax():
    mu, jmu = _pair(K=3, Nr=4, Nt=4, seed=8, noise_var=0.1)
    inner, jinner = ia.MaxSinrIASolver(mu), jia.MaxSinrIASolver(jmu)
    for x in (inner, jinner):
        x.max_iterations = 10
        x.set_precoder_seed(3)
    g, jg = ia.GreedStreamIASolver(inner), jia.GreedStreamIASolver(jinner)
    g.solve(Ns=2, P=1.0)
    jg.solve(Ns=2, P=1.0)
    np.testing.assert_allclose(g.every_sum_capacity, jg.every_sum_capacity,
                               rtol=1e-6)
    mu, jmu = _pair(K=2, Nr=2, Nt=2, seed=9, noise_var=0.1)
    b = ia.BruteForceStreamIASolver(ia.AlternatingMinIASolver(mu))
    jb = jia.BruteForceStreamIASolver(jia.AlternatingMinIASolver(jmu))
    for x in (b, jb):
        x.iasolver.max_iterations = 10
        x.solve(Ns=2, P=1.0)
    assert b.stream_combinations == jb.stream_combinations
    np.testing.assert_allclose(b.every_sum_capacity, jb.every_sum_capacity,
                               rtol=1e-6)
    assert list(b.iasolver.Ns) == list(jb.iasolver.Ns)


def test_channel_matrix_matches_jax():
    mu, jmu = _pair(K=3, Nr=2, Nt=2, seed=4, noise_var=0.3)
    rng = np.random.default_rng(5)
    F = [_crandn(rng, 2, 1) for _ in range(3)]
    U = [_crandn(rng, 2, 1) for _ in range(3)]
    Fj = [_crandn(rng, 6, 1) for _ in range(3)]     # joint processing
    for k in range(3):
        np.testing.assert_allclose(mu.calc_Q(k, F).numpy(),
                                   jmu.calc_Q(k, F).to_numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(mu.calc_JP_Q(k, Fj).numpy(),
                                   jmu.calc_JP_Q(k, Fj).to_numpy(),
                                   rtol=1e-5, atol=1e-6)
    for got, want in zip(mu.calc_SINR(F, U), jmu.calc_SINR(F, U)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    for got, want in zip(mu.calc_JP_SINR(Fj, U), jmu.calc_JP_SINR(Fj, U)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(mu.H.numpy(), jmu.H.to_numpy())
    # transmission: big_H data + noise, per user
    mu.noise_var = 0.0
    jmu.noise_var = 0.0
    data = [_crandn(rng, 2, 5) for _ in range(3)]
    for got, want in zip(mu.corrupt_data(data), jmu.corrupt_data(data)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["randn_c_RS", "peig", "leig",
                                  "update_inv_sum_diag",
                                  "get_principal_component_matrix"])
def test_misc_helpers_match_jax(name):
    """The numpy helpers the host solvers use, copied into the port: the
    same numpy code on the same input, so equal to 1e-6."""
    from pyphysim_tpu.utils import misc as jmisc
    from pyphysim_tpu_torch.utils import misc
    rng = np.random.default_rng(9)
    A = _crandn(rng, 4, 4).astype(np.complex128)
    A = A @ A.conj().T + np.eye(4)
    args = {"randn_c_RS": lambda: (np.random.RandomState(2), 3, 2),
            "peig": lambda: (A, 2), "leig": lambda: (A, 2),
            "update_inv_sum_diag": lambda: (np.linalg.inv(A),
                                            np.array([0.5, 1.0, 2.0, 0.0])),
            "get_principal_component_matrix": lambda: (A[:, :3], 2)}[name]
    got, want = getattr(misc, name)(*args()), getattr(jmisc, name)(*args())
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-12)


def test_channel_matrix_draws_and_seeds():
    mu = MultiUserChannelMatrix(device="cpu")
    mu.set_channel_seed(3)
    mu.randomize(2, 3, 2)
    first = mu.big_H.clone()
    assert first.shape == (4, 6) and first.dtype == torch.complex64
    assert mu.get_Hkl(1, 0).shape == (2, 3)
    mu.set_channel_seed(3)
    mu.randomize(2, 3, 2)
    assert torch.equal(mu.big_H, first)
    mu.set_pathloss(np.array([[1.0, 0.25], [0.25, 1.0]]))
    np.testing.assert_allclose(mu.get_Hkl(0, 1).numpy(),
                               0.5 * first[:2, 3:].numpy())
    mu.noise_var = 0.5
    mu.set_noise_seed(1)
    out = mu.corrupt_concatenated_data(np.ones((6, 4), np.complex64))
    assert isinstance(out, np.ndarray) and out.shape == (4, 4)
    assert mu.last_noise is not None
    mu.set_post_filter([np.eye(2, dtype=np.complex64)] * 2)
    assert mu.big_W.shape == (4, 4)
    with pytest.raises(ValueError, match="dimensions"):
        mu.init_from_channel_matrix(np.ones((3, 3)), 2, 2, 2)


# -- the alignment properties of tests/test_ia.py, on the port ------------

def make_channel(K=3, Nr=2, Nt=2, seed=0, noise_var=1e-4):
    mu = MultiUserChannelMatrix(device="cpu")
    mu.set_channel_seed(seed)
    mu.randomize(Nr, Nt, K)
    mu.noise_var = noise_var
    return mu


def total_leakage(solver):
    leak = 0.0
    for k in range(solver.K):
        Wk = solver.W[k]
        leak += float(np.trace(np.abs(Wk.conj().T @ solver.calc_Q(k) @ Wk)))
    return leak


def test_closed_form_aligns_perfectly():
    solver = ia.ClosedFormIASolver(make_channel(seed=2))
    solver.solve(Ns=1)
    assert total_leakage(solver) < 1e-8
    assert all(float(s) > 1e3 for s in np.hstack(solver.calc_SINR()))
    assert solver.calc_sum_capacity() > 10
    with pytest.raises(AssertionError):
        ia.ClosedFormIASolver(make_channel(K=2)).solve(Ns=1)


@pytest.mark.parametrize("name", ["AlternatingMinIASolver",
                                  "MinLeakageIASolver", "MaxSinrIASolver",
                                  "MMSEIASolver"])
def test_iterative_solvers_reduce_leakage(name):
    solver = getattr(ia, name)(make_channel(seed=3))
    solver.set_precoder_seed(5)
    solver.max_iterations = 100
    iters = solver.solve(Ns=1, P=1.0)
    assert 1 <= iters <= 100
    sig = sum(np.linalg.norm(solver.W[k].conj().T @ solver._get_channel(k, k)
                             @ solver.full_F[k]) ** 2 for k in range(3))
    assert total_leakage(solver) < 0.05 * sig


def test_max_sinr_capacity_grows_with_power_and_options():
    caps = []
    for P in (0.1, 1.0, 10.0):
        solver = ia.MaxSinrIASolver(make_channel(seed=4))
        solver.set_precoder_seed(17)
        solver.max_iterations = 60
        solver.solve(Ns=1, P=P)
        caps.append(solver.calc_sum_capacity())
    assert caps[0] < caps[1] < caps[2]
    for init in ("random", "svd", "alt_min", "closed_form"):
        solver = ia.MaxSinrIASolver(make_channel(seed=5))
        solver.initialize_with = init
        solver.max_iterations = 20
        solver.solve(Ns=1, P=1.0)
        assert solver.F is not None
    with pytest.raises(RuntimeError):
        solver.initialize_with = "bogus"
    fix = ia.MaxSinrIASolver(make_channel(seed=6))
    fix.initialize_with = "fix"
    with pytest.raises(RuntimeError):
        fix.solve(Ns=1, P=1.0)
    with pytest.raises(ValueError):
        ia.MaxSinrIASolver("not a channel")
