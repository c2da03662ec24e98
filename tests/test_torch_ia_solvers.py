"""The port's batched Min-Leakage, MMSE, alternating-minimization and
closed-form IA solvers (pyphysim_tpu_torch/ia/batched.py) held against
pyphysim_tpu.ia.batched on identical numpy channels, the random init
replaced by the same numpy precoders in both packages (the Max-SINR solver
is in test_torch_ia_batched.py, the stream searches in
test_torch_ia_search.py).

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


def _caps(H, F, U, P=1.0, Ns=None):
    return tb.sum_capacity(tb.calc_sinrs(torch.from_numpy(H),
                                         torch.from_numpy(_np(F)),
                                         torch.from_numpy(_np(U)), NV, P,
                                         Ns=Ns)).numpy()


@pytest.mark.parametrize("solver,N,Ns", [("min_leakage", 2, 1),
                                         ("mmse", 4, 2), ("alt_min", 2, 1)])
def test_random_init_solvers_match_jax(monkeypatch, solver, N, Ns):
    rng = np.random.default_rng(5)
    K = 3
    H = _crandn(rng, B, K, K, N, N)
    F0 = _unit(rng, B, K, N, Ns)
    monkeypatch.setattr(tb, "random_unit_precoders",
                        lambda *a, **k: torch.from_numpy(F0))
    Ht = torch.from_numpy(H)
    if solver == "min_leakage":
        F, U = tb.min_leakage_solve(Ht, None, Ns, 1.0, 4)

        def jfn(h, f0):
            jb_init = jb.random_unit_precoders
            jb.random_unit_precoders = lambda *a: f0
            try:
                return jb.min_leakage_solve(h, KEY, Ns, 1.0, 4)
            finally:
                jb.random_unit_precoders = jb_init
        jF, jU = _jax(jfn, H, F0)
        np.testing.assert_allclose(
            tb.calc_leakage(Ht, F, U).numpy(),
            np.asarray(_jax(lambda h, f, u: jb.calc_leakage(h, f, u), H,
                            _np(jF), _np(jU))), rtol=2e-3, atol=1e-5)
    elif solver == "mmse":
        F, U = tb.mmse_solve(Ht, None, Ns, 1.0, NV, 4)

        def jfn(h, f0):
            jb_init = jb.random_unit_precoders
            jb.random_unit_precoders = lambda *a: f0
            try:
                return jb.mmse_solve(h, KEY, Ns, 1.0, NV, 4)
            finally:
                jb.random_unit_precoders = jb_init
        jF, jU = _jax(jfn, H, F0)
        # the MMSE precoders meet the power constraint
        assert float((F.abs() ** 2).sum(dim=(-2, -1)).max()) <= 1.0 + 1e-4
    else:
        F, U = tb.alt_min_solve(Ht, None, Ns, 1.0, 4, torch.from_numpy(F0))
        jF, jU = _jax(lambda h, f: jb.alt_min_solve(h, KEY, Ns, 1.0, 4, f),
                      H, F0)
        np.testing.assert_allclose(
            tb.alt_min_cost(Ht, F).numpy(),
            np.asarray(_jax(lambda h, f: jb.alt_min_cost(h, f), H, _np(jF))),
            rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(_proj(F), _proj(jF), atol=2e-3)
    np.testing.assert_allclose(_caps(H, F, U), _caps(H, _np(jF), _np(jU)),
                               rtol=2e-3)


def test_closed_form_matches_jax():
    rng = np.random.default_rng(6)
    H = _crandn(rng, B, 3, 3, 2, 2)
    F, U = tb.closed_form_solve(torch.from_numpy(H), 1, 1.0, NV)
    jF, jU = _jax(lambda h: jb.closed_form_solve(h, 1, 1.0, NV), H)
    np.testing.assert_allclose(_caps(H, F, U), _caps(H, _np(jF), _np(jU)),
                               rtol=2e-3)
    # perfect alignment: no interference leaks through the filters
    assert float(tb.calc_leakage(torch.from_numpy(H), F, U).max()) < 1e-6
    with pytest.raises(AssertionError):
        tb.closed_form_solve(torch.from_numpy(H[:, :2, :2]))


# -- the batched solvers and the host solvers on the card ------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_batched_solvers_on_the_card_match_the_cpu(cuda_device):
    """Every batched solver runs on CUDA tensors (``torch.linalg.eig`` of
    the closed form included) and gives the CPU's capacities on the same
    channels and inits: rtol 2e-3, as against the JAX package.

    The closed form is compared where its answer is unique, at 2x2 with
    one stream: at 4x4 with two, its receive filters span the 2-D null
    space of a rank-2 Gram matrix, so any basis of it is right, LAPACK's
    and cuSOLVER's eigh pick different ones, and the per-stream SINRs
    follow the basis. There it must still align
    (leakage under 1e-4, where unaligned filters leak O(1); the CPU's is
    ~1e-6 at float32)."""
    rng = np.random.default_rng(11)
    H = torch.from_numpy(_crandn(rng, B, 3, 3, 4, 4))
    F0 = torch.from_numpy(_unit(rng, B, 3, 4, 2))
    H2 = H[..., :2, :2].contiguous()
    runs = {
        "max_sinr": (H, lambda h, f: tb.max_sinr_solve(h, None, 2, 1.0, NV,
                                                       4, "fix", f)),
        "max_sinr_svd": (H, lambda h, f: tb.max_sinr_solve(h, None, 2, 1.0,
                                                           NV, 4, "svd")),
        "alt_min": (H, lambda h, f: tb.alt_min_solve(h, None, 2, 1.0, 4, f)),
        "closed_form": (H2, lambda h, f: tb.closed_form_solve(h, 1, 1.0,
                                                              NV)),
    }
    for name, (Hc, run) in runs.items():
        want = _caps(Hc.numpy(), *run(Hc, F0))
        F, U = run(Hc.to(cuda_device), F0.to(cuda_device))
        assert F.device == U.device == Hc.to(cuda_device).device, name
        np.testing.assert_allclose(_caps(Hc.numpy(), F.cpu(), U.cpu()),
                                   want, rtol=2e-3, err_msg=name)
    F, U = tb.closed_form_solve(H.to(cuda_device), 2, 1.0, NV)
    assert float(tb.calc_leakage(H, F.cpu(), U.cpu()).max()) < 1e-4
    g = torch.Generator(device=cuda_device).manual_seed(2)
    for solve in (tb.min_leakage_solve, tb.mmse_solve):
        F, U = solve(H.to(cuda_device), g, 2, 1.0)
        assert bool(torch.isfinite(F).all() and torch.isfinite(U).all())
    _, _, best, caps = tb.brute_force_stream_solve(
        H[:4, :, :, :2, :2].to(cuda_device), None, 2, 1.0, NV, 3)
    _, _, cbest, ccaps = tb.brute_force_stream_solve(
        H[:4, :, :, :2, :2], None, 2, 1.0, NV, 3)
    assert torch.equal(best.cpu(), cbest)
    np.testing.assert_allclose(caps.cpu().numpy(), ccaps.numpy(), rtol=2e-3)


@pytest.mark.cuda
def test_host_solver_over_a_channel_on_the_card(cuda_device):
    from pyphysim_tpu_torch.channels import MultiUserChannelMatrix
    from pyphysim_tpu_torch.ia import MaxSinrIASolver
    caps = []
    for dev in ("cpu", cuda_device):
        mu = MultiUserChannelMatrix(device=dev)
        mu.init_from_channel_matrix(_crandn(np.random.default_rng(3), 6, 6),
                                    2, 2, 3)
        mu.noise_var = 0.1
        s = MaxSinrIASolver(mu)
        s.set_precoder_seed(4)
        s.max_iterations = 10
        s.solve(1, P=1.0)
        caps.append(s.calc_sum_capacity())
    assert caps[1] == pytest.approx(caps[0], rel=1e-6)
