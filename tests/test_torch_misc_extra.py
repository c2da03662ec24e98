"""The library's last names of the port against the JAX package, on the CPU.

* ``utils/misc.py``'s ``xor``, ``qfunc_inv``, ``peig_h`` / ``leig_h``,
  ``calc_unorm_autocorr`` / ``calc_autocorr``,
  ``calc_decorrelation_matrix`` and ``get_mixed_range_representation`` on
  the inputs of ``tests/test_utils.py``, in numpy and as tensors. The
  eigenvector helpers are compared through their eigenvalues and
  projectors (a basis column's phase is the backend's choice): rtol 1e-5
  in float32, 1e-10 in float64. Integer and string results are equal.
* ``pointprocess``: the same points bit for bit from the same
  ``RandomState``; a ``torch.Generator`` gives a tensor on its device.
* ``extra``: identical strings.
* ``utils/testing.py`` ``SeedReplay``: capture on failure, replay, delete
  on success, and a ``torch.Generator`` state round trip.
* ``TdlImpulseResponse.plot_impulse_response`` /
  ``plot_frequency_response`` under matplotlib's Agg backend: the plotted
  lines equal the JAX method's (rtol 1e-5; both float32).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pyphysim_tpu.utils import misc as J  # noqa: E402
from pyphysim_tpu_torch.utils import misc as T  # noqa: E402


def _hermitian(seed, shape, dtype=np.complex128):
    rng = np.random.RandomState(seed)
    X = rng.randn(*shape) + 1j * rng.randn(*shape)
    return (X @ np.conj(np.swapaxes(X, -1, -2))).astype(dtype)


def _projector(v):
    v = np.asarray(v)
    return v @ np.conj(np.swapaxes(v, -1, -2))


# -- misc ------------------------------------------------------------------


def test_xor_on_ints_arrays_and_tensors():
    a = np.array([0b1100, 7, 255, 0])
    b = np.array([0b1010, 1, 15, 9])
    want = J.xor(a, b)
    assert np.array_equal(T.xor(a, b), want)
    assert T.xor(12, 10) == J.xor(12, 10) == 6
    got = T.xor(torch.as_tensor(a), torch.as_tensor(b))
    assert isinstance(got, torch.Tensor)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(T.xor(torch.as_tensor(a), 3).numpy(), a ^ 3)


@pytest.mark.parametrize("p", [0.4, 0.1, 0.01, 1e-4, [0.2, 1e-6]])
def test_qfunc_inv(p):
    got = T.qfunc_inv(p)
    assert np.allclose(got, J.qfunc_inv(p), rtol=0, atol=0)
    assert np.allclose(T.qfunc(got), p, rtol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_peig_h_leig_h(n, as_tensor):
    A = _hermitian(4, (3, 4, 4))
    jV, jD = J.peig_h(jnp.asarray(A.astype(np.complex64)), n)
    jVl, jDl = J.leig_h(jnp.asarray(A.astype(np.complex64)), n)
    if as_tensor:
        arg = torch.as_tensor(A.astype(np.complex64))
        rtol = 1e-5
    else:
        arg = A
        rtol = 1e-10
    V, D = T.peig_h(arg, n)
    Vl, Dl = T.leig_h(arg, n)
    assert isinstance(V, torch.Tensor) == as_tensor
    V, D, Vl, Dl = (np.asarray(x) for x in (V, D, Vl, Dl))
    assert V.shape == (3, 4, n) and Vl.shape == (3, 4, n)
    w = np.linalg.eigvalsh(A)
    assert np.allclose(D, w[:, ::-1][:, :n], rtol=rtol)
    assert np.allclose(Dl, w[:, :n], rtol=rtol)
    # against the JAX functions (float32): eigenvalues and projectors
    scale = np.abs(w).max()
    assert np.allclose(D, np.asarray(jD), rtol=1e-5, atol=1e-5 * scale)
    assert np.allclose(Dl, np.asarray(jDl), rtol=1e-5, atol=1e-5 * scale)
    assert np.allclose(_projector(V), _projector(jV), atol=1e-4)
    assert np.allclose(_projector(Vl), _projector(jVl), atol=1e-4)


@pytest.mark.parametrize("x", [[4, 2, 1, 3, 7, 3, 8], [1.5, -2.0, 0.25],
                               [3, 3, 3, 3], [5]])
def test_autocorrelations(x):
    x = np.asarray(x)
    assert np.array_equal(T.calc_unorm_autocorr(x),
                          J.calc_unorm_autocorr(x))
    assert np.allclose(T.calc_autocorr(x), J.calc_autocorr(x), rtol=1e-12,
                       atol=0)


def test_autocorr_reference_values():
    x = np.array([4, 2, 1, 3, 7, 3, 8])
    assert T.calc_unorm_autocorr(x).tolist() == [152, 79, 82, 53, 42, 28, 32]
    assert np.allclose(T.calc_autocorr(x),
                       [1.0, -0.025, 0.15, -0.175, -0.25, -0.2, 0.0])


@pytest.mark.parametrize("as_tensor", [False, True])
def test_calc_decorrelation_matrix(as_tensor):
    rng = np.random.RandomState(8)
    X = rng.randn(2, 4, 4) + 1j * rng.randn(2, 4, 4)
    R = X @ np.conj(np.swapaxes(X, -1, -2)) + np.eye(4)
    arg = torch.as_tensor(R) if as_tensor else R
    W = T.calc_decorrelation_matrix(arg)
    assert isinstance(W, torch.Tensor) == as_tensor
    W = np.asarray(W)
    Wj = np.asarray(J.calc_decorrelation_matrix(R))
    M = np.conj(np.swapaxes(W, -1, -2)) @ R @ W
    off = M - np.einsum("...ii->...i", M)[..., None] * np.eye(4)
    assert np.allclose(off, 0, atol=1e-10)
    # each column spans the JAX function's column (same eigenvalue order)
    for k in range(4):
        assert np.allclose(_projector(W[..., k:k + 1]),
                           _projector(Wj[..., k:k + 1]), atol=1e-10)


@pytest.mark.parametrize("arr", [[1, 2, 3, 4, 5, 10, 15, 20], [0, 7, 8],
                                 [5], [], [0, 5, 10, 15], [1.5, 2, 2.5, 7],
                                 [1, 3, 5, 6, 7, 8, 20, 21]])
@pytest.mark.parametrize("filename_mode", [False, True])
def test_get_mixed_range_representation(arr, filename_mode):
    arr = np.array(arr)
    assert T.get_mixed_range_representation(arr, filename_mode) == \
        J.get_mixed_range_representation(arr, filename_mode)


def test_misc_exports_the_new_names():
    for name in ("xor", "qfunc_inv", "peig_h", "leig_h",
                 "calc_unorm_autocorr", "calc_autocorr",
                 "calc_decorrelation_matrix",
                 "get_mixed_range_representation"):
        assert name in T.__all__ and callable(getattr(T, name))


# -- pointprocess ------------------------------------------------------------


def test_points_equal_the_jax_package_bit_for_bit():
    from pyphysim_tpu import pointprocess as JP
    from pyphysim_tpu_torch import pointprocess as TP
    for seed in (0, 3):
        got = TP.generate_random_points_in_circle(
            100, 5.0, 1.0, np.random.RandomState(seed))
        want = JP.generate_random_points_in_circle(
            100, 5.0, 1.0, np.random.RandomState(seed))
        assert np.array_equal(got, want)
        got = TP.generate_random_points_in_rectangle(
            100, 4.0, 2.0, np.random.RandomState(seed))
        want = JP.generate_random_points_in_rectangle(
            100, 4.0, 2.0, np.random.RandomState(seed))
        assert np.array_equal(got, want)


def test_points_from_a_torch_generator():
    from pyphysim_tpu_torch import pointprocess as TP
    g = torch.Generator().manual_seed(5)
    p = TP.generate_random_points_in_circle(2000, 2.0, 1.0, g)
    assert isinstance(p, torch.Tensor) and p.dtype == torch.complex128
    assert p.device == g.device and p.shape == (2000,)
    r = p.abs()
    assert bool(((r >= 1.0) & (r <= 2.0)).all())
    # uniform area density: half of the annulus's area lies inside r2
    r2 = np.sqrt((1.0 + 4.0) / 2)
    assert abs(float((r < r2).double().mean()) - 0.5) < 0.05
    g2 = torch.Generator().manual_seed(5)
    again = TP.generate_random_points_in_circle(2000, 2.0, 1.0, g2)
    assert torch.equal(p, again)
    q = TP.generate_random_points_in_rectangle(
        500, 4.0, 2.0, torch.Generator().manual_seed(1))
    assert bool((q.real.abs() <= 2.0).all() and (q.imag.abs() <= 1.0).all())


# -- extra -------------------------------------------------------------------


def test_extra_strings_equal_the_jax_package():
    from pyphysim_tpu import extra as JE
    from pyphysim_tpu_torch import extra as TE
    rng = np.random.RandomState(2)
    real = rng.randn(2, 3)
    cplx = rng.randn(3) + 1j * rng.randn(3)
    for x, fmt in ((real, "+.12e"), (cplx, "+.12e"), (real[0], ".3f"),
                   (np.arange(4), "d")):
        assert TE.to_mat_str(x, fmt) == JE.to_mat_str(x, fmt)
    with pytest.raises(ValueError):
        TE.to_mat_str(np.zeros((2, 2, 2)))
    x, y, err = [0, 5, 10], [0.1, 0.01, 0.001], np.array([0.02, 0.002, 2e-4])
    for kw in ({}, {"options": "mark=o", "legend": "BER"},
               {"errors": err}, {"errors": err, "legend": "L"}):
        assert TE.generate_pgfplots_plotline(x, y, **kw) == \
            JE.generate_pgfplots_plotline(x, y, **kw)
    assert TE.generate_pgfplots_plotline(np.array(x), np.array(y)) == \
        JE.generate_pgfplots_plotline(np.array(x), np.array(y))
    assert TE.ber_plot_options() == JE.ber_plot_options()
    assert TE.ser_plot_options("green") == JE.ser_plot_options("green")


# -- SeedReplay --------------------------------------------------------------


def test_seed_replay_capture_replay_delete(tmp_path):
    from pyphysim_tpu_torch.utils.testing import SeedReplay
    folder = str(tmp_path / "replays")
    path = os.path.join(folder, "t.pickle")
    # first run fails -> seeds and generator states captured
    with pytest.raises(AssertionError):
        with SeedReplay("t.pickle", folder=folder) as sr:
            assert not sr.replaying
            g = sr.generator("chan", torch.Generator().manual_seed(7))
            first = torch.randn(4, generator=g)
            sr.seed("noise", 42)
            raise AssertionError("boom")
    assert os.path.exists(path)

    # the second run replays the SAME state and seed, whatever the defaults
    with SeedReplay("t.pickle", folder=folder) as sr:
        assert sr.replaying
        g2 = sr.generator("chan", torch.Generator().manual_seed(999))
        assert torch.equal(torch.randn(4, generator=g2), first)
        assert sr.seed("noise", 1) == 42
        assert sr.seed("other", 5) == 5       # not recorded: the default
    # success removed the replay file
    assert not os.path.exists(path)
    with SeedReplay("t.pickle", folder=folder) as sr:
        assert not sr.replaying


def test_seed_replay_generator_state_round_trip(tmp_path):
    from pyphysim_tpu_torch.utils.testing import SeedReplay
    folder = str(tmp_path)
    g = torch.Generator().manual_seed(3)
    torch.rand(10, generator=g)               # a state mid-stream
    state = g.get_state().clone()
    with pytest.raises(RuntimeError):
        with SeedReplay("r.pickle", folder=folder) as sr:
            sr.generator("g", g)
            torch.rand(100, generator=g)      # used after the hand-out
            raise RuntimeError("fail")
    with SeedReplay("r.pickle", folder=folder) as sr:
        g2 = sr.generator("g", torch.Generator())
        assert torch.equal(g2.get_state(), state)


# -- plot methods ------------------------------------------------------------


def _plotted_lines(ir_plot, *args):
    """The (x, y, z) data of every line the method draws, under Agg."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    plt.close("all")
    show = plt.show
    plt.show = lambda *a, **k: None
    try:
        ir_plot(*args)
        ax = plt.gcf().axes[0]
        lines = [np.array(line.get_data_3d()) for line in ax.get_lines()]
        labels = (ax.get_xlabel(), ax.get_ylabel(), ax.get_zlabel())
    finally:
        plt.show = show
        plt.close("all")
    return lines, labels


@pytest.mark.parametrize("mimo", [False, True])
def test_plot_methods_draw_the_jax_lines(mimo):
    pytest.importorskip("matplotlib")
    from pyphysim_tpu.channels import fading as JF
    from pyphysim_tpu.ops import cplx
    from pyphysim_tpu_torch.channels import TdlImpulseResponse, fading as TF
    ts = 3.25e-8
    j_prof = JF.COST259_TUx.get_discretize_profile(ts)
    t_prof = TF.COST259_TUx.get_discretize_profile(ts)
    rng = np.random.RandomState(11)
    shape = (j_prof.num_taps,) + ((2, 3) if mimo else ()) + (4,)
    taps = (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)
    j_ir = JF.TdlImpulseResponse(cplx.from_numpy(taps), j_prof)
    t_ir = TdlImpulseResponse.from_numpy(taps, t_prof, device="cpu")
    for method, args in (("plot_impulse_response", ()),
                         ("plot_frequency_response", (64,))):
        want, j_labels = _plotted_lines(getattr(j_ir, method), *args)
        got, t_labels = _plotted_lines(getattr(t_ir, method), *args)
        assert t_labels == j_labels
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            assert a.shape == b.shape
            assert np.allclose(a, b, rtol=1e-5, atol=1e-6)
