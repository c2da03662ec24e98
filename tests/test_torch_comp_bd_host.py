"""The comp_BD slice's host modules held against the JAX package on the
same numpy inputs: the host block diagonalizers (``BlockDiagonalizer``,
``WhiteningBD``, ``EnhancedBD`` with every metric) on the channel with
external interference (``MultiUserChannelMatrixExtInt``), the subspace
helpers, the whitening / capacity / singular-vector helpers of
``utils.misc``, the path loss models, the cell geometry and the
``simulate_do_what_i_mean`` launcher.

Tolerances and why:

* host solvers: both packages run the same numpy algorithm on the same
  complex64 channel, so the stream counts are equal and precoders, filters
  and SINRs agree to rtol 1e-5 of their largest entry (the port's
  pseudo-inverses drop singular values at or below 1e-3 of the largest,
  numpy's default keeps them; no draw here is conditioned worse than 1e3);
* the channel object: the same complex64 products, rtol 1e-6 (1e-5 for
  the interference covariances); SINRs, whose Bkl covariances are
  differences of float32 sums, rtol 1e-3 of the largest (measured
  4.4e-4);
* subspace, misc, path loss and geometry: the same float64 formulas,
  rtol 1e-12 (geometry exactly).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pyphysim_tpu.cell import Grid as JGrid  # noqa: E402
from pyphysim_tpu.channels import pathloss as jpl  # noqa: E402
from pyphysim_tpu.channels.multiuser import \
    MultiUserChannelMatrixExtInt as JMU  # noqa: E402
from pyphysim_tpu.comm import blockdiagonalization as jbd  # noqa: E402
from pyphysim_tpu.modulators import PSK as JPSK  # noqa: E402
from pyphysim_tpu.subspace import metrics as jmetrics  # noqa: E402
from pyphysim_tpu.subspace import projections as jproj  # noqa: E402
from pyphysim_tpu.utils import misc as jmisc  # noqa: E402
from pyphysim_tpu_torch.cell import Grid  # noqa: E402
from pyphysim_tpu_torch.channels import pathloss as pl  # noqa: E402
from pyphysim_tpu_torch.channels.multiuser import \
    MultiUserChannelMatrixExtInt as MU  # noqa: E402
from pyphysim_tpu_torch.comm import blockdiagonalization as bd  # noqa: E402
from pyphysim_tpu_torch.modulators import PSK  # noqa: E402
from pyphysim_tpu_torch.subspace import metrics, projections  # noqa: E402
from pyphysim_tpu_torch.utils import misc  # noqa: E402

K, NR, NT, RANK = 3, 2, 2, 1
PT, PE, NV = 1.5, 0.01, 2.3e-15


def _np(x):
    if hasattr(x, "to_numpy"):
        return x.to_numpy()
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def channel_pair(seed):
    """The same (K*NR, K*NT + RANK) channel with path loss in both
    packages' channel objects."""
    rng = np.random.default_rng(seed)
    shape = (K * NR, K * NT + RANK)
    big = ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
           / np.sqrt(2)).astype(np.complex64)
    pathloss = 10.0 ** rng.uniform(-13, -10, (K, K))
    pathloss_int = 10.0 ** rng.uniform(-11, -9, (K, 1))
    mu, jmu = MU(device="cpu"), JMU()
    for m in (mu, jmu):
        m.init_from_channel_matrix(big, NR, NT, K, RANK)
        m.set_pathloss(pathloss, pathloss_int)
        m.noise_var = NV
    return mu, jmu


def assert_blocks_close(got, want, rtol):
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        np.testing.assert_allclose(g, w, atol=rtol * np.abs(w).max())


def test_channel_with_external_interference_matches_jax():
    mu, jmu = channel_pair(0)
    for name in ("big_H", "big_H_no_ext_int"):
        np.testing.assert_allclose(_np(getattr(mu, name)),
                                   _np(getattr(jmu, name)), rtol=1e-6)
    assert (mu.K, mu.extIntK) == (jmu.K, jmu.extIntK) == (K, 1)
    np.testing.assert_array_equal(mu.Nr, jmu.Nr)
    np.testing.assert_array_equal(mu.extIntNt, jmu.extIntNt)
    for pe in (1.0, PE):
        assert_blocks_close(mu.calc_cov_matrix_extint_plus_noise(pe),
                            jmu.calc_cov_matrix_extint_plus_noise(pe), 1e-6)
        assert_blocks_close(mu.calc_cov_matrix_extint_without_noise(pe),
                            jmu.calc_cov_matrix_extint_without_noise(pe),
                            1e-6)
    for k in range(K):
        np.testing.assert_allclose(_np(mu.get_Hk_without_ext_int(k)),
                                   _np(jmu.get_Hk_without_ext_int(k)),
                                   rtol=1e-6)
    rng = np.random.default_rng(1)
    F = [(rng.standard_normal((NT, 1)) + 1j * rng.standard_normal((NT, 1)))
         .astype(np.complex64) for _ in range(K)]
    U = [(rng.standard_normal((NR, 1)) + 1j * rng.standard_normal((NR, 1)))
         .astype(np.complex64) for _ in range(K)]
    assert_blocks_close(mu.calc_SINR(F, U, PE), jmu.calc_SINR(F, U, PE),
                        1e-3)
    for k in range(K):
        np.testing.assert_allclose(_np(mu.calc_Q(k, F, PE)),
                                   _np(jmu.calc_Q(k, F, PE)), rtol=1e-5)
        F_jp = [np.tile(f, (K, 1)) for f in F]       # joint precoders
        np.testing.assert_allclose(_np(mu.calc_JP_Q(k, F_jp, PE)),
                                   _np(jmu.calc_JP_Q(k, F_jp, PE)),
                                   rtol=1e-5)
    # the signals through the channel, noise off
    mu.noise_var = jmu.noise_var = None
    data = [rng.standard_normal((NT, 5)).astype(np.complex64)
            for _ in range(K)]
    ext = [rng.standard_normal((RANK, 5)).astype(np.complex64)]
    assert_blocks_close(mu.corrupt_data(data, ext),
                        jmu.corrupt_data(data, ext), 1e-6)


@pytest.mark.parametrize("metric, extra", [
    (None, None), ("naive", {"num_streams": 1}),
    ("fixed", {"num_streams": 1}), ("capacity", None),
    ("effective_throughput", "modulator")])
def test_enhanced_bd_host_matches_jax(metric, extra):
    for seed in range(3):
        mu, jmu = channel_pair(seed)
        e, je = bd.EnhancedBD(K, PT, NV, PE), jbd.EnhancedBD(K, PT, NV, PE)
        if extra == "modulator":
            e.set_ext_int_handling_metric(metric, {
                "modulator": PSK(4, device="cpu"), "packet_length": 60})
            je.set_ext_int_handling_metric(metric, {
                "modulator": JPSK(4), "packet_length": 60})
        else:
            e.set_ext_int_handling_metric(metric, extra)
            je.set_ext_int_handling_metric(metric, extra)
        assert e.metric_name == je.metric_name
        Ms, Wk, Ns = e.block_diagonalize_no_waterfilling(mu)
        jMs, jWk, jNs = je.block_diagonalize_no_waterfilling(jmu)
        np.testing.assert_array_equal(Ns, jNs)
        assert_blocks_close(Ms, jMs, 1e-5)
        assert_blocks_close(Wk, jWk, 1e-5)
        F = list(Ms)
        U = [np.asarray(w).conj().T for w in Wk]
        assert_blocks_close(mu.calc_JP_SINR(F, U, PE),
                            jmu.calc_JP_SINR(F, U, PE), 1e-3)


def test_whitening_and_plain_bd_host_match_jax():
    mu, jmu = channel_pair(4)
    Ms, Wk, Ns = bd.WhiteningBD(K, PT, NV, PE)\
        .block_diagonalize_no_waterfilling(mu)
    jMs, jWk, jNs = jbd.WhiteningBD(K, PT, NV, PE)\
        .block_diagonalize_no_waterfilling(jmu)
    np.testing.assert_array_equal(Ns, jNs)
    assert_blocks_close(Ms, jMs, 1e-5)
    assert_blocks_close(Wk, jWk, 1e-5)
    H = _np(mu.big_H_no_ext_int).astype(np.complex128)
    for mode in ("block_diagonalize", "block_diagonalize_no_waterfilling"):
        got = getattr(bd.BlockDiagonalizer(K, PT, NV), mode)(H)
        want = getattr(jbd.BlockDiagonalizer(K, PT, NV), mode)(H)
        assert_blocks_close(got, want, 1e-9)
    newH, _ = bd.block_diagonalize(H, K, PT, NV)
    np.testing.assert_allclose(bd.calc_receive_filter(newH),
                               jbd.calc_receive_filter(newH), rtol=1e-9)


def test_enhanced_bd_metric_errors_match_jax():
    for obj in (bd.EnhancedBD(K, PT, NV, PE), jbd.EnhancedBD(K, PT, NV, PE)):
        with pytest.raises(AttributeError, match="num_streams"):
            obj.set_ext_int_handling_metric("fixed")
        with pytest.raises(AttributeError, match="modulator"):
            obj.set_ext_int_handling_metric("effective_throughput")
        with pytest.raises(AttributeError, match="can only be one of"):
            obj.set_ext_int_handling_metric("bogus")


def test_subspace_matches_jax():
    rng = np.random.default_rng(5)
    A = rng.standard_normal((4, 2)) + 1j * rng.standard_normal((4, 2))
    B = rng.standard_normal((4, 2)) + 1j * rng.standard_normal((4, 2))
    for name in ("calcProjectionMatrix", "calcOrthogonalProjectionMatrix"):
        np.testing.assert_allclose(getattr(projections, name)(A),
                                   getattr(jproj, name)(A), rtol=1e-12)
        np.testing.assert_allclose(
            getattr(projections, name)(torch.from_numpy(A)).numpy(),
            getattr(jproj, name)(A), atol=1e-12)
    p, jp = projections.Projection(A), jproj.Projection(A)
    for name in ("project", "reflect", "oProject"):
        np.testing.assert_allclose(getattr(p, name)(B),
                                   getattr(jp, name)(B), atol=1e-12)
    for name in ("calc_principal_angles", "calc_chordal_distance",
                 "calc_chordal_distance_2"):
        np.testing.assert_allclose(getattr(metrics, name)(A, B),
                                   getattr(jmetrics, name)(A, B),
                                   rtol=1e-12)
        np.testing.assert_allclose(
            getattr(metrics, name)(torch.from_numpy(A),
                                   torch.from_numpy(B)).numpy(),
            getattr(jmetrics, name)(A, B), rtol=1e-10)
    angles = jmetrics.calc_principal_angles(A, B)
    assert metrics.calc_chordal_distance_from_principal_angles(angles) == \
        pytest.approx(
            jmetrics.calc_chordal_distance_from_principal_angles(angles),
            rel=1e-12)


def test_misc_helpers_match_jax():
    rng = np.random.default_rng(6)
    A = rng.standard_normal((3, 5)) + 1j * rng.standard_normal((3, 5))
    for n in (1, 2, 3):
        got = misc.least_right_singular_vectors(A, n)
        want = jmisc.least_right_singular_vectors(A, n)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-14)
    X = rng.standard_normal((3, 3)) + 1j * rng.standard_normal((3, 3))
    Rm = X @ X.conj().T
    np.testing.assert_allclose(misc.calc_whitening_matrix(Rm),
                               jmisc.calc_whitening_matrix(Rm), rtol=1e-12)
    W = misc.calc_whitening_matrix(torch.from_numpy(Rm)).numpy()
    np.testing.assert_allclose(W.conj().T @ Rm @ W, np.eye(3), atol=1e-12)
    sinrs = rng.uniform(0.1, 100.0, 6)
    assert misc.calc_shannon_sum_capacity(sinrs) == pytest.approx(
        jmisc.calc_shannon_sum_capacity(sinrs), rel=1e-12)
    assert float(misc.calc_shannon_sum_capacity(torch.from_numpy(sinrs))) \
        == pytest.approx(jmisc.calc_shannon_sum_capacity(sinrs), rel=1e-12)


@pytest.mark.parametrize("make", [
    lambda m: m.PathLossFreeSpace(), lambda m: m.PathLossFreeSpace(3.0, 2400),
    lambda m: m.PathLoss3GPP1(), lambda m: m.PathLossGeneral(3.5, 120.0),
    lambda m: m.PathLossMetisPS7(2000.0), lambda m: m.PathLossOkomuraHata()])
def test_path_loss_matches_jax(make):
    model, jmodel = make(pl), make(jpl)
    d = np.array([1.2, 2.5, 7.0, 15.0])
    np.testing.assert_allclose(model.calc_path_loss_dB(d),
                                jmodel.calc_path_loss_dB(d), rtol=1e-12)
    np.testing.assert_allclose(model.calc_path_loss(d),
                                jmodel.calc_path_loss(d), rtol=1e-12)
    np.testing.assert_allclose(
        model.calc_path_loss(torch.from_numpy(d)).numpy(),
        jmodel.calc_path_loss(d), rtol=1e-12)
    PL = jmodel.calc_path_loss_dB(d)
    np.testing.assert_allclose(model.which_distance_dB(PL),
                               jmodel.which_distance_dB(PL), rtol=1e-12)
    assert model.type == jmodel.type
    if isinstance(model, pl.PathLossMetisPS7):
        walls = np.array([0, 1, 2, 3])
        np.testing.assert_allclose(
            model.calc_path_loss_dB(d, num_walls=walls),
            jmodel.calc_path_loss_dB(d, num_walls=walls), rtol=1e-12)


def test_grid_geometry_matches_jax():
    for num_cells, radius in ((3, 1.0), (7, 0.5), (2, 2.0)):
        grid, jgrid = Grid(), JGrid()
        grid.create_clusters(2, num_cells, radius)
        jgrid.create_clusters(2, num_cells, radius)
        for i in range(2):
            c, jc = (g.get_cluster_from_index(i) for g in (grid, jgrid))
            assert c.pos == jc.pos
            assert c.external_radius == jc.external_radius
            np.testing.assert_array_equal(
                np.array([x.pos for x in c._cells]),
                np.array([x.pos for x in jc._cells]))
            np.testing.assert_array_equal(np.asarray(c.vertices),
                                          np.asarray(jc.vertices))
            ids = np.arange(1, num_cells + 1)
            angles = np.linspace(0, 300, num_cells)
            c.add_border_users(ids, angles, 0.7)
            jc.add_border_users(ids, angles, 0.7)
            np.testing.assert_array_equal(
                c.calc_dist_all_users_to_each_cell(),
                jc.calc_dist_all_users_to_each_cell())


def test_simulate_do_what_i_mean_runs_each_runner(capsys):
    from pyphysim_tpu_torch.simulations import (Result, SimulationResults,
                                                SimulationRunner,
                                                simulate_do_what_i_mean)

    class Count(SimulationRunner):
        def __init__(self):
            super().__init__(read_command_line_args=False)
            self.params.add("x", np.array([1.0, 2.0]))
            self.params.set_unpack_parameter("x")
            self.rep_max = 3
            self.update_progress_function_style = None

        def _run_simulation(self, p):
            r = SimulationResults()
            r.add_result(Result.create("x", Result.SUMTYPE, p["x"]))
            return r

    runners = [Count(), Count()]
    simulate_do_what_i_mean(runners, ".")
    for r in runners:
        assert r.runned_reps == [3, 3]
        assert r.results.get_result_values_list("x") == [3.0, 6.0]
    one = Count()
    one.command_line_args.index = 1
    simulate_do_what_i_mean(one)
    assert one.runned_reps == [3]
