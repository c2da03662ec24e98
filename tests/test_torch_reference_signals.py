"""The port's reference signals and channel estimators against the JAX
package on the same numpy inputs.

* Every ``reference_signals`` name: the sequences are numpy in both
  packages, so they agree bit for bit.
* The CAZAC and OCC estimators: the port's numpy route bit for bit with
  the JAX package's (the same numpy FFTs); its tensor route (complex64,
  ``torch.fft``) within 1e-5 of the largest value.
* LS / MMSE: numpy and batched complex64 tensors against the JAX
  package's numpy and CArray routes to 1e-4, the JAX tests' tolerance.
* The estimation sweep through the runner's per-key path, held to the
  closed-form theory with the JAX test's tolerance (rtol 0.35; MMSE below
  LS at noise power 1.0).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import pyphysim_tpu.channel_estimation as J_est  # noqa: E402
import pyphysim_tpu.reference_signals as J_rs  # noqa: E402
from pyphysim_tpu.ops import cplx  # noqa: E402
from pyphysim_tpu.reference_signals import ts36211_tables as J_tables  # noqa
import pyphysim_tpu_torch.channel_estimation as est  # noqa: E402
import pyphysim_tpu_torch.reference_signals as rs  # noqa: E402
from pyphysim_tpu_torch.reference_signals import \
    ts36211_tables as tables  # noqa: E402


def _crandn(rng, *shape):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            / np.sqrt(2)).astype(np.complex64)


def test_tables_are_the_jax_package_tables():
    for name in ("PHI_TABLE_SIZE_12", "PHI_TABLE_SIZE_24"):
        mine, theirs = getattr(tables, name), getattr(J_tables, name)
        assert mine.keys() == theirs.keys()
        for k in mine:
            np.testing.assert_array_equal(mine[k], theirs[k])


@pytest.mark.parametrize("Nzc,u,q", [(139, 25, 0), (31, 5, 0), (149, 1, 2)])
def test_zadoff_chu_is_bitwise_jax(Nzc, u, q):
    a = rs.calcBaseZC(Nzc, u, q)
    np.testing.assert_array_equal(a, J_rs.calcBaseZC(Nzc, u, q))
    for n_cs, den in ((3, 8), (7, 12)):
        np.testing.assert_array_equal(
            rs.get_shifted_root_seq(a, n_cs, den),
            J_rs.get_shifted_root_seq(a, n_cs, den))
    np.testing.assert_array_equal(rs.get_extended_ZF(a, 2 * Nzc + 3),
                                  J_rs.get_extended_ZF(a, 2 * Nzc + 3))
    with pytest.raises(ValueError):
        rs.calcBaseZC(Nzc, Nzc)
    with pytest.raises(ValueError):
        rs.get_shifted_root_seq(a, 8, 8)


@pytest.mark.parametrize("index,size,Nzc", [
    (0, 12, None), (5, 24, None), (25, 139, None), (3, 150, None),
    (17, 300, 139), (7, None, 31)])
def test_root_and_user_sequences_are_bitwise_jax(index, size, Nzc):
    root = rs.RootSequence(index, size, Nzc)
    jroot = J_rs.RootSequence(index, size, Nzc)
    assert (root.Nzc, root.size, root.index, repr(root)) == \
        (jroot.Nzc, jroot.size, jroot.index, repr(jroot))
    np.testing.assert_array_equal(root.seq_array(), jroot.seq_array())
    np.testing.assert_array_equal(root.conj(), jroot.conj())
    np.testing.assert_array_equal(root * 2, jroot * 2)
    for normalize in (False, True):
        for make, jmake, arg in (
                (rs.SrsUeSequence, J_rs.SrsUeSequence, 3),
                (rs.DmrsUeSequence, J_rs.DmrsUeSequence, 5)):
            seq = make(root, arg, normalize=normalize)
            jseq = jmake(jroot, arg, normalize=normalize)
            np.testing.assert_array_equal(seq.seq_array(),
                                          jseq.seq_array())
            assert (seq.size, seq.normalized, repr(seq)) == \
                (jseq.size, jseq.normalized, repr(jseq))
        occ = rs.DmrsUeSequence(root, 2, np.array([1, -1]), normalize)
        jocc = J_rs.DmrsUeSequence(jroot, 2, np.array([1, -1]), normalize)
        np.testing.assert_array_equal(occ.seq_array(), jocc.seq_array())
        assert occ.size == jocc.size
    np.testing.assert_array_equal(rs.get_srs_seq(root.seq_array(), 4),
                                  J_rs.get_srs_seq(jroot.seq_array(), 4))
    np.testing.assert_array_equal(rs.get_dmrs_seq(root.seq_array(), 4),
                                  J_rs.get_dmrs_seq(jroot.seq_array(), 4))


def test_root_sequence_raises_as_jax():
    for args in ((0,), (0, 13), (0, 20, 31)):
        with pytest.raises(AttributeError):
            rs.RootSequence(*args)
        with pytest.raises(AttributeError):
            J_rs.RootSequence(*args)


@pytest.mark.parametrize("normalize", [False, True])
def test_cazac_estimator_matches_jax(normalize):
    rng = np.random.default_rng(0)
    root = rs.RootSequence(1, 150, 149)
    seq = rs.SrsUeSequence(root, 4, normalize=normalize)
    jseq = J_rs.SrsUeSequence(J_rs.RootSequence(1, 150, 149), 4,
                              normalize=normalize)
    mine = rs.CazacBasedChannelEstimator(seq)
    jax_est = J_rs.CazacBasedChannelEstimator(jseq)
    np.testing.assert_array_equal(mine.ue_ref_seq, jax_est.ue_ref_seq)
    h = _crandn(rng, 4, 150)
    rx = h * seq.seq_array()
    want = jax_est.estimate_channel_freq_domain(rx, 15)
    np.testing.assert_array_equal(mine.estimate_channel_freq_domain(rx, 15),
                                  want)
    assert want.shape == (4, 300)
    got = mine.estimate_channel_freq_domain(
        torch.as_tensor(rx[None].repeat(2, 0)), 15)
    assert got.dtype == torch.complex64 and got.shape == (2, 4, 300)
    scale = np.abs(want).max()
    for row in got.numpy():
        np.testing.assert_allclose(row, want, atol=1e-5 * scale)
    jgot = jax_est.estimate_channel_freq_domain(
        cplx.from_numpy(rx.astype(np.complex64)), 15).to_numpy()
    np.testing.assert_allclose(got[0].numpy(), jgot, atol=1e-5 * scale)


def test_occ_estimator_matches_jax():
    rng = np.random.default_rng(1)
    occ = np.array([1, -1])
    seq = rs.DmrsUeSequence(rs.RootSequence(2, 24), 3, occ)
    jseq = J_rs.DmrsUeSequence(J_rs.RootSequence(2, 24), 3, occ)
    mine = rs.CazacBasedWithOCCChannelEstimator(seq)
    jax_est = J_rs.CazacBasedWithOCCChannelEstimator(jseq)
    np.testing.assert_array_equal(mine.cover_code, jax_est.cover_code)
    h = _crandn(rng, 3, 1, 24)
    rx = h * seq.seq_array() + 0.1 * _crandn(rng, 3, 2, 24)
    want = jax_est.estimate_channel_freq_domain(rx, 5)
    np.testing.assert_array_equal(mine.estimate_channel_freq_domain(rx, 5),
                                  want)
    got = mine.estimate_channel_freq_domain(torch.as_tensor(rx), 5)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * np.abs(want).max())
    # without the slot axis: the plain estimate of one slot
    one = rx[:, 0] * occ[0]
    np.testing.assert_array_equal(
        mine.estimate_channel_freq_domain(one, 5, extra_dimension=False),
        jax_est.estimate_channel_freq_domain(one, 5, extra_dimension=False))


def test_layered_occ_estimator_matches_jax():
    """The port's estimate batched over the 4-layer PUSCH's DMRS (cyclic
    shifts 0, 6, 3, 9, cover codes [1 1], [1 1], [1 -1], [1 -1]) is, layer
    by layer, the JAX package's ``CazacBasedWithOCCChannelEstimator`` on
    the same numpy slots: bit for bit on the numpy route, within 1e-5 of
    the largest value on the tensor route."""
    rng = np.random.default_rng(4)
    shifts, covers = (0, 6, 3, 9), ([1, 1], [1, 1], [1, -1], [1, -1])
    seqs = [rs.DmrsUeSequence(rs.RootSequence(25, 72), c, np.array(cc))
            for c, cc in zip(shifts, covers)]
    jseqs = [J_rs.DmrsUeSequence(J_rs.RootSequence(25, 72), c, np.array(cc))
             for c, cc in zip(shifts, covers)]
    rx = _crandn(rng, 3, 2, 72)
    est = rs.LayeredOCCChannelEstimator(seqs)
    got = est.estimate_channel_freq_domain(rx, 8)
    got_t = est.estimate_channel_freq_domain(torch.as_tensor(rx), 8).numpy()
    assert got.shape == got_t.shape == (3, 4, 72)
    for layer, jseq in enumerate(jseqs):
        want = J_rs.CazacBasedWithOCCChannelEstimator(
            jseq).estimate_channel_freq_domain(rx, 8)
        np.testing.assert_array_equal(got[:, layer], want)
        np.testing.assert_allclose(got_t[:, layer], want,
                                   atol=1e-5 * np.abs(want).max())


def test_ls_estimation_matches_jax():
    rng = np.random.default_rng(10)
    Y = _crandn(rng, 5, 3, 16)
    s = _crandn(rng, 2, 16)
    want = J_est.compute_ls_estimation(Y, s)
    np.testing.assert_allclose(est.compute_ls_estimation(Y, s), want,
                               atol=1e-6)
    got = est.compute_ls_estimation(torch.as_tensor(Y), s)
    assert got.dtype == torch.complex64 and got.shape == (5, 3, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    jgot = J_est.compute_ls_estimation(cplx.from_numpy(Y),
                                       cplx.from_numpy(s)).to_numpy()
    np.testing.assert_allclose(got.numpy(), jgot, atol=1e-4)
    # per-realization pilots
    sb = _crandn(rng, 5, 2, 16)
    np.testing.assert_allclose(
        est.compute_ls_estimation(torch.as_tensor(Y), torch.as_tensor(sb))
        .numpy(), J_est.compute_ls_estimation(Y, sb), atol=1e-4)
    # exact recovery without noise
    h = _crandn(rng, 5, 3, 1)
    s1 = _crandn(rng, 1, 8)
    np.testing.assert_allclose(
        est.compute_ls_estimation(torch.as_tensor(h @ s1), s1).numpy(), h,
        atol=1e-5)


def test_mmse_estimation_matches_jax():
    rng = np.random.default_rng(11)
    Nr, Np = 3, 8
    A = _crandn(rng, Nr, Nr)
    C = A @ A.conj().T / Nr + 0.1 * np.eye(Nr)
    Y = _crandn(rng, 4, Nr, Np)
    s = np.exp(1j * 2 * np.pi * rng.random((1, Np)))
    want = J_est.compute_mmse_estimation(Y, s, 0.2, C)
    np.testing.assert_allclose(est.compute_mmse_estimation(Y, s, 0.2, C),
                               want, atol=1e-10)
    got = est.compute_mmse_estimation(torch.as_tensor(Y), s, 0.2, C)
    assert got.dtype == torch.complex64 and got.shape == (4, Nr, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    jgot = J_est.compute_mmse_estimation(
        cplx.from_numpy(Y), cplx.from_numpy(s), 0.2,
        cplx.from_numpy(C)).to_numpy()
    np.testing.assert_allclose(got.numpy(), jgot, atol=1e-4)
    for Nr_, npow in ((3, 0.2), (4, 1.0)):
        Ci = np.eye(Nr_)
        assert est.compute_theoretical_mmse_MSE(Nr_, npow, 1.0, 1.0, Np,
                                                Ci) == pytest.approx(
            J_est.compute_theoretical_mmse_MSE(Nr_, npow, 1.0, 1.0, Np, Ci))
        assert est.compute_theoretical_mmse_MSE(
            Nr_, npow, 1.0, 1.0, Np, torch.eye(Nr_)) == pytest.approx(
            J_est.compute_theoretical_mmse_MSE(Nr_, npow, 1.0, 1.0, Np, Ci))
        assert est.compute_theoretical_ls_MSE(Nr_, npow, 0.5, 2.0, Np) == \
            J_est.compute_theoretical_ls_MSE(Nr_, npow, 0.5, 2.0, Np)
    with pytest.raises(AssertionError, match="Nt == 1"):
        est.compute_mmse_estimation(Y, _crandn(rng, 2, Np), 0.2, C)
    with pytest.raises(AssertionError, match="Nt == 1"):
        est.compute_mmse_estimation(torch.as_tensor(Y),
                                    torch.as_tensor(_crandn(rng, 2, Np)),
                                    0.2, C)


def test_runner_estimation_sweep_matches_theory():
    """The JAX test's sweep (Nr 2, 8 unit-modulus pilots, 96 realizations
    in chunks of 32) through the port's per-key path: LS and MMSE within
    rtol 0.35 of their theory, MMSE below LS at noise power 1.0."""
    from apps.channel_estimation_sweep_torch import EstimationSweepRunner
    s_np = np.exp(1j * 2 * np.pi * np.random.RandomState(5).rand(1, 8))
    r = EstimationSweepRunner(Nr=2, pilots=s_np, device="cpu",
                              read_command_line_args=False)
    r.rep_max, r.batch_size = 96, 32
    r.simulate()
    ls = [float(v) for v in r.results.get_result_values_list("ls_mse")]
    mm = [float(v) for v in r.results.get_result_values_list("mmse_mse")]
    for i, npow in enumerate([0.1, 1.0]):
        theory_ls, theory_mm = r.theory(npow)
        assert theory_ls == J_est.compute_theoretical_ls_MSE(2, npow, 1.0,
                                                             1.0, 8)
        assert np.isclose(ls[i], theory_ls, rtol=0.35), (ls[i], theory_ls)
        assert np.isclose(mm[i], theory_mm, rtol=0.35), (mm[i], theory_mm)
    assert mm[1] < ls[1]
    assert r.chunks_dispatched == 2 * 3
    # the default pilots: the comb-2 SRS of 300 subcarriers
    srs = EstimationSweepRunner(device="cpu", read_command_line_args=False)
    assert srs.pilots.shape == (1, 150)
    np.testing.assert_allclose(np.abs(srs.pilots), 1.0, rtol=1e-6)
