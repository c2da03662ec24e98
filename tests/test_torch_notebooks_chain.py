"""The port's notebooks 02, 03 and 08 run end to end on the CPU, held
against the JAX package and the physics.

* 02: the channel's tap counts, the frequency-domain path's output and
  impulse-response counts equal the JAX package's (the port's output
  carries one more leading axis, the attempt); the block-static mode
  convolves through ``block_fir`` (here its plain version); the BERs at 5
  and 15 dB lie in ``bench.py``'s ``BER_CORNERS`` (8 attempts of 16 OFDM
  symbols a point, from the notebook's seed).
* 03: Alamouti's BER at 10 dB lies in ``bench.py``'s band and MRC 1x2
  beats Alamouti 2x1 (its 3 dB array gain). The IA sweeps' mean
  capacities a SNR equal the JAX package's solvers (Max-SINR with
  ``init='fix'``; Min-Leakage and MMSE with their random init replaced by
  the same precoders) on the notebook's own channels, initial precoders
  and noise variances, with the MMSE precoders normalised in JAX, at
  tests/test_torch_ia_batched.py's rtol 2e-3 (float32, other
  decompositions, 25 iterations); the Max-SINR means lie in ``bench.py``'s
  IA band at 10 dB and grow with the SNR, and Min-Leakage loses to
  Max-SINR at 0 dB.
* 08: the comp_BD study's SERs with no stream sacrifice and with the
  capacity metric lie in ``bench.py``'s bands (the same scenario: SNR 20
  dB, Pe 10 dBm, here 32 repetitions of 200 symbols), the sacrifice beats
  no sacrifice, and the non-square configuration runs its three metrics.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_notebooks import run_notebook  # noqa: E402

BER_CORNERS = {5.0: (0.08, 0.22), 15.0: (0.02, 0.06)}    # bench.py
ALAMOUTI_BER_10DB = (0.008, 0.030)                        # bench.py
IA_CAP_RANGE = (6.0, 16.0)                                # bench.py
COMP_BD_SER_CAPACITY = (0.0015, 0.03)                     # bench.py
COMP_BD_SER_NONE = (0.025, 0.15)                          # bench.py


def test_notebook_02_chain_against_jax(tmp_path, monkeypatch):
    import jax
    import jax.numpy as jnp
    from pyphysim_tpu.channels import (COST259_TUx, JakesSampleGenerator,
                                       TdlChannel)
    from pyphysim_tpu.modulators import OFDM, QAM
    from pyphysim_tpu_torch.ops import fir
    before = fir.block_fir.reference_count
    ns = run_notebook("02", tmp_path, monkeypatch)
    assert fir.block_fir.reference_count > before

    channel = TdlChannel(JakesSampleGenerator(Fd=30.0, Ts=1 / 20e6, L=16),
                         COST259_TUx)
    assert ns["channel"].num_taps == channel.num_taps
    assert ns["channel"].num_taps_with_padding == \
        channel.num_taps_with_padding
    ofdm, qam = OFDM(512, 52, 300), QAM(16)
    np.testing.assert_array_equal(ns["carriers"],
                                  ofdm.get_used_subcarrier_indexes())
    sym = qam.modulate(jnp.asarray(np.arange(1200) % 16))
    out, ir, _ = channel.corrupt_data_in_freq_domain(
        channel.init_state(jax.random.PRNGKey(7)), sym, 512,
        ofdm.get_used_subcarrier_indexes())
    assert tuple(ns["out"].shape) == (1,) + tuple(out.shape)
    assert ns["ir"].num_samples == ir.num_samples == 4

    bits = ns["bits_per_point"]
    assert bits == 8 * 300 * 16 * 4
    for (block_static, snr), errors in ns["bit_errors"].items():
        if snr in BER_CORNERS:
            lo, hi = BER_CORNERS[snr]
            assert lo < errors / bits < hi, (block_static, snr, errors)
    # the channel barely moves within an OFDM symbol at 30 Hz
    for snr in (5.0, 15.0, 25.0):
        a, b = ns["bit_errors"][False, snr], ns["bit_errors"][True, snr]
        assert abs(a - b) <= 0.05 * max(a, b), (snr, a, b)


def _jax_ia_solvers(iterations):
    """A jitted function of numpy-built batches ``(H, F0, nv)`` giving the
    (B, 3) sum capacities of the JAX package's Max-SINR, Min-Leakage and
    MMSE solvers, every solver started from the unit precoders ``F0``, at
    the noise variances ``nv``; the MMSE precoders normalised to unit
    Frobenius norm a user."""
    import jax
    import jax.numpy as jnp
    from pyphysim_tpu.ia import batched as jb
    from pyphysim_tpu.ops.cplx import CArray

    def fixed_init(solve, h, f0, *args):
        jb_init = jb.random_unit_precoders
        jb.random_unit_precoders = lambda *a: f0
        try:
            return solve(h, jax.random.PRNGKey(0), *args)
        finally:
            jb.random_unit_precoders = jb_init

    def caps(h, f0, v):
        Fm, Um = jb.max_sinr_solve(h, None, 1, 1.0, v, iterations, "fix", f0)
        Fl, Ul = fixed_init(jb.min_leakage_solve, h, f0, 1, 1.0, iterations)
        Fe, Ue = fixed_init(jb.mmse_solve, h, f0, 1, 1.0, v, iterations)
        nrm = jnp.sqrt(jnp.sum(Fe.re ** 2 + Fe.im ** 2, axis=(-2, -1),
                               keepdims=True))
        Fe = CArray(Fe.re / nrm, Fe.im / nrm)
        return jnp.stack([jb.sum_capacity(jb.calc_sinrs(h, F, U, v, 1.0))
                          for F, U in ((Fm, Um), (Fl, Ul), (Fe, Ue))])

    return jax.jit(jax.vmap(caps))


def test_notebook_03_diversity_and_ia(tmp_path, monkeypatch):
    from pyphysim_tpu_torch.ia.batched import random_unit_precoders
    ns = run_notebook("03", tmp_path, monkeypatch)
    ber = ns["ber"]
    lo, hi = ALAMOUTI_BER_10DB
    assert lo < ber["Alamouti 2x1", 10.0] < hi
    for snr in (5.0, 10.0, 15.0):
        assert ber["MRC 1x2", snr] < ber["Alamouti 2x1", snr]

    from pyphysim_tpu.ops import cplx
    solvers = _jax_ia_solvers(25)
    shape = (len(ns["ia_snrs"]), ns["draws"], 3)
    want = {}
    for name, offset in (("caps", 1), ("caps3", 2)):
        H, s_init, nv = ns["sweep_inputs"](ns["SEED"] + offset)
        F0 = random_unit_precoders(s_init, 3, 2, 1, H.shape[:-4])
        want[name] = np.asarray(solvers(
            cplx.from_numpy(H.numpy()), cplx.from_numpy(F0.numpy()),
            nv.reshape(-1).numpy())).reshape(shape).mean(axis=1)
    np.testing.assert_allclose(ns["caps"], want["caps"][:, 0], rtol=2e-3)
    np.testing.assert_allclose(ns["caps3"], want["caps3"], rtol=2e-3)
    caps, caps3 = ns["caps"], ns["caps3"]
    assert IA_CAP_RANGE[0] < caps[1] < IA_CAP_RANGE[1]
    assert (np.diff(caps) > 0).all()
    assert caps3.shape == (4, 3) and np.isfinite(caps3).all()
    assert IA_CAP_RANGE[0] < caps3[1, 0] < IA_CAP_RANGE[1]
    # Min-Leakage ignores the noise: it loses to Max-SINR at 0 dB
    assert caps3[0, 1] < caps3[0, 0]


def test_notebook_08_stream_sacrifice(tmp_path, monkeypatch):
    ns = run_notebook("08", tmp_path, monkeypatch)
    ser = ns["ser"]
    assert sorted(ser) == sorted(ns["METRICS"])
    assert all(0.0 <= v <= 1.0 for v in ser.values()), ser
    assert COMP_BD_SER_NONE[0] < ser["None"] < COMP_BD_SER_NONE[1]
    assert COMP_BD_SER_CAPACITY[0] < ser["capacity"] < \
        COMP_BD_SER_CAPACITY[1]
    assert ser["capacity"] < ser["None"]
    assert ns["runner"].runned_reps == [32]
    assert sorted(ns["ns_ser"]) == ["None", "Whitening", "capacity"]
    assert all(0.0 <= v <= 1.0 for v in ns["ns_ser"].values())
    assert ns["ns_runner"].runned_reps == [16]
