"""The port's single-user and multiuser TDL channels (``SuChannel``,
``SuMimoChannel``, ``MuChannel``, ``MuMimoChannel``) against the JAX
package, with the links' Jakes states carried across as numpy
(``jakes_state_from_numpy``: the JAX package's stacked link states, links
first, are the port's layout).

Outputs and per-link impulse responses agree to atol 1e-4, the JAX tests'
tolerance; the port's one batched link call agrees with a per-link loop of
``SuChannel`` on the same states to 1e-6 (the same float32 operations).
Then a small K = 3 interference sweep through the runner's per-key path
(the JAX package's ``test_k3_mumimo_ofdm_sweep_through_batch_runner``),
whose results must not depend on the chunk size.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pyphysim_tpu.channels import fading as J_fading  # noqa: E402
from pyphysim_tpu.channels import multiuser as J_mu  # noqa: E402
from pyphysim_tpu.channels import singleuser as J_su  # noqa: E402
from pyphysim_tpu.channels.fading_generators import \
    JakesSampleGenerator as J_Jakes  # noqa: E402
from pyphysim_tpu.ops import cplx  # noqa: E402
from pyphysim_tpu_torch.channels import (COST259_TUx,  # noqa: E402
                                         JakesSampleGenerator, MuChannel,
                                         MuMimoChannel, SuChannel,
                                         SuMimoChannel, TdlChannel,
                                         jakes_state_from_numpy)
from pyphysim_tpu_torch.ops.streams import AttemptStreams  # noqa: E402

TS_TEST = 3.25e-8          # the JAX test's
ATOL = 1e-4
PL = np.array([[1.0, 0.1, 0.1],
               [0.2, 0.9, 0.05],
               [0.3, 0.1, 0.8]])


def _crandn(rng, *shape):
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(np.complex64)


def _jakes(shape=None):
    return (J_Jakes(30.0, TS_TEST, 16, shape=shape),
            JakesSampleGenerator(30.0, TS_TEST, 16, shape=shape,
                                 device="cpu"))


@pytest.mark.parametrize("mimo", [False, True])
@pytest.mark.parametrize("freq", [False, True])
def test_su_channel_with_pathloss_matches_jax(mimo, freq):
    jgen, gen = _jakes()
    if mimo:
        jch = J_su.SuMimoChannel(2, jgen, J_fading.COST259_TUx)
        ch = SuMimoChannel(2, gen, COST259_TUx)
        # as in the JAX package, the caller's generator becomes (N, N)
        assert gen.shape == (ch.num_taps, 2, 2)
        assert (ch.num_rx_antennas, ch.num_tx_antennas) == (2, 2)
    else:
        jch = J_su.SuChannel(jgen, J_fading.COST259_TUx)
        ch = SuChannel(gen, COST259_TUx)
    jch.set_pathloss(0.25)
    ch.set_pathloss(0.25)
    assert ch.pathloss_value == 0.25
    jstate = jch.init_state(jax.random.PRNGKey(3))
    state = jakes_state_from_numpy(jstate, device="cpu")
    x = _crandn(np.random.default_rng(1), *((2,) if mimo else ()), 128)
    if freq:
        out, ir, _ = ch.corrupt_data_in_freq_domain(
            state, torch.as_tensor(x), 64, None)
        jout, jir, _ = jch.corrupt_data_in_freq_domain(
            jstate, cplx.from_numpy(x), 64, None)
    else:
        out, ir, _ = ch.corrupt_data(state, torch.as_tensor(x))
        jout, jir, _ = jch.corrupt_data(jstate, cplx.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), jout.to_numpy(), atol=ATOL)
    np.testing.assert_allclose(ir.tap_values_sparse.numpy(),
                               jir.tap_values_sparse.to_numpy(), atol=ATOL)
    # the stateful form scales the output and the kept response alike
    ch.seed(4)
    out = ch.corrupt_data(torch.as_tensor(x))
    ch.set_pathloss(None)
    ch.seed(4)
    ref = ch.corrupt_data(torch.as_tensor(x))
    np.testing.assert_allclose(out.numpy(), 0.5 * ref.numpy(), atol=1e-6)


def test_su_channel_bad_pathloss_raises_as_jax():
    ch = SuChannel(device="cpu")
    jch = J_su.SuChannel()
    for bad in (0.0, -0.1, 1.5):
        with pytest.raises(ValueError, match="Pathloss"):
            ch.set_pathloss(bad)
        with pytest.raises(ValueError, match="Pathloss"):
            jch.set_pathloss(bad)
    mu = MuChannel(3, device="cpu")
    with pytest.raises(ValueError, match="Pathloss"):
        mu.set_pathloss(np.where(PL == 1.0, 2.0, PL))
    with pytest.raises(ValueError, match="3x3"):
        mu.set_pathloss(PL[:2])


def _mu_pair(mimo):
    jgen, gen = _jakes()
    if mimo:
        jmu = J_mu.MuMimoChannel(2, 2, 2, jgen, J_fading.COST259_TUx)
        mu = MuMimoChannel(2, 2, 2, gen, COST259_TUx)
    else:
        jmu = J_mu.MuChannel(3, jgen, J_fading.COST259_TUx)
        mu = MuChannel(3, gen, COST259_TUx)
        jmu.set_pathloss(PL)
        mu.set_pathloss(PL)
    jstates = jmu.init_state(jax.random.PRNGKey(42))
    return jmu, mu, jstates, jakes_state_from_numpy(jstates, device="cpu")


def test_mu_channel_k3_matches_jax_per_receiver():
    """K = 3, COST259-TU, Jakes at 30 Hz, the JAX test's path losses."""
    jmu, mu, jstates, states = _mu_pair(False)
    assert states.t0.shape == (9,)
    x = _crandn(np.random.default_rng(7), 3, 64)
    out, irs, new = mu.corrupt_data(states, torch.as_tensor(x))
    jout, jirs, jnew = jmu.corrupt_data(jstates, cplx.from_numpy(x))
    assert len(out) == 3
    for r in range(3):
        np.testing.assert_allclose(out[r].numpy(), jout[r].to_numpy(),
                                   atol=ATOL)
    jtaps = jirs.tap_values_sparse.to_numpy()       # (taps, links, N)
    for r in range(3):
        for t in range(3):
            np.testing.assert_allclose(
                mu.get_last_impulse_response(r, t, irs)
                .tap_values_sparse.numpy(), jtaps[:, 3 * r + t], atol=ATOL)
    np.testing.assert_allclose(new.t0.numpy(), np.asarray(jnew.t0))
    # the stateful form keeps the last responses per link
    mu.seed(1)
    out = mu.corrupt_data(x)
    assert isinstance(out[0], np.ndarray)      # numpy in, numpy out
    assert out[0].shape == (64 + mu.num_taps_with_padding - 1,)
    assert mu.get_last_impulse_response(2, 1).num_samples == 64


def test_mu_mimo_channel_freq_domain_matches_jax():
    """2 users x 2 x 2 antennas in the frequency domain."""
    jmu, mu, jstates, states = _mu_pair(True)
    x = _crandn(np.random.default_rng(9), 2, 2, 32)
    out, irs, _ = mu.corrupt_data_in_freq_domain(
        states, [torch.as_tensor(v) for v in x], 16, None)
    jout, jirs, _ = jmu.corrupt_data_in_freq_domain(
        jstates, [cplx.from_numpy(v) for v in x], 16, None)
    for r in range(2):
        assert out[r].shape == (2, 32)
        np.testing.assert_allclose(out[r].numpy(), jout[r].to_numpy(),
                                   atol=ATOL)
    jtaps = jirs.tap_values_sparse.to_numpy()   # (taps, links, 2, 2, 2)
    for link in range(4):
        np.testing.assert_allclose(
            mu.get_last_impulse_response(link // 2, link % 2, irs)
            .tap_values_sparse.numpy(), jtaps[:, link], atol=ATOL)
    assert (mu.num_rx_antennas, mu.num_tx_antennas) == (2, 2)
    assert repr(mu) == repr(jmu) == "MuChannel with shape 2x2"


@pytest.mark.parametrize("freq", [False, True])
def test_one_batched_call_matches_a_per_link_loop(freq, monkeypatch):
    """The K^2 links run in ONE TdlChannel call over an attempts batch,
    equal to a loop of SuChannel over the same links' states."""
    _, gen = _jakes()
    mu = MuChannel(3, gen, COST259_TUx)
    mu.set_pathloss(PL)
    states = mu.init_state(AttemptStreams.from_range(5, 0, 2, "cpu"))
    assert states.phi_l.shape[:2] == (2, 9)
    x = torch.as_tensor(_crandn(np.random.default_rng(3), 2, 3, 64))
    calls = []
    name = "_corrupt_freq_impl" if freq else "_corrupt_data_impl"
    orig = getattr(TdlChannel, name)
    monkeypatch.setattr(TdlChannel, name,
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    if freq:
        out, irs, _ = mu.corrupt_data_in_freq_domain(states, x, 32, None)
    else:
        out, irs, _ = mu.corrupt_data(states, x)
    assert len(calls) == 1
    monkeypatch.undo()
    for r in range(3):
        acc = 0
        for t in range(3):
            su = SuChannel(JakesSampleGenerator(30.0, TS_TEST, 16,
                                                device="cpu"), COST259_TUx)
            su.set_pathloss(PL[r, t])
            link = type(states)(*(v[:, 3 * r + t] for v in states))
            if freq:
                o, ir, _ = su.corrupt_data_in_freq_domain(link, x[:, t], 32,
                                                          None)
            else:
                o, ir, _ = su.corrupt_data(link, x[:, t])
            acc = acc + o
            np.testing.assert_allclose(
                mu.get_last_impulse_response(r, t, irs)
                .tap_values_sparse.numpy(), ir.tap_values_sparse.numpy(),
                atol=1e-6)
        np.testing.assert_allclose(out[r].numpy(), acc.numpy(), atol=1e-6)


def test_k3_interference_sweep_through_the_per_key_runner():
    """The JAX test's K = 3 sweep (1 x 1 antennas a link, equal power:
    interference-limited, SER inside (0.05, 0.95)) on the port's per-key
    path at a small width; the results do not depend on the chunk
    size."""
    from apps.mimo.mu_mimo_interference_torch import \
        MuMimoInterferenceRunner

    def run(batch):
        r = MuMimoInterferenceRunner(fft_size=64, num_used=48,
                                     num_symbols=2, device="cpu",
                                     read_command_line_args=False)
        r.params.add("SNR", np.array([30.0, 50.0]))
        r.rep_max, r.batch_size = 16, batch
        r.simulate()
        return r

    r8, r16 = run(8), run(16)
    ser = np.array(r8.results.get_result_values_list("ser"))
    assert np.all(ser > 0.05) and np.all(ser < 0.95), ser
    assert r8.results.get_result_values_list("symbol_errors") == \
        r16.results.get_result_values_list("symbol_errors")
    assert (r8.chunks_dispatched, r16.chunks_dispatched) == (4, 2)
