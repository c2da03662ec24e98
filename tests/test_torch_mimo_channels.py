"""The port's MIMO TDL channel (``TdlMimoChannel`` and a MIMO-shaped
``TdlChannel``) against the JAX package, both driven from one Jakes state
carried across as numpy (``jakes_state_from_numpy``).

Routes: per sample; block-static on both block-convolution routes (the
kernel route through ``block_fir``'s plain version here); the frequency
domain with and without ``carrier_indexes``; each with and without
``switched_direction``. Outputs and impulse responses agree to atol 1e-4,
the JAX tests' tolerance (O(1) float32 values summed in another order).
Then the JAX package's raises, the MIMO impulse response's views, the
antenna setters, and, on the card only, the kernel route against the plain
version.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pyphysim_tpu.channels import fading as J_fading  # noqa: E402
from pyphysim_tpu.channels.fading_generators import \
    JakesSampleGenerator as J_Jakes  # noqa: E402
from pyphysim_tpu.ops import cplx  # noqa: E402
from pyphysim_tpu_torch.channels import (JakesSampleGenerator,  # noqa: E402
                                         RayleighSampleGenerator,
                                         TdlChannel, TdlImpulseResponse,
                                         TdlMimoChannel, fading,
                                         jakes_state_from_numpy)
from pyphysim_tpu_torch.ops import fir  # noqa: E402

TS = 1.0 / 20e6
L = 16
ATOL = 1e-4
BLOCK = 48                     # >= the COST259-TU span at TS (44)
FFT = 64
CARRIERS = np.r_[2:26, 40:64]  # 48 used carriers


def _crandn(rng, *shape):
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(np.complex64)


def _pair(cls, nr, nt, seed):
    """The JAX channel and the port's, with one Jakes state."""
    jch = getattr(J_fading, cls)(J_Jakes(30.0, TS, L, shape=(nr, nt)),
                                 J_fading.COST259_TUx)
    ch = getattr(fading, cls)(
        JakesSampleGenerator(30.0, TS, L, shape=(nr, nt), device="cpu"),
        fading.COST259_TUx)
    jstate = jch.init_state(jax.random.PRNGKey(seed))
    return jch, ch, jstate, jakes_state_from_numpy(jstate, device="cpu")


def _run(ch, state, x, route, to_tensor):
    if route in ("per_sample", "block_kernel", "block_fft"):
        block = None if route == "per_sample" else BLOCK
        return ch.corrupt_data(state, to_tensor(x), block_size=block)
    carriers = CARRIERS if route == "freq_carriers" else None
    return ch.corrupt_data_in_freq_domain(state, to_tensor(x), FFT,
                                          carriers)


def _signal(rng, route, rows):
    n = {"freq": FFT, "freq_carriers": CARRIERS.size}.get(route, BLOCK)
    return _crandn(rng, rows, 3 * n)


ROUTES = ["per_sample", "block_kernel", "block_fft", "freq",
          "freq_carriers"]


@pytest.mark.parametrize("nr,nt", [(2, 3), (4, 4)])
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("switched", [False, True])
def test_tdl_mimo_channel_matches_jax(nr, nt, route, switched,
                                      monkeypatch):
    jch, ch, jstate, state = _pair("TdlMimoChannel", nr, nt, 3 + nr)
    jch.switched_direction = ch.switched_direction = switched
    monkeypatch.setattr(fading, "BLOCK_CONV_IMPL",
                        "fft" if route == "block_fft" else "auto")
    x = _signal(np.random.default_rng(nr + 10 * switched), route,
                nr if switched else nt)
    fir.block_fir.reference_count = 0
    out, ir, new_state = _run(ch, state, x, route, torch.as_tensor)
    jout, jir, jnew = _run(jch, jstate, x, route, cplx.from_numpy)
    assert out.shape == jout.shape == ((nt if switched else nr),
                                       out.shape[-1])
    np.testing.assert_allclose(out.numpy(), jout.to_numpy(), atol=ATOL)
    assert ir.mimo and ir.tap_values_sparse.shape == \
        jir.tap_values_sparse.shape
    np.testing.assert_allclose(ir.tap_values_sparse.numpy(),
                               jir.tap_values_sparse.to_numpy(), atol=ATOL)
    np.testing.assert_allclose(new_state.t0.numpy(), np.asarray(jnew.t0),
                               rtol=1e-6)
    if route == "block_kernel":       # one plain block_fir call, all pairs
        assert fir.block_fir.reference_count == 1


@pytest.mark.parametrize("nr,nt", [(2, 3), (4, 4)])
@pytest.mark.parametrize("route", ["per_sample", "block_kernel", "freq"])
def test_mimo_shaped_tdl_channel_matches_jax(nr, nt, route):
    """A plain TdlChannel with a (Nr, Nt) generator: with a block_size it
    filters per sample and returns the per-sample response, as the JAX
    package's does (its other routes are TdlMimoChannel's code, whose
    test above covers their options)."""
    jch, ch, jstate, state = _pair("TdlChannel", nr, nt, 20 + nr)
    x = _signal(np.random.default_rng(nr), route, nt)
    out, ir, _ = _run(ch, state, x, route, torch.as_tensor)
    jout, jir, _ = _run(jch, jstate, x, route, cplx.from_numpy)
    np.testing.assert_allclose(out.numpy(), jout.to_numpy(), atol=ATOL)
    np.testing.assert_allclose(ir.tap_values_sparse.numpy(),
                               jir.tap_values_sparse.to_numpy(), atol=ATOL)
    if route == "block_kernel":
        assert ir.num_samples == x.shape[-1]      # per-sample response


def test_switched_freq_domain_on_a_plain_channel_matches_jax():
    jch, ch, jstate, state = _pair("TdlChannel", 2, 3, 7)
    jch.switched_direction = ch.switched_direction = True
    x = _crandn(np.random.default_rng(1), 2, 2 * FFT)
    out, _, _ = ch.corrupt_data_in_freq_domain(state, torch.as_tensor(x),
                                               FFT)
    jout, _, _ = jch.corrupt_data_in_freq_domain(jstate, cplx.from_numpy(x),
                                                 FFT)
    assert out.shape == (3, 2 * FFT)
    np.testing.assert_allclose(out.numpy(), jout.to_numpy(), atol=ATOL)


def test_batched_states_match_jax_row_by_row():
    """Two attempts' states stacked (``jakes_state_from_numpy`` of a list)
    give, row by row, the JAX package's output of each state."""
    jch, ch, _, _ = _pair("TdlMimoChannel", 2, 3, 0)
    jstates = [jch.init_state(jax.random.PRNGKey(s)) for s in (4, 5)]
    state = jakes_state_from_numpy(jstates, device="cpu")
    assert state.phi_l.shape == (2, L, ch.num_taps, 2, 3, 1)
    x = _crandn(np.random.default_rng(2), 2, 3, 3 * BLOCK)
    out, ir, _ = ch.corrupt_data(state, torch.as_tensor(x), block_size=BLOCK)
    for row, js in enumerate(jstates):
        jout, jir, _ = jch.corrupt_data(js, cplx.from_numpy(x[row]),
                                        block_size=BLOCK)
        np.testing.assert_allclose(out[row].numpy(), jout.to_numpy(),
                                   atol=ATOL)
        np.testing.assert_allclose(ir.tap_values_sparse[row].numpy(),
                                   jir.tap_values_sparse.to_numpy(),
                                   atol=ATOL)


def test_raises_as_the_jax_package():
    with pytest.raises(RuntimeError, match="num_rx_antennas"):
        TdlMimoChannel(JakesSampleGenerator(30.0, TS, L, device="cpu"),
                       fading.COST259_TUx)
    with pytest.raises(RuntimeError, match="num_rx_antennas"):
        J_fading.TdlMimoChannel(J_Jakes(30.0, TS, L), J_fading.COST259_TUx)
    # the plain channel refuses the per-sample uplink, in both packages
    jch, ch, jstate, state = _pair("TdlChannel", 2, 3, 1)
    jch.switched_direction = ch.switched_direction = True
    x = _crandn(np.random.default_rng(0), 2, 2 * BLOCK)
    with pytest.raises(NotImplementedError):
        ch.corrupt_data(state, torch.as_tensor(x))
    with pytest.raises(NotImplementedError):
        jch.corrupt_data(jstate, cplx.from_numpy(x))
    with pytest.raises(NotImplementedError):
        ch.corrupt_data(state, torch.as_tensor(x), block_size=BLOCK)
    _, ch, _, state = _pair("TdlMimoChannel", 2, 3, 1)
    x = _crandn(np.random.default_rng(0), 3, 2 * BLOCK + 1)
    with pytest.raises(ValueError, match="block_size"):
        ch.corrupt_data(state, torch.as_tensor(x), block_size=BLOCK)
    with pytest.raises(ValueError, match="span"):
        ch.corrupt_data(state, torch.as_tensor(x[:, :40]), block_size=20)
    ir, _ = ch._generate_strided_impulse_response(state, 2, BLOCK)
    with pytest.raises(ValueError, match="do not match"):
        fading.tdl_filter_block_fft_mimo(
            ir, torch.as_tensor(x[:2, :2 * BLOCK]), BLOCK)
    with pytest.raises(ValueError, match="antenna axes"):
        TdlImpulseResponse(ir.tap_values_sparse[:, 0, 0],
                           ir.channel_profile).transposed()


def test_mimo_impulse_response_views_match_jax():
    jch, ch, jstate, state = _pair("TdlMimoChannel", 2, 3, 9)
    jir, _ = jch.generate_impulse_response_f(jstate, 5)
    taps = np.asarray(jir.tap_values_sparse.to_numpy())
    ir = TdlImpulseResponse.from_numpy(taps, ch.channel_profile,
                                       device="cpu")
    assert ir.mimo and ir.tap_axis == -4
    np.testing.assert_allclose(ir.tap_values.numpy(),
                               jir.tap_values.to_numpy(), atol=1e-6)
    np.testing.assert_allclose(ir.get_freq_response(FFT).numpy(),
                               jir.get_freq_response(FFT).to_numpy(),
                               atol=ATOL)
    np.testing.assert_allclose((ir * 0.5).tap_values_sparse.numpy(),
                               0.5 * taps, atol=1e-7)
    both = TdlImpulseResponse.concatenate_samples([ir, ir])
    assert both.mimo and both.num_samples == 10
    np.testing.assert_array_equal(
        ir.transposed().tap_values_sparse.numpy(), taps.transpose(0, 2, 1, 3))
    mine, _ = ch.generate_impulse_response_f(state, 5)
    np.testing.assert_allclose(mine.tap_values_sparse.numpy(), taps,
                               atol=1e-5)


def test_antenna_setters_match_jax():
    gen = RayleighSampleGenerator(device="cpu")
    ch = TdlChannel(gen, fading.COST259_TUx, Ts=TS)
    jch = J_fading.TdlChannel(J_Jakes(30.0, TS, L), J_fading.COST259_TUx)
    for nr, nt in ((None, None), (2, 4), (3, 1), (None, None)):
        ch.set_num_antennas(nr, nt)
        jch.set_num_antennas(nr, nt)
        assert (ch.num_rx_antennas, ch.num_tx_antennas) == \
            (jch.num_rx_antennas, jch.num_tx_antennas) == (nr, nt)
        assert ch.mimo == (nr is not None)
    ch.set_num_antennas(2, 3)
    assert gen.shape == (ch.num_taps, 2, 3)
    x = torch.ones(3, 2 * BLOCK, dtype=torch.complex64)
    out = ch.corrupt_data(x)                 # the stateful form, MIMO
    assert out.shape == (2, 2 * BLOCK + ch.num_taps_with_padding - 1)
    assert ch.get_last_impulse_response().tap_values_sparse.shape == \
        (ch.num_taps, 2, 3, 2 * BLOCK)
    with pytest.raises(ValueError, match="Invalid fading generator shape"):
        TdlChannel(RayleighSampleGenerator(shape=(1, 2, 3, 4), device="cpu"),
                   fading.COST259_TUx, Ts=TS)


@pytest.mark.cuda
@pytest.mark.parametrize("nr,nt", [(2, 3), (4, 4)])
def test_mimo_kernel_route_against_plain_version_on_the_card(nr, nt):
    """On the card: the MIMO block-static route's one block_fir launch
    against the same route through block_fir's plain version, within the
    kernel's tolerance (1e-5 of the largest output)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda")
    gen = JakesSampleGenerator(30.0, TS, L, shape=(nr, nt), device=dev)
    ch = TdlMimoChannel(gen, fading.COST259_TUx)
    state = ch.init_state(torch.Generator(device=dev).manual_seed(1),
                          (8,))
    ir, _ = ch._generate_strided_impulse_response(state, 4, 564)
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(8, nt, 4 * 564, dtype=torch.complex64, device=dev,
                    generator=g)
    launches = fir.block_fir.launch_count
    y = fading.tdl_filter_block_fft_mimo(ir, x, 564)
    assert fir.block_fir.launch_count == launches + 1
    cpu_ir = TdlImpulseResponse(ir.tap_values_sparse.cpu(),
                                ir.channel_profile, True)
    ref = fading.tdl_filter_block_fft_mimo(cpu_ir, x.cpu(), 564)
    err = float((y.cpu() - ref).abs().max() / ref.abs().max())
    assert err <= 1e-5, err
