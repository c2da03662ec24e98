"""The port's SISO TDL channel against the JAX package, both driven from
one Jakes state carried across as numpy (``JakesState.from_numpy``).

Impulse responses (per-sample and strided), the dense view, the frequency
response (frequency axis last), ``corrupt_data`` per-sample and
block-static, ``corrupt_data_in_freq_domain``, a batched port state
against the JAX package row by row, the stateful convenience form, and
the Rayleigh generator's moments. Tolerances: 1e-5 on O(1) float32 values
(the same closed forms, summed in another order); 2e-5 on channel outputs,
which add 16 such products.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pyphysim_tpu.channels import fading as J_fading  # noqa: E402
from pyphysim_tpu.channels.fading_generators import \
    JakesSampleGenerator as J_Jakes  # noqa: E402
from pyphysim_tpu.channels.fading_generators import \
    JakesState as J_JakesState  # noqa: E402
from pyphysim_tpu.ops.cplx import CArray  # noqa: E402
from pyphysim_tpu_torch.channels import (JakesSampleGenerator,  # noqa: E402
                                         JakesState, RayleighSampleGenerator,
                                         RayleighState, TdlChannel,
                                         TdlImpulseResponse, fading,
                                         generate_jakes_samples)

TS = 1.0 / 20e6
L = 16
ATOL = 1e-5
ATOL_OUT = 2e-5


def _state(rng, batch=()):
    shape = batch + (L, 16, 1)
    phi = rng.uniform(0, 2 * np.pi, shape).astype(np.float32)
    psi = rng.uniform(0, 2 * np.pi, shape).astype(np.float32)
    return phi, psi


def _channels():
    j = J_fading.TdlChannel(J_Jakes(Fd=30.0, Ts=TS, L=L),
                            J_fading.COST259_TUx)
    mine = TdlChannel(JakesSampleGenerator(Fd=30.0, Ts=TS, L=L,
                                           device="cpu"),
                      fading.COST259_TUx)
    return j, mine


def _pair(rng, t0=0.0):
    """A JAX state and the port's, from the same numpy arrays."""
    phi, psi = _state(rng)
    jstate = J_JakesState(jnp.asarray(phi), jnp.asarray(psi),
                          jnp.asarray(np.float32(t0)))
    return jstate, JakesState.from_numpy(phi, psi, t0, device="cpu")


def _signal(rng, *shape):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * np.sqrt(0.5)).astype(np.complex64)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def test_impulse_response_matches_jax():
    rng = np.random.default_rng(0)
    j, mine = _channels()
    jstate, state = _pair(rng, t0=1e-3)
    j_ir, jstate = j.generate_impulse_response_f(jstate, 300)
    ir, state = mine.generate_impulse_response_f(state, 300)
    assert isinstance(ir, TdlImpulseResponse)
    assert ir.tap_values_sparse.shape == (16, 300)
    _close(ir.tap_values_sparse.numpy(), j_ir.tap_values_sparse.to_numpy())
    _close(ir.tap_values.numpy(), j_ir.tap_values.to_numpy())
    np.testing.assert_array_equal(ir.tap_indexes_sparse,
                                  j_ir.tap_indexes_sparse)
    np.testing.assert_allclose(ir.tap_delays_sparse, j_ir.tap_delays_sparse)
    assert ir.Ts == j_ir.Ts and ir.num_samples == j_ir.num_samples
    for fft_size in (512, 32):      # 32 < span: taps beyond it are dropped
        _close(ir.get_freq_response(fft_size).numpy(),
               j_ir.get_freq_response(fft_size).to_numpy())
    _close(float(state.t0), float(jstate.t0), atol=1e-9)
    # a second draw continues in time
    j_ir2, _ = j.generate_impulse_response_f(jstate, 7)
    ir2, _ = mine.generate_impulse_response_f(state, 7)
    _close(ir2.tap_values_sparse.numpy(), j_ir2.tap_values_sparse.to_numpy())
    both = TdlImpulseResponse.concatenate_samples([ir, ir2])
    j_both = J_fading.TdlImpulseResponse.concatenate_samples([j_ir, j_ir2])
    _close(both.tap_values_sparse.numpy(),
           j_both.tap_values_sparse.to_numpy())
    _close((ir * 2.0).tap_values_sparse.numpy(),
           (j_ir * 2.0).tap_values_sparse.to_numpy(), atol=2 * ATOL)


def test_impulse_response_from_numpy():
    rng = np.random.default_rng(1)
    j, _ = _channels()
    jstate, _ = _pair(rng)
    j_ir, _ = j.generate_impulse_response_f(jstate, 5)
    profile = fading.COST259_TUx.get_discretize_profile(TS)
    ir = TdlImpulseResponse.from_numpy(
        np.asarray(j_ir.tap_values_sparse.to_numpy()), profile, device="cpu")
    assert ir.tap_values_sparse.dtype == torch.complex64
    _close(ir.get_freq_response(64).numpy(),
           j_ir.get_freq_response(64).to_numpy())
    with pytest.raises(RuntimeError, match="discretized"):
        TdlImpulseResponse(ir.tap_values_sparse, fading.COST259_TUx)


@pytest.mark.parametrize("block_size", [None, 564])
def test_corrupt_data_matches_jax(block_size):
    rng = np.random.default_rng(2)
    j, mine = _channels()
    jstate, state = _pair(rng, t0=2e-3)
    x = _signal(rng, 3 * 564)
    j_out, j_ir, jstate = j.corrupt_data(
        jstate, CArray(jnp.asarray(x.real), jnp.asarray(x.imag)),
        block_size=block_size)
    out, ir, state = mine.corrupt_data(state, torch.from_numpy(x),
                                       block_size=block_size)
    assert out.shape == (3 * 564 + 43,)
    _close(out.numpy(), j_out.to_numpy(), atol=ATOL_OUT)
    _close(ir.tap_values_sparse.numpy(), j_ir.tap_values_sparse.to_numpy())
    _close(float(state.t0), float(jstate.t0), atol=1e-9)


@pytest.mark.parametrize("carriers", [None, np.arange(10, 40)])
def test_corrupt_data_in_freq_domain_matches_jax(carriers):
    rng = np.random.default_rng(3)
    j, mine = _channels()
    jstate, state = _pair(rng, t0=5e-4)
    n = 3 * (64 if carriers is None else len(carriers))
    x = _signal(rng, n)
    j_out, j_ir, jstate = j.corrupt_data_in_freq_domain(
        jstate, CArray(jnp.asarray(x.real), jnp.asarray(x.imag)), 64,
        carriers)
    out, ir, state = mine.corrupt_data_in_freq_domain(
        state, torch.from_numpy(x), 64, carriers)
    _close(out.numpy(), j_out.to_numpy(), atol=ATOL_OUT)
    _close(ir.tap_values_sparse.numpy(), j_ir.tap_values_sparse.to_numpy())
    _close(float(state.t0), float(jstate.t0), atol=1e-9)
    with pytest.raises(ValueError, match="multiple"):
        mine.corrupt_data_in_freq_domain(state, torch.from_numpy(x[:-1]), 64,
                                         carriers)


@pytest.mark.parametrize("block_size", [None, 564])
def test_batched_state_matches_jax_rows(block_size):
    """One port call on a batch of states equals the JAX channel row by
    row (the JAX package would vmap)."""
    rng = np.random.default_rng(4)
    j, mine = _channels()
    phi, psi = _state(rng, (2,))
    t0 = np.array([0.0, 3e-3], np.float32)
    x = _signal(rng, 2, 2 * 564)
    state = JakesState.from_numpy(phi, psi, t0, device="cpu")
    out, ir, new = mine.corrupt_data(state, torch.from_numpy(x),
                                     block_size=block_size)
    assert out.shape == (2, 2 * 564 + 43)
    for b in range(2):
        jstate = J_JakesState(jnp.asarray(phi[b]), jnp.asarray(psi[b]),
                              jnp.asarray(t0[b]))
        j_out, j_ir, jnew = j.corrupt_data(
            jstate, CArray(jnp.asarray(x[b].real), jnp.asarray(x[b].imag)),
            block_size=block_size)
        _close(out[b].numpy(), j_out.to_numpy(), atol=ATOL_OUT)
        _close(ir.tap_values_sparse[b].numpy(),
               j_ir.tap_values_sparse.to_numpy())
        _close(float(new.t0[b]), float(jnew.t0), atol=1e-9)


def test_stateful_convenience_form():
    _, mine = _channels()
    x = torch.from_numpy(_signal(np.random.default_rng(5), 2 * 564))
    mine.seed(7)
    first = mine.corrupt_data(x, 564)
    ir = mine.get_last_impulse_response()
    assert ir is not None and ir.num_samples == 2
    second = mine.corrupt_data(x)            # continues the same state
    assert mine.get_last_impulse_response().num_samples == 2 * 564
    mine.seed(7)
    assert torch.equal(mine.corrupt_data(x, 564), first)
    assert not torch.equal(second[:564], first[:564])
    freq = mine.corrupt_data_in_freq_domain(x[:128], 64)
    assert freq.shape == (128,)


def test_rayleigh_moments():
    gen = RayleighSampleGenerator(shape=(4,), device="cpu")
    state = gen.init_state(torch.Generator().manual_seed(0))
    x, state = gen.generate(state, 50_000)
    assert x.shape == (4, 50_000) and x.dtype == torch.complex64
    n = x.numel()
    # mean 0 and E|x|^2 = 1, each within 5 standard errors
    assert abs(complex(x.mean())) < 5 / np.sqrt(n)
    assert abs(float((x.abs() ** 2).mean()) - 1.0) < 5 / np.sqrt(n)
    assert abs(float(x.real.var()) - 0.5) < 5 * 0.5 * np.sqrt(2 / n)
    assert abs(float((x.real * x.imag).mean())) < 5 * 0.5 / np.sqrt(n)
    y, _ = gen.generate(state, 10)
    assert not torch.equal(y, x[:, :10])     # the counter moved on


def test_rayleigh_state_from_jax_key_and_channel():
    """A JAX Rayleigh state's key, passed through numpy, names one port
    state; a Rayleigh TDL channel runs from it (with the profile
    discretized at Ts = 1, as the JAX package does)."""
    key = np.asarray(jax.random.PRNGKey(3))
    a = RayleighState.from_numpy(key, device="cpu")
    b = RayleighState.from_numpy(key, device="cpu")
    gen = RayleighSampleGenerator(device="cpu")
    channel = TdlChannel(gen, tap_powers_dB=np.array([0.0, -3.0]),
                         tap_delays=np.array([0.0, 2.0]))
    j_channel = J_fading.TdlChannel(
        J_fading.RayleighSampleGenerator(),
        tap_powers_dB=np.array([0.0, -3.0]), tap_delays=np.array([0.0, 2.0]))
    np.testing.assert_array_equal(channel.channel_profile.tap_delays,
                                  j_channel.channel_profile.tap_delays)
    x = torch.ones(6, dtype=torch.complex64)
    out_a, ir_a, _ = channel.corrupt_data(a, x)
    out_b, _, _ = channel.corrupt_data(b, x)
    assert torch.equal(out_a, out_b) and out_a.shape == (8,)
    # with a unit signal the output is the taps' running sum
    taps = ir_a.tap_values_sparse
    _close(out_a[:2].numpy(), taps[0, :2].numpy())
    _close(out_a[2:6].numpy(), (taps[0, 2:] + taps[1, :4]).numpy(),
           atol=1e-6)


# -- the generator base: similar generators, the stateful API, the
# -- stateless Jakes function -------------------------------------------------

def _jax_and_port_jakes(shape=(3,)):
    return (J_Jakes(Fd=30.0, Ts=TS, L=L, shape=shape),
            JakesSampleGenerator(Fd=30.0, Ts=TS, L=L, shape=shape,
                                 device="cpu"))


def _carry(jstate):
    """A JAX Jakes state as the port's, through numpy."""
    return JakesState.from_numpy(np.asarray(jstate.phi_l),
                                 np.asarray(jstate.psi_l),
                                 np.asarray(jstate.t0), device="cpu")


def test_similar_fading_generators_match_jax():
    j, mine = _jax_and_port_jakes()
    j2, mine2 = j.get_similar_fading_generator(), \
        mine.get_similar_fading_generator()
    assert isinstance(mine2, JakesSampleGenerator) and mine2 is not mine
    assert (mine2.Fd, mine2.Ts, mine2.L, mine2.shape, mine2.device) == \
        (j2.Fd, j2.Ts, j2.L, j2.shape, mine.device)
    jstate = j2.init_state(jax.random.PRNGKey(4))
    got, _ = mine2.generate(_carry(jstate), 50)
    want, _ = j2.generate(jstate, 50)
    _close(got.numpy(), want.to_numpy())
    r = RayleighSampleGenerator(shape=(2, 2), device="cpu")
    r2 = r.get_similar_fading_generator()
    assert isinstance(r2, RayleighSampleGenerator) and r2 is not r
    assert (r2.shape, r2.device) == (
        J_fading.RayleighSampleGenerator((2, 2))
        .get_similar_fading_generator().shape, r.device)


def test_stateful_api_matches_jax():
    """``generate_more_samples`` / ``skip_samples_for_next_generation`` /
    ``get_samples`` from one state as the JAX package's, the state carried
    over; one sample without the trailing axis when no count is given."""
    j, mine = _jax_and_port_jakes()
    j.set_seed(11)
    mine.set_seed(11)
    mine._state = _carry(j._state)
    for n in (20, None, 7):
        j.generate_more_samples(n)
        mine.generate_more_samples(n)
        got, want = mine.get_samples(), j.get_samples()
        assert isinstance(got, np.ndarray) and got.shape == want.shape
        _close(got, want)
        j.skip_samples_for_next_generation(564)
        mine.skip_samples_for_next_generation(564)
    assert mine.get_samples().shape == (3, 7)
    _close(float(mine._state.t0), float(j._state.t0), atol=1e-9)


@pytest.mark.parametrize("make", [
    lambda: JakesSampleGenerator(Fd=30.0, Ts=TS, L=L, shape=(2,),
                                 device="cpu"),
    lambda: RayleighSampleGenerator(shape=(2,), device="cpu"),
])
def test_stateful_api_is_seeded(make):
    """``set_seed`` makes the draws repeatable; without it each generator
    seeds itself; a skip moves the stream on."""
    a, b = make(), make()
    assert a.get_samples() is None
    for g in (a, b):
        g.set_seed(3)
        g.generate_more_samples(10)
    np.testing.assert_array_equal(a.get_samples(), b.get_samples())
    first = a.get_samples()
    a.skip_samples_for_next_generation(100)
    a.generate_more_samples(10)
    assert a.get_samples().shape == (2, 10)
    assert not np.array_equal(a.get_samples(), first)
    c = make()
    c.generate_more_samples()
    assert c.get_samples().shape == (2,) and c._seed is not None


def test_generate_jakes_samples_matches_jax():
    from pyphysim_tpu.channels.fading_generators import \
        generate_jakes_samples as j_generate
    key = jax.random.PRNGKey(9)
    want = j_generate(30.0, TS, 100, L, (2, 3), key=key)
    jstate = J_Jakes(30.0, TS, L, (2, 3)).init_state(key)
    got = generate_jakes_samples(30.0, TS, 100, L, (2, 3),
                                 source=_carry(jstate), device="cpu")
    assert got.shape == (2, 3, 100) and got.dtype == torch.complex64
    _close(got.numpy(), want.to_numpy())
    # a random source: the port's own draws, seeded like its generators
    a = generate_jakes_samples(30.0, TS, 64, L, device="cpu")
    b = generate_jakes_samples(
        30.0, TS, 64, L, source=torch.Generator().manual_seed(0),
        device="cpu")
    assert a.shape == (64,) and torch.equal(a, b)
    assert abs(float((a.abs() ** 2).mean()) - 1.0) < 1.0
