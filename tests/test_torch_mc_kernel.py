"""The port's Monte Carlo kernel (pyphysim_tpu_torch/ops/mc_kernel.py)
held against the JAX kernel (pyphysim_tpu/ops/mc_pallas.py).

On the CPU the wrappers run the plain PyTorch version. The same numpy
uint32 bits go to the JAX kernel (``build_inject`` under the Pallas
interpreter, as tests/test_mc_pallas.py runs it) and to the port. The
tolerance is the JAX test's own: identical bits and float32 math, with a
handful of decision-boundary flips allowed from float association and
transcendental differences (at most 16 per (rep, tile) cell and 32 per
call), in float32 and in bf16 channel-product mode. The CUDA kernel itself is compared with the plain version on the
card by ``chip_smoke.py`` and by the ``cuda``-marked tests here.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pyphysim_tpu.channels.fading import COST259_TUx as J_COST259_TUx  # noqa: E402
from pyphysim_tpu.channels.fading import TdlChannel as J_TdlChannel  # noqa: E402
from pyphysim_tpu.channels.fading_generators import \
    JakesSampleGenerator as J_Jakes  # noqa: E402
from pyphysim_tpu.modulators import OFDM as J_OFDM  # noqa: E402
from pyphysim_tpu.ops.mc_pallas import MonteCarloOfdmTdl as J_MC  # noqa: E402
from pyphysim_tpu_torch.channels import (COST259_TUx,  # noqa: E402
                                         JakesSampleGenerator, TdlChannel)
from pyphysim_tpu_torch.modulators import OFDM  # noqa: E402
from pyphysim_tpu_torch.ops.mc_kernel import (MonteCarloOfdmTdl,  # noqa: E402
                                              from_jax_arrays)

TS = 1.0 / 20e6
# bench.py BER_CORNERS (copied: bench.py imports jax)
BER_CORNERS = [(5.0, 0.08, 0.22), (15.0, 0.02, 0.06), (30.0, 2e-4, 6e-3)]


def _port_mc(tile, device="cpu", matmul_dtype=torch.float32):
    ofdm = OFDM(512, 52, 300, device=device)
    jakes = JakesSampleGenerator(Fd=30.0, Ts=TS, L=16, device=device)
    return MonteCarloOfdmTdl(ofdm, TdlChannel(jakes, COST259_TUx), M=16,
                             tile=tile, matmul_dtype=matmul_dtype,
                             device=device)


def _jax_mc(tile, matmul_dtype=jnp.float32):
    channel = J_TdlChannel(J_Jakes(Fd=30.0, Ts=TS, L=16), J_COST259_TUx)
    return J_MC(J_OFDM(512, 52, 300), channel, M=16, tile=tile,
                matmul_dtype=matmul_dtype)


def _jax_state(jmc):
    return {"g_re": np.asarray(jmc._g_re), "g_im": np.asarray(jmc._g_im),
            "C": jmc._C, "noise_gain": jmc.noise_gain, "M": jmc._M,
            "tile": jmc._tile, "used": jmc._used, "TL": jmc._TL}


def _bits(seed, mc, reps, num_tiles):
    """uint32 bits in the JAX inject layout, from a numpy seed."""
    rng = np.random.default_rng(seed)
    pb = rng.integers(0, 2 ** 32, (reps, 8, mc.TLp), dtype=np.uint32)
    shape = (reps, num_tiles * mc.tile, mc.used_p)
    return (pb,) + tuple(rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
                         for _ in range(3))


def _amp(mc, snr_db):
    return np.float32(np.sqrt(0.5 / 10 ** (snr_db / 10.0)) * mc.noise_gain)


def test_host_constants_match_jax():
    """G bit-equal on its (TL, used) block (JAX's padding is zero), C and
    noise_gain to 1e-12 relative, for the flagship geometry."""
    mc, jmc = _port_mc(64), _jax_mc(64)
    assert (mc.TL, mc.used, mc.TLp, mc.used_p) == \
        (jmc._TL, jmc._used, jmc._TLp, jmc._used_p) == (256, 300, 256, 384)
    for mine, theirs in ((mc.g_re, jmc._g_re), (mc.g_im, jmc._g_im)):
        theirs = np.asarray(theirs)
        np.testing.assert_array_equal(mine.numpy(),
                                      theirs[:mc.TL, :mc.used])
        assert not theirs[mc.TL:].any() and not theirs[:, mc.used:].any()
    assert mc.C == pytest.approx(jmc._C, rel=1e-12)
    assert mc.noise_gain == pytest.approx(jmc.noise_gain, rel=1e-12)
    assert mc.qam_scale == pytest.approx(jmc._qam_scale, rel=1e-12)


@pytest.mark.parametrize("seed,snr_db", [(0, 15.0), (1, 5.0)])
def test_inject_matches_jax_kernel(seed, snr_db):
    mc, jmc = _port_mc(64), _jax_mc(64)
    reps, num_tiles = 2, 2
    bits = _bits(seed, mc, reps, num_tiles)
    amp = _amp(mc, snr_db)
    want = np.asarray(jmc.build_inject(reps, num_tiles)(*bits, amp),
                      np.int64)
    got = mc.build_inject(reps, num_tiles)(*bits, amp).numpy().astype(
        np.int64)
    total = int(want.sum())
    assert total > 1000  # the comparison is not vacuous
    assert abs(int(got.sum()) - total) <= 32
    assert np.all(np.abs(got - want) <= 16)


def test_from_jax_arrays_gives_identical_counts():
    jmc = _jax_mc(64)
    carried = from_jax_arrays(_jax_state(jmc), device="cpu")
    mc = _port_mc(64)
    bits = _bits(4, mc, 2, 2)
    amp = _amp(mc, 10.0)
    np.testing.assert_array_equal(
        carried.build_inject(2, 2)(*bits, amp).numpy(),
        mc.build_inject(2, 2)(*bits, amp).numpy())
    np.testing.assert_array_equal(carried.build(2, 2)(9, 10.0, 3).numpy(),
                                  mc.build(2, 2)(9, 10.0, 3).numpy())


@pytest.mark.parametrize("seed,snr_db", [(2, 15.0), (3, 5.0)])
def test_bf16_inject_matches_jax_kernel(seed, snr_db):
    """bf16 mode (E and G rounded to bf16, f32 sums) against the JAX
    kernel's ``matmul_dtype=bfloat16`` on the same bits, at the JAX test's
    slack: a different result from float32 mode, with its own parity."""
    mc = _port_mc(64, matmul_dtype=torch.bfloat16)
    jmc = _jax_mc(64, jnp.bfloat16)
    bits = _bits(seed, mc, 2, 2)
    amp = _amp(mc, snr_db)
    want = np.asarray(jmc.build_inject(2, 2)(*bits, amp), np.int64)
    got = mc.build_inject(2, 2)(*bits, amp).numpy().astype(np.int64)
    assert int(want.sum()) > 1000
    assert abs(int(got.sum()) - int(want.sum())) <= 32
    assert np.all(np.abs(got - want) <= 16)


def test_bf16_g_matches_jax():
    """The rounded G the bf16 plain version multiplies by is the JAX
    object's bf16 G, bit for bit."""
    mc, jmc = _port_mc(16, matmul_dtype="bfloat16"), _jax_mc(16, jnp.bfloat16)
    for mine, theirs in ((mc._g.real, jmc._g_re), (mc._g.imag, jmc._g_im)):
        theirs = np.asarray(theirs, np.float32)[:mc.TL, :mc.used]
        np.testing.assert_array_equal(mine.numpy(), theirs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_g_tap_is_the_first_row_of_each_tap(dtype):
    mc = _port_mc(16, matmul_dtype=dtype)
    assert (mc.taps, mc.rays) == (16, 16)
    want_re, want_im = mc.g_re[::16], mc.g_im[::16]
    if dtype == torch.bfloat16:
        want_re = want_re.to(dtype).float()
        want_im = want_im.to(dtype).float()
    assert torch.equal(mc.g_tap_re, want_re)
    assert torch.equal(mc.g_tap_im, want_im)
    g = mc.g_re.reshape(16, 16, -1)
    assert torch.equal(g, g[:, :1].expand_as(g))   # the rays share a row


def test_from_jax_arrays_checks_the_tap_structure():
    """The ray count comes from G (the leading rows equal to the first);
    every tap must then repeat one row over that many rays."""
    state = _jax_state(_jax_mc(16))
    carried = from_jax_arrays(state, device="cpu")
    assert (carried.rays, carried.taps) == (16, 16)
    for key in ("g_re", "g_im"):
        bad = state[key].copy()
        bad[16 + 5, 7] += 1e-3            # ray 5 of tap 1 differs
        with pytest.raises(ValueError, match="rows of a tap"):
            from_jax_arrays(dict(state, **{key: bad}), device="cpu")
    with pytest.raises(ValueError, match="multiple of the ray count"):
        from_jax_arrays(dict(state, TL=250), device="cpu")


def test_from_jax_arrays_carries_bf16():
    jmc = _jax_mc(64, jnp.bfloat16)
    carried = from_jax_arrays(dict(_jax_state(jmc),
                                   matmul_dtype=str(jmc._matmul_dtype)),
                              device="cpu")
    assert carried.matmul_dtype == torch.bfloat16
    mc = _port_mc(64, matmul_dtype=torch.bfloat16)
    bits = _bits(4, mc, 2, 2)
    amp = _amp(mc, 10.0)
    np.testing.assert_array_equal(
        carried.build_inject(2, 2)(*bits, amp).numpy(),
        mc.build_inject(2, 2)(*bits, amp).numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rays_first_product_is_the_depth_tl_product(dtype):
    """The kernel's order (rays of a tap summed, then a 16-deep product
    with G_tap) against the plain version's 256-deep E @ G, on the phasors
    of a whole tile of 1,024 symbols: within 2e-6 of max |H|."""
    mc = _port_mc(16, matmul_dtype=dtype)
    rng = np.random.default_rng(21)
    phi, psi = rng.uniform(0, 2 * np.pi, (2, mc.TL))
    t = np.arange(1024)[:, None]
    e = torch.from_numpy(np.exp(1j * (t * mc.C * np.cos(phi) + psi))
                         .astype(np.complex64))
    want = mc.channel_reference(e)
    got = mc.channel_rays_first(e)
    assert got.shape == want.shape == (1024, mc.used)
    assert float((got - want).abs().max()) <= 2e-6 * float(want.abs().max())


@pytest.mark.parametrize("dtype", ["float16", torch.float64, "bf16", None,
                                   np.float32])
def test_unknown_matmul_dtype_raises(dtype):
    with pytest.raises(ValueError, match="matmul_dtype"):
        _port_mc(16, matmul_dtype=dtype)


def test_prng_kernel_profile():
    """One thread per used bin and block (idle lanes left out) and the
    trips of the kernel's four loops, at the flagship chunk and at a tile
    smaller than a block's rows."""
    mc = _port_mc(1024, matmul_dtype="bfloat16")
    assert mc.prng_kernel_profile(32, 4) == {
        "pattern": "mc_ofdm_tdl_kernelILi16ELb0ELb1EE",
        "threads": 32 * 4 * 16 * 300, "loops": 4,
        "loop_trips": [256 / 300, 16, 16 * 64 / 300, 64]}
    small = _port_mc(16).prng_kernel_profile(2, 2)
    assert small["pattern"] == "mc_ofdm_tdl_kernelILi16ELb0ELb0EE"
    assert small["threads"] == 2 * 2 * 300
    assert small["loop_trips"] == [256 / 300, 16, 16 * 16 / 300, 16]


def test_extreme_noise_bits_stay_finite():
    """0x7fffffff noise bits round to exactly 1.0 in _u11; without the
    clamp erfinv(1.0) = +inf would corrupt every decision. At high SNR the
    decisions must come out nearly error-free, not saturated."""
    mc = _port_mc(64)
    pb, db, n1, n2 = _bits(5, mc, 1, 1)
    n1 = np.full_like(n1, 0x7FFFFFFF)
    n2 = np.full_like(n2, 0x7FFFFFFF)
    errs = int(mc.build_inject(1, 1)(pb, db, n1, n2, _amp(mc, 40.0)).sum())
    bits = mc.tile * mc.used * mc.bits_per_symbol
    assert errs < 0.01 * bits, f"{errs}/{bits} bit errors"


@pytest.mark.parametrize("snr_db,lo,hi", BER_CORNERS)
def test_prng_mode_ber_corners(snr_db, lo, hi):
    """PRNG mode (Philox bits, plain version on the CPU) inside the BER
    brackets bench.py asserts on the JAX kernel."""
    mc = _port_mc(64)
    reps, num_tiles = 4, 2
    counts = mc.build(reps, num_tiles)(seed=11 + int(snr_db),
                                       snr_linear=10 ** (snr_db / 10.0))
    bits = reps * num_tiles * mc.tile * mc.used * mc.bits_per_symbol
    ber = int(counts.sum()) / bits
    assert lo < ber < hi, f"BER {ber} outside ({lo}, {hi}) at {snr_db}"


def test_prng_mode_is_chunk_invariant():
    mc = _port_mc(16)
    four = mc.build(4, 2)(7, 30.0, 0)
    two = mc.build(2, 2)(7, 30.0, 2)
    assert torch.equal(four[2:], two)
    assert not torch.equal(four[:2], two)


def test_inject_accepts_tensors_and_checks_shapes():
    mc = _port_mc(16)
    bits = _bits(6, mc, 2, 1)
    amp = _amp(mc, 10.0)
    from_numpy = mc.build_inject(2, 1)(*bits, amp)
    as_int64 = [torch.from_numpy(b.astype(np.int64)) for b in bits]
    assert torch.equal(mc.build_inject(2, 1)(*as_int64, amp), from_numpy)
    with pytest.raises(ValueError, match="data/noise bits"):
        mc.build_inject(2, 2)(*bits, amp)
    with pytest.raises(ValueError, match="phase bits"):
        mc.build_inject(2, 1)(bits[0][:, :1], *bits[1:], amp)
    with pytest.raises(TypeError, match="32-bit"):
        mc.build_inject(2, 1)(*(torch.zeros(b.shape) for b in bits), amp)


def test_constructor_checks():
    mc = _port_mc(16)
    state = {"g_re": mc.g_re.numpy(), "g_im": mc.g_im.numpy(), "C": mc.C,
             "noise_gain": mc.noise_gain, "M": 16, "tile": 16,
             "used": mc.used, "TL": mc.TL}
    with pytest.raises(ValueError, match="square power of 2"):
        from_jax_arrays(dict(state, M=8), device="cpu")
    with pytest.raises(ValueError, match="tile"):
        from_jax_arrays(dict(state, tile=24), device="cpu")
    short_cp = OFDM(512, 10, 300, device="cpu")
    with pytest.raises(ValueError, match="cp_size"):
        MonteCarloOfdmTdl(short_cp, TdlChannel(
            JakesSampleGenerator(Fd=30.0, Ts=TS, L=4, device="cpu"),
            COST259_TUx), device="cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile", [256, 16])
def test_cuda_kernel_matches_plain_version(cuda_device, tile, dtype):
    """Kernel vs plain version on the card, inject and PRNG mode, at
    |diff| <= 2e-4 of a cell's bits (the JAX test's 16 in 76,800), in both
    channel-product types; tile 16 is smaller than a block's 64 rows."""
    mc = _port_mc(tile, cuda_device, dtype)
    cell_bits = mc.tile * mc.used * mc.bits_per_symbol
    bits = [torch.from_numpy(b.view(np.int32)).to(cuda_device)
            for b in _bits(8, mc, 2, 2)]
    amp = float(_amp(mc, 15.0))
    got = mc.build_inject(2, 2)(*bits, amp)
    want = mc.simulate_block_reference(*bits, amp)
    assert (got - want).abs().max().item() <= 2e-4 * cell_bits
    got = mc.build(2, 2)(5, 10 ** 1.5, 0)
    want = mc.prng_reference(2, 2, 5, mc.amp(10 ** 1.5), 0)
    assert (got - want).abs().max().item() <= 2e-4 * cell_bits
    assert mc.launch_count == 2
