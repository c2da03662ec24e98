"""The port's Monte Carlo kernel (pyphysim_tpu_torch/ops/mc_kernel.py)
held against the JAX kernel (pyphysim_tpu/ops/mc_pallas.py).

On the CPU the wrappers run the plain PyTorch version. The same numpy
uint32 bits go to the JAX kernel (``build_inject`` under the Pallas
interpreter, as tests/test_mc_pallas.py runs it) and to the port. The
tolerance is the JAX test's own: identical bits and float32 math, with a
handful of decision-boundary flips allowed from float association and
transcendental differences (at most 16 per (rep, tile) cell and 32 per
call). The CUDA kernel itself is compared with the plain version on the
card by ``chip_smoke.py`` and by the ``cuda``-marked tests here.
"""

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


def _port_mc(tile, device="cpu"):
    ofdm = OFDM(512, 52, 300, device=device)
    jakes = JakesSampleGenerator(Fd=30.0, Ts=TS, L=16, device=device)
    return MonteCarloOfdmTdl(ofdm, TdlChannel(jakes, COST259_TUx), M=16,
                             tile=tile, device=device)


def _jax_mc(tile):
    channel = J_TdlChannel(J_Jakes(Fd=30.0, Ts=TS, L=16), J_COST259_TUx)
    return J_MC(J_OFDM(512, 52, 300), channel, M=16, tile=tile)


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
    state = {"g_re": np.asarray(jmc._g_re), "g_im": np.asarray(jmc._g_im),
             "C": jmc._C, "noise_gain": jmc.noise_gain, "M": jmc._M,
             "tile": jmc._tile, "used": jmc._used, "TL": jmc._TL}
    carried = from_jax_arrays(state, device="cpu")
    mc = _port_mc(64)
    bits = _bits(4, mc, 2, 2)
    amp = _amp(mc, 10.0)
    np.testing.assert_array_equal(
        carried.build_inject(2, 2)(*bits, amp).numpy(),
        mc.build_inject(2, 2)(*bits, amp).numpy())
    np.testing.assert_array_equal(carried.build(2, 2)(9, 10.0, 3).numpy(),
                                  mc.build(2, 2)(9, 10.0, 3).numpy())


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
def test_cuda_kernel_matches_plain_version(cuda_device):
    """Kernel vs plain version on the card, inject and PRNG mode, at
    |diff| <= 2e-4 of a cell's bits (the JAX test's 16 in 76,800)."""
    mc = _port_mc(256, cuda_device)
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
