"""The port's Alamouti Monte Carlo kernel (pyphysim_tpu_torch/ops/
alamouti_kernel.py) and its bulk app held against the JAX kernel
(pyphysim_tpu/ops/alamouti_pallas.py) and app.

On the CPU the wrappers run the plain PyTorch version. The same numpy
uint32 bits go to the JAX kernel (``build_inject`` under the Pallas
interpreter, at tile 32 x lane 128 as tests/test_alamouti_pallas.py runs
it) and to the port. The tolerance is that test's slack: identical bits and
float32 math, with at most 4 decision-boundary flips in all (float
association and erfinv implementations differ in the last bits). The CUDA
kernel is compared with the plain version on the card by the
``cuda``-marked tests here and by ``chip_smoke.py``.
"""

import math
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pyphysim_tpu.ops.alamouti_pallas import \
    MonteCarloAlamouti as J_MC  # noqa: E402
from pyphysim_tpu_torch.ops import philox  # noqa: E402
from pyphysim_tpu_torch.ops.alamouti_kernel import (  # noqa: E402
    MonteCarloAlamouti, from_jax_attrs)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

BER_10DB = (0.008, 0.030)      # bench.py ALAMOUTI_BER_10DB
SLACK = 4                      # tests/test_alamouti_pallas.py


def _bits(seed, reps, num_tiles, tile, lane):
    """uint32 bits in the JAX inject layout, from a numpy seed."""
    rng = np.random.default_rng(seed)
    ch = rng.integers(0, 2 ** 32, (reps, 8, lane), dtype=np.uint32)
    shape = (reps, num_tiles * tile, lane)
    return (ch,) + tuple(rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
                         for _ in range(5))


def _amp(snr_db):
    return np.float32(math.sqrt(0.5 / 10 ** (snr_db / 10.0)))


@pytest.mark.parametrize("seed,snr_db", [(0, 10.0), (1, 3.0)])
def test_inject_matches_jax_kernel(seed, snr_db):
    jmc = J_MC(tile=32, lane=128)
    mc = from_jax_attrs(vars(jmc), device="cpu")
    bits = _bits(seed, 2, 2, 32, 128)
    want = np.asarray(jmc.build_inject(2, 2)(*bits, _amp(snr_db)), np.int64)
    got = mc.build_inject(2, 2)(*bits, _amp(snr_db)).numpy().astype(np.int64)
    assert want.sum() > 500                 # the comparison is not vacuous
    assert np.abs(got - want).sum() <= SLACK, (got, want)
    assert (mc.launch_count, mc.reference_count) == (0, 1)


def test_tile_swap_keeps_the_channel():
    """The channel is held per (rep, lane): swapping the two tiles' data
    and noise swaps the per-tile counts (tests/test_alamouti_pallas.py)."""
    mc = MonteCarloAlamouti(tile=32, lane=128, device="cpu")
    bits = _bits(9, 1, 2, 32, 128)
    base = mc.build_inject(1, 2)(*bits, _amp(10.0))
    swapped = [bits[0]] + [np.concatenate([b[:, 32:], b[:, :32]], axis=1)
                           for b in bits[1:]]
    out = mc.build_inject(1, 2)(*swapped, _amp(10.0))
    assert torch.equal(out[0].flip(0), base[0])


def test_prng_mode_is_chunk_invariant():
    mc = MonteCarloAlamouti(tile=32, lane=128, device="cpu")
    four = mc.build(4, 2)(7, 10.0, 0)
    two = mc.build(2, 2)(7, 10.0, 2)
    assert torch.equal(four[2:], two)
    assert not torch.equal(four[:2], two)


def test_stream_layout():
    """Channel words depend on (seed, attempt, lane) only; data nibbles are
    4 bits; every word depends only on its absolute attempt."""
    attempts = torch.arange(3, 7)
    ch, d, *noise = philox.alamouti_stream_bits(11, attempts, 2, 40, 128)
    assert ch.shape == (4, 4, 128)
    assert d.shape == noise[0].shape == (4, 80, 128)
    assert int(d.min()) >= 0 and int(d.max()) == 15
    ch2, d2, *noise2 = philox.alamouti_stream_bits(11, attempts[2:], 2, 40,
                                                   128)
    assert torch.equal(ch2, ch[2:]) and torch.equal(d2, d[2:])
    assert torch.equal(noise2[3], noise[3][2:])
    # the four channel words are one Philox call of (lane, 0, attempt)
    w = philox.philox4x32_10(5, 0, 4, 0, 11, philox.ALAMOUTI_CHANNEL_KEY)
    assert [int(x) for x in w] == \
        [int(v) & 0xFFFFFFFF for v in ch[1, :, 5]]


def test_prng_ber_inside_the_band():
    mc = MonteCarloAlamouti(tile=64, lane=256, device="cpu")
    counts = mc.build(2, 2)(seed=21, snr_linear=10.0)
    ber = int(counts.sum()) / (2 * 2 * 64 * 256 * 4)
    assert BER_10DB[0] < ber < BER_10DB[1], ber


def test_inject_checks_shapes():
    mc = MonteCarloAlamouti(tile=32, lane=128, device="cpu")
    bits = _bits(3, 1, 1, 32, 128)
    with pytest.raises(ValueError, match="data/noise bits"):
        mc.build_inject(1, 2)(*bits, 0.1)
    with pytest.raises(ValueError, match="channel bits"):
        mc.build_inject(1, 1)(bits[0][:, :3], *bits[1:], 0.1)
    with pytest.raises(ValueError, match="multiple"):
        MonteCarloAlamouti(tile=12, lane=128, device="cpu")


def _app(cls, snrs, rep_max, batch, **kw):
    r = cls(tile=16, lane=128, num_tiles=2, **kw)
    r.params.add("SNR", np.array(snrs))
    r.params.set_unpack_parameter("SNR")
    r.rep_max, r.batch_size = rep_max, batch
    r.update_progress_function_style = None
    return r


def test_bulk_app_prng_ber_falls_and_is_chunk_invariant():
    from apps.mimo.alamouti_mc_kernel_torch import \
        AlamoutiMcKernelSimulationRunner
    bers = []
    for batch in (2, 4):
        r = _app(AlamoutiMcKernelSimulationRunner, [0.0, 10.0], 4, batch,
                 device="cpu", read_command_line_args=False)
        r.simulate()
        bers.append([float(v) for v in
                     r.results.get_result_values_list("ber")])
        assert r.chunks_dispatched == 2 * 4 // batch
        assert r.mc.launch_count == 0
    assert bers[0] == bers[1]
    assert bers[0][1] < bers[0][0] < 0.5
    assert BER_10DB[0] < bers[0][1] < BER_10DB[1], bers


def test_bulk_app_matches_the_jax_app_on_its_bits():
    """The slice end to end: the port's bulk app fed the JAX app's CPU bits
    (jax.random, folded per attempt) gives the JAX app's bit errors."""
    from apps.mimo.alamouti_mc_kernel import \
        AlamoutiMcKernelSimulationRunner as JRunner
    from apps.mimo.alamouti_mc_kernel_torch import \
        AlamoutiMcKernelSimulationRunner
    theirs = _app(JRunner, [0.0, 10.0], 4, 4)
    theirs.simulate()
    mine = _app(AlamoutiMcKernelSimulationRunner, [0.0, 10.0], 4, 4,
                device="cpu", read_command_line_args=False)

    def source(unpack_idx, start, n):
        base = jax.random.fold_in(jax.random.PRNGKey(mine.base_seed),
                                  unpack_idx)
        keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(
            jnp.arange(start, start + n))

        def draw(salt, shape):
            return np.array(jax.vmap(lambda k: jax.random.bits(
                jax.random.fold_in(k, salt), shape, jnp.uint32))(keys))
        shape = (2 * 16, 128)
        return (draw(0, (8, 128)),) + tuple(draw(s, shape)
                                            for s in range(1, 6))

    mine.bit_source = source
    mine.simulate()
    want = theirs.results.get_result_values_list("bit_errors")
    got = mine.results.get_result_values_list("bit_errors")
    assert all(abs(g - w) <= SLACK for g, w in zip(got, want)), (got, want)
    assert theirs.results.get_result_values_list("ber")[1] < \
        theirs.results.get_result_values_list("ber")[0]


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
    |diff| <= 2e-4 of a cell's bits, and chunk invariance."""
    mc = MonteCarloAlamouti(tile=64, lane=256, device=cuda_device)
    cell_bits = mc.tile * mc.lane * 4
    bits = [torch.from_numpy(b.view(np.int32)).to(cuda_device)
            for b in _bits(8, 2, 2, 64, 256)]
    amp = float(_amp(10.0))
    got = mc.build_inject(2, 2)(*bits, amp)
    want = mc.simulate_block_reference(*bits, amp)
    assert (got - want).abs().max().item() <= 2e-4 * cell_bits
    got = mc.build(4, 2)(5, 10.0, 0)
    want = mc.prng_reference(4, 2, 5, mc.amp(10.0), 0)
    assert (got - want).abs().max().item() <= 2e-4 * cell_bits
    assert torch.equal(mc.build(2, 2)(5, 10.0, 2), got[2:])
    assert mc.launch_count == 3
