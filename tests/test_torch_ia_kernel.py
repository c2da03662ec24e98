"""The port's Max-SINR IA Monte Carlo kernel (pyphysim_tpu_torch/ops/
ia_kernel.py) held against the JAX package on the same numpy bits.

Tolerances and why:

* the plain version against the JAX kernel body ``_solve_block`` (jitted
  under vmap as tests/test_ia_pallas.py runs it, no Pallas interpreter) on
  identical bits: the same operations in the same order, in float32 through
  torch's and XLA's own erfinv, complex products and fused ops; after a few
  Max-SINR iterations each per-tile capacity sum (1,024 solves) agrees to
  rel 2e-4, the chip_smoke.py tolerance between the CUDA kernel and the
  plain version. A draw near the closed-form init's ``ok`` switch or a
  determinant floor may take the other branch in one implementation; one
  such draw moves a 1,024-solve sum by at most ~1e-3 relative, so the
  seeds below were drawn once and hold no such draw;
* the general body is held against the JAX solver in
  test_torch_ia_general.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pyphysim_tpu.ops.ia_pallas import MonteCarloMaxSinr as J_MC  # noqa: E402
from pyphysim_tpu_torch.ops import philox  # noqa: E402
from pyphysim_tpu_torch.ops.ia_kernel import (MENU,  # noqa: E402
                                              MonteCarloMaxSinr,
                                              from_jax_attrs)

IA_CAP_RANGE = (6.0, 16.0)            # bench.py


def _bits(seed, mc, reps, num_tiles):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, (reps, num_tiles * mc.tile,
                                     mc.num_planes * mc.lane),
                        dtype=np.uint32)


def _jax_tile_sums(jmc, bits, noise_var):
    """The JAX kernel body on identical bits, one jitted vmap over tiles
    (as tests/test_ia_pallas.py ``_direct_caps``): (reps, num_tiles)."""
    reps, rows, _ = bits.shape
    nt = rows // jmc._tile
    blocks = jnp.asarray(bits.view(np.int32).reshape(
        reps * nt, jmc._tile, jmc.num_planes, jmc._lane))

    def one(block):
        return jmc._solve_block([block[:, i] for i in range(jmc.num_planes)],
                                jnp.float32(noise_var))

    return np.asarray(jax.jit(jax.vmap(one))(blocks)).reshape(reps, nt)


@pytest.mark.parametrize("K,iters", [(3, 4), (2, 1), (4, 1)])
def test_plain_version_matches_jax_kernel_body(K, iters):
    jmc = J_MC(tile=8, lane=128, iterations=iters, K=K)
    mc = from_jax_attrs(vars(jmc), device="cpu")
    bits = _bits(7 + K, mc, 1, 2)
    want = _jax_tile_sums(jmc, bits, 0.1)
    got = mc.build_inject(1, 2)(bits, 0.1).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert (mc.launch_count, mc.reference_count) == (0, 1)
    mean = got.sum() / (2 * mc.solves_per_grid_step)
    assert 1.0 < mean < 30.0, mean


def test_stream_bits_plane_order_is_the_channel_map():
    """Plane 4 j + w of element e of tile t is word w of Philox call
    (e, t * G + j, attempt) under IA_CHANNEL_KEY, and plane
    2 ((k K + j) N^2 + row N + col) (+1) is H[k][j][row, col] re (im)."""
    mc = MonteCarloMaxSinr(tile=8, lane=128, K=3, device="cpu")
    G = (mc.num_planes + 3) // 4
    bits = mc.prng_bits(1, 2, seed=5, start=3)
    assert torch.equal(bits, philox.ia_stream_bits(
        5, torch.tensor([3]), 2, 8, 128, 72))
    w = philox.philox4x32_10(130, 1 * G + 2, 3, 0, 5, philox.IA_CHANNEL_KEY)
    e_row, e_lane = divmod(130, 128)
    got = [int(bits[0, 8 + e_row, (8 + k) * 128 + e_lane]) & 0xFFFFFFFF
           for k in range(4)]
    assert got == [int(x) for x in w]
    assert not torch.equal(bits, philox.bd_stream_bits(
        5, torch.tensor([3]), 2, 8, 128, 72))
    # the channel map: plane 2 ((k K + j) 4 + row 2 + col) is H[k, j].re
    H = mc.channels(bits)
    from pyphysim_tpu_torch.ops.alamouti_kernel import _gauss
    k, j, row, col = 2, 1, 1, 0
    pl = 2 * ((k * 3 + j) * 4 + row * 2 + col)
    want = torch.complex(_gauss(bits[0, 9, pl * 128 + 5]),
                         _gauss(bits[0, 9, (pl + 1) * 128 + 5]))
    assert H[0, 1, 1, 5, k, j, row, col] == want


def test_prng_mode_is_chunk_invariant_and_in_band():
    mc = MonteCarloMaxSinr(tile=8, lane=128, iterations=3, device="cpu")
    four = mc.build(4, 1)(5, 0.1, 0)
    two = mc.build(2, 1)(5, 0.1, 2)
    assert torch.equal(four[2:], two)
    assert not torch.equal(four[:2], two)
    mean = float(four.sum()) / (4 * mc.solves_per_grid_step)
    assert IA_CAP_RANGE[0] < mean < IA_CAP_RANGE[1], mean


def test_noise_monotonicity_and_iterations_help():
    mc = MonteCarloMaxSinr(tile=8, lane=128, iterations=3, device="cpu")
    bits = _bits(3, mc, 1, 1)
    lo = float(mc.build_inject(1, 1)(bits, 0.05).sum())
    hi = float(mc.build_inject(1, 1)(bits, 0.5).sum())
    assert hi < lo
    one = MonteCarloMaxSinr(tile=8, lane=128, iterations=0, device="cpu")
    assert float(one.build_inject(1, 1)(bits, 0.1).sum()) < \
        float(mc.build_inject(1, 1)(bits, 0.1).sum())


def test_from_jax_attrs_and_checks():
    jmc = J_MC(tile=16, lane=256, iterations=7, P=2.0, K=2, N=4, Ns=2,
               init_iters=5)
    mc = from_jax_attrs(vars(jmc), device="cpu")
    assert (mc.tile, mc.lane, mc.iterations, mc.P, mc.K, mc.N, mc.Ns,
            mc.init_iters) == (16, 256, 7, 2.0, 2, 4, 2, 5)
    assert mc.num_planes == jmc.num_planes == 128
    assert mc.solves_per_grid_step == jmc.solves_per_grid_step
    for bad in ({"tile": 12}, {"lane": 100}, {"K": 1}, {"N": 1},
                {"Ns": 3}):
        with pytest.raises(ValueError):
            MonteCarloMaxSinr(device="cpu", **bad)
    # any geometry runs the plain version; the card takes the menu
    MonteCarloMaxSinr(K=5, N=3, Ns=2, device="cpu")
    assert (3, 2, 1) in MENU and (2, 4, 2) in MENU
    mc = MonteCarloMaxSinr(tile=8, lane=128, device="cpu")
    with pytest.raises(ValueError, match="channel bits"):
        mc.build_inject(1, 1)(np.zeros((1, 8, 128), np.uint32), 0.1)
    prof = mc.prng_kernel_profile(2, 3)
    assert prof["threads"] == 2 * 3 * 8 * 128 and prof["loop_trips"] == 10
    assert prof["pattern"] == "mc_ia_closed_kernelILi3ELb0EE"


# -- the CUDA kernel (on the card) ----------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,Ns", MENU)
def test_cuda_kernel_inject_matches_plain_version(cuda_device, K, N, Ns):
    """Per cell (32,768 solves) within 2e-4 relative: one draw that takes
    another branch at a discontinuity moves such a cell by < 1e-4."""
    mc = MonteCarloMaxSinr(tile=64, lane=512, iterations=4, K=K, N=N, Ns=Ns,
                           init_iters=4, device=cuda_device)
    bits = torch.from_numpy(_bits(K * N + Ns, mc, 2, 2).view(
        np.int32)).to(cuda_device)
    got = mc.build_inject(2, 2)(bits, 0.1)
    want = mc.simulate_block_reference(bits, 0.1)
    assert ((got - want).abs() / want.abs()).max().item() <= 2e-4
    assert mc.launch_count == 1


@pytest.mark.cuda
def test_cuda_kernel_prng_parity_and_chunk_invariance(cuda_device):
    mc = MonteCarloMaxSinr(tile=8, lane=512, device=cuda_device)
    got = mc.build(4, 4)(9, 0.1, 0)
    want = mc.prng_reference(4, 4, 9, 0.1, 0)
    assert ((got.sum(1) - want.sum(1)).abs() / want.sum(1)).max() <= 2e-4
    assert torch.equal(mc.build(2, 4)(9, 0.1, 2), got[2:])
    assert torch.equal(mc.build(4, 4)(9, 0.1, 0), got)   # rerun
