"""The four Monte Carlo kernels' sharded builds (``build(..., mesh=)``,
``build_inject(..., mesh=)``) on a 2-rank ``gloo`` group, held against the
JAX package's sharded builds (``build_inject(..., mesh=make_mesh(2))``
under the Pallas interpreter, in this process; the ranks never import
jax) on the same numpy uint32 bits:

* counts within the slack of ``tests/test_mc_pallas.py:118-124`` (16 a
  cell, 32 a call; Alamouti 4 a call, its own test's), capacities within
  2e-4 of a cell;
* the sharded inject and PRNG builds equal the port's unsharded builds bit
  for bit (rank ``i`` runs attempts ``start + i * reps / 2`` on);
* reps that do not split over the ranks raise ``ValueError``;
* the flagship bulk app under ``simulate_in_parallel`` equals
  ``simulate()``, with and without a stop criterion.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_parallel_checks as checks  # noqa: E402
from pyphysim_tpu_torch.parallel.launch import run_ranks  # noqa: E402

WORLD = 2
REPS, NUM_TILES = 4, 1
KERNELS = ("ofdm", "alamouti", "bd", "ia")


def _jax_builder(name):
    if name == "ofdm":
        from pyphysim_tpu.channels import (COST259_TUx, JakesSampleGenerator,
                                           TdlChannel)
        from pyphysim_tpu.modulators import OFDM
        from pyphysim_tpu.ops.mc_pallas import MonteCarloOfdmTdl
        channel = TdlChannel(JakesSampleGenerator(Fd=30.0, Ts=1.0 / 20e6,
                                                  L=16), COST259_TUx)
        return MonteCarloOfdmTdl(OFDM(512, 52, 300), channel, M=16, tile=16)
    if name == "alamouti":
        from pyphysim_tpu.ops.alamouti_pallas import MonteCarloAlamouti
        return MonteCarloAlamouti(tile=16, lane=128)
    if name == "bd":
        from pyphysim_tpu.ops.bd_pallas import MonteCarloBD
        return MonteCarloBD(tile=8, lane=128, K=2, Nr_u=1)
    from pyphysim_tpu.ops.ia_pallas import MonteCarloMaxSinr
    return MonteCarloMaxSinr(tile=8, lane=128, iterations=1, K=2)


def _inject_inputs():
    """{name: (bit arrays, trailing arguments)} from numpy seeds, in the
    JAX inject layout of each kernel."""
    rng = np.random.default_rng(1010)

    def bits(*shape):
        return rng.integers(0, 2 ** 32, shape, dtype=np.uint32)

    ofdm = checks.kernel_builder("ofdm")
    rows = NUM_TILES * ofdm.tile
    amp = np.float32(math.sqrt(0.5 / 10 ** 1.0) * ofdm.noise_gain)
    bd = checks.kernel_builder("bd")
    ia = checks.kernel_builder("ia")
    return {
        "ofdm": ((bits(REPS, 8, ofdm.TLp),) +
                 tuple(bits(REPS, rows, ofdm.used_p) for _ in range(3)),
                 (amp,)),
        "alamouti": ((bits(REPS, 8, 128),) +
                     tuple(bits(REPS, NUM_TILES * 16, 128)
                           for _ in range(5)),
                     (np.float32(math.sqrt(0.5 / 10.0)),)),
        "bd": ((bits(REPS, NUM_TILES * 8, bd.num_planes * 128),), ()),
        "ia": ((bits(REPS, NUM_TILES * 8, ia.num_planes * 128),), (0.1,)),
    }


@pytest.fixture(scope="module")
def inputs():
    return _inject_inputs()


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return run_ranks(checks.kernel_checks, WORLD,
                     args=(inputs, REPS, NUM_TILES),
                     store_dir=str(tmp_path_factory.mktemp("store")))


@pytest.mark.parametrize("name", KERNELS)
def test_sharded_inject_matches_the_jax_sharded_build(ranks, inputs, name):
    from pyphysim_tpu.parallel import make_mesh
    bits, rest = inputs[name]
    jmc = _jax_builder(name)
    want = np.asarray(jmc.build_inject(REPS, NUM_TILES,
                                       mesh=make_mesh(WORLD))(*bits, *rest))
    for out in ranks:
        got = out[name]["inject"]
        assert got.shape == want.shape == (REPS, NUM_TILES)
        if name == "ofdm":
            diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
            assert want.sum() > 1000           # not vacuous
            assert diff.max() <= 16 and abs(int(got.sum()) -
                                            int(want.sum())) <= 32
        elif name == "alamouti":
            assert want.sum() > 100
            assert np.abs(got.astype(np.int64) - want).sum() <= 4
        else:
            assert want.min() > 0
            np.testing.assert_allclose(got, want, rtol=2e-4)


@pytest.mark.parametrize("name", KERNELS)
def test_sharded_builds_equal_unsharded_bit_for_bit(ranks, name):
    for out in ranks:
        k = out[name]
        np.testing.assert_array_equal(k["inject"], k["inject_whole"])
        np.testing.assert_array_equal(k["prng"], k["prng_whole"])
        assert k["prng"].shape == (REPS, NUM_TILES)
    np.testing.assert_array_equal(ranks[0][name]["prng"],
                                  ranks[1][name]["prng"])


@pytest.mark.parametrize("name", KERNELS)
def test_reps_must_divide_over_the_ranks(ranks, name):
    for out in ranks:
        assert out[name]["indivisible"] == (True, True)


@pytest.mark.parametrize("key", ["plain", "stop"])
def test_flagship_app_in_parallel_equals_simulate(ranks, key):
    for out in ranks:
        parallel, serial = out["app"][key]
        assert parallel == serial
        assert sum(serial["bit_errors"]) > 0
    if key == "stop":
        assert ranks[0]["app"][key][1]["runned_reps"][0] < 32   # tripped
