"""``corrupt_data_time_sharded`` (``pyphysim_tpu_torch/parallel/
timeshard.py``) on 2- and 4-rank ``gloo`` meshes against the JAX package's
``corrupt_data_time_sharded`` on 2- and 4-device CPU meshes, on the same
signal and Jakes state (the JAX state carried across as numpy arrays):

* the ranks' outputs, in rank order, within ``atol=2e-5`` of JAX's (the
  JAX test's tolerance, ``tests/test_parallel.py``), the first ``span - 1``
  samples of every shard after the first (the halo a rank receives)
  included, and of the unsharded ``corrupt_data``'s first ``N`` samples;
* the per-block responses against JAX's, and the state skipped by ``N``;
* a length that does not split, and a shard shorter than the channel's
  span, raise ``ValueError``.

One 4-rank group serves both meshes (ranks 0 and 1 form the 2-rank one).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import torch_parallel_checks as checks  # noqa: E402
from pyphysim_tpu_torch.parallel.launch import run_ranks  # noqa: E402

WORLD = 4
BLOCK = 128
N = 8 * 4 * BLOCK


def _jax_channel():
    from pyphysim_tpu.channels import (COST259_TUx, JakesSampleGenerator,
                                       TdlChannel)
    return TdlChannel(JakesSampleGenerator(Fd=50.0, Ts=1.0 / 20e6, L=12),
                      COST259_TUx)


@pytest.fixture(scope="module")
def case():
    from pyphysim_tpu.ops.cplx import CArray
    rng = np.random.default_rng(77)
    signal = ((rng.standard_normal(N) + 1j * rng.standard_normal(N)) *
              np.sqrt(0.5)).astype(np.complex64)
    channel = _jax_channel()
    state = channel.init_state(jax.random.PRNGKey(1))
    arrays = tuple(np.asarray(getattr(state, f))
                   for f in ("phi_l", "psi_l", "t0"))
    return {"signal": signal, "state": state, "arrays": arrays,
            "jsignal": CArray(jax.numpy.asarray(signal.real),
                              jax.numpy.asarray(signal.imag))}


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    return run_ranks(checks.timeshard_checks, WORLD,
                     args=(case["signal"], case["arrays"], BLOCK),
                     store_dir=str(tmp_path_factory.mktemp("store")))


@pytest.fixture(scope="module")
def jax_sharded(case):
    """JAX's time-sharded output, per-block taps and skipped ``t0`` on 2-
    and 4-device meshes (under ``jax.jit``: one compile, not op-by-op)."""
    from pyphysim_tpu.parallel import corrupt_data_time_sharded, make_mesh
    channel = _jax_channel()
    result = {}
    for n in (2, 4):
        mesh = make_mesh(n, axis_name="time")
        out, ir, state = jax.jit(
            lambda st, sig, mesh=mesh: corrupt_data_time_sharded(
                channel, st, sig, BLOCK, mesh))(case["state"],
                                                case["jsignal"])
        taps = ir.tap_values_sparse
        result[n] = (np.asarray(out.re) + 1j * np.asarray(out.im),
                     np.asarray(taps.re) + 1j * np.asarray(taps.im),
                     float(np.asarray(state.t0)))
    return result


@pytest.mark.parametrize("n", [2, 4])
def test_output_matches_jax(ranks, jax_sharded, n):
    want, _, _ = jax_sharded[n]
    got = np.concatenate([ranks[r][n][0] for r in range(n)])
    assert got.shape == (N,)
    np.testing.assert_allclose(got, want, atol=2e-5)
    # the halo really crossed ranks: the head of every later shard
    span = _jax_channel().num_taps_with_padding
    n_local = N // n
    for r in range(1, n):
        seg = slice(r * n_local, r * n_local + span - 1)
        np.testing.assert_allclose(got[seg], want[seg], atol=2e-5)
        assert np.abs(want[seg]).max() > 0.1


@pytest.mark.parametrize("n", [2, 4])
def test_output_matches_unsharded_corrupt_data(ranks, case, n):
    channel = _jax_channel()
    ref, _, _ = jax.jit(lambda st, sig: channel.corrupt_data(
        st, sig, block_size=BLOCK))(case["state"], case["jsignal"])
    want = np.asarray(ref.re)[:N] + 1j * np.asarray(ref.im)[:N]
    got = np.concatenate([ranks[r][n][0] for r in range(n)])
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_block_responses_and_state_match_jax(ranks, jax_sharded, n):
    _, taps, t0 = jax_sharded[n]
    got = np.concatenate([ranks[r][n][1] for r in range(n)], axis=-1)
    assert got.shape == taps.shape == (taps.shape[0], N // BLOCK)
    np.testing.assert_allclose(got, taps, atol=2e-5)
    for r in range(n):
        assert ranks[r][n][2] == pytest.approx(t0, rel=1e-6)


def test_lengths_that_do_not_split_raise(ranks):
    for out in ranks:
        assert out["bad_length"]
        assert out["span_too_long"]
