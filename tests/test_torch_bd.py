"""The port's water-filling, batched BD and BD Monte Carlo kernel
(pyphysim_tpu_torch/comm, ops/bd_kernel.py) and the two BD apps held
against the JAX package on the same numpy inputs.

Tolerances and why:

* water-filling: identical arithmetic in float32, rtol 1e-6;
* ``bd_precoders_batched``: the same algorithm through other
  decompositions (torch.linalg's LU solve and eigh against the JAX
  package's Schur-block inverse and closed-form 2x2 eigh), float32 on
  random 6x6 channels whose null-space gains can be ill conditioned:
  rtol 1e-4;
* the kernel's plain version against the JAX kernel body ``_solve_block``
  (run eagerly as a plain function, no Pallas interpreter) on identical
  bits: the same operations in the same order, so each per-tile capacity
  sum agrees to rel 2e-4 (the chip_smoke.py tolerance for the CUDA kernel);
* the plain version against the port's own ``bd_precoders_batched`` at the
  larger geometries (4, 1) and (4, 2), which keeps JAX compiles of them out
  of the default run: rtol 3e-3, tests/test_bd_pallas.py's tolerance
  between the kernel and the batched chain.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from pyphysim_tpu.comm import bd_precoders_batched as j_bd  # noqa: E402
from pyphysim_tpu.comm.batched import \
    bd_blocks_no_power_batched as j_blocks  # noqa: E402
from pyphysim_tpu.comm.waterfilling import doWF as j_doWF  # noqa: E402
from pyphysim_tpu.comm.waterfilling import doWF_jit as j_doWF_jit  # noqa: E402,E501
from pyphysim_tpu.ops import cplx  # noqa: E402
from pyphysim_tpu.ops.bd_pallas import MonteCarloBD as J_MC  # noqa: E402
from pyphysim_tpu_torch.comm import (bd_blocks_no_power_batched,  # noqa: E402
                                     bd_precoders_batched,
                                     bd_receive_filter_batched, doWF,
                                     doWF_jit)
from pyphysim_tpu_torch.ops import philox  # noqa: E402
from pyphysim_tpu_torch.ops.alamouti_kernel import _gauss  # noqa: E402
from pyphysim_tpu_torch.ops.bd_kernel import (MonteCarloBD,  # noqa: E402
                                              from_jax_attrs)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

BD_CAP_RANGE = (5.0, 16.0)           # bench.py
IPU = 10.0 / 3


def _crandn(rng, *shape):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            / np.sqrt(2)).astype(np.complex64)


def _np(x):
    return x.to_numpy() if isinstance(x, cplx.CArray) else np.asarray(x)


# -- water-filling ---------------------------------------------------------

def test_doWF_matches_jax():
    rng = np.random.default_rng(0)
    for n, pt in ((3, 10.0), (5, 0.5), (2, 1.0)):
        g = rng.uniform(0.05, 3.0, n)
        p, mu = doWF(g, pt, noiseVar=0.7)
        jp, jmu = j_doWF(g, pt, noiseVar=0.7)
        np.testing.assert_array_equal(p, jp)
        assert mu == jmu


def test_doWF_jit_matches_jax_and_host():
    rng = np.random.default_rng(1)
    gains = rng.uniform(0.01, 4.0, (64, 6)).astype(np.float32)
    gains[0] = 1.5                                  # all tied
    gains[1, :3] = gains[1, 3:]                     # pairwise ties
    p, mu = doWF_jit(torch.from_numpy(gains), 10.0 / 3 * 3, 0.7)
    jp, jmu = j_doWF_jit(jnp.asarray(gains), 10.0 / 3 * 3, 0.7)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-6)
    np.testing.assert_allclose(p.sum(-1).numpy(), 10.0, rtol=1e-5)
    hp, hmu = doWF(gains[5].astype(float), 10.0, 0.7)
    np.testing.assert_allclose(p[5].numpy(), hp, rtol=1e-5, atol=1e-6)


# -- batched BD ------------------------------------------------------------

def _cap(Ms, Sigma, nv):
    p = (np.abs(Ms) ** 2).sum(axis=-2)
    return np.log2(1.0 + p * Sigma ** 2 / nv).sum(axis=-1)


@pytest.mark.parametrize("mode", ["normalized", "global", "none"])
def test_bd_precoders_match_jax(mode):
    rng = np.random.default_rng(2)
    H = _crandn(rng, 16, 6, 6)
    nv = 0.8
    newH, Ms, Sigma = (t.numpy() for t in bd_precoders_batched(
        torch.from_numpy(H), 3, IPU, nv, mode))
    jnewH, jMs, jSigma = (_np(x) for x in j_bd(cplx.from_numpy(H), 3, IPU,
                                                nv, mode))
    np.testing.assert_allclose(Sigma, jSigma, rtol=1e-4)
    np.testing.assert_allclose(_cap(Ms, Sigma, nv), _cap(jMs, jSigma, nv),
                               rtol=1e-4)
    # block-diagonal: user k's rows see only its own 2 streams
    scale = np.abs(newH).max()
    for k in range(3):
        off = np.delete(newH[:, 2 * k:2 * k + 2], [2 * k, 2 * k + 1],
                        axis=-1)
        assert np.abs(off).max() < 1e-4 * scale
    # per-BS power
    pw = np.stack([(np.abs(Ms[..., 2 * k:2 * k + 2]) ** 2).sum((-2, -1))
                   for k in range(3)], axis=-1)
    jpw = np.stack([(np.abs(jMs[..., 2 * k:2 * k + 2]) ** 2).sum((-2, -1))
                    for k in range(3)], axis=-1)
    np.testing.assert_allclose(pw, jpw, rtol=1e-4, atol=1e-5)
    if mode == "normalized":
        np.testing.assert_allclose(pw.max(-1), IPU, rtol=1e-5)
    elif mode == "none":
        np.testing.assert_allclose(pw, IPU, rtol=1e-5)
    else:
        np.testing.assert_allclose(pw.sum(-1), 3 * IPU, rtol=1e-5)


def test_bd_blocks_and_receive_filter_match_jax():
    rng = np.random.default_rng(3)
    H = _crandn(rng, 8, 6, 6)
    blocks, sigmas = bd_blocks_no_power_batched(torch.from_numpy(H), 3)
    jblocks, jsigmas = j_blocks(cplx.from_numpy(H), 3)
    for b, jb, s, js in zip(blocks, jblocks, sigmas, jsigmas):
        np.testing.assert_allclose(s.numpy(), _np(js), rtol=1e-4)
        # canonical phases make the basis unique: element-wise equal
        np.testing.assert_allclose(b.numpy(), _np(jb), rtol=1e-3, atol=1e-4)
    # equal power keeps every stream, so newH is invertible
    newH, _, _ = bd_precoders_batched(torch.from_numpy(H), 3, IPU, 1.0,
                                      "none")
    G = bd_receive_filter_batched(newH)
    eye = np.eye(6, dtype=np.complex64)
    np.testing.assert_allclose((G @ newH).numpy(), np.broadcast_to(
        eye, (8, 6, 6)), atol=1e-4)


def test_bd_checks():
    H = torch.zeros(2, 5, 6, dtype=torch.complex64)
    with pytest.raises(ValueError, match="multiple"):
        bd_precoders_batched(H, 3, IPU)
    with pytest.raises(ValueError, match="Unknown mode"):
        bd_precoders_batched(torch.ones(1, 6, 6, dtype=torch.complex64), 3,
                             IPU, 1.0, "bogus")
    with pytest.raises(ValueError, match="null-space"):
        bd_precoders_batched(torch.ones(1, 6, 4, dtype=torch.complex64), 3,
                             IPU)


# -- the kernel's plain version -------------------------------------------

def _bits(seed, mc, reps, num_tiles):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, (reps, num_tiles * mc.tile,
                                     mc.num_planes * mc.lane),
                        dtype=np.uint32)


def _jax_tile_sums(jmc, bits, num_tiles, iPu, nv):
    """The JAX kernel body on identical bits, eagerly, per tile."""
    tile, lane = jmc._tile, jmc._lane
    b = bits[0].astype(np.int32).reshape(num_tiles * tile, jmc.num_planes,
                                         lane)
    planes = [jnp.asarray(b[:, i]) for i in range(jmc.num_planes)]
    caps = np.asarray(jmc._solve_block(planes, noise_var=nv, iPu=iPu))
    return caps.reshape(num_tiles, -1).sum(axis=-1)


@pytest.mark.parametrize("K,NR", [(2, 1), (2, 2), (3, 2)])
@pytest.mark.parametrize("mode", ["normalized", "global", "none"])
def test_plain_version_matches_jax_kernel_body(K, NR, mode):
    jmc = J_MC(tile=8, lane=128, K=K, Nr_u=NR, mode=mode)
    mc = from_jax_attrs(vars(jmc), device="cpu")
    bits = _bits(10 * K + NR, mc, 1, 2)
    iPu, nv = (IPU, 1.0) if mode != "global" else (2.5, 0.7)
    want = _jax_tile_sums(jmc, bits, 2, iPu, nv)
    got = mc.build_inject(1, 2)(bits, iPu=iPu, noise_var=nv).numpy()[0]
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert (mc.launch_count, mc.reference_count) == (0, 1)


def _port_chain_tile_sums(mc, bits, num_tiles):
    """Capacities of the port's batched BD chain (the per-key app's
    ``bd_capacity``) on the kernel's channels, invalid draws zeroed."""
    from apps.comp_BD.batched_bd_capacity_torch import bd_capacity
    NT = mc.K * mc.Nr_u
    planes = torch.from_numpy(bits.view(np.int32)).reshape(
        -1, mc.num_planes, mc.lane).transpose(-1, -2)
    g = _gauss(planes)
    H = torch.complex(g[..., 0::2], g[..., 1::2]).reshape(-1, NT, NT)
    cap, valid = bd_capacity(H, mc.K, mc.iPu, mc.noise_var, mc.mode)
    cap = torch.where(valid, cap, torch.zeros_like(cap))
    return cap.reshape(num_tiles, -1).sum(-1).numpy()


@pytest.mark.parametrize("NR", [1, 2])
def test_plain_version_matches_port_chain_at_K4(NR):
    mc = MonteCarloBD(tile=8, lane=128, K=4, Nr_u=NR, device="cpu")
    bits = _bits(40 + NR, mc, 1, 2)
    got = mc.build_inject(1, 2)(bits).numpy()[0]
    np.testing.assert_allclose(got, _port_chain_tile_sums(mc, bits, 2),
                               rtol=3e-3)


def test_prng_mode_is_chunk_invariant_and_in_band():
    mc = MonteCarloBD(tile=8, lane=128, device="cpu")
    four = mc.build(4, 2)(seed=5, start=0)
    two = mc.build(2, 2)(seed=5, start=2)
    assert torch.equal(four[2:], two)
    assert not torch.equal(four[:2], two)
    mean = float(four.sum()) / (4 * 2 * 8 * 128)
    assert BD_CAP_RANGE[0] < mean < BD_CAP_RANGE[1], mean
    # plane 4 j + w of element e of tile t is word w of Philox call
    # (e, t * calls + j, attempt)
    bits = philox.bd_stream_bits(5, torch.tensor([3]), 2, 8, 128, 72)
    w = philox.philox4x32_10(130, 1 * 18 + 2, 3, 0, 5,
                             philox.BD_CHANNEL_KEY)
    e_row, e_lane = divmod(130, 128)
    got = [int(bits[0, 8 + e_row, (8 + k) * 128 + e_lane]) & 0xFFFFFFFF
           for k in range(4)]
    assert got == [int(x) for x in w]


def test_builder_checks():
    # any K >= 2 and Nr_u in (1, 2) builds, as in the JAX kernel
    mc = MonteCarloBD(K=3, Nr_u=1, device="cpu")
    assert (mc.K, mc.Nr_u, mc.num_planes) == (3, 1, 18) and not mc.prebuilt
    for bad in ({"K": 1}, {"Nr_u": 3}):
        with pytest.raises(ValueError):
            MonteCarloBD(device="cpu", **bad)
    with pytest.raises(ValueError, match="Unknown mode"):
        MonteCarloBD(mode="bogus", device="cpu")
    mc = MonteCarloBD(tile=8, lane=128, device="cpu")
    with pytest.raises(ValueError, match="channel bits"):
        mc.build_inject(1, 1)(np.zeros((1, 8, 128), np.uint32))
    assert mc.prng_kernel_profile(1, 1)["threads"] == 8 * 128  # one a solve


# -- the apps --------------------------------------------------------------

def _sweep(runner, pu_db, rep_max, batch):
    runner.params.add("Pu_dB", np.array(pu_db))
    runner.params.set_unpack_parameter("Pu_dB")
    runner.rep_max, runner.batch_size = rep_max, batch
    runner.update_progress_function_style = None
    runner.simulate()
    return [float(v) for v in
            runner.results.get_result_values_list("sum_capacity")]


def test_batched_app_in_band_and_chunk_invariant():
    from apps.comp_BD.batched_bd_capacity_torch import \
        BatchedBDCapacityRunner
    pu = [10 * np.log10(IPU)]
    caps = []
    for batch in (64, 128):
        r = BatchedBDCapacityRunner("normalized", K=3, nr_u=2, device="cpu",
                                    read_command_line_args=False)
        caps.append(_sweep(r, pu, 256, batch))
        assert r.chunks_dispatched == 256 // batch
    assert caps[0] == pytest.approx(caps[1], rel=1e-6)
    assert BD_CAP_RANGE[0] < caps[0][0] < BD_CAP_RANGE[1], caps


def test_batched_app_skips_invalid_draws(monkeypatch):
    """A draw marked invalid is skipped and retried: rep_max valid draws
    are kept and the skips are counted."""
    from apps.comp_BD import batched_bd_capacity_torch as app
    real = app.bd_capacity

    def some_invalid(H, *args):
        cap, valid = real(H, *args)
        return cap, valid & (H[:, 0, 0].real < 0.5)   # ~24 % of the draws

    monkeypatch.setattr(app, "bd_capacity", some_invalid)
    r = app.BatchedBDCapacityRunner("global", K=2, nr_u=2, device="cpu",
                                    read_command_line_args=False)
    _sweep(r, [5.0], 32, 16)
    assert r.runned_reps == [32]
    skipped = r.results.get_result_values_list("num_skipped_reps")[0]
    assert skipped >= 1


def test_kernel_app_capacity_rises_with_power():
    from apps.comp_BD.batched_bd_capacity_torch import BDKernelCapacityRunner
    r = BDKernelCapacityRunner(K=2, nr_u=2, tile=8, lane=128, num_tiles=1,
                               device="cpu", read_command_line_args=False)
    caps = _sweep(r, [-5.0, 5.0, 15.0], 2, 2)
    assert caps[0] < caps[1] < caps[2]
    assert r.chunks_dispatched == 3 and r.mc.launch_count == 0
    r = BDKernelCapacityRunner(K=3, nr_u=2, tile=8, lane=128, num_tiles=1,
                               device="cpu", read_command_line_args=False)
    mean = _sweep(r, [10 * np.log10(IPU)], 2, 2)[0]   # per solve
    assert BD_CAP_RANGE[0] < mean < BD_CAP_RANGE[1], mean


# -- the CUDA kernel (on the card) ----------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("K,NR", [(2, 1), (2, 2), (3, 2), (4, 1), (4, 2),
                                  (3, 1), (5, 2), (7, 2)])
def test_cuda_kernel_inject_matches_plain_version(cuda_device, K, NR):
    """Per cell within 2e-4 relative. The guard zeroes a draw whose smaller
    gain is within float32 rounding of 0, so the two may disagree on such a
    draw; cells of 32,768 solves keep one disagreement below 3e-5."""
    for mode in ("normalized", "global", "none"):
        mc = MonteCarloBD(tile=64, lane=512, K=K, Nr_u=NR, mode=mode,
                          device=cuda_device)
        bits = torch.from_numpy(_bits(K * NR, mc, 2, 2).view(
            np.int32)).to(cuda_device)
        got = mc.build_inject(2, 2)(bits)
        want = mc.simulate_block_reference(bits)
        assert ((got - want).abs() / want.abs()).max().item() <= 2e-4


@pytest.mark.cuda
def test_cuda_kernel_prng_parity_and_chunk_invariance(cuda_device):
    mc = MonteCarloBD(tile=8, lane=512, device=cuda_device)
    got = mc.build(4, 4)(seed=9, start=0)
    want = mc.prng_reference(4, 4, seed=9, start=0)
    assert ((got - want).abs() / want.abs()).max().item() <= 2e-4
    assert torch.equal(mc.build(2, 4)(seed=9, start=2), got[2:])
    assert torch.equal(mc.build(4, 4)(seed=9, start=0), got)   # rerun


@pytest.mark.cuda
@pytest.mark.parametrize("K,NR", [(2, 1), (2, 2), (3, 2), (4, 1), (4, 2),
                                  (3, 1), (5, 2), (7, 2), (11, 2)])
def test_cuda_kernel_prng_matches_plain_version_across_menu(cuda_device, K,
                                                            NR):
    """PRNG mode at the bench tile: each rep's sum (16,384 solves) within
    2e-4 of the plain version's on the same Philox bits, in every mode, at
    the prebuilt geometries and at others, built on first use (at (3, 1)
    the prebuilt kernel's form, above NT = 8 the wide form in shared
    memory, and at (11, 2) in the scratch buffer)."""
    for mode in ("normalized", "global", "none"):
        mc = MonteCarloBD(tile=8, lane=512, K=K, Nr_u=NR, mode=mode,
                          device=cuda_device)
        got = mc.build(4, 4)(seed=K * 10 + NR, start=3).sum(dim=1)
        want = mc.prng_reference(4, 4, seed=K * 10 + NR, start=3).sum(dim=1)
        assert ((got - want).abs() / want.abs()).max().item() <= 2e-4
        assert mc.launch_count == 1
