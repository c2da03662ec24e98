"""The port's MIMO schemes (pyphysim_tpu_torch/mimo) held against the JAX
package's (pyphysim_tpu/mimo) on the same numpy channels and symbols.

Both packages compute in float32, by different routes (the JAX package's
Gram-route SVD / pseudo-inverse and closed-form solves, torch.linalg's
LAPACK routines here), so outputs agree to float32 rounding of small,
well-conditioned matrices: rtol 1e-5 with an absolute floor of 1e-5 of the
outputs' scale. SVD bases carry an arbitrary phase per column in both
packages, so ``SVDMimo`` is compared through phase-invariant quantities
(the decoded stream and the SINRs).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pyphysim_tpu import mimo as jmimo  # noqa: E402
from pyphysim_tpu_torch import mimo  # noqa: E402

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    atol = rtol * max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _crandn(rng, *shape):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            / np.sqrt(2)).astype(np.complex64)


def _pair(name, h, **kw):
    return (getattr(jmimo, name)(h),
            getattr(mimo, name)(h, device="cpu", **kw))


# channel shapes (..., Nr, Nt) and stream lengths, 1-D / unbatched / batched
CASES = [
    ("Blast", (3, 3), 12), ("Blast", (4, 3, 3), 9),
    ("MRC", (3,), 8), ("MRC", (4, 3, 1), 6),
    ("Alamouti", (2,), 10), ("Alamouti", (3, 2), 8),
    ("Alamouti", (6, 2, 2), 12),
    ("GMDMimo", (3, 3), 9),
]


@pytest.mark.parametrize("name,hshape,n", CASES)
def test_encode_decode_match_jax(name, hshape, n):
    rng = np.random.default_rng(len(hshape) * 100 + n)
    h = _crandn(rng, *hshape)
    theirs, mine = _pair(name, h)
    batch = hshape[:-2]
    x = _crandn(rng, *(batch + (n,)))
    enc_j, enc_p = theirs.encode(x), mine.encode(x)
    assert isinstance(enc_p, np.ndarray)      # numpy in, numpy out
    _close(enc_p, enc_j)
    rx = np.asarray(mine.channel.numpy() @ enc_p) + \
        0.05 * _crandn(rng, *np.shape(enc_p)[:-2],
                       mine.channel.shape[-2], np.shape(enc_p)[-1])
    _close(mine.decode(rx), theirs.decode(rx))


@pytest.mark.parametrize("noise_var", [0.0, 0.3])
def test_blast_zf_and_mmse_match_jax(noise_var):
    rng = np.random.default_rng(3)
    h = _crandn(rng, 4, 3, 3)
    theirs, mine = _pair("Blast", h)
    theirs.set_noise_var(noise_var)
    mine.set_noise_var(noise_var)
    rx = _crandn(rng, 4, 3, 5)
    _close(mine.decode(rx), theirs.decode(rx))
    if noise_var > 0:
        _close(mine.calc_linear_SINRs(noise_var).numpy(),
               theirs.calc_linear_SINRs(noise_var))
        _close(mine.calc_SINRs(noise_var).numpy(),
               theirs.calc_SINRs(noise_var))


def test_mrt_matches_jax():
    rng = np.random.default_rng(4)
    h = _crandn(rng, 3)
    theirs, mine = _pair("MRT", h)
    x = _crandn(rng, 10)
    _close(mine.encode(x), theirs.encode(x))
    rx = h[None, :] @ mine.encode(x)                 # (1, n)
    _close(mine.decode(rx), theirs.decode(rx))
    _close(mine.decode(rx), x, rtol=1e-4)            # no noise: exact


@pytest.mark.parametrize("hshape", [(3, 3), (4, 3, 3)])
def test_svd_mimo_matches_jax_invariants(hshape):
    rng = np.random.default_rng(5)
    h = _crandn(rng, *hshape)
    theirs, mine = _pair("SVDMimo", h)
    nt = hshape[-1]
    x = _crandn(rng, *(hshape[:-2] + (4 * nt,)))
    rx_p = mine.channel.numpy() @ mine.encode(x)
    rx_j = np.asarray(h @ np.asarray(theirs.encode(x)))
    _close(mine.decode(rx_p), theirs.decode(rx_j))
    _close(mine.decode(rx_p), x, rtol=1e-4)          # G_H H W = I
    _close(mine.calc_linear_SINRs(0.1).numpy(),
           theirs.calc_linear_SINRs(0.1), rtol=1e-4)


def test_sinrs_match_jax():
    rng = np.random.default_rng(6)
    for name, hshape in (("MRC", (3,)), ("Alamouti", (2, 2)),
                         ("Blast", (4, 3, 3)), ("GMDMimo", (3, 3))):
        h = _crandn(rng, *hshape)
        theirs, mine = _pair(name, h)
        _close(mine.calc_linear_SINRs(0.2).numpy(),
               theirs.calc_linear_SINRs(0.2))
    h = _crandn(rng, 3, 3)
    W = _crandn(rng, 3, 2)
    G = _crandn(rng, 2, 3)
    for nv in (None, 0.5):
        _close(mimo.calc_post_processing_SINRs(
            torch.from_numpy(h), torch.from_numpy(W), torch.from_numpy(G),
            nv).numpy(),
            jmimo.calc_post_processing_SINRs(h, W, G, nv))


def test_alamouti_requires_two_transmit_antennas():
    rng = np.random.default_rng(7)
    for h in (_crandn(rng, 2, 3), _crandn(rng, 3)):
        with pytest.raises(ValueError, match="equal to 2"):
            mimo.Alamouti(h, device="cpu")
        with pytest.raises(ValueError, match="equal to 2"):
            jmimo.Alamouti(h)
    ala = mimo.Alamouti(_crandn(rng, 2), device="cpu")
    with pytest.raises(ValueError, match="multiple of 2"):
        ala.encode(_crandn(rng, 5))


def test_tensor_channel_stays_on_its_device_and_batches():
    """A tensor channel gives tensor outputs; a batch of channels decodes
    every row as its own unbatched problem would."""
    rng = np.random.default_rng(8)
    h = _crandn(rng, 4, 1, 2)
    x = _crandn(rng, 4, 6)
    ala = mimo.Alamouti(torch.from_numpy(h), device="cpu")
    enc = ala.encode(torch.from_numpy(x))
    assert isinstance(enc, torch.Tensor) and enc.shape == (4, 2, 6)
    out = ala.decode(torch.from_numpy(h) @ enc)
    for b in range(4):
        one = mimo.Alamouti(h[b], device="cpu")
        _close(out[b].numpy(), one.decode(h[b] @ one.encode(x[b])))
    _close(out.numpy(), x, rtol=1e-4)


def test_layers_and_checks():
    rng = np.random.default_rng(9)
    assert mimo.Blast(_crandn(rng, 3, 4), device="cpu").getNumberOfLayers() \
        == 4
    assert mimo.MRT(_crandn(rng, 4), device="cpu").getNumberOfLayers() == 1
    with pytest.raises(ValueError, match="multiple"):
        mimo.Blast(_crandn(rng, 3, 3), device="cpu").encode(_crandn(rng, 4))
    with pytest.raises(ValueError, match="non-negative"):
        mimo.Blast(device="cpu").set_noise_var(-1.0)


def _mimo_runner(scheme, nr, snrs, rep_max, batch, n=256):
    from apps.mimo.simulate_mimo_torch import MimoSimulationRunner
    r = MimoSimulationRunner(scheme, nr, device="cpu",
                             read_command_line_args=False)
    r.params.add("SNR", np.array(snrs))
    r.params.set_unpack_parameter("SNR")
    r.rep_max, r.batch_size, r.NSymbs = rep_max, batch, n
    r.update_progress_function_style = None
    return r


@pytest.mark.parametrize("scheme,nr", [("alamouti", 1), ("alamouti", 2),
                                       ("mrc", 2), ("blast", 2)])
def test_per_key_app_ber_falls_with_snr(scheme, nr):
    r = _mimo_runner(scheme, nr, [0.0, 10.0], 64, 32)
    r.max_bit_errors = 10 ** 9
    r.simulate()
    ber = [float(v) for v in r.results.get_result_values_list("ber")]
    ser = [float(v) for v in r.results.get_result_values_list("ser")]
    assert ber[1] < ber[0] < 0.5 and ser[1] < ser[0]
    assert r.chunks_dispatched == 4


def test_per_key_alamouti_in_band_chunk_invariant_and_stops_early():
    """Alamouti 2x1 at 10 dB inside bench.py's ALAMOUTI_BER_10DB, the same
    BER for any chunk size, and the early stop at max_bit_errors."""
    bers = []
    for batch in (64, 128):
        r = _mimo_runner("alamouti", 1, [10.0], 256, batch, n=512)
        r.max_bit_errors = 10 ** 9
        r.simulate()
        bers.append(float(r.results.get_result_values_list("ber")[0]))
    assert bers[0] == bers[1]
    assert 0.008 < bers[0] < 0.030, bers
    r = _mimo_runner("alamouti", 1, [0.0], 1000, 16)
    r.max_bit_errors = 3000
    r.simulate()
    assert r.runned_reps[0] < 1000
    assert r.results.get_result_values_list("bit_errors")[0] >= 3000
