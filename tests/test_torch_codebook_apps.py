"""The port's codebook search and quantized-CSI IA apps against the JAX apps,
on the CPU.

* ``apps/find_codebook_torch.py``: ``min_chordal_dist_sq`` on the same
  codebooks as the JAX function (rtol 1e-5, both float32) and as the
  float64 host ``calc_min_chordal_dist`` (atol 1e-3, the JAX test's);
  the finder's best is monotone, respects its three types and lies under
  the Rankin simplex bound; its candidates depend only on the seed and
  their index; ``main`` writes the ``.npz`` and ``.mat`` files.
* ``apps/ia/simple_maxsinr_quantized_torch.py``: ``quantize_channel`` picks
  the JAX function's codewords on the same arrays (exactly) and the
  nearest codeword by brute force; ``gen_codebook`` gives unit norms;
  ``bit_errors`` counts the JAX app's receive loop's errors (its per-user
  ``cplx.matmul`` sums, ``U^H`` filter and sign decision) on the same
  channels, precoders, filters, bits and noise, exactly (both float32);
  ``run``'s two halves are the errors of the quantized-CSI and the
  perfect-CSI solve, each solved alone; the app's BERs lie in (0, 0.5)
  with the quantized one not below the perfect one, and repeat on the
  same seed.
"""

import os
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pyphysim_tpu.ops import cplx  # noqa: E402
from pyphysim_tpu.utils.misc import randn_c_RS  # noqa: E402


def _codebooks(seed, shape):
    rs = np.random.RandomState(seed)
    cb = randn_c_RS(rs, *shape)
    return cb / np.linalg.norm(cb, axis=(-2, -1), keepdims=True)


@pytest.mark.parametrize("shape", [(6, 4, 2), (5, 8, 3, 1), (3, 7, 5, 3),
                                   (4, 16, 3, 1)])
def test_min_chordal_dist_sq_matches_the_jax_function(shape):
    from apps.find_codebook import min_chordal_dist_sq as jax_fn
    from apps.find_codebook_torch import min_chordal_dist_sq
    cb = _codebooks(len(shape), shape)
    want = np.asarray(jax.jit(jax_fn)(cplx.from_numpy(cb)))
    got = min_chordal_dist_sq(torch.as_tensor(cb)).numpy()
    assert got.shape == want.shape == shape[:-3]
    assert np.allclose(got, want, rtol=1e-5, atol=1e-6)


def test_min_chordal_dist_matches_the_host_float64():
    from apps.find_codebook_torch import (CodebookFinder,
                                          min_chordal_dist_sq)
    cb = _codebooks(7, (6, 4, 2))
    host_d, _ = CodebookFinder.calc_min_chordal_dist(cb)
    got = float(min_chordal_dist_sq(torch.as_tensor(cb))) ** 0.5
    assert np.isclose(got, host_d, atol=1e-3)


def test_orthonormal_columns_span_the_input():
    from apps.find_codebook_torch import orthonormal_columns
    c = torch.as_tensor(_codebooks(3, (10, 5, 3)).astype(np.complex128))
    q = orthonormal_columns(c)
    eye = torch.eye(3, dtype=q.dtype)
    assert torch.allclose(q.mH @ q, eye.expand(10, 3, 3), atol=1e-10)
    proj = q @ q.mH
    assert torch.allclose(proj @ c, c, atol=1e-10)


def test_finder_improves_and_respects_types():
    from apps.find_codebook_torch import COMPLEX_QEGT, REAL, CodebookFinder
    cb = CodebookFinder(3, 1, 8, prng_seed=1, batch=32, device="cpu")
    cb.find_codebook(64)
    first = cb.min_dist
    assert 0.0 < first <= 1.0 + 1e-6
    cb.find_codebook(256)
    assert cb.min_dist >= first  # best-so-far is monotone
    assert cb.codebook.shape == (8, 3, 1)
    assert cb.candidates_scored == 64 + 256

    real = CodebookFinder(3, 1, 4, REAL, prng_seed=2, batch=16, device="cpu")
    real.find_codebook(16)
    assert np.allclose(real.codebook.imag, 0)

    qegt = CodebookFinder(3, 1, 4, COMPLEX_QEGT, prng_seed=3, batch=16,
                          device="cpu")
    qegt.find_codebook(16)
    assert np.allclose(np.abs(qegt.codebook), 1.0, atol=1e-5)
    assert "Complex QEG" in repr(qegt)
    with pytest.raises(ValueError):
        CodebookFinder(2, 2, 4, device="cpu")


@pytest.mark.parametrize("ctype", [0, 1, 2])
def test_finder_best_is_the_best_candidate_under_the_rankin_bound(ctype):
    from apps.find_codebook_torch import (AttemptStreams, CodebookFinder,
                                          generate_random_codebooks,
                                          min_chordal_dist_sq)
    Nt, Ns, K, seed = 4, 2, 6, 9
    f = CodebookFinder(Nt, Ns, K, ctype, prng_seed=seed, batch=64,
                       device="cpu")
    best_d2, best_C = f.search(192)
    # the same candidates scored in one batch: the same best distance
    cands = generate_random_codebooks(
        AttemptStreams.from_range(seed, 0, 192, "cpu"), K, Nt, Ns, ctype)
    d2 = min_chordal_dist_sq(cands)
    assert float(best_d2) == float(d2.max())
    assert float(min_chordal_dist_sq(best_C)) == float(best_d2)
    rankin = Ns * (Nt - Ns) / Nt * K / (K - 1)
    assert 0.0 < float(best_d2) <= rankin


def test_finder_candidates_depend_on_seed_and_index_only():
    from apps.find_codebook_torch import CodebookFinder
    a = CodebookFinder(3, 1, 8, prng_seed=4, batch=16, device="cpu")
    b = CodebookFinder(3, 1, 8, prng_seed=4, batch=16, device="cpu")
    a.find_codebook(32)
    b.find_codebook(32)
    assert np.array_equal(a.codebook, b.codebook)
    # the second search scores new candidates
    d_first, _ = a.search(16)
    d_again, _ = a.search(16)
    assert float(d_first) != float(d_again)


def test_find_codebook_main_writes_npz_and_mat(tmp_path, capsys):
    from apps import find_codebook_torch as app
    out = str(tmp_path / "res")
    cb = app.main(["--rep_max", "64", "--batch", "32", "--outdir", out,
                   "--device", "cpu"])
    name = os.path.join(out, "codebook_16_precoders_in_G(3,1)")
    data = np.load(name + ".npz")
    assert np.isclose(float(data["best_dist"]), cb.min_dist)
    assert data["best_codebook"].shape == (16, 3, 1)
    import scipy.io
    mat = scipy.io.loadmat(name + ".mat")
    assert np.array_equal(mat["codebook"], data["best_codebook"])
    assert "Saving new results" in capsys.readouterr().out
    app.main(["--rep_max", "32", "--batch", "32", "--outdir", out,
              "--device", "cpu", "--seed", "1"])
    assert "Previous minimum distance" in capsys.readouterr().out
    assert app.find_codebook(3, 1, 4, 16, batch=16,
                             device="cpu").shape == (4, 3, 1)


# -- quantized CSI -----------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_channel_matches_the_jax_function(seed):
    from apps.ia.simple_maxsinr_quantized import \
        quantize_channel as jax_quantize
    from apps.ia.simple_maxsinr_quantized_torch import quantize_channel
    rs = np.random.RandomState(seed)
    H = randn_c_RS(rs, 3, 3, 2, 2)
    cb = randn_c_RS(rs, 64, 4)
    cb /= np.linalg.norm(cb, axis=-1, keepdims=True)
    want = jax.jit(jax_quantize)(cplx.from_numpy(H),
                                 cplx.from_numpy(cb)).to_numpy()
    got = quantize_channel(torch.as_tensor(H), torch.as_tensor(cb)).numpy()
    assert np.array_equal(got, want)
    # batched over leading axes: each block quantized alone
    Hb = randn_c_RS(rs, 5, 3, 3, 2, 2)
    got_b = quantize_channel(torch.as_tensor(Hb), torch.as_tensor(cb))
    for i in range(5):
        one = quantize_channel(torch.as_tensor(Hb[i]), torch.as_tensor(cb))
        assert torch.equal(got_b[i], one)
    # the nearest codeword after normalization, by brute force
    hn = H.reshape(9, 4)
    for b in range(9):
        v = hn[b] / np.linalg.norm(hn[b])
        d = np.linalg.norm(v[None, :] - cb, axis=-1)
        assert np.array_equal(got.reshape(9, 4)[b], cb[np.argmin(d)])


def test_gen_codebook_unit_norm_one_codeword_a_stream_row():
    from apps.ia.simple_maxsinr_quantized_torch import (AttemptStreams,
                                                        gen_codebook)
    streams = AttemptStreams.from_range(3, 0, 64, "cpu")
    cb = gen_codebook(streams, 64, 4)
    assert cb.shape == (64, 4) and cb.dtype == torch.complex64
    assert torch.allclose(cb.abs().square().sum(-1), torch.ones(64),
                          atol=1e-5)
    assert torch.equal(gen_codebook(streams, 64, 4), cb)
    # codeword i depends on stream row i only
    assert torch.equal(gen_codebook(streams[:16], 16, 4), cb[:16])
    with pytest.raises(ValueError):
        gen_codebook(streams, 16, 4)


def _jax_receive_errors(H, F, U, bits, noise):
    """The receive and decision step of the JAX app's ``one_rep``
    (``apps/ia/simple_maxsinr_quantized.py``) on one repetition's
    CArrays, the noise already scaled."""
    import jax.numpy as jnp
    from pyphysim_tpu.ops.cplx import CArray
    K = H.shape[0]
    x = CArray(2.0 * bits - 1.0, jnp.zeros(bits.shape))
    rx = []
    for kk in range(K):
        acc = CArray(noise.re[kk], noise.im[kk])
        for ll in range(K):
            acc = acc + cplx.matmul(cplx.matmul(H[kk, ll], F[ll]), x[ll])
        rx.append(cplx.matmul(U[kk].mH, acc))
    y = cplx.stack(rx, axis=0)
    decided = (y.re < 0).astype(jnp.int32) ^ 1
    return int(jnp.sum(decided != bits))


@pytest.mark.parametrize("seed", [0, 1])
def test_bit_errors_match_the_jax_receive_loop(seed):
    from apps.ia.simple_maxsinr_quantized_torch import K, NR, NS, NT, \
        bit_errors
    rs = np.random.RandomState(seed)
    reps, n = 4, 40
    c64 = np.complex64
    H = randn_c_RS(rs, reps, K, K, NR, NT).astype(c64)
    F = randn_c_RS(rs, reps, K, NT, NS).astype(c64)
    U = randn_c_RS(rs, reps, K, NR, NS).astype(c64)
    bits = rs.randint(0, 2, (reps, K, NS, n))
    noise = (0.5 * randn_c_RS(rs, reps, K, NR, n)).astype(c64)
    got = bit_errors(*(torch.as_tensor(a) for a in (H, F, U, bits, noise)))
    want = [_jax_receive_errors(cplx.from_numpy(H[r]), cplx.from_numpy(F[r]),
                                cplx.from_numpy(U[r]), jax.numpy.asarray(
                                    bits[r]), cplx.from_numpy(noise[r]))
            for r in range(reps)]
    assert got.dtype == torch.int64
    assert got.tolist() == want
    assert 0 < min(want)  # random precoders and filters: errors to count


def test_run_halves_are_the_quantized_and_perfect_solves():
    from apps.ia import simple_maxsinr_quantized_torch as app
    from pyphysim_tpu_torch.ia import batched
    from pyphysim_tpu_torch.utils.conversion import dB2Linear
    reps, size, n, iterations, snr = 12, 64, 30, 20, 5.0
    noise_var = 1.0 / dB2Linear(snr)
    codebook, H, s_F, bits, noise = app.draws(reps, size, n, 0, "cpu")
    errors = {}
    for name, csi in (("quantized", app.quantize_channel(H, codebook)),
                      ("perfect", H)):
        F, U = batched.max_sinr_solve(csi, s_F, app.NS, 1.0, noise_var,
                                      iterations=iterations)
        errors[name] = int(app.bit_errors(
            H, F, U, bits, noise * noise_var ** 0.5).sum())
    err_q, err_p, _ = app.run(reps, size, snr, n, iterations, device="cpu")
    assert (int(err_q), int(err_p)) == (errors["quantized"],
                                        errors["perfect"])
    assert errors["quantized"] > errors["perfect"]


def test_quantized_app_bers(capsys):
    from apps.ia import simple_maxsinr_quantized_torch as app
    err_q, err_p, bits = app.run(reps=40, codebook_size=64, nsymbs=20,
                                 iterations=20, device="cpu")
    assert bits == 40 * 3 * 20
    ber_q, ber_p = int(err_q) / bits, int(err_p) / bits
    assert 0.0 < ber_q < 0.5 and 0.0 <= ber_p < 0.5
    assert ber_q >= ber_p
    again = app.run(reps=40, codebook_size=64, nsymbs=20, iterations=20,
                    device="cpu")
    assert (int(again[0]), int(again[1])) == (int(err_q), int(err_p))
    # the first reps of a longer run are the same reps
    more = app.run(reps=41, codebook_size=64, nsymbs=20, iterations=20,
                   device="cpu")
    assert int(more[0]) >= int(err_q) and int(more[1]) >= int(err_p)
    out = app.main(["--reps", "8", "--codebook-size", "32", "--device",
                    "cpu"])
    text = capsys.readouterr().out
    assert "BER with quantized CSI" in text and out[2] == 8 * 3 * 50
