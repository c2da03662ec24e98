"""Shared inputs and checks of the comp_BD tests (``test_torch_comp_bd*``):
the batched stream-sacrifice and whitening BD solvers of the port held
against the JAX package on the same numpy draws.

Inputs: K = 3 users of 2 receive antennas, 64 draws: 48 at the comp_BD
scenario's scales (channel blocks ~1e-7..1e-5, external interference power
0.01 W through a ~1e-6..3e-5 channel, noise variance 2.3e-15) and 16 at
unit scale (noise variance 0.01).

Tolerances and why. At these scales the users' rows differ by up to 40
dB, and float32 rounding moves the SINRs of the most ill-conditioned
draws far from a float64 run of the same algorithm: by per cents in the
port, whose decompositions are LAPACK's, and on a few draws by more than
the SINR itself in the JAX package. So each output is held to the float64
run of the port's algorithm (``exact``) at least as closely as the JAX
package is, and the JAX package pins that float64 run: its own error from
it is at most 1e-3 on every unit-scale draw and, on the scaled draws, at
most 1e-3 in the median and 1e-2 at the 90th percentile (no bound holds
on every scaled draw, for the few it loses). An algorithm error shared by
both of the port's runs moves every draw and cannot pass:

* stream counts and validity masks: equal to the JAX package's;
* per-stream SINRs: in each draw, the port's largest relative error at
  most ``max(1e-3, 4 x the JAX package's)`` (two float32 roundings of an
  ill-conditioned draw land apart by a few times either's error), and
  summed over the draws at most the JAX package's;
* precoders ``Ms`` and receive filters ``Wk``, relative to each draw's
  largest entry, through their phase-free Gram forms ``Ms Ms^H`` and
  ``Wk^H Wk`` (each basis column's phase is fixed by its largest entry,
  and two nearly equal entries pick differently under two roundings, a
  gauge the filters undo): the SINRs' rule with a per-draw floor of 2e-2
  on the scaled draws (the weakest BD stream of a 40 dB spread carries
  float32 errors of 1 % in either package);
* on the unit-scale draws, SINRs, ``Ms`` and ``Wk`` also directly against
  the JAX package to rtol 1e-3;
* ``W_k H_k Ms_j = delta_kj I``: 1e-4 on the diagonal blocks; the cross
  terms, which block diagonalization nulls, within 1e-5 of
  ``|W_k| |H_k| |Ms_j|`` (Frobenius norms) on the unit-scale draws, and
  at most 4 x the JAX package's own cross terms on the others (the null
  space of rows 40 dB apart is float32-accurate only to ~1e-3).
"""

import numpy as np
import torch

from pyphysim_tpu.ops import cplx
from pyphysim_tpu_torch.comm.batched import enhanced_bd_batched

K, NR, NT = 3, 2, 2
PT = 1.5


def comp_bd_draws(seed, B=64, nt=NT, unit=16):
    """(H, R): ``B`` joint channels (K*NR, K*nt) and ext-int-plus-noise
    covariances (K, NR, NR) at the comp_BD scenario's scales (the last
    ``unit`` draws at unit scale)."""
    rng = np.random.default_rng(seed)

    def crandn(*s):
        return (rng.standard_normal(s) + 1j * rng.standard_normal(s)) / \
            np.sqrt(2)

    spl = 10.0 ** rng.uniform(-7, -5, (B, K, K))          # sqrt path loss
    spl[B - unit:] = 1.0
    H = crandn(B, K, NR, K, nt) * spl[:, :, None, :, None]
    she = 10.0 ** rng.uniform(-6, -4.5, (B, K, 1, 1))
    she[B - unit:] = 1.0
    He = crandn(B, K, NR, 1) * she
    pe, nv = np.full(B, 0.01), np.full(B, 2.3e-15)
    pe[B - unit:], nv[B - unit:] = 1.0, 1e-2
    R = pe[:, None, None, None] * (He @ He.conj().swapaxes(-1, -2)) + \
        nv[:, None, None, None] * np.eye(NR)
    return (H.reshape(B, K * NR, K * nt).astype(np.complex64),
            R.astype(np.complex64))


def jax_out(out):
    return [x.to_numpy() if isinstance(x, cplx.CArray) else np.asarray(x)
            for x in out]


def draw_errors(x, ref, elementwise=False):
    """Per draw: the largest |x - ref|, relative to each element
    (``elementwise``) or to the draw's largest |ref|."""
    B = ref.shape[0]
    d = np.abs(x - ref).reshape(B, -1)
    r = np.abs(ref).reshape(B, -1)
    if elementwise:
        return (d / np.maximum(r, 1e-30)).max(axis=-1)
    return d.max(axis=-1) / np.maximum(r.max(axis=-1), 1e-30)


def gram_forms(out):
    """SINRs, ``Ms Ms^H`` and ``Wk^H Wk`` of a result (numpy)."""
    Ms, W = out[0], out[1]
    return (out[3], Ms @ Ms.conj().swapaxes(-1, -2),
            W.conj().swapaxes(-1, -2) @ W)


def check_against_jax(got, want, exact, ns_flips=0, unit=16):
    """The rules of the module docstring (the last ``unit`` draws at unit
    scale); returns the draws where the stream counts agree."""
    got = [x.numpy() for x in got]
    exact = [x.numpy() for x in exact]
    np.testing.assert_array_equal(got[4], want[4])
    agree = (got[2] == want[2]).all(axis=-1)
    assert int((~agree).sum()) <= ns_flips, (got[2][~agree],
                                             want[2][~agree])
    # a float32 tie (saturated metric values) that float64 breaks the
    # other way has no float64 counterpart to measure against
    agree &= (got[2] == exact[2]).all(axis=-1)
    scaled = np.arange(agree.size) < agree.size - unit
    for i, (g, w, e) in enumerate(zip(gram_forms(got), gram_forms(want),
                                      gram_forms(exact))):
        port = draw_errors(g, e, elementwise=i == 0)
        ref = draw_errors(w, e, elementwise=i == 0)
        check_jax_pins_exact(ref[agree], scaled[agree], i)
        floor = np.where(scaled & (i > 0), 2e-2, 1e-3)
        assert (port <= np.maximum(floor, 4 * ref))[agree].all(), \
            (i, port.max(), ref.max())
        assert port[agree].sum() <= max(ref[agree].sum(), 1e-3), \
            (i, port.sum(), ref.sum())
        np.testing.assert_array_less(
            draw_errors(g, w, elementwise=i == 0)[agree & ~scaled], 1e-3)
    return agree


def check_jax_pins_exact(ref, scaled, what):
    """The JAX package's error from the port's float64 run (``ref``, per
    draw): at most 1e-3 on each unit-scale draw; on the ``scaled`` ones at
    most 1e-3 in the median and 1e-2 at the 90th percentile."""
    assert (ref[~scaled] <= 1e-3).all(), (what, ref[~scaled].max())
    median, p90 = np.quantile(ref[scaled], [0.5, 0.9])
    assert median <= 1e-3 and p90 <= 1e-2, (what, median, p90)


def port_run(H, R, **kw):
    """The port's result in float32 and its float64 run (``exact``)."""
    out = enhanced_bd_batched(torch.from_numpy(H), torch.from_numpy(R), K,
                              PT, **kw)
    exact = enhanced_bd_batched(torch.from_numpy(H.astype(np.complex128)),
                                torch.from_numpy(R.astype(np.complex128)),
                                K, PT, **kw)
    return out, exact


def check_whitening_against_jax(got, want, exact, unit=16):
    """``whitening_bd_batched``'s validity mask equal to the JAX
    package's, and its precoders and composite filters by the Gram-form
    rule of the module docstring (the last ``unit`` draws at unit
    scale)."""
    np.testing.assert_array_equal(got[2], want[2])
    scaled = np.arange(got[0].shape[0]) < got[0].shape[0] - unit
    for i in (0, 1):
        g, w, e = (x[i] @ x[i].conj().swapaxes(-1, -2) if i == 0 else
                   x[i].conj().swapaxes(-1, -2) @ x[i]
                   for x in (got, want, exact))
        port, ref = draw_errors(g, e), draw_errors(w, e)
        check_jax_pins_exact(ref, scaled, i)
        assert (port <= np.maximum(np.where(scaled, 2e-2, 1e-3),
                                   4 * ref)).all(), (i, port.max())
        assert port.sum() <= max(ref.sum(), 1e-3)
        np.testing.assert_array_less(draw_errors(g, w)[~scaled], 1e-3)
