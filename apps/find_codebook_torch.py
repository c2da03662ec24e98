#!/usr/bin/env python
"""Grassmannian codebook search by random sampling, on the PyTorch port.

The counterpart of ``apps/find_codebook.py``: find the set of K precoders
in G(Nt, Ns) with the largest minimum pairwise chordal distance. A whole
batch of candidate codebooks is scored at once on ``--device``:

- the candidates come from the port's Philox streams
  (``ops/streams.py``), one stream row a candidate, keyed from ``--seed``
  and the candidate's index, so the card and the CPU score the same
  candidates and a second search continues with new ones;
- each precoder's columns are orthonormalized by a Gram-Schmidt pass in
  tensor ops: ``torch.linalg.qr`` issues about 11 launches a matrix on the
  card, and a search batch took 287x (G(3, 1), 256 candidates) and
  3,905x (G(4, 2), 2,048) as long with it on an NVIDIA H100 80GB HBM3 at
  700 W (``bin/time_codebook_orth_torch.py``);
- every pair's squared chordal distance ``d^2 = Ns - <P_i, P_j>_F``, with
  ``<P_i, P_j>_F = ||Q_i^H Q_j||_F^2``, comes from one batched matrix
  product over all K precoders of a codebook;
- the running best stays on the device across batches, with no host sync
  until the search ends.

Run: ``python apps/find_codebook_torch.py --Nt 3 --Ns 1 -K 16
--rep_max 100000 [--device cuda]``.
"""

import argparse
import math
import os
import sys

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pyphysim_tpu_torch._device import require_cuda  # noqa: E402
from pyphysim_tpu_torch.ops.streams import AttemptStreams  # noqa: E402
from pyphysim_tpu_torch.subspace import (  # noqa: E402
    calc_chordal_distance_from_principal_angles, calc_principal_angles)
from pyphysim_tpu_torch.utils.misc import full_precision  # noqa: E402

(COMPLEX, REAL, COMPLEX_QEGT) = range(3)
_TYPE_NAMES = {COMPLEX: "Complex", REAL: "Real", COMPLEX_QEGT: "Complex QEG"}


def generate_random_codebooks(streams: AttemptStreams, K: int, Nt: int,
                              Ns: int, codebook_type=COMPLEX) -> torch.Tensor:
    """(n, K, Nt, Ns) complex64 random codebooks, one a stream row. Each
    COMPLEX or REAL precoder has unit Frobenius norm; COMPLEX_QEGT keeps
    the JAX app's unit-modulus entries (the chordal distance only sees the
    column space)."""
    shape = (K, Nt, Ns)
    if codebook_type == COMPLEX:
        re, im = streams.normal((2,) + shape).unbind(dim=1)
        c = torch.complex(re, im)
    elif codebook_type == REAL:
        re = streams.normal(shape)
        c = torch.complex(re, torch.zeros_like(re))
    elif codebook_type == COMPLEX_QEGT:
        phases = streams.uniform(shape) * math.pi
        return torch.polar(torch.ones_like(phases), phases)
    else:
        raise ValueError(f"unknown codebook type {codebook_type}")
    norm = c.abs().square().sum(dim=(-2, -1), keepdim=True).sqrt()
    return c / norm


def orthonormal_columns(c: torch.Tensor) -> torch.Tensor:
    """An orthonormal basis of the column space of each (..., Nt, Ns)
    matrix of full column rank (modified Gram-Schmidt)."""
    cols = []
    for j in range(c.shape[-1]):
        v = c[..., j]
        for q in cols:
            v = v - q * (q.conj() * v).sum(dim=-1, keepdim=True)
        cols.append(v / v.abs().square().sum(dim=-1, keepdim=True).sqrt())
    return torch.stack(cols, dim=-1)


@full_precision
def min_chordal_dist_sq(codebooks: torch.Tensor) -> torch.Tensor:
    """Minimum squared pairwise chordal distance of each codebook:
    (..., K, Nt, Ns) complex -> (...,) real, from ``d_ij^2 = Ns -
    ||Q_i^H Q_j||_F^2`` for every pair at once."""
    codebooks = torch.as_tensor(codebooks)
    *lead, K, Nt, Ns = codebooks.shape
    q = orthonormal_columns(codebooks)
    rows = q.transpose(-1, -2).reshape(*lead, K * Ns, Nt)    # q_ik^T rows
    g = rows.conj() @ rows.transpose(-1, -2)                 # q_ik^H q_jl
    gram = g.abs().square().reshape(*lead, K, Ns, K, Ns).sum(dim=(-3, -1))
    d2 = torch.clamp(Ns - gram, min=0.0)
    eye = torch.eye(K, dtype=torch.bool, device=d2.device)
    d2 = d2.masked_fill(eye, math.inf)
    return d2.flatten(-2).min(dim=-1).values


class CodebookFinder:
    """Random-search Grassmannian codebook finder, with the JAX app's API.

    The search runs on ``device``; this object keeps the best codebook
    found so far across ``find_codebook`` calls. Candidate ``i`` (counted
    over all calls) is Philox stream row ``i`` under ``prng_seed``.
    """

    (COMPLEX, REAL, COMPLEX_QEGT) = (COMPLEX, REAL, COMPLEX_QEGT)

    def __init__(self, Nt, Ns, K, codebook_type=COMPLEX, prng_seed=0,
                 batch=256, device="cuda"):
        if not Ns < Nt:
            raise ValueError("Ns must be lower than Nt")
        self._Nt, self._Ns, self._K = Nt, Ns, K
        self._codebook_type = codebook_type
        self._seed = int(prng_seed or 0)
        self._batch = int(batch)
        self._dev = require_cuda(device)
        self._scored = 0
        self._min_dist = 0.0
        self._best_C = None

    def __repr__(self):
        return ("CodebookFinder: {0} {1} precoders in G({2},{3}) with "
                "minimum distance {4:.4f}").format(
                    self._K, self.type, self._Nt, self._Ns, self._min_dist)

    def search(self, rep_max=100):
        """Score ``rep_max`` new candidates (rounded up to whole batches):
        ``(best d^2, best codebook)`` as tensors on the device, read by no
        host sync."""
        steps = max(1, math.ceil(rep_max / self._batch))
        K, Nt, Ns = self._K, self._Nt, self._Ns
        best_d2 = torch.tensor(-math.inf, device=self._dev)
        best_C = torch.zeros((K, Nt, Ns), dtype=torch.complex64,
                             device=self._dev)
        for _ in range(steps):
            streams = AttemptStreams.from_range(self._seed, self._scored,
                                                self._batch, self._dev)
            self._scored += self._batch
            cands = generate_random_codebooks(streams, K, Nt, Ns,
                                              self._codebook_type)
            d2 = min_chordal_dist_sq(cands)
            i = torch.argmax(d2).reshape(1)
            top = d2.index_select(0, i)[0]
            better = top > best_d2
            best_d2 = torch.where(better, top, best_d2)
            best_C = torch.where(better, cands.index_select(0, i)[0], best_C)
        return best_d2, best_C

    def find_codebook(self, rep_max=100):
        """Score ``rep_max`` random codebooks (rounded up to whole device
        batches), keeping the best found so far."""
        best_d2, best_C = self.search(rep_max)
        best_dist = float(torch.sqrt(best_d2))
        if best_dist > self._min_dist:
            self._min_dist = best_dist
            self._best_C = best_C.cpu().numpy()

    @staticmethod
    def calc_min_chordal_dist(codebook):
        """(min_dist, principal_angles_of_the_min_pair) of a host codebook,
        pair by pair in float64."""
        codebook = np.asarray(codebook)
        K = codebook.shape[0]
        best = (np.inf, None)
        for i in range(K):
            for j in range(i + 1, K):
                pa = calc_principal_angles(codebook[i], codebook[j])
                d = calc_chordal_distance_from_principal_angles(pa)
                if d < best[0]:
                    best = (d, pa)
        return best

    @property
    def min_dist(self):
        return self._min_dist

    @property
    def candidates_scored(self):
        """Candidates drawn so far (the next search starts after them)."""
        return self._scored

    @property
    def principal_angles(self):
        if self._best_C is None:
            return None
        return CodebookFinder.calc_min_chordal_dist(self._best_C)[1]

    @property
    def codebook(self):
        return self._best_C

    @property
    def type(self):
        return _TYPE_NAMES[self._codebook_type]


def find_codebook(Nt, Ns, K, rep_max, prng_seed=0, codebook_type=COMPLEX,
                  batch=256, device="cuda"):
    """One-shot functional API: the best codebook of ``rep_max``
    candidates, as numpy."""
    cb = CodebookFinder(Nt, Ns, K, codebook_type, prng_seed, batch, device)
    cb.find_codebook(rep_max)
    return cb.codebook


def _save_results(best_dist, best_codebook, principal_angles, filename):
    """``filename``.npz, and ``filename``.mat through scipy."""
    np.savez(filename + ".npz", best_codebook=best_codebook,
             best_dist=best_dist,
             best_principal_angles=np.asarray(principal_angles))
    try:
        import scipy.io
    except ImportError:
        return
    scipy.io.savemat(filename + ".mat",
                     {"codebook": best_codebook,
                      "shape": np.asarray(best_codebook.shape)},
                     oned_as="row")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--Nt", type=int, default=3)
    parser.add_argument("--Ns", type=int, default=1)
    parser.add_argument("-K", type=int, default=16)
    parser.add_argument("--rep_max", type=int, default=10000)
    parser.add_argument("--batch", type=int, default=256,
                        help="candidate codebooks scored at once")
    parser.add_argument("--type", choices=["complex", "real", "qegt"],
                        default="complex")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--outdir", default="codebook_results")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    ctype = {"complex": COMPLEX, "real": REAL,
             "qegt": COMPLEX_QEGT}[args.type]
    cb = CodebookFinder(args.Nt, args.Ns, args.K, ctype, args.seed,
                        args.batch, args.device)
    print(f"Scoring {args.rep_max} random codebooks "
          f"({args.K} {cb.type} precoders in G({args.Nt},{args.Ns}))...")
    cb.find_codebook(args.rep_max)
    print(repr(cb))
    pa = cb.principal_angles
    print("Principal angles (degrees):", 180 / np.pi * np.asarray(pa))

    os.makedirs(args.outdir, exist_ok=True)
    filename = os.path.join(
        args.outdir, f"codebook_{args.K}_precoders_in_G({args.Nt},{args.Ns})")
    try:
        previous = float(np.load(filename + ".npz")["best_dist"])
        print(f"Previous minimum distance: {previous}")
    except (IOError, KeyError):
        previous = 0.0
    if cb.min_dist > previous:
        print("Saving new results")
        _save_results(cb.min_dist, cb.codebook, pa, filename)
    else:
        print("Keeping previous (better) results")
    return cb


if __name__ == "__main__":
    main()
