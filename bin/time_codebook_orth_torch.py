#!/usr/bin/env python3
"""Time the codebook search's column orthonormalization on one card.

``apps/find_codebook_torch.py`` orthonormalizes each candidate precoder's
columns by a Gram-Schmidt pass in tensor ops (``orthonormal_columns``).
This script times it against ``torch.linalg.qr(c)[0]`` at the search's two
sizes, G(3, 1) with K = 16 in batches of 256 (the CLI defaults) and
G(4, 2) with K = 64 in batches of 2,048 (``chip_smoke.py`` phase 43):

  * the orthonormalization alone on one batch of candidates, best of
    ``repeat`` with CUDA events after a warm-up;
  * one search batch end to end (``CodebookFinder.search``), with each
    orthonormalization in turn: best of ``repeat`` on the host clock, the
    device synchronized on both sides, after a warm-up;
  * the launches and device time of each from a ``torch.profiler`` trace
    of one call, where the route issues at most ``TRACE_LAUNCHES``
    (``torch.linalg.qr`` on the card issues about 11 launches a matrix,
    as a trace at G(3, 1) shows, so over a million a G(4, 2) batch: too
    many to trace);
  * the squared distances ``min_chordal_dist_sq`` gives each candidate of
    the batch with each, which must agree within 1e-5 (the same
    projectors, whatever the phase of the basis).

Run from the repository root: ``python3 bin/time_codebook_orth_torch.py
[--json PATH]``. Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "bin"))

# (size, best of how many calls for (Gram-Schmidt, QR)): a QR call at
# G(4, 2) takes seconds
SIZES = ((dict(Nt=3, Ns=1, K=16, batch=256), (10, 10)),
         (dict(Nt=4, Ns=2, K=64, batch=2048), (10, 2)))
TRACE_LAUNCHES = 100_000


def wall_ms(fn, repeat=10):
    """Best host time of one ``fn()`` in ms, the device synchronized on
    both sides, after a warm-up."""
    import torch
    fn()
    best = float("inf")
    for _ in range(repeat):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - tic)
    return best * 1e3


def time_size(Nt, Ns, K, batch, repeats, dev):
    import torch
    from apps import find_codebook_torch as app
    from profile_chain_torch import best_ms, kernels, trace
    from pyphysim_tpu_torch.ops.streams import AttemptStreams

    gram_schmidt = app.orthonormal_columns
    routes = {"gram_schmidt": gram_schmidt,
              "linalg_qr": lambda c: torch.linalg.qr(c)[0]}
    cands = app.generate_random_codebooks(
        AttemptStreams.from_range(0, 0, batch, dev), K, Nt, Ns)
    out = {"Nt": Nt, "Ns": Ns, "K": K, "batch": batch}
    d2 = {}
    try:
        for (name, orth), repeat in zip(routes.items(), repeats):
            app.orthonormal_columns = orth
            finder = app.CodebookFinder(Nt, Ns, K, batch=batch, device=dev)
            r = out[name] = {
                "repeat": repeat,
                "alone_ms": best_ms(lambda: orth(cands), repeat=repeat),
                "search_ms_a_batch": wall_ms(lambda: finder.search(batch),
                                             repeat=repeat)}
            d2[name] = app.min_chordal_dist_sq(cands)
            if name == "gram_schmidt" or batch * K * 11 <= TRACE_LAUNCHES:
                for what, fn in (("alone", lambda: orth(cands)),
                                 ("search", lambda: finder.search(batch))):
                    events, _ = trace(fn, repeat=1)
                    r[f"{what}_launches"] = kernels(events, repeat=1)
                    r[f"{what}_device_ms"] = sum(
                        t for _, t, _ in events) / 1e3
    finally:
        app.orthonormal_columns = gram_schmidt
    gs, qr = out["gram_schmidt"], out["linalg_qr"]
    out["qr_over_gram_schmidt_alone"] = qr["alone_ms"] / gs["alone_ms"]
    out["qr_over_gram_schmidt_search"] = (qr["search_ms_a_batch"] /
                                          gs["search_ms_a_batch"])
    out["d2_max_abs_diff"] = float((d2["linalg_qr"] -
                                    d2["gram_schmidt"]).abs().max())
    print(json.dumps(out), flush=True)
    if not out["d2_max_abs_diff"] <= 1e-5:
        raise AssertionError(f"QR and Gram-Schmidt disagree: {out}")
    return out


def main() -> int:
    import torch
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", default=None,
                        help="also write the results to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_codebook_orth_torch: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = {"card": card, "torch": torch.__version__,
              "sizes": [time_size(**size, repeats=repeats,
                                  dev=torch.device("cuda"))
                        for size, repeats in SIZES]}
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
