"""The per-key runner's stop-ruled executor in its sequential order, for
the tests that hold the executor to it (on the CPU and on a card): each
sub-chunk runs; its stop metric, its ``__valid__`` mask and then each of
its outputs are fetched with ``.cpu()``, one at a time; only then does the
next sub-chunk run. No mesh. Imports no JAX."""

import numpy as np


def _fetch(value):
    if isinstance(value, tuple):
        return tuple(_fetch(v) for v in value)
    if hasattr(value, "detach"):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _outputs(out, n):
    host = {}
    for name, v in out.items():
        if isinstance(v, tuple):
            values, totals = _fetch(v)
            totals = np.asarray(totals, np.float64)
            if totals.ndim == 0:
                totals = np.full(n, float(totals))
            host[name] = (values, totals)
        else:
            host[name] = _fetch(v)
    return host


def _stack_rows(parts, n):
    if isinstance(parts[0], tuple):
        return tuple(_stack_rows(list(p), n) for p in zip(*parts))
    a = np.concatenate([np.asarray(p) for p in parts])
    return np.concatenate([a, np.zeros((n - len(a),) + a.shape[1:],
                                       a.dtype)])


def sequential_executor(runner, kernel, seed, device):
    """What ``runner._make_chunk_executor(kernel, seed, device)`` builds
    under ``runner.batch_stop_criterion``, in the sequential order."""
    from pyphysim_tpu_torch.ops.streams import AttemptStreams
    stop_name, limit = runner.batch_stop_criterion
    limit = np.float32(limit)
    n_sub = max(int(runner.num_stop_subchunks), 1)

    def executor(cursor, nk, prior_metric):
        sub = nk // n_sub
        acc = np.float32(prior_metric)
        parts = []
        while len(parts) < n_sub and acc < limit:
            out = kernel(AttemptStreams.from_range(
                seed, cursor + len(parts) * sub, sub, device))
            metric = out[stop_name]
            if isinstance(metric, tuple):
                metric = metric[0]
            metric = np.asarray(_fetch(metric), np.float64)
            if "__valid__" in out:
                metric = np.where(_fetch(out["__valid__"]), metric, 0)
            acc = np.float32(acc + np.float32(metric.sum()))
            parts.append(_outputs(out, sub))
        active = np.arange(nk) < len(parts) * sub
        merged = {name: _stack_rows([p[name] for p in parts], nk)
                  for name in parts[0]}
        return merged, active

    return executor


def use_sequential_executor(runner):
    """Make ``runner`` run its per-key chunks through
    :func:`sequential_executor`."""
    runner._make_chunk_executor = \
        lambda kernel, seed, device: sequential_executor(runner, kernel,
                                                         seed, device)
    return runner
