"""Frozen copies of the runner's chunked paths, for the tests that hold
the runner to them (on the CPU and on a card). No mesh, no spans. Imports
no JAX.

* The per-key runner's stop-ruled executor in its sequential order: each
  sub-chunk runs; its stop metric, its ``__valid__`` mask and then each of
  its outputs are fetched with ``.cpu()``, one at a time; only then does
  the next sub-chunk run.
* The two chunk loops the runner had before one loop ran both paths: the
  per-key path's (``_batch_loop``) and the bulk path's (``_bulk_loop``,
  with its ladder), each fetching a chunk's outputs with ``.cpu()`` after
  it has dispatched the speculative next chunk.
"""

import time

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


def _stop_ok(runner, current_results):
    if runner.batch_stop_criterion is None:
        return True
    return runner._stop_metric_value(current_results) < \
        float(runner.batch_stop_criterion[1])


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
    :func:`sequential_executor`, behind the runner's executor interface
    (``executor(cursor, nk, prior_metric) -> fetch``)."""
    def make(kernel, seed, device):
        executor = sequential_executor(runner, kernel, seed, device)

        def fetch_later(cursor, nk, prior_metric):
            done = executor(cursor, nk, prior_metric)
            return lambda: done
        return fetch_later

    runner._make_chunk_executor = make
    return runner


def _executor(runner, kernel, seed, device):
    if runner.batch_stop_criterion is not None:
        return sequential_executor(runner, kernel, seed, device)
    from pyphysim_tpu_torch.ops.streams import AttemptStreams

    def executor(cursor, nk, prior_metric):
        del prior_metric
        return kernel(AttemptStreams.from_range(seed, cursor, nk,
                                                device)), None

    return executor


def batch_loop(runner, kernel, current_params, current_results,
               current_rep, pbar):
    """The per-key path's chunk loop (``_batch_loop``)."""
    from pyphysim_tpu_torch._device import require_cuda
    from pyphysim_tpu_torch.simulations.runner import kernel_stream_seed
    seed = kernel_stream_seed(runner.base_seed, current_params.unpack_index)
    executor = _executor(runner, kernel, seed, require_cuda(runner.device))
    bsize = runner._default_batch_size()
    cursor = current_rep + runner._skipped_before(current_results)

    def dispatch(cur, nk):
        prior = (runner._stop_metric_value(current_results)
                 if runner.batch_stop_criterion is not None else 0.0)
        return executor(cur, nk, prior)

    speculate = runner.batch_stop_criterion is None
    pending = None
    while current_rep < runner.rep_max and \
            _stop_ok(runner, current_results) and \
            runner._keep_going(current_params, current_results,
                               current_rep):
        tic = time.time()
        needed = runner.rep_max - current_rep
        nk = min(bsize, runner._round_chunk(needed))
        if pending is not None and pending[:2] == (cursor, nk):
            out, active = pending[2]
        else:
            out, active = dispatch(cursor, nk)
        pending = None
        if speculate and needed > nk:
            nk_next = min(bsize, runner._round_chunk(needed - nk))
            pending = (cursor + nk, nk_next,
                       dispatch(cursor + nk, nk_next))
        out = _outputs(out, nk)
        elapsed = time.time() - tic
        n_accept, consumed, n_skip = runner._consume_chunk(
            out, nk, needed, elapsed, current_results, active)
        current_rep += n_accept
        cursor += consumed
        if consumed != nk:
            speculate = False
        pbar.progress(current_rep)
        runner._save_partial_results_maybe(current_rep, current_params,
                                           current_results)
        if n_accept == 0 and n_skip == 0:
            break
    runner._merge_skip_count(current_results, 0)
    return current_rep


def bulk_loop(runner, bulk, current_params, current_results, current_rep,
              pbar):
    """The bulk path's chunk loop (``_bulk_loop``)."""
    bsize = runner._default_batch_size()
    cursor = current_rep + runner._skipped_before(current_results)
    ladder = sorted({runner._round_chunk(max(bsize // d, 1))
                     for d in (8, 4, 2, 1)})

    def pick_chunk(needed):
        if runner.batch_stop_criterion is None:
            return bsize
        nk = next((n for n in ladder if n >= needed), ladder[-1])
        limit = float(runner.batch_stop_criterion[1])
        metric = runner._stop_metric_value(current_results)
        if current_rep > 0 and metric > 0:
            rate = metric / current_rep
            expected = (limit - metric) / rate
            rung = ladder[0]
            for n in ladder:
                if n <= expected:
                    rung = n
            nk = min(nk, rung)
        return nk

    speculate = runner.batch_stop_criterion is None
    pending = None
    while current_rep < runner.rep_max and \
            _stop_ok(runner, current_results) and \
            runner._keep_going(current_params, current_results,
                               current_rep):
        tic = time.time()
        needed = runner.rep_max - current_rep
        nk = pick_chunk(needed)
        if pending is not None and pending[:2] == (cursor, nk):
            out = pending[2]
        else:
            out = bulk(cursor, nk)
        pending = None
        if speculate and needed > nk:
            pending = (cursor + nk, bsize, bulk(cursor + nk, bsize))
        out = {name: _fetch(v) for name, v in out.items()}
        elapsed = time.time() - tic
        n_accept, consumed, n_skip = runner._consume_chunk(
            out, nk, needed, elapsed, current_results)
        current_rep += n_accept
        cursor += consumed
        if consumed != nk:
            speculate = False
        pbar.progress(current_rep)
        runner._save_partial_results_maybe(current_rep, current_params,
                                           current_results)
        if n_accept == 0 and n_skip == 0:
            break
    runner._merge_skip_count(current_results, 0)
    return current_rep


def use_parent_loops(runner):
    """Make ``runner`` run its chunked paths through :func:`batch_loop` and
    :func:`bulk_loop` in place of its one chunk loop."""
    runner._perkey_chunks = lambda kernel, params: (batch_loop, kernel)
    runner._bulk_chunks = lambda bulk: (bulk_loop, bulk)
    runner._chunk_loop = lambda loop, fn, *args: loop(runner, fn, *args)
    return runner
