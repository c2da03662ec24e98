"""Time-sharded TDL channel corruption: a long symbol stream over ranks.

Counterpart of ``pyphysim_tpu/parallel/timeshard.py``. The stream is cut in
``n`` contiguous shards of whole channel blocks; rank ``i`` skips the
Jakes clock by ``i * n_local`` samples (the closed form makes the skip
O(1)), runs the block-static ``corrupt_data`` on its shard (on the card,
the ``block_fir`` kernel) and sends the ``span - 1`` samples its
convolution spills past the shard to rank ``i + 1``, which adds them to
its head: one send / receive pair where JAX writes ``lax.ppermute``.

The output is the first ``N`` samples of the unsharded ``corrupt_data``
(the last rank's spill-over is dropped, the samples every consumer of the
chain slices away).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .mesh import _coordinate

__all__ = ["corrupt_data_time_sharded", "corrupt_shard"]


def _shard_length(channel, num_samples: int, block_size: int,
                  num_shards: int) -> int:
    if num_samples % (num_shards * block_size) != 0:
        raise ValueError(
            f"signal length {num_samples} must divide over {num_shards} "
            f"devices x block_size {block_size}")
    n_local = num_samples // num_shards
    if channel.num_taps_with_padding - 1 >= n_local:
        raise ValueError("channel span exceeds the per-device shard")
    return n_local


def corrupt_shard(channel, state, signal: torch.Tensor, block_size: int,
                  index: int, num_shards: int):
    """Shard ``index`` of ``num_shards`` of the time-sharded corruption,
    before the halo exchange: ``(main, tail, ir)`` with ``main`` the
    shard's ``n_local`` output samples, ``tail`` the ``span - 1`` samples
    that spill into shard ``index + 1`` and ``ir`` the shard's per-block
    response. ``signal`` is the whole stream ``(N,)``."""
    signal = channel._as_signal(signal)
    n_local = _shard_length(channel, signal.shape[-1], block_size,
                            num_shards)
    st = channel._fading_generator.skip(state, index * n_local)
    out, ir, _ = channel._corrupt_data_impl(
        st, signal[..., index * n_local:(index + 1) * n_local], block_size)
    return out[..., :n_local].clone(), out[..., n_local:], ir


def _pass_right(mesh, axis_name: str,
                tail: torch.Tensor) -> Optional[torch.Tensor]:
    """Send ``tail`` to the next rank along ``axis_name`` and receive the
    previous rank's (None on the first rank)."""
    index, size = _coordinate(mesh, axis_name)
    group = mesh.get_group(axis_name)
    wire = torch.view_as_real(tail.contiguous())
    received = torch.empty_like(wire) if index > 0 else None
    ops = []
    if index + 1 < size:
        ops.append(dist.P2POp(dist.isend, wire,
                              dist.get_global_rank(group, index + 1), group))
    if received is not None:
        ops.append(dist.P2POp(dist.irecv, received,
                              dist.get_global_rank(group, index - 1), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return None if received is None else torch.view_as_complex(received)


def corrupt_data_time_sharded(channel, state, signal: torch.Tensor,
                              block_size: int, mesh,
                              axis_name: str = "time") -> Tuple:
    """Block-static ``corrupt_data`` over a time-sharded signal.

    ``channel``: a SISO ``TdlChannel`` whose generator skips in O(1)
    (Jakes closed form, or Rayleigh); ``state``: its state, the same on
    every rank; ``signal``: the whole stream ``(N,)`` on every rank, ``N``
    divisible by ``mesh`` axis size × ``block_size``; ``mesh`` /
    ``axis_name``: the axis to shard time over.

    Returns ``(out, ir, state)``: this rank's ``n_local = N / size`` output
    samples (the halo of the previous rank added to its head), its
    per-block response (``TdlImpulseResponse``, taps ``(T, blocks of the
    shard)``), and ``state`` skipped by ``N``.
    """
    index, size = _coordinate(mesh, axis_name)
    main, tail, ir = corrupt_shard(channel, state, signal, block_size,
                                   index, size)
    received = _pass_right(mesh, axis_name, tail)
    if received is not None:
        main[..., :received.shape[-1]] += received
    num_samples = signal.shape[-1]
    return main, ir, channel._fading_generator.skip(state, num_samples)
