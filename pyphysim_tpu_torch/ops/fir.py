"""Block-static sparse-tap FIR: each row of ``x_blocks`` (R, block_size)
convolved with its own sparse complex kernel ``taps`` (R, T) at static
offsets ``d_0 < ... < d_{T-1}``, giving (R, block_size + D - 1) with
``D = d_{T-1} + 1``.

Counterpart of ``pyphysim_tpu/ops/fir_pallas.py`` ``block_fir``. Three
versions of one function:

  * :func:`block_fir`, the wrapper: on CUDA tensors it launches the
    hand-written kernel ``ops/csrc/block_fir.cu`` (its source note says what
    bounds it and what its design does about that; the kernel picks its
    own form, instance and shape for any number of taps, block and span,
    :func:`kernel_plan` reads them), on CPU tensors it runs the plain
    version. There is no fallback from one to the other.
  * :func:`block_fir_reference`, the plain PyTorch version: one shifted
    multiply-add per tap, as the TPU kernel's body does.
  * :func:`block_fir_fft`, the per-block FFT convolution (the JAX package's
    XLA route): any circular length >= block_size + D - 1 gives the same
    linear convolution.

``block_fir.launch_count`` counts kernel launches and
``block_fir.reference_count`` calls of the plain version, so a run can show
which one it went through.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Sequence, Tuple

import torch

from .sparse_dft import sparse_dft

__all__ = ["block_fir", "block_fir_reference", "block_fir_fft",
           "kernel_plan", "kernel_profile", "launch_info", "loop_trips"]

# the kernel's forms (block_fir.cu make_plan): a whole row in a buffer with
# the taps unrolled (up to 64), a row cut into segments, one thread an
# output reading x through the caches
_FORMS = ("rows", "segments", "direct")
_PLAN_KEYS = ("tap_bound", "full", "stages", "warps", "row0",
              "stage_elements", "chunks", "out_len", "smem_bytes", "blocks",
              "rows_per_warp", "kChunks", "form", "segment", "segments",
              "rows_per_item", "unit", "dense", "items")
# block_fir_launch_info's values, in order
_INFO_KEYS = ("registers", "local_bytes", "static_smem_bytes",
              "blocks_per_sm")


def kernel_plan(rows: int, block_size: int, tap_offsets: Sequence[int],
                plan_fn=None) -> Dict[str, int]:
    """How the kernel runs ``rows`` rows of ``block_size`` samples with
    the taps at ``tap_offsets``, as ``block_fir.cu`` ``make_plan`` decides
    it (the C function ``block_fir_plan`` of the built library, or
    ``plan_fn``, a tuner's variant's): its ``form`` (``"rows"``: the
    whole row in a buffer where T <= 64 and four warps of two such buffers
    fit 227 KB; else ``"segments"``: block-wide items of
    ``rows_per_item`` whole rows or of one row's ``segment`` outputs and
    its halo, ``items`` of them, ``dense`` where the offsets are
    consecutive, ``unit`` outputs a warp at once; else, past ~28,000
    samples of span, ``"direct"``),
    the rows form's instance (``tap_bound``, the least of 16 / 32 / 64
    that holds T, and ``full``, T equal to it; ``rows_per_warp`` and
    ``kChunks``, its rows a warp and chunks a lane, 0 in the other
    forms), the buffers (stages) a
    warp or block (``stages``), the warps a block, the elements of a
    buffer, the shared bytes, the grid and the threads launched. Needs
    the built library, so the card; raises ``ValueError`` for arguments
    that are no FIR (no taps, an empty block)."""
    from . import _build
    offsets = _offsets(tuple(tap_offsets))
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    fn = plan_fn or _build.load().block_fir_plan
    if fn(int(rows), int(block_size), len(offsets), offsets[0],
          offsets[-1], out):
        raise ValueError(f"block_fir: no plan for {len(offsets)} taps, "
                         f"block_size {block_size}, span "
                         f"{offsets[-1] + 1}")
    plan = dict(zip(_PLAN_KEYS, out))
    plan["full"] = bool(plan["full"])
    plan["dense"] = bool(plan["dense"])
    plan["form"] = _FORMS[plan["form"]]
    plan["threads"] = plan["blocks"] * plan["warps"] * 32
    return plan


def launch_info(rows: int, block_size: int,
                tap_offsets: Sequence[int]) -> Dict[str, int]:
    """What the instance of :func:`kernel_plan`'s plan runs on this card
    (``block_fir_launch_info``): registers and local (spill) bytes a
    thread, static shared bytes and resident blocks a SM at the plan's
    threads and shared bytes. Needs the card."""
    from . import _build
    offsets = _offsets(tuple(tap_offsets))
    out = (ctypes.c_int * len(_INFO_KEYS))()
    _build.check(_build.load().block_fir_launch_info(
        int(rows), int(block_size), len(offsets), offsets[0], offsets[-1],
        out), "block_fir_launch_info")
    return dict(zip(_INFO_KEYS, out))


@functools.lru_cache(maxsize=64)
def _offsets(tap_offsets: Tuple[int, ...]) -> Tuple[int, ...]:
    offsets = tuple(int(d) for d in tap_offsets)
    if not offsets or offsets[0] < 0 or \
            any(b <= a for a, b in zip(offsets, offsets[1:])):
        raise ValueError("tap_offsets must be increasing and non-negative")
    return offsets


def _check(x_blocks: torch.Tensor, taps: torch.Tensor,
           tap_offsets: Sequence[int], block_size: int) -> Tuple[int, ...]:
    offsets = _offsets(tuple(tap_offsets))
    if x_blocks.dim() != 2 or x_blocks.shape[1] != block_size:
        raise ValueError(f"x_blocks must be (R, {block_size}), got "
                         f"{tuple(x_blocks.shape)}")
    if taps.dim() != 2 or taps.shape != (x_blocks.shape[0], len(offsets)):
        raise ValueError(f"taps must be (R, T) = ({x_blocks.shape[0]}, "
                         f"{len(offsets)}), got {tuple(taps.shape)}")
    if taps.device != x_blocks.device:
        raise ValueError("x_blocks and taps must be on one device")
    return offsets


def kernel_profile(rows: int, block_size: int,
                   tap_offsets: Sequence[int]) -> Dict[str, object]:
    """What ``ops/sass.py`` needs to count the instructions of one launch:
    the instance's mangled-name pattern and the threads launched (its
    loops' trips come from the listing, :func:`loop_trips`)."""
    plan = kernel_plan(rows, block_size, tap_offsets)
    pattern = {"rows": (f"block_fir_kernelILi{plan['tap_bound']}"
                        f"ELb{int(plan['full'])}ELi{plan['stages']}EE"),
               "segments": (f"block_fir_seg_kernelILi{plan['stages']}ELb"
                            f"{int(plan['dense'])}EE"),
               "direct": "block_fir_direct_kernel"}[plan["form"]]
    return {"pattern": pattern, "threads": plan["threads"], "plan": plan,
            "rows": rows}


def loop_trips(loops: Sequence[Dict[str, int]],
               profile: Dict[str, object]) -> List[float]:
    """Each loop's trips, in listing order, from its opcodes
    (``sass.loop_ops``): the loop holding the most FFMAs is a warp's row
    loop (its rows, averaged over the warps launched), the next the
    pass loop (``chunks // kChunks`` a row), the third the tail
    (``chunks % kChunks``); every other loop (the zero fills and the
    copies, unrolled by the compiler with remainders) counts one trip,
    a few per cent of the issue not resolved."""
    plan = profile["plan"]
    ranked = sorted((i for i, ops in enumerate(loops)
                     if ops.get("FFMA", 0)),
                    key=lambda i: -loops[i]["FFMA"])
    if len(ranked) != 3:
        raise ValueError(f"{len(ranked)} loops with FFMAs in the block_fir "
                         f"listing, expected 3 (rows, passes, tail)")
    trips = [1.0] * len(loops)
    warps = plan["threads"] // 32
    trips[ranked[0]] = profile["rows"] / warps
    trips[ranked[1]] = plan["chunks"] // plan["kChunks"]
    trips[ranked[2]] = plan["chunks"] % plan["kChunks"]
    return trips


def block_fir(x_blocks: torch.Tensor, taps: torch.Tensor,
              tap_offsets: Sequence[int], block_size: int) -> torch.Tensor:
    """Convolve each row of ``x_blocks`` (R, block_size) with its own
    sparse kernel ``taps`` (R, T) at static ``tap_offsets``; returns
    (R, block_size + D - 1) complex64 on the inputs' device. The CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    offsets = _check(x_blocks, taps, tap_offsets, block_size)
    dev = x_blocks.device
    if dev.type == "cuda":
        return _launch(x_blocks, taps, offsets, block_size)
    if dev.type == "cpu":
        return block_fir_reference(x_blocks, taps, offsets, block_size)
    raise RuntimeError(f"no route for device {dev}")


block_fir.launch_count = 0
block_fir.reference_count = 0


def block_fir_reference(x_blocks: torch.Tensor, taps: torch.Tensor,
                        tap_offsets: Sequence[int],
                        block_size: int) -> torch.Tensor:
    """The plain PyTorch version: ``y[:, d_i : d_i + block_size] +=
    taps[:, i] * x`` for each tap, as ``fir_pallas._kernel`` does."""
    offsets = _check(x_blocks, taps, tap_offsets, block_size)
    block_fir.reference_count += 1
    x = x_blocks.to(torch.complex64)
    t = taps.to(torch.complex64)
    y = x.new_zeros((x.shape[0], block_size + offsets[-1]))
    for i, d in enumerate(offsets):
        y[:, d:d + block_size] += t[:, i:i + 1] * x
    return y


def block_fir_fft(x_blocks: torch.Tensor, taps: torch.Tensor,
                  tap_offsets: Sequence[int],
                  block_size: int) -> torch.Tensor:
    """The same convolution per block in the frequency domain: circular
    length ``L`` = block_size + D - 1 rounded up to a multiple of 128 (as
    the JAX package's route), kernel spectrum from the sparse taps."""
    offsets = _check(x_blocks, taps, tap_offsets, block_size)
    out_len = block_size + offsets[-1]
    L = ((out_len + 127) // 128) * 128
    X = torch.fft.fft(x_blocks.to(torch.complex64), n=L)
    H = taps.to(torch.complex64) @ sparse_dft(offsets, range(L), L,
                                              x_blocks.device)
    return torch.fft.ifft(X * H)[:, :out_len]


def _launch(x_blocks: torch.Tensor, taps: torch.Tensor,
            offsets: Tuple[int, ...], block_size: int) -> torch.Tensor:
    from . import _build
    if x_blocks.dtype != torch.complex64 or taps.dtype != torch.complex64:
        raise TypeError("the block_fir kernel takes complex64 tensors")
    x = x_blocks.contiguous()
    t = taps.contiguous()
    rows = x.shape[0]
    y = torch.empty((rows, block_size + offsets[-1]), dtype=torch.complex64,
                    device=x.device)
    rc = _build.load().block_fir(
        x.data_ptr(), t.data_ptr(), y.data_ptr(), rows, block_size,
        len(offsets), _host_offsets(offsets),
        _device_offsets(offsets, x.device).data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "block_fir")
    block_fir.launch_count += 1
    return y


@functools.lru_cache(maxsize=64)
def _host_offsets(offsets: Tuple[int, ...]) -> ctypes.c_void_p:
    """A host int array of the offsets, as the pointer the C function
    takes (the pointer keeps its array alive, the cache the pointer)."""
    return ctypes.cast((ctypes.c_int * len(offsets))(*offsets),
                       ctypes.c_void_p)


@functools.lru_cache(maxsize=64)
def _device_offsets(offsets: Tuple[int, ...],
                    device: torch.device) -> torch.Tensor:
    """The offsets as an int32 tensor on ``device``, which the segments and
    direct forms read (made once a tuple and device: a launch copies
    nothing)."""
    return torch.tensor(offsets, dtype=torch.int32, device=device)
