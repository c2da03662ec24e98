"""The port at shapes past the first forms of its two flagship-path kernels,
held against the JAX package on the same seeded numpy inputs.

* ``ops/mc_kernel.py`` ``MonteCarloOfdmTdl`` with the IEEE 802.11
  exponential-decay channel (taps every Ts = 50 ns, power proportional to
  exp(-k Ts / Trms) for k <= 10 Trms / Ts) at Trms = 250 ns: 51 taps, a span
  of 51 inside the flagship's CP of 52, under a Jakes generator of 32 rays
  (TL = 1,632). Its inject counts (the plain version on the CPU) against
  ``pyphysim_tpu/ops/mc_pallas.py`` ``build_inject`` under the Pallas
  interpreter, through ``from_jax_arrays`` and through the port's own
  constructor, in float32 and bf16, at the JAX test's slack (16 a cell, 32
  a call: decision-boundary flips from float association).
* ``prng_kernel_profile`` and ``kernel_plan`` at 51 taps (the general form,
  its taps padded to 56) beside the flagship's fast instance, read from a
  stand-in library whose plan is ``plan_mirror`` (``mc_ofdm_tdl.cu``
  ``make_plan`` in Python, held to the built library on the card), and
  ``launch_slices``: the launches of a call of 70,000 reps and of 70,000
  tiles (both the fast instance's).
* ``ops/fir.py`` ``block_fir`` (its plain version on the CPU) and
  ``TdlChannel.corrupt_data(..., block_size=...)`` at 81 taps / block 564
  (the same model at Trms = 400 ns), COST259-HT at Ts = 1/20 MHz with
  block 8,192 and at Ts = 1/100 MHz (a span past 1,800) with block 16,384,
  against ``pyphysim_tpu/ops/fir_pallas.py`` ``block_fir`` and the JAX
  channel: ``atol`` 1e-5 on O(1) values (the same float32 products summed
  in another order).
* ``block_fir.cu`` ``make_plan`` in Python (``fir_plan_mirror``, held to
  the built library on the card) at those shapes: the segments form's
  block-wide items and grid, dense where the offsets are consecutive; and
  the segments form's staging and window indexing replayed in numpy
  (``seg_replay``) against the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pyphysim_tpu.channels import fading as J_fading  # noqa: E402
from pyphysim_tpu.channels.fading_generators import \
    JakesSampleGenerator as J_Jakes  # noqa: E402
from pyphysim_tpu.channels.fading_generators import \
    JakesState as J_JakesState  # noqa: E402
from pyphysim_tpu.modulators import OFDM as J_OFDM  # noqa: E402
from pyphysim_tpu.ops.cplx import CArray  # noqa: E402
from pyphysim_tpu.ops.fir_pallas import block_fir as j_block_fir  # noqa: E402
from pyphysim_tpu.ops.mc_pallas import MonteCarloOfdmTdl as J_MC  # noqa: E402
from pyphysim_tpu_torch.channels import (JakesSampleGenerator,  # noqa: E402
                                         JakesState, TdlChannel, fading)
from pyphysim_tpu_torch.modulators import OFDM  # noqa: E402
from pyphysim_tpu_torch.ops import _build, fir  # noqa: E402
from pyphysim_tpu_torch.ops.mc_kernel import (_PLAN_KEYS,  # noqa: E402
                                              MonteCarloOfdmTdl,
                                              from_jax_arrays, launch_slices)

TS = 1.0 / 20e6
ATOL = 1e-5

# mc_ofdm_tdl.cu's constants, which plan_mirror copies
_ROWS = 64                    # symbols a block (kRows)
_MAX_THREADS = 512            # used bins a block (kMaxThreads)
_GEN_THREADS = 320            # used bins a block, general form (kGenThreads)
_MAX_TL = 1024                # (tap, ray) pairs of the fast instances (kMaxTL)
_CHUNK = 8                    # taps a chunk of G_tap, and their pad (kChunk)
_GROUP = 8                    # rows summed at once (kGroup)
_MAX_SMEM = 232448 - 1024     # a block's dynamic bytes (kMaxSmem)
_MAX_GRID = 1 << 24           # blocks launched (kMaxGrid)
_SCRATCH_BLOCKS_PER_SM = 4    # slots a SM past shared memory
_GRID_YZ = 65535
_INT_MAX = 2 ** 31 - 1


def plan_mirror(reps, num_tiles, tile, used, TL, taps, sms=132):
    """``mc_ofdm_tdl.cu`` ``make_plan`` in Python, keyed as
    ``MonteCarloOfdmTdl.kernel_plan``, of the first launch of a call
    (at most 65,535 reps and tiles of it): the fast instance while
    ``taps`` <= 32, ``TL`` <= 1,024 and the call's 32-bit indices hold;
    else the general form (at most 320 bins a block), its taps padded to
    a multiple of 8, its rows a block halved (down to 8) until h[row, tap]
    takes at most a quarter of the shared bytes, its slot in shared
    memory or, past it, in a scratch buffer with ``sms * 4`` blocks
    launched."""
    reps, tiles = min(reps, _GRID_YZ), min(num_tiles, _GRID_YZ)
    general = not (taps <= 32 and TL <= _MAX_TL and
                   reps * num_tiles <= _INT_MAX and
                   num_tiles * tile <= _INT_MAX)
    bin_chunks = -(-used // (_GEN_THREADS if general else _MAX_THREADS))
    per_chunk = -(-used // bin_chunks)
    threads = -(-per_chunk // 32) * 32
    rows = min(_ROWS, tile)
    plan = dict.fromkeys(_PLAN_KEYS, 0)
    plan.update(general=int(general), bin_chunks=bin_chunks, threads=threads,
                chunk_taps=_CHUNK, group_rows=_GROUP)
    if not general:
        plan.update(rows=rows, grid=(tile // rows) * bin_chunks)
        return plan
    tle = TL + (TL & 1)
    tp = -(-taps // _CHUNK) * _CHUNK
    h_stride = tp + 2
    while rows > _GROUP and 8 * h_stride * rows > _MAX_SMEM // 4:
        rows //= 2
    slot_floats = 2 * tle + 2 * h_stride * rows
    blocks = reps * tiles * (tile // rows) * bin_chunks
    plan.update(rows=rows, blocks=blocks, taps_padded=tp,
                slot_floats=slot_floats)
    if 4 * slot_floats <= _MAX_SMEM:
        plan.update(smem_bytes=4 * slot_floats, grid=min(blocks, _MAX_GRID))
    else:
        grid = min(blocks, sms * _SCRATCH_BLOCKS_PER_SM)
        plan.update(grid=grid, scratch_bytes=grid * 4 * slot_floats)
    return plan


class _MirrorLib:
    """A stand-in library whose ``mc_ofdm_tdl_plan`` is ``plan_mirror``."""

    def mc_ofdm_tdl_plan(self, reps, tiles, tile, used, TL, T, num_tiles,
                         out):
        assert (reps, tiles) == (min(reps, _GRID_YZ),
                                 min(num_tiles, _GRID_YZ))
        for i, v in enumerate(plan_mirror(reps, num_tiles, tile, used, TL,
                                          T).values()):
            out[i] = v
        return 0


@pytest.fixture
def mirror_lib(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda geo=None: _MirrorLib())


def exponential_profile(module, trms, ts=TS):
    """The IEEE 802.11 exponential-decay profile in ``module``'s
    ``TdlChannelProfile``: taps every ``ts``, power exp(-k ts / trms) for
    k <= 10 trms / ts."""
    k = np.arange(int(round(10 * trms / ts)) + 1)
    return module.TdlChannelProfile(10 * np.log10(np.exp(-k * ts / trms)),
                                    k * ts, f"exponential {trms * 1e9:g} ns")


def _port_mc(dtype, tile=8):
    jakes = JakesSampleGenerator(Fd=30.0, Ts=TS, L=32, device="cpu")
    channel = TdlChannel(jakes, exponential_profile(fading, 250e-9))
    return MonteCarloOfdmTdl(OFDM(512, 52, 300, device="cpu"), channel,
                             M=16, tile=tile, matmul_dtype=dtype,
                             device="cpu")


def _jax_mc(dtype, tile=8):
    channel = J_fading.TdlChannel(J_Jakes(Fd=30.0, Ts=TS, L=32),
                                  exponential_profile(J_fading, 250e-9))
    return J_MC(J_OFDM(512, 52, 300), channel, M=16, tile=tile,
                matmul_dtype=dtype)


def _bits(seed, mc, reps, num_tiles):
    rng = np.random.default_rng(seed)
    pb = rng.integers(0, 2 ** 32, (reps, 8, mc.TLp), dtype=np.uint32)
    shape = (reps, num_tiles * mc.tile, mc.used_p)
    return (pb,) + tuple(rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
                         for _ in range(3))


@pytest.mark.parametrize("dtype,jdtype", [
    (torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)])
def test_51_taps_32_rays_match_the_jax_kernel(dtype, jdtype):
    """The fault of the port's constructor (it refused more than 32 taps):
    51 taps of 32 rays build, and count the JAX kernel's errors on the
    same bits, through both ways into the port."""
    jmc = _jax_mc(jdtype)
    own = _port_mc(dtype)
    carried = from_jax_arrays({
        "g_re": np.asarray(jmc._g_re, np.float32),
        "g_im": np.asarray(jmc._g_im, np.float32), "C": jmc._C,
        "noise_gain": jmc.noise_gain, "M": jmc._M, "tile": jmc._tile,
        "used": jmc._used, "TL": jmc._TL,
        "matmul_dtype": str(jmc._matmul_dtype)}, device="cpu")
    assert (own.taps, own.rays, own.TL) == (carried.taps, carried.rays,
                                            carried.TL) == (51, 32, 1632)
    reps, num_tiles = 2, 2
    bits = _bits(51, own, reps, num_tiles)
    amp = np.float32(np.sqrt(0.5 / 10 ** 0.5) * jmc.noise_gain)
    want = np.asarray(jmc.build_inject(reps, num_tiles)(*bits, amp),
                      np.int64)
    assert int(want.sum()) > 500          # the comparison is not vacuous
    for mc in (own, carried):
        got = mc.build_inject(reps, num_tiles)(*bits, amp).numpy()
        assert abs(int(got.sum()) - int(want.sum())) <= 32
        assert np.all(np.abs(got.astype(np.int64) - want) <= 16)
    np.testing.assert_array_equal(
        own.build_inject(reps, num_tiles)(*bits, amp).numpy(),
        carried.build_inject(reps, num_tiles)(*bits, amp).numpy())


def test_profile_names_the_general_form_at_51_taps(mirror_lib):
    """51 taps go to the general form's shared-memory instance: one thread
    a used bin and block, and its six loops' trips (pairs, rays a tap,
    (row, tap) pairs, chunks of 8 taps, groups of 8 rows, the walk),
    counted over the 51 taps and not the 56 the form pads them to; the
    plan the library makes."""
    mc = _port_mc("bfloat16", tile=1024)
    assert mc.prng_kernel_profile(32, 4) == {
        "pattern": "mc_ofdm_tdl_general_kernelILb0ELb1ELb0EE",
        "threads": 32 * 4 * 16 * 300, "loops": 6,
        "loop_trips": [1632 / 300, 32, 51 * 64 / 300, 51 / 8, 8, 1]}
    plan = mc.kernel_plan(32, 4)
    assert plan["general"] == 1 and plan["rows"] == 64
    assert plan["taps_padded"] == 56 and plan["scratch_bytes"] == 0
    # the rates and phases of 1,632 pairs, then 64 rows of 58 complex taps
    assert plan["smem_bytes"] == 4 * (2 * 1632 + 2 * 58 * 64)
    assert plan["blocks"] == plan["grid"] == 32 * 4 * 16
    assert mc.g_tap_pairs.shape == (56, 300, 2)
    assert not mc.g_tap_pairs[51:].any()


def test_plan_keeps_the_fast_instances_and_takes_every_shape():
    """The flagship (16 taps of 16 rays) keeps its fast instance at the
    bench chunk, and at more than 65,535 reps or tiles (the call is cut
    into launches); the general form takes what the fast one cannot: more
    than 32 taps, more than 1,024 pairs; its taps are padded to a multiple
    of 8, h past a quarter of shared memory shrinks the rows (to 8), and a
    slot past shared memory goes to the scratch buffer, one a resident
    block."""
    flagship = plan_mirror(32, 4, 1024, 300, 256, 16)
    assert flagship["general"] == 0 and flagship["rows"] == 64
    assert flagship["grid"] == 16 and flagship["threads"] == 320
    assert plan_mirror(65535, 1, 8, 300, 256, 16)["general"] == 0
    assert plan_mirror(2, 65535, 8, 300, 256, 16)["general"] == 0
    assert plan_mirror(2, 65536, 8, 300, 256, 16)["general"] == 0
    assert plan_mirror(70000, 8, 8, 300, 256, 16)["general"] == 0
    # 65,535 reps of more than 32,768 tiles pass the 32-bit out index
    assert plan_mirror(65535, 40000, 8, 300, 256, 16)["general"] == 1
    assert plan_mirror(2, 1, 8, 300, 32 * 33, 32)["general"] == 1
    assert plan_mirror(2, 1, 8, 300, 33, 33)["general"] == 1
    for taps, padded in ((33, 40), (40, 40), (51, 56), (52, 56), (64, 64)):
        assert plan_mirror(2, 1, 64, 300, taps, taps)["taps_padded"] == \
            padded
    wide = plan_mirror(2, 4, 1024, 300, 2000, 2000)
    assert wide["general"] == 1 and wide["taps_padded"] == 2000
    assert wide["rows"] == 8 and wide["scratch_bytes"] == 0
    assert plan_mirror(2, 4, 64, 300, 400, 200)["rows"] == 32
    huge = plan_mirror(2, 4, 64, 128, 30000, 30000, sms=132)
    assert huge["rows"] == 8 and huge["smem_bytes"] == 0
    assert huge["grid"] == min(huge["blocks"], 132 * 4)
    assert huge["scratch_bytes"] == huge["grid"] * 4 * huge["slot_floats"]
    bins = plan_mirror(1, 1, 8, 1200, 16, 16)
    assert (bins["bin_chunks"], bins["threads"]) == (3, 416)
    gen_bins = plan_mirror(1, 1, 8, 1200, 1632, 51)
    assert (gen_bins["bin_chunks"], gen_bins["threads"]) == (4, 320)


def test_launch_slices_of_70000_reps_and_70000_tiles():
    """A call is cut into launches of at most 65,535 reps and 65,535 tiles,
    each writing its rows and tiles of ``out`` and reading those of the
    bits from attempt ``start + r0`` and tile ``t0``; 70,000 tiles of 16
    taps are two launches of the fast instance."""
    assert launch_slices(70000) == [(0, 65535), (65535, 70000)]
    assert launch_slices(65535) == [(0, 65535)]
    assert launch_slices(2) == [(0, 2)]
    out = torch.arange(70000 * 1).reshape(70000, 1)
    rows = torch.cat([out[r0:r1] for r0, r1 in launch_slices(70000)])
    assert torch.equal(rows, out)
    mc = _port_mc(torch.float32)
    launches = mc._launches(2, 70000)
    assert launches == [(0, 2, 0, 65535), (0, 2, 65535, 70000)]
    assert len(mc._launches(70000, 70000)) == 4
    tiles = torch.arange(2 * 70000).reshape(2, 70000)
    assert torch.equal(torch.cat([tiles[r0:r1, t0:t1]
                                  for r0, r1, t0, t1 in launches], dim=1),
                       tiles)
    plan = plan_mirror(2, 70000, 8, 300, 256, 16)
    assert plan["general"] == 0 and plan["grid"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("reps,num_tiles,taps,rays,tile", [
    (32, 4, 16, 16, 1024), (2, 70000, 16, 16, 8), (4, 2, 51, 32, 64),
    (2, 2, 2000, 1, 8), (2, 2, 16, 4000, 8), (65535, 1, 16, 16, 8),
    (32, 4, 51, 32, 1024), (2, 4, 200, 2, 64), (65535, 40000, 16, 16, 8)])
def test_plan_mirror_is_the_library_plan(reps, num_tiles, taps, rays, tile):
    """``plan_mirror`` (which the CPU tests above stand in for the library)
    equals the built library's ``mc_ofdm_tdl_plan`` on this card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import ctypes
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    _build.check(_build.load().mc_ofdm_tdl_plan(
        min(reps, _GRID_YZ), min(num_tiles, _GRID_YZ), tile, 300,
        taps * rays, taps, num_tiles, out), "mc_ofdm_tdl_plan")
    assert dict(zip(_PLAN_KEYS, out)) == plan_mirror(
        reps, num_tiles, tile, 300, taps * rays, taps, sms)


def test_plain_version_takes_a_first_tile():
    """The plain version's tiles ``first_tile`` onward equal the same
    tiles of a call from tile 0 (the last tiles of a call of many tiles are
    held to the kernel on the card this way)."""
    mc = _port_mc(torch.float32)
    whole = mc.prng_reference(2, 5, 7, mc.amp(10.0), start=3)
    tail = mc.prng_reference(2, 2, 7, mc.amp(10.0), start=3, first_tile=3)
    assert torch.equal(whole[:, 3:], tail)


def _c(rng, *shape):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * np.sqrt(0.5)).astype(np.complex64)


def _carray(a):
    return CArray(jnp.asarray(a.real), jnp.asarray(a.imag))


def _ht_offsets(ts):
    return [int(d) for d in
            fading.COST259_HTx.get_discretize_profile(ts).tap_delays]


@pytest.mark.parametrize("rows,block_size,offsets", [
    (6, 564, list(range(81))),               # 81 taps, span 81
    (2, 8192, _ht_offsets(TS)),              # HTx at 20 MHz, span 361
    (1, 16384, _ht_offsets(1 / 100e6)),      # HTx at 100 MHz, span 1,802
])
def test_block_fir_past_the_first_form_matches_jax(rows, block_size,
                                                   offsets):
    rng = np.random.default_rng(block_size + len(offsets))
    x = _c(rng, rows, block_size)
    taps = _c(rng, rows, len(offsets))
    want = j_block_fir(_carray(x), _carray(taps), offsets,
                       block_size).to_numpy()
    fir.block_fir.reference_count = 0
    got = fir.block_fir(torch.from_numpy(x), torch.from_numpy(taps),
                        offsets, block_size)
    assert fir.block_fir.reference_count == 1
    assert got.shape == (rows, block_size + offsets[-1])
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_ht_spans():
    """The shapes named above: HTx's span at 20 and 100 MHz."""
    assert _ht_offsets(TS)[-1] + 1 == 361
    assert _ht_offsets(1 / 100e6)[-1] + 1 > 1800


@pytest.mark.parametrize("profile,ts,block_size,num_blocks", [
    ("exponential", TS, 564, 3),       # 81 taps
    ("ht", TS, 8192, 2),
    ("ht", 1 / 100e6, 16384, 1),
])
def test_corrupt_data_block_static_matches_jax(profile, ts, block_size,
                                               num_blocks):
    """``TdlChannel.corrupt_data(state, signal, block_size=...)`` (SISO,
    the block_fir route) against the JAX channel on one Jakes state and
    signal, carried across as numpy."""
    rng = np.random.default_rng(block_size)
    if profile == "ht":
        j_prof, prof = J_fading.COST259_HTx, fading.COST259_HTx
    else:
        j_prof = exponential_profile(J_fading, 400e-9, ts)
        prof = exponential_profile(fading, 400e-9, ts)
    rays = 16
    jch = J_fading.TdlChannel(J_Jakes(Fd=30.0, Ts=ts, L=rays), j_prof)
    ch = TdlChannel(JakesSampleGenerator(Fd=30.0, Ts=ts, L=rays,
                                         device="cpu"), prof)
    shape = (rays, ch.num_taps, 1)
    phi = rng.uniform(0, 2 * np.pi, shape).astype(np.float32)
    psi = rng.uniform(0, 2 * np.pi, shape).astype(np.float32)
    jstate = J_JakesState(jnp.asarray(phi), jnp.asarray(psi),
                          jnp.asarray(np.float32(1e-3)))
    state = JakesState.from_numpy(phi, psi, 1e-3, device="cpu")
    x = _c(rng, num_blocks * block_size)
    j_out = jch.corrupt_data(jstate, _carray(x), block_size=block_size)[0]
    fir.block_fir.reference_count = 0
    out = ch.corrupt_data(state, torch.from_numpy(x),
                          block_size=block_size)[0]
    assert fir.block_fir.reference_count == 1
    assert out.shape == (num_blocks * block_size + ch.num_taps_with_padding
                         - 1,)
    np.testing.assert_allclose(out.numpy(), j_out.to_numpy(), atol=ATOL,
                               rtol=0)


# block_fir.cu's constants, which fir_plan_mirror copies
_FIR_SMEM = 232448            # dynamic shared memory a block (kMaxSmem)
_SM_SMEM, _SMEM_RESERVED = 233472, 1024   # a SM's, and a block's reserve
_FIR_MAX_TAPS, _FIR_WARPS, _FIR_STAGES = 64, 4, 2
_FIR_ROWS_PER_WARP, _FIR_CHUNKS = 8, 4
_SEG_WARPS, _SEG_STAGES, _SEG_BLOCKS_PER_SM, _SEG_MAX_ROWS = 8, 2, 2, 16
_SEG_CHUNKS, _DENSE_OUT = 16, 7
_DIRECT_THREADS, _DIRECT_GRID = 256, 1 << 20


def balanced_segment(out_len, unit, most):
    """``block_fir.cu`` ``balanced_segment``: of the fewest parts up to 3
    more, each rounded up to a multiple of 8 units (a block's warps) where
    that fits, else of one unit, the segment whose units take the fewest
    rounds of the warps (then the fewest segments)."""
    fewest = -(-out_len // most)
    best = None
    for parts in range(fewest, fewest + 4):
        for grain in (unit * _SEG_WARPS, unit):
            seg = -(-(-(-out_len // parts)) // grain) * grain
            if seg > most:
                continue
            n = -(-out_len // seg)
            rounds = sum(-(-(-(-min(seg, out_len - i * seg) // unit)) //
                           _SEG_WARPS) for i in range(n))
            if best is None or (rounds, n) < best[1:]:
                best = (seg, rounds, n)
    return best[0]


def fir_plan_mirror(rows, block_size, offsets, sms=132):
    """``block_fir.cu`` ``make_plan`` in Python, keyed as ``fir.kernel_plan``
    (before its names for the form and flags): the rows form where T <= 64
    and four warps of two row buffers fit; else the segments form, dense
    where the offsets are consecutive, its items of whole rows (at most
    16) or of one row's segment, two stages sized for two blocks a SM
    (each less the 1 KB the card keeps a resident block),
    else for one, else one stage, and a grid of that many blocks a SM;
    else the direct form."""
    T, first, last = len(offsets), offsets[0], offsets[-1]
    out_len = block_size + last
    chunks = -(-out_len // 32)
    tap_slots = (T + 1) & ~1
    row0 = tap_slots + ((last + 1) & ~1)
    stage = row0 + 32 * chunks
    plan = dict.fromkeys(fir._PLAN_KEYS, 0)
    plan.update(chunks=chunks, out_len=out_len)
    if T <= _FIR_MAX_TAPS and \
            8 * stage * _FIR_STAGES * _FIR_WARPS <= _FIR_SMEM:
        bound = 16 if T <= 16 else 32 if T <= 32 else 64
        per_block = _FIR_WARPS * _FIR_ROWS_PER_WARP
        plan.update(rows_per_warp=_FIR_ROWS_PER_WARP, kChunks=_FIR_CHUNKS,
                    tap_bound=bound, full=int(T == bound),
                    stages=_FIR_STAGES, warps=_FIR_WARPS, row0=row0,
                    stage_elements=stage,
                    smem_bytes=8 * _FIR_WARPS * _FIR_STAGES * stage,
                    blocks=-(-rows // per_block))
        return plan
    dense = last - first == T - 1
    unit = 32 * (_DENSE_OUT if dense else _SEG_CHUNKS)
    offs_bytes = 0 if dense else (4 * T + 15) // 16 * 16
    whole = -(-out_len // unit) * unit
    pad = last & 1 if block_size % 2 == 0 else 0
    fixed = tap_slots + pad + last
    for stages, per_sm in ((_SEG_STAGES, _SEG_BLOCKS_PER_SM),
                           (_SEG_STAGES, 1), (1, 1)):
        budget = min(_FIR_SMEM, _SM_SMEM // per_sm - _SMEM_RESERVED)
        room = (budget - offs_bytes) // (8 * stages)
        if fixed + whole <= room:
            segment = whole
            nrows = min(room // (fixed + whole), _SEG_MAX_ROWS, max(rows, 1))
            break
        if room - fixed >= unit:
            segment = balanced_segment(out_len, unit,
                                       (room - fixed) // unit * unit)
            nrows = 1
            break
    else:
        plan.update(form=2, warps=_DIRECT_THREADS // 32,
                    blocks=min(-(-rows * out_len // _DIRECT_THREADS),
                               _DIRECT_GRID), row0=row0,
                    stage_elements=stage)
        return plan
    segments = -(-out_len // segment)
    items = -(-rows // nrows) * segments
    row_stride = fixed + segment
    plan.update(form=1, stages=stages, warps=_SEG_WARPS, row0=fixed,
                stage_elements=nrows * row_stride,
                smem_bytes=offs_bytes + 8 * stages * nrows * row_stride,
                blocks=min(items, sms * per_sm), segment=segment,
                segments=segments, rows_per_item=nrows, unit=unit,
                dense=int(dense), items=items)
    return plan


def seg_replay(x, taps, offsets, plan):
    """The segments form's data flow in numpy (complex128): each item
    staged as ``load_item`` stages it (a row's taps, then its window from
    ``halo`` samples before the segment, zeros outside the row), every
    output of its units summed from the stage at the positions the kernel
    reads (``seg_dense_unit``: tap_slots + halo + o - d_0 - i;
    ``seg_sparse_unit``: tap_slots + halo + o - d_i, both after the
    window's pad), each position checked to lie in the row's slot, and
    stored where the kernel stores."""
    rows, block_size = x.shape
    T = len(offsets)
    d = np.asarray(offsets)
    tap_slots = (T + 1) & ~1
    halo = offsets[-1]
    pad = halo & 1 if block_size % 2 == 0 else 0
    S, R, unit = plan["segment"], plan["rows_per_item"], plan["unit"]
    stride = tap_slots + pad + halo + S
    assert plan["stage_elements"] == R * stride
    out_len = plan["out_len"]
    y = np.full((rows, out_len), np.nan, np.complex128)
    # a warp's unit: lane l, output j of it -> the unit's output
    if plan["dense"]:
        lanes = [l * _DENSE_OUT + j for l in range(32)
                 for j in range(_DENSE_OUT)]
    else:
        lanes = [32 * j + l for l in range(32) for j in range(_SEG_CHUNKS)]
    assert sorted(lanes) == list(range(unit))
    for item in range(plan["items"]):
        group, seg = divmod(item, plan["segments"])
        m0, row0 = seg * S, group * R
        lo = m0 - halo - pad - tap_slots
        out_left = min(out_len - m0, S)
        for r in range(min(R, rows - row0)):
            slot = np.zeros(stride, np.complex128)
            slot[:T] = taps[row0 + r]
            src = lo + np.arange(tap_slots, stride)
            on = (src >= 0) & (src < block_size)
            slot[tap_slots:][on] = x[row0 + r, src[on]]
            o = np.arange(S)
            pos = tap_slots + pad + halo + o[:, None] - d[None, :]
            assert pos.min() >= tap_slots and pos.max() < stride
            acc = (slot[pos] * slot[:T][None, :]).sum(1)
            keep = o < out_left
            y[row0 + r, m0 + o[keep]] = acc[keep]
    return y


def _fir_case(rows, block_size, offsets, seed=0):
    rng = np.random.default_rng(seed + block_size)
    return (_c(rng, rows, block_size), _c(rng, rows, len(offsets)))


def test_fir_plan_at_b1_and_b2():
    """The segments form's block-wide items and grid at the shapes it was
    redesigned for: B1 (81 consecutive taps over 8,192 rows of 564: dense,
    8 whole rows an item, 7 adjacent outputs a lane), COST259-HT at 20 MHz
    (1,024 rows of 8,192: two segments a row, sparse, 16 outputs a lane 32
    apart) and at 100 MHz (256 rows of 16,384, span 1,803: five
    segments); two stages a block, two blocks a SM, a grid of 264 blocks
    walking the items."""
    b1 = fir_plan_mirror(8192, 564, list(range(81)))
    assert (b1["form"], b1["dense"], b1["unit"]) == (1, 1, 224)
    assert (b1["rows_per_item"], b1["segment"], b1["segments"]) == \
        (8, 672, 1)
    assert (b1["items"], b1["blocks"], b1["stages"], b1["warps"]) == \
        (1024, 264, 2, 8)
    assert b1["smem_bytes"] == 2 * 8 * (82 + 80 + 672) * 8 <= \
        _SM_SMEM // 2 - _SMEM_RESERVED
    ht20 = fir_plan_mirror(1024, 8192, _ht_offsets(TS))
    assert (ht20["form"], ht20["dense"], ht20["unit"]) == (1, 0, 512)
    # 4,608 outputs (9 units of 512) and 3,944 (8 units): 3 rounds of 8
    # warps a row, as 3 segments of 4,096, 4,096 and 360 would take
    assert (ht20["rows_per_item"], ht20["segment"], ht20["segments"]) == \
        (1, 4608, 2)
    assert (ht20["items"], ht20["blocks"]) == (2048, 264)
    ht100 = fir_plan_mirror(256, 16384, _ht_offsets(1 / 100e6))
    assert (ht100["form"], ht100["dense"], ht100["rows_per_item"]) == \
        (1, 0, 1)
    # 4 x 4,096 (8 units of 512 each) and 1,802: 5 rounds of 8 warps a
    # row, where the fewest segments (4 x 4,608: 9 units) take 8
    assert (ht100["segment"], ht100["segments"]) == (4096, 5)
    assert (ht100["items"], ht100["blocks"]) == (1280, 264)
    assert ht100["smem_bytes"] <= _SM_SMEM // 2 - _SMEM_RESERVED
    # the flagship's rows form is untouched
    flagship = fir_plan_mirror(8192, 564, [int(d) for d in
                                           fading.COST259_TUx
                                           .get_discretize_profile(TS)
                                           .tap_delays])
    assert (flagship["form"], flagship["blocks"], flagship["tap_bound"]) \
        == (0, 256, 16)


def test_fir_plan_leaves_each_block_its_reserve():
    """Two blocks a SM fit only where each block's shared bytes and the
    1 KB the card keeps for it fit half a SM: a whole row of 6,000 samples
    under a span of 601 would take 116,144 bytes a block (past the 115,712
    left to each of two, within half a SM), so the row is cut into two
    segments; the stages of every shape the form is timed at fit."""
    edge = fir_plan_mirror(4, 6000, [0, 600])
    assert (edge["form"], edge["stages"], edge["segments"]) == (1, 2, 2)
    whole_row = 16 + 2 * 8 * (2 + 600 + 6656)
    assert whole_row == 116144
    assert edge["smem_bytes"] < _SM_SMEM // 2 - _SMEM_RESERVED < whole_row
    for rows, block_size, offsets in [
            (8192, 564, list(range(81))), (1024, 8192, _ht_offsets(TS)),
            (256, 16384, _ht_offsets(1 / 100e6)), (4, 6000, [0, 600])]:
        plan = fir_plan_mirror(rows, block_size, offsets)
        assert 2 * (plan["smem_bytes"] + _SMEM_RESERVED) <= _SM_SMEM


@pytest.mark.parametrize("rows,block_size,offsets,form,stages,dense", [
    (20, 564, list(range(81)), 1, 2, 1),          # B1's kind: dense rows
    (3, 8192, _ht_offsets(TS), 1, 2, 0),          # HT 20 MHz
    (1, 16384, _ht_offsets(1 / 100e6), 1, 2, 0),  # HT 100 MHz
    (10, 6144, [0, 5000], 1, 2, 0),               # a long span: segments
    (10, 6144, [0, 20000], 1, 1, 0),              # one stage a block
    (10, 64, list(range(65)), 1, 2, 1),           # more than 64 taps
    (10, 6145, [0, 1], 1, 2, 1),                  # a block past 6,144
    (33, 300, [0, 3, 70, 71, 72, 150], 1, 2, 0),  # ragged row groups
    (5, 20000, [0, 3, 1501], 1, 2, 0),            # odd halo: a pad slot
    (5, 20001, [0, 3, 1500], 1, 2, 0),            # odd block: 8-byte copies
    (4, 6000, [0, 600], 1, 2, 0),                 # a block's reserve: 2 parts
])
def test_seg_replay_matches_the_plain_version(rows, block_size, offsets,
                                              form, stages, dense):
    """The segments form's staging and reads, replayed in numpy from the
    mirrored plan, give the plain version's outputs at every position of
    every row (each read inside its row's slot)."""
    plan = fir_plan_mirror(rows, block_size, offsets)
    if offsets == [0, 3, 70, 71, 72, 150]:
        # force the segments form at a shape the rows form takes
        plan = fir_plan_mirror(rows, block_size, offsets + [7000])
        offsets = offsets + [7000]
    assert (plan["form"], plan["stages"], plan["dense"]) == \
        (form, stages, dense)
    x, taps = _fir_case(rows, block_size, offsets)
    got = seg_replay(x, taps, offsets, plan)
    # the plain version's sums, in complex128
    want = np.zeros((rows, block_size + offsets[-1]), np.complex128)
    for i, d in enumerate(offsets):
        want[:, d:d + block_size] += taps[:, i:i + 1].astype(
            np.complex128) * x
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_fir_plan_takes_the_direct_form_past_one_unit():
    """A span whose one unit of outputs and halo do not fit 227 KB in one
    stage runs the direct form; one that fits runs the segments form."""
    assert fir_plan_mirror(3, 100, [0, 40000])["form"] == 2
    assert fir_plan_mirror(3, 100, [0, 28000])["form"] == 1
    assert fir_plan_mirror(3, 100, list(range(0, 28000, 7)))["form"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("rows,block_size,offsets", [
    (8192, 564, list(range(81))), (1024, 8192, _ht_offsets(TS)),
    (256, 16384, _ht_offsets(1 / 100e6)), (8192, 564, list(range(16))),
    (10, 6144, [0, 20000]), (3, 100, [0, 40000]), (10, 64, list(range(65))),
    (33, 300, [0, 3, 70, 71, 72, 150, 7000]), (4, 6000, [0, 600])])
def test_fir_plan_mirror_is_the_library_plan(rows, block_size, offsets):
    """``fir_plan_mirror`` equals the built library's ``block_fir_plan``
    on this card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    got = fir.kernel_plan(rows, block_size, tuple(offsets))
    want = fir_plan_mirror(rows, block_size, offsets, sms)
    want.update(full=bool(want["full"]), dense=bool(want["dense"]),
                form=fir._FORMS[want["form"]],
                threads=want["blocks"] * want["warps"] * 32)
    assert got == want
