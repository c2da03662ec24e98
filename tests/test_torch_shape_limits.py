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
* ``prng_kernel_profile`` and ``kernel_plan`` at 51 taps (the general form)
  beside the flagship's fast instance, read from a stand-in library whose
  plan is ``plan_mirror`` (``mc_ofdm_tdl.cu`` ``make_plan`` in Python, held
  to the built library on the card), and ``launch_slices``: the launches
  of a call of 70,000 reps and of 70,000 tiles.
* ``ops/fir.py`` ``block_fir`` (its plain version on the CPU) and
  ``TdlChannel.corrupt_data(..., block_size=...)`` at 81 taps / block 564
  (the same model at Trms = 400 ns), COST259-HT at Ts = 1/20 MHz with
  block 8,192 and at Ts = 1/100 MHz (a span past 1,800) with block 16,384,
  against ``pyphysim_tpu/ops/fir_pallas.py`` ``block_fir`` and the JAX
  channel: ``atol`` 1e-5 on O(1) values (the same float32 products summed
  in another order).
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
_MAX_TL = 1024                # (tap, ray) pairs of the fast instances (kMaxTL)
_CHUNK = 32                   # taps of G_tap held at once (kChunk)
_GROUP = 4                    # rows summed at once (kGroup)
_MAX_SMEM = 232448 - 1024     # a block's dynamic bytes (kMaxSmem)
_MAX_GRID = 1 << 24           # blocks launched (kMaxGrid)
_SCRATCH_BLOCKS_PER_SM = 4    # slots a SM past shared memory
_GRID_YZ = 65535
_INT_MAX = 2 ** 31 - 1


def plan_mirror(reps, num_tiles, tile, used, TL, taps, sms=132):
    """``mc_ofdm_tdl.cu`` ``make_plan`` in Python, keyed as
    ``MonteCarloOfdmTdl.kernel_plan``: the fast instance while ``taps`` <=
    32, ``TL`` <= 1,024 and the (rep, tile) grid fits 65,535 a dimension
    and 32-bit indices; else the general form, its rows a block halved
    (down to 4) until h[row, tap] takes at most half of the shared bytes,
    its slot in shared memory or, past it, in a scratch buffer with ``sms
    * 4`` blocks launched."""
    bin_chunks = -(-used // _MAX_THREADS)
    per_chunk = -(-used // bin_chunks)
    threads = -(-per_chunk // 32) * 32
    rows = min(_ROWS, tile)
    general = not (taps <= 32 and TL <= _MAX_TL and reps <= _GRID_YZ and
                   num_tiles <= _GRID_YZ and reps * num_tiles <= _INT_MAX
                   and num_tiles * tile <= _INT_MAX)
    plan = dict.fromkeys(_PLAN_KEYS, 0)
    plan.update(general=int(general), bin_chunks=bin_chunks, threads=threads,
                chunk_taps=_CHUNK, group_rows=_GROUP)
    if not general:
        plan.update(rows=rows, grid=(tile // rows) * bin_chunks)
        return plan
    tle = TL + (TL & 1)
    tp = -(-taps // _CHUNK) * _CHUNK
    h_stride = tp + 2
    while rows > _GROUP and 8 * h_stride * rows > _MAX_SMEM // 2:
        rows //= 2
    slot_floats = 2 * tle + 2 * h_stride * rows
    blocks = reps * num_tiles * (tile // rows) * bin_chunks
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

    def mc_ofdm_tdl_plan(self, reps, num_tiles, tile, used, TL, T, out):
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
    """51 taps go to the general form: its instance, one thread a used bin
    and block, and its six loops' trips (pairs, rays a tap, (row, tap)
    pairs, chunks of 32 taps, groups of 4 rows, the walk), counted over
    the 51 taps and not the 64 the form pads them to; the plan the
    library makes."""
    mc = _port_mc("bfloat16", tile=1024)
    assert mc.prng_kernel_profile(32, 4) == {
        "pattern": "mc_ofdm_tdl_general_kernelILb0ELb1EE",
        "threads": 32 * 4 * 16 * 300, "loops": 6,
        "loop_trips": [1632 / 300, 32, 51 * 64 / 300, 51 / 32, 16, 1]}
    plan = mc.kernel_plan(32, 4)
    assert plan["general"] == 1 and plan["rows"] == 64
    assert plan["taps_padded"] == 64 and plan["scratch_bytes"] == 0
    # the rates and phases of 1,632 pairs, then 64 rows of 66 complex taps
    assert plan["smem_bytes"] == 4 * (2 * 1632 + 2 * 66 * 64)
    assert plan["blocks"] == plan["grid"] == 32 * 4 * 16


def test_plan_keeps_the_fast_instances_and_takes_every_shape():
    """The flagship (16 taps of 16 rays) keeps its fast instance at the
    bench chunk; the general form takes what the fast one cannot: more
    than 32 taps, more than 1,024 pairs, more than 65,535 tiles; h past
    half of shared memory shrinks the rows, and a slot past shared memory
    goes to the scratch buffer, one a resident block."""
    flagship = plan_mirror(32, 4, 1024, 300, 256, 16)
    assert flagship["general"] == 0 and flagship["rows"] == 64
    assert flagship["grid"] == 16 and flagship["threads"] == 320
    assert plan_mirror(65535, 1, 8, 300, 256, 16)["general"] == 0
    assert plan_mirror(2, 65535, 8, 300, 256, 16)["general"] == 0
    assert plan_mirror(2, 65536, 8, 300, 256, 16)["general"] == 1
    assert plan_mirror(2, 1, 8, 300, 32 * 33, 32)["general"] == 1
    assert plan_mirror(2, 1, 8, 300, 33, 33)["general"] == 1
    wide = plan_mirror(2, 4, 1024, 300, 2000, 2000)
    assert wide["general"] == 1 and wide["taps_padded"] == 2016
    assert wide["rows"] == 4 and wide["scratch_bytes"] == 0
    huge = plan_mirror(2, 4, 64, 128, 30000, 30000, sms=132)
    assert huge["rows"] == 4 and huge["smem_bytes"] == 0
    assert huge["grid"] == min(huge["blocks"], 132 * 4)
    assert huge["scratch_bytes"] == huge["grid"] * 4 * huge["slot_floats"]
    bins = plan_mirror(1, 1, 8, 1200, 16, 16)
    assert (bins["bin_chunks"], bins["threads"]) == (3, 416)


def test_launch_slices_of_70000_reps_and_70000_tiles():
    """A call is cut into launches of at most 65,535 reps, each writing
    its rows of ``out`` and reading its rows of the bits from attempt
    ``start + r0``; 70,000 tiles are one launch (the general form folds
    them into its grid)."""
    assert launch_slices(70000) == [(0, 65535), (65535, 70000)]
    assert launch_slices(65535) == [(0, 65535)]
    assert launch_slices(2) == [(0, 2)]
    out = torch.arange(70000 * 1).reshape(70000, 1)
    rows = torch.cat([out[r0:r1] for r0, r1 in launch_slices(70000)])
    assert torch.equal(rows, out)
    assert plan_mirror(2, 70000, 8, 300, 256, 16)["blocks"] == 2 * 70000


@pytest.mark.cuda
@pytest.mark.parametrize("reps,num_tiles,taps,rays,tile", [
    (32, 4, 16, 16, 1024), (2, 70000, 16, 16, 8), (4, 2, 51, 32, 64),
    (2, 2, 2000, 1, 8), (2, 2, 16, 4000, 8), (65535, 1, 16, 16, 8)])
def test_plan_mirror_is_the_library_plan(reps, num_tiles, taps, rays, tile):
    """``plan_mirror`` (which the CPU tests above stand in for the library)
    equals the built library's ``mc_ofdm_tdl_plan`` on this card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import ctypes
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    _build.check(_build.load().mc_ofdm_tdl_plan(
        reps, num_tiles, tile, 300, taps * rays, taps, out),
        "mc_ofdm_tdl_plan")
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
