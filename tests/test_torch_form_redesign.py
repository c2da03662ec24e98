"""On the card (``cuda`` marker; every test skips without one): the
flagship kernel's general form and ``block_fir``'s segments form as
redesigned for the H100, held to their plain versions and to the forms
they share shapes with.

* ``ops/csrc/mc_ofdm_tdl.cu`` ``mc_ofdm_tdl_general_kernel`` at 33, 40, 51,
  52 and 64 taps (padded to 40, 40, 56, 56, 64), inject and PRNG mode,
  against ``simulate_block_reference`` at 2e-4 of a cell's bits (the JAX
  test's 16 in 76,800: decision flips from float association); at 16 and
  32 taps, where the fast instances run, a library built with the fast
  instances switched off (the committed source with one line changed, as
  ``bin/_tune.py`` builds the tuners' variants) gives the fast instances'
  counts bit for bit (the same sums in the same order); a call of more
  than 65,535 tiles (two launches of the fast instance, or of the general
  form) gives a call of 65,535 tiles' counts bit for bit on those tiles,
  and its last tiles are held to the plain version.
* ``ops/csrc/block_fir.cu`` ``block_fir_seg_kernel`` at B1 (81 consecutive
  taps over 8,192 rows of 564) and at COST259-HT's blocks of 8,192 (20
  MHz) and 16,384 (100 MHz), against ``block_fir_reference`` within 1e-5
  of max |y| (float32 products summed in another order); the rows form and
  the segments form (a library with the rows form switched off) bit for
  bit where a shape fits both, at sparse and at consecutive offsets.

This file imports no JAX: the card's tests compare with the plain PyTorch
versions.
"""

import ctypes
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyphysim_tpu_torch.channels import (COST259_HTx,  # noqa: E402
                                         COST259_TUx, JakesSampleGenerator,
                                         TdlChannel)
from pyphysim_tpu_torch.modulators import OFDM  # noqa: E402
from pyphysim_tpu_torch.ops import _build, fir  # noqa: E402
from pyphysim_tpu_torch.ops.mc_kernel import MonteCarloOfdmTdl  # noqa: E402

TS = 1.0 / 20e6
FIR_TOL = 1e-5


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _variant(source, old, new, kernel):
    """A library of ``ops/csrc/<source>`` with ``old`` replaced by ``new``
    (``bin/_tune.py``), built on first use."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bin"))
    import _tune
    text = _tune.substitute(source, (_build.SRC_DIR / source).read_text(),
                            [(old, new)])
    (lib, _), = _tune.build_variants({source: (text, _build.SRC_DIR)},
                                     f"test_{source.split('.')[0]}",
                                     kernel).values()
    return lib


@pytest.fixture(scope="module")
def general_only(card):
    """The flagship kernel's library with the fast instances off."""
    lib = _variant("mc_ofdm_tdl.cu", "  pl->general = !(T <= 32",
                   "  pl->general = 1 || !(T <= 32",
                   "mc_ofdm_tdl_general_kernel")
    import _tune
    return {name: _tune.function(lib, name)
            for name in ("mc_ofdm_tdl_prng", "mc_ofdm_tdl_plan")}


@pytest.fixture(scope="module")
def segments_only(card):
    """``block_fir``'s library with the rows form off."""
    lib = _variant("block_fir.cu", "  if (num_taps <= kMaxTaps &&",
                   "  if (false && num_taps <= kMaxTaps &&",
                   "block_fir_seg_kernel")
    import _tune
    return {name: _tune.function(lib, name)
            for name in ("block_fir", "block_fir_plan")}


def _synthetic_mc(taps, rays, device, tile=64, seed=0):
    """``taps`` taps of ``rays`` rays over the flagship's 300 bins: G's rows
    random and repeated over a tap's rays, the flagship's Doppler
    coefficient, unit noise gain."""
    rng = np.random.default_rng(seed + taps)
    g = rng.standard_normal((2, taps, 1, 300)) * np.sqrt(1.0 / taps)
    g = np.repeat(g, rays, axis=2).reshape(2, taps * rays, 300)
    flagship = MonteCarloOfdmTdl(
        OFDM(512, 52, 300, device="cpu"),
        TdlChannel(JakesSampleGenerator(Fd=30.0, Ts=TS, L=16, device="cpu"),
                   COST259_TUx), M=16, tile=tile, device="cpu")
    mc = MonteCarloOfdmTdl.__new__(MonteCarloOfdmTdl)
    mc._set_state(g[0].astype(np.float32), g[1].astype(np.float32),
                  flagship.C, 1.0, 16, tile, 300, rays, torch.float32,
                  device)
    return mc


def _bits(mc, reps, num_tiles, device, seed=9):
    rng = np.random.default_rng(seed)
    pb = rng.integers(0, 2 ** 32, (reps, 8, mc.TLp), dtype=np.uint32)
    shape = (reps, num_tiles * mc.tile, mc.used_p)
    return [torch.from_numpy(b.view(np.int32)).to(device)
            for b in (pb, *(rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
                            for _ in range(3)))]


@pytest.mark.cuda
@pytest.mark.parametrize("taps,padded", [(33, 40), (40, 40), (51, 56),
                                         (52, 56), (64, 64)])
def test_general_form_against_the_plain_version(card, taps, padded):
    mc = _synthetic_mc(taps, 8, card)
    plan = mc.kernel_plan(2, 3)
    assert plan["general"] == 1 and plan["taps_padded"] == padded
    assert mc.g_tap_pairs.shape[0] == padded
    cell_bits = mc.tile * mc.used * mc.bits_per_symbol
    amp = mc.amp(10 ** 1.5)
    bits = _bits(mc, 2, 3, card)
    got = mc.build_inject(2, 3)(*bits, amp)
    want = mc.simulate_block_reference(*bits, amp)
    assert int(want.sum()) > 0
    assert (got - want).abs().max().item() <= 2e-4 * cell_bits
    got = mc.build(2, 3)(5, 10 ** 1.5, 0)
    want = mc.prng_reference(2, 3, 5, amp, 0)
    assert (got - want).abs().max().item() <= 2e-4 * cell_bits


@pytest.mark.cuda
@pytest.mark.parametrize("taps,rays", [(16, 16), (32, 8), (24, 4)])
def test_general_form_gives_the_fast_counts(card, general_only, taps,
                                            rays):
    """Where both forms take a shape, the general form (a library whose
    plan never picks the fast instances) counts what the fast instance
    counts, bit for bit."""
    mc = _synthetic_mc(taps, rays, card)
    reps, tiles = 3, 2
    assert mc.kernel_plan(reps, tiles)["general"] == 0
    plan = (ctypes.c_longlong * 13)()
    assert general_only["mc_ofdm_tdl_plan"](reps, tiles, mc.tile, mc.used,
                                            mc.TL, mc.taps, tiles,
                                            plan) == 0
    assert plan[0] == 1
    seed, snr = 77, 10 ** 1.5
    fast = mc.build(reps, tiles)(seed, snr, 4)
    out = torch.zeros((reps, tiles), dtype=torch.int32, device=card)
    g_re, g_im, o, *geom = mc._common_args(out, reps, tiles, mc.amp(snr))
    _build.check(general_only["mc_ofdm_tdl_prng"](
        g_re, g_im, o, *geom, seed, 4, 0, tiles, None,
        torch.cuda.current_stream().cuda_stream), "general only")
    torch.cuda.synchronize()
    assert int(fast.sum()) > 0
    assert torch.equal(out, fast)


@pytest.mark.cuda
@pytest.mark.parametrize("taps,rays", [(16, 16), (40, 2)])
def test_tiles_past_65535(card, taps, rays):
    """65,540 tiles of 8 symbols in one call: two launches (tiles [0,
    65,535) and [65,535, 65,540)), the first equal to a call of 65,535
    tiles bit for bit, the last tiles held to the plain version."""
    mc = _synthetic_mc(taps, rays, card, tile=8)
    seed, snr = 13, 10 ** 1.5
    mc.launch_count = 0
    wide = mc.build(2, 65540)(seed, snr, 0)
    assert mc.launch_count == 2
    fast = mc.build(2, 65535)(seed, snr, 0)
    torch.cuda.synchronize()
    assert torch.equal(wide[:, :65535], fast)
    cell_bits = mc.tile * mc.used * mc.bits_per_symbol
    want = mc.prng_reference(2, 5, seed, mc.amp(snr), 0, first_tile=65535)
    assert (wide[:, 65535:] - want).abs().max().item() <= 2e-4 * cell_bits


def _fir_rows(rows, block_size, offsets, device, seed=3):
    g = torch.Generator(device=device).manual_seed(seed + block_size)
    x = torch.randn(rows, block_size, dtype=torch.complex64, device=device,
                    generator=g)
    taps = torch.randn(rows, len(offsets), dtype=torch.complex64,
                       device=device, generator=g)
    return x, taps


def _ht(mhz):
    return [int(d) for d in COST259_HTx.get_discretize_profile(
        1 / (mhz * 1e6)).tap_delays]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,block_size,offsets,dense", [
    (8192, 564, list(range(81)), True),
    (1024, 8192, "ht20", False),
    (256, 16384, "ht100", False),
    (7, 564, list(range(3, 84)), True),          # ragged rows, d_0 > 0
    (10, 6144, [0, 5000], False),
    (10, 6144, [0, 20000], False),
    (10, 64, list(range(65)), True),
    (10, 6145, [0, 1], True),
    (5, 20000, [0, 3, 1501], False),             # odd halo: a pad slot
    (5, 20001, [0, 3, 1500], False)])            # odd block: 8-byte copies
def test_segments_form_against_the_plain_version(card, rows, block_size,
                                                 offsets, dense):
    if isinstance(offsets, str):
        offsets = {"ht20": _ht(20), "ht100": _ht(100)}[offsets]
    plan = fir.kernel_plan(rows, block_size, tuple(offsets))
    assert plan["form"] == "segments" and plan["dense"] == dense
    x, taps = _fir_rows(rows, block_size, offsets, card)
    fir.block_fir.launch_count = 0
    got = fir.block_fir(x, taps, offsets, block_size)
    want = fir.block_fir_reference(x, taps, offsets, block_size)
    torch.cuda.synchronize()
    assert fir.block_fir.launch_count == 1
    assert float((got - want).abs().max()) <= \
        FIR_TOL * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("rows,block_size,offsets", [
    (1000, 564, [0, 4, 10, 13, 18, 25, 26, 27, 31, 32, 36, 37, 38, 39, 41,
                 43]),                           # the flagship, sparse
    (300, 564, list(range(32))),                 # consecutive: dense
    (65, 2000, list(range(5, 69)))])             # 64 taps from d_0 = 5
def test_rows_and_segments_forms_agree_bit_for_bit(card, segments_only,
                                                   rows, block_size,
                                                   offsets):
    assert fir.kernel_plan(rows, block_size, tuple(offsets))["form"] == \
        "rows"
    variant = fir.kernel_plan(rows, block_size, tuple(offsets),
                              segments_only["block_fir_plan"])
    assert variant["form"] == "segments"
    assert variant["dense"] == (offsets[-1] - offsets[0] ==
                                len(offsets) - 1)
    x, taps = _fir_rows(rows, block_size, offsets, card)
    want = fir.block_fir(x, taps, offsets, block_size)
    got = torch.empty_like(want)
    host = (ctypes.c_int * len(offsets))(*offsets)
    dev_offsets = torch.tensor(offsets, dtype=torch.int32, device=card)
    _build.check(segments_only["block_fir"](
        x.data_ptr(), taps.data_ptr(), got.data_ptr(), rows, block_size,
        len(offsets), ctypes.cast(host, ctypes.c_void_p),
        dev_offsets.data_ptr(), torch.cuda.current_stream().cuda_stream),
        "segments only")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [True, False])
def test_segments_form_with_an_unaligned_x(card, dense):
    """x that is not 16-byte aligned (a view one sample into its storage)
    is staged by 8-byte copies: the same outputs as an aligned copy of it,
    bit for bit."""
    rows, block_size = 40, 1000
    offsets = list(range(70)) if dense else [0, 3, 70, 71, 72, 150, 7000]
    g = torch.Generator(device=card).manual_seed(5)
    flat = torch.randn(rows * block_size + 1, dtype=torch.complex64,
                       device=card, generator=g)
    x = flat[1:].view(rows, block_size)
    assert x.data_ptr() % 16 == 8
    taps = torch.randn(rows, len(offsets), dtype=torch.complex64,
                       device=card, generator=g)
    plan = fir.kernel_plan(rows, block_size, tuple(offsets))
    assert plan["form"] == "segments" and plan["dense"] == dense
    got = fir.block_fir(x, taps, offsets, block_size)
    aligned = fir.block_fir(x.clone(), taps, offsets, block_size)
    want = fir.block_fir_reference(x, taps, offsets, block_size)
    torch.cuda.synchronize()
    assert torch.equal(got, aligned)
    assert float((got - want).abs().max()) <= \
        FIR_TOL * float(want.abs().max())
