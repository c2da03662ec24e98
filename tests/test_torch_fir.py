"""The port's block-static FIR against the JAX package on the same numpy
inputs.

* ``ops/fir.py`` ``block_fir`` (on CPU tensors: its plain version) and the
  FFT route against ``pyphysim_tpu/ops/fir_pallas.py`` ``block_fir``, run
  as the JAX package runs it off the TPU (interpret mode): a ragged row
  count and the flagship geometry (block 564, 16 taps, span 44). Both sum
  the same 16 float32 products in another order: ``atol`` 1e-5 on O(1)
  values.
* ``channels/fading.py`` ``tdl_filter_block_fft`` under both
  ``BLOCK_CONV_IMPL`` routes against the JAX function and against JAX
  ``tdl_filter`` with the taps held per block (``atol`` 1e-5).
* The trips of the kernel's SASS loops (``loop_trips``), on the CPU.
* On the card (``cuda`` marker): the CUDA kernel against its plain version,
  at the flagship geometry and at rows of 4,520 B and tap counts above 16;
  the kernel's own plan (``kernel_plan``, read from the built library's
  ``block_fir_plan``: its form, instance by tap count, row buffers, warps,
  grid), and the forms past the first one's limits.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pyphysim_tpu.channels import fading as J_fading  # noqa: E402
from pyphysim_tpu.ops.cplx import CArray  # noqa: E402
from pyphysim_tpu.ops.fir_pallas import block_fir as j_block_fir  # noqa: E402
from pyphysim_tpu_torch.channels import fading  # noqa: E402
from pyphysim_tpu_torch.ops import fir  # noqa: E402

TS = 1.0 / 20e6
TU_OFFSETS = [0, 4, 10, 13, 18, 25, 26, 27, 31, 32, 36, 37, 38, 39, 41, 43]
ATOL = 1e-5


def _c(rng, *shape):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * np.sqrt(0.5)).astype(np.complex64)


def _carray(a):
    return CArray(jnp.asarray(a.real), jnp.asarray(a.imag))


def test_flagship_offsets():
    """The flagship channel's offsets and block are the kernel's shape."""
    profile = fading.COST259_TUx.get_discretize_profile(TS)
    assert list(profile.tap_delays.astype(int)) == TU_OFFSETS


@pytest.mark.parametrize("rows,block_size,offsets", [
    (70, 64, [0, 3, 7, 20]),             # ragged: not a multiple of 64 rows
    (8, 564, TU_OFFSETS),                # the flagship geometry
    (9, 565, TU_OFFSETS),                # a row of 4,520 B, not 16-byte whole
    (12, 100, list(range(0, 60, 3))),    # 20 taps: the 32-tap instance
    (5, 64, list(range(0, 128, 2))),     # 64 taps: the widest instance
    (1, 33, [0]),                        # one row, one tap, odd block
])
def test_block_fir_matches_jax(rows, block_size, offsets):
    rng = np.random.default_rng(rows + block_size)
    x = _c(rng, rows, block_size)
    taps = _c(rng, rows, len(offsets))
    want = j_block_fir(_carray(x), _carray(taps), offsets,
                       block_size).to_numpy()
    fir.block_fir.reference_count = 0
    got = fir.block_fir(torch.from_numpy(x), torch.from_numpy(taps),
                        offsets, block_size)
    assert fir.block_fir.reference_count == 1       # the plain version ran
    assert got.shape == (rows, block_size + offsets[-1])
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    fft = fir.block_fir_fft(torch.from_numpy(x), torch.from_numpy(taps),
                            offsets, block_size)
    np.testing.assert_allclose(fft.numpy(), want, atol=ATOL, rtol=0)


def test_block_fir_checks_its_inputs():
    x = torch.zeros(4, 16, dtype=torch.complex64)
    t = torch.zeros(4, 2, dtype=torch.complex64)
    with pytest.raises(ValueError, match="x_blocks"):
        fir.block_fir(x, t, [0, 3], 15)
    with pytest.raises(ValueError, match="taps"):
        fir.block_fir(x, t[:3], [0, 3], 16)
    with pytest.raises(ValueError, match="increasing"):
        fir.block_fir(x, t, [3, 3], 16)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("T,bound,full", [
    (1, 16, False), (15, 16, False), (16, 16, True), (17, 32, False),
    (32, 32, True), (33, 64, False), (64, 64, True)])
def test_kernel_plan_picks_the_instance_by_tap_count(T, bound, full):
    """On the card: the kernel's own plan (``block_fir_plan``) picks the
    least of 16 / 32 / 64 that holds T."""
    _needs_card()
    plan = fir.kernel_plan(100, 564, tuple(range(0, 2 * T, 2)))
    assert (plan["tap_bound"], plan["full"]) == (bound, full)


@pytest.mark.cuda
def test_kernel_plan_at_the_flagship_geometry():
    """On the card: taps (16), D - 1 zeros rounded to even (44), then 19
    chunks of 32 outputs; two buffers a warp, four warps a block, eight
    rows a warp, four chunks a lane."""
    _needs_card()
    for rows, blocks in ((8192, 256), (1000, 32), (1, 1)):
        plan = fir.kernel_plan(rows, 564, tuple(TU_OFFSETS))
        assert plan["row0"] == 16 + 44
        assert plan["chunks"] == 19 and plan["out_len"] == 607
        assert plan["stage_elements"] == 60 + 19 * 32
        assert (plan["stages"], plan["warps"]) == (2, 4)
        assert (plan["rows_per_warp"], plan["kChunks"]) == (8, 4)
        assert plan["smem_bytes"] == 4 * 2 * 8 * 668
        assert plan["blocks"] == blocks
        assert plan["threads"] == blocks * 128
    # a row of 4,520 B keeps the same plan
    assert fir.kernel_plan(1000, 565, tuple(TU_OFFSETS))["chunks"] == 19
    profile = fir.kernel_profile(1000, 564, TU_OFFSETS)
    assert profile["pattern"] == "block_fir_kernelILi16ELb1ELi2EE"
    assert profile["threads"] == 32 * 128


@pytest.mark.cuda
def test_kernel_plan_shrinks_to_what_fits_and_raises_beyond():
    """On the card: a row whose buffer does not fit four warps of two is
    staged by the segments form, a block of eight warps at a time: two
    stages sized for two blocks a SM, then for one, then one stage where
    the halo leaves no room; a span whose one unit of outputs does not fit
    227 KB takes the direct form. Beyond the first form's limits (more
    than 64 taps, a block above 6,144, a span of 20,001) the kernel plans
    and runs against its plain version; only arguments that are no FIR
    raise."""
    _needs_card()
    plan = fir.kernel_plan(10, 6144, (0, 5000))
    assert plan["form"] == "segments"
    assert (plan["stages"], plan["warps"]) == (2, 8)
    assert plan["smem_bytes"] <= 232448 // 2
    assert fir.kernel_plan(10, 6144, (0, 300))["stages"] == 2
    long_span = fir.kernel_plan(10, 6144, (0, 20000))
    assert long_span["form"] == "segments"
    assert (long_span["stages"], long_span["warps"]) == (1, 8)
    assert fir.kernel_plan(3, 100, (0, 40000))["form"] == "direct"
    assert fir.kernel_plan(10, 64, tuple(range(65)))["form"] == "segments"
    assert fir.kernel_plan(10, 6145, (0, 1))["form"] == "segments"
    rng = np.random.default_rng(3)
    for rows, block, offsets in ((10, 6144, [0, 20000]),
                                 (10, 64, list(range(65))),
                                 (10, 6145, [0, 1]), (3, 100, [0, 40000])):
        x = torch.from_numpy(_c(rng, rows, block)).cuda()
        taps = torch.from_numpy(_c(rng, rows, len(offsets))).cuda()
        got = fir.block_fir(x, taps, offsets, block)
        want = fir.block_fir_reference(x, taps, offsets, block)
        assert float((got - want).abs().max()) <= \
            1e-5 * float(want.abs().max())
    with pytest.raises(ValueError, match="no plan"):
        fir.kernel_plan(10, 0, (0, 1))


def _profile(rows, chunks, k_chunks, threads):
    """A profile as ``kernel_profile`` gives it, with the plan entries
    ``loop_trips`` reads."""
    return {"rows": rows, "threads": threads,
            "plan": {"chunks": chunks, "kChunks": k_chunks,
                     "threads": threads}}


@pytest.mark.parametrize("rows,chunks,k_chunks,threads", [
    (1000, 19, 4, 32 * 128),      # the flagship plan at 1,000 rows
    (8192, 19, 8, 256 * 128),     # 8 chunks a lane: 2 passes, 3 tail
    (1, 2, 4, 128),               # one row, no full pass
])
def test_loop_trips_name_rows_passes_and_tail(rows, chunks, k_chunks,
                                              threads):
    """The loop with the most FFMAs is the row loop (rows over the warps
    launched), the next the pass loop, the third the tail; copies and
    zero fills one trip each."""
    profile = _profile(rows, chunks, k_chunks, threads)
    loops = [{"STS": 4}, {"LDGSTS": 4}, {"FFMA": 256, "LDS": 64},
             {"FFMA": 64}, {"FFMA": 320, "LDGSTS": 4}]
    trips = fir.loop_trips(loops, profile)
    assert trips == [1.0, 1.0, chunks // k_chunks, chunks % k_chunks,
                     rows / (threads // 32)]
    with pytest.raises(ValueError, match="expected 3"):
        fir.loop_trips(loops[:3], profile)


def _ir_pair(rng, batch, num_blocks):
    """The same block-static taps as a JAX impulse response per row and as
    one batched port impulse response."""
    j_profile = J_fading.COST259_TUx.get_discretize_profile(TS)
    profile = fading.COST259_TUx.get_discretize_profile(TS)
    taps = _c(rng, batch, j_profile.num_taps, num_blocks)
    j_irs = [J_fading.TdlImpulseResponse(_carray(t), j_profile)
             for t in taps]
    return j_irs, fading.TdlImpulseResponse.from_numpy(taps, profile,
                                                       device="cpu")


@pytest.mark.parametrize("impl", ["kernel", "fft", "auto"])
def test_tdl_filter_block_fft_matches_jax(monkeypatch, impl):
    rng = np.random.default_rng(11)
    block_size, num_blocks, batch = 564, 3, 2
    j_irs, ir = _ir_pair(rng, batch, num_blocks)
    x = _c(rng, batch, num_blocks * block_size)
    monkeypatch.setattr(fading, "BLOCK_CONV_IMPL", impl)
    fir.block_fir.reference_count = 0
    got = fading.tdl_filter_block_fft(ir, torch.from_numpy(x), block_size)
    assert fir.block_fir.reference_count == (0 if impl == "fft" else 1)
    assert got.shape == (batch, num_blocks * block_size + 43)
    for b in range(batch):
        want = J_fading.tdl_filter_block_fft(j_irs[b], _carray(x[b]),
                                             block_size).to_numpy()
        np.testing.assert_allclose(got[b].numpy(), want, atol=ATOL, rtol=0)
        # the same output as the per-sample filter with per-block taps
        taps = j_irs[b].tap_values_sparse.to_numpy()
        held = np.repeat(taps, block_size, axis=-1)
        per_sample = J_fading.tdl_filter(
            J_fading.TdlImpulseResponse(_carray(held),
                                        j_irs[b].channel_profile),
            _carray(x[b])).to_numpy()
        np.testing.assert_allclose(got[b].numpy(), per_sample, atol=ATOL,
                                   rtol=0)


def test_tdl_filter_block_fft_rejects_bad_blocks(monkeypatch):
    rng = np.random.default_rng(2)
    _, ir = _ir_pair(rng, 1, 2)
    with pytest.raises(ValueError, match="channel span"):
        fading.tdl_filter_block_fft(ir, torch.zeros(1, 2 * 40,
                                                    dtype=torch.complex64), 40)
    with pytest.raises(ValueError, match="divide"):
        fading.tdl_filter_block_fft(ir, torch.zeros(1, 2 * 64 + 1,
                                                    dtype=torch.complex64), 64)
    monkeypatch.setattr(fading, "BLOCK_CONV_IMPL", "pallas")
    with pytest.raises(ValueError, match="BLOCK_CONV_IMPL"):
        fading.tdl_filter_block_fft(ir, torch.zeros(1, 2 * 64,
                                                    dtype=torch.complex64), 64)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8192, 1000, 1])
def test_block_fir_kernel_matches_plain(rows):
    """On the card: the CUDA kernel against its plain version on the same
    inputs, within 1e-5 of max |y| (the same float32 products summed in
    another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    g = torch.Generator(device="cuda").manual_seed(rows)
    x = torch.randn(rows, 564, dtype=torch.complex64, device="cuda",
                    generator=g)
    taps = torch.randn(rows, 16, dtype=torch.complex64, device="cuda",
                       generator=g)
    before = fir.block_fir.launch_count
    y = fir.block_fir(x, taps, TU_OFFSETS, 564)
    torch.cuda.synchronize()
    assert fir.block_fir.launch_count == before + 1
    ref = fir.block_fir_reference(x, taps, TU_OFFSETS, 564)
    assert float((y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("rows,block_size,offsets", [
    (8192, 564, TU_OFFSETS), (1000, 564, TU_OFFSETS), (1, 564, TU_OFFSETS),
    (1000, 565, TU_OFFSETS), (1000, 564, list(range(0, 100, 5))),
    (256, 564, list(range(0, 128, 2))), (7, 33, [0])])
def test_block_fir_kernel_geometries(rows, block_size, offsets):
    """On the card: every instance (16 / 32 / 64 taps, full or not) and a
    row that is not 16-byte whole, against the plain version within 1e-5
    of max |y|."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    g = torch.Generator(device="cuda").manual_seed(rows + block_size)
    x = torch.randn(rows, block_size, dtype=torch.complex64, device="cuda",
                    generator=g)
    taps = torch.randn(rows, len(offsets), dtype=torch.complex64,
                       device="cuda", generator=g)
    y = fir.block_fir(x, taps, offsets, block_size)
    torch.cuda.synchronize()
    ref = fir.block_fir_reference(x, taps, offsets, block_size)
    assert float((y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
