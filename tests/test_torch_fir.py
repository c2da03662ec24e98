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
* On the card (``cuda`` marker): the CUDA kernel against its plain version.
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
