"""Philox4x32-10 in torch integer ops (pyphysim_tpu_torch/ops/philox.py).

Known answers are Random123's (kat_vectors, philox4x32_10). The stream
layout must make the bits of absolute attempt i independent of the chunk
it falls in, which is what makes the runner's results chunk-size invariant
and resume exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pyphysim_tpu_torch.ops import philox  # noqa: E402

M32 = 0xFFFFFFFF


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32, M32, M32, M32), (M32, M32),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_random123_known_answers(ctr, key, want):
    got = philox.philox4x32_10(*ctr, *key)
    assert tuple(int(w) for w in got) == want


def test_vectorized_matches_scalar_calls():
    rng = np.random.default_rng(0)
    ctr = rng.integers(0, 2 ** 32, (64, 4), dtype=np.int64)
    vec = torch.stack(philox.philox4x32_10(
        *(torch.from_numpy(ctr[:, j]) for j in range(4)), 0xDEADBEEF, 7),
        dim=1)
    for i in (0, 17, 63):
        one = philox.philox4x32_10(*(int(c) for c in ctr[i]), 0xDEADBEEF, 7)
        assert [int(w) for w in one] == vec[i].tolist()


def test_mulhilo_is_exact_at_the_extremes():
    b = torch.tensor([0, 1, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000, M32,
                      0x12345678], dtype=torch.int64)
    for a in (0xD2511F53, 0xCD9E8D57):
        hi, lo = philox._mulhilo(a, b)
        for bi, h, l in zip(b.tolist(), hi.tolist(), lo.tolist()):
            assert (h, l) == ((a * bi) >> 32, (a * bi) & M32)


def test_int32_view_keeps_the_bits():
    words = torch.tensor([0, 1, 2 ** 31 - 1, 2 ** 31, M32], dtype=torch.int64)
    got = philox.to_int32_bits(words)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.array(words.tolist(), np.uint32))


@pytest.mark.parametrize("start", [0, 5, 2 ** 32 - 3])
def test_attempt_bits_do_not_depend_on_the_chunk(start):
    """Attempt ``start + i`` draws the same bits in a chunk of 8 starting
    at ``start`` as alone in a chunk of 1 — including across the 32-bit
    boundary of the 64-bit attempt counter."""
    seed, TL, nt, tile, used = 12345, 40, 2, 8, 12
    eight = torch.arange(start, start + 8, dtype=torch.int64)
    pb8 = philox.phase_stream_bits(seed, eight, TL)
    sb8 = philox.symbol_stream_bits(seed, eight, nt, tile, used)
    assert pb8.shape == (8, 2, TL)
    assert all(b.shape == (8, nt * tile, used) for b in sb8)
    for i in (0, 3, 7):
        one = torch.tensor([start + i], dtype=torch.int64)
        assert torch.equal(philox.phase_stream_bits(seed, one, TL)[0],
                           pb8[i])
        for b1, b8 in zip(philox.symbol_stream_bits(seed, one, nt, tile,
                                                    used), sb8):
            assert torch.equal(b1[0], b8[i])


def test_streams_differ_by_seed_attempt_tile_and_word():
    att = torch.arange(2, dtype=torch.int64)
    db, n1, n2 = philox.symbol_stream_bits(1, att, 2, 8, 12)
    other, _, _ = philox.symbol_stream_bits(2, att, 2, 8, 12)
    assert not torch.equal(db, other)                    # seed
    assert not torch.equal(db[0], db[1])                 # attempt
    assert not torch.equal(db[0, :8], db[0, 8:])         # tile
    assert not torch.equal(db, n1) and not torch.equal(n1, n2)


@pytest.mark.cuda
def test_device_philox_matches_torch():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from pyphysim_tpu_torch.ops import _build
    g = torch.Generator(device="cuda").manual_seed(0)
    ctr = torch.randint(0, 2 ** 32, (4096, 4), dtype=torch.int64,
                        device="cuda", generator=g)
    key = (0x9E3779B9, 42)
    want = philox.to_int32_bits(torch.stack(philox.philox4x32_10(
        *ctr.unbind(1), *key), dim=1))
    ctr32 = philox.to_int32_bits(ctr).contiguous()
    key32 = philox.to_int32_bits(torch.tensor(key, device="cuda"))
    got = torch.empty_like(ctr32)
    _build.check(_build.load().philox_fill(
        ctr32.data_ptr(), key32.data_ptr(), got.data_ptr(), ctr.shape[0],
        torch.cuda.current_stream().cuda_stream), "philox_fill")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
