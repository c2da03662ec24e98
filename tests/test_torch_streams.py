"""The per-attempt streams' draws (``pyphysim_tpu_torch/ops/streams.py``).

* The host-side packing of keys and counters for the fill kernel
  (``pack_words``): what the kernel reads for each row equals the words
  ``philox_words`` draws from, for a chunk of attempts (scalar key, the
  attempt's low and high words read from one int64 column) and for the
  Rayleigh generator's per-row keys (strided columns of its key tensor).
* ``philox_draw`` on CPU tensors (its plain version) against Philox4x32-10
  composed by hand from ``ops/philox.py``: bits, masked integers, uniforms
  and Box-Muller normals at an odd row length, the streams and the
  Rayleigh generator drawing through it, and the integer Philox of a
  stream split.
* On the card (``cuda`` marker): one fill launch a draw, bits and uniforms
  bit for bit against the plain version and the CPU route, normals bit for
  bit against the plain version.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from pyphysim_tpu_torch.channels.fading_generators import (  # noqa: E402
    RayleighSampleGenerator, RayleighState)
from pyphysim_tpu_torch.ops import philox, streams  # noqa: E402
from pyphysim_tpu_torch.ops.streams import AttemptStreams  # noqa: E402

M32 = 0xFFFFFFFF


def _by_hand(k0, k1, c2, c3, m):
    """(n, m) Philox words: counter (j, 0, c2, c3) under (k0, k1)."""
    j = torch.arange((m + 3) // 4, dtype=torch.int64)
    cols = [w.reshape(-1, 1) if isinstance(w, torch.Tensor) else w
            for w in (k0, k1, c2, c3)]
    words = torch.stack(torch.broadcast_tensors(*philox.philox4x32_10(
        j[None, :], 0, cols[2], cols[3], cols[0], cols[1])), dim=-1)
    n = next(w.shape[0] for w in cols if isinstance(w, torch.Tensor))
    return words.reshape(n, -1)[:, :m]


def _normals(words):
    u = (words >> 8).to(torch.float32) * (2.0 ** -24)
    r = torch.sqrt(-2.0 * torch.log(1.0 - u[:, 0::2]))
    a = np.float32(2 * np.pi) * u[:, 1::2]
    return torch.stack([r * torch.cos(a), r * torch.sin(a)],
                       dim=-1).reshape(words.shape)


def _kernel_reads(packed, n):
    """What the kernel reads for each row: ``column[r * stride] >> shift``,
    its low 32 bits, straight from the column's storage."""
    out = []
    for t, stride, shift, value in packed:
        if t is None:
            out.append(torch.full((n,), value, dtype=torch.int64))
        else:
            col = torch.as_strided(t, (n,), (stride,), t.storage_offset())
            out.append((col >> shift) & M32)
    return out


def test_packing_of_a_chunk_of_attempts():
    """Scalar key (seed, salt); the counter words are the low and high 32
    bits of one int64 column of attempts, across 2**32, with nothing
    computed on the host."""
    a = torch.arange(2 ** 32 - 3, 2 ** 32 + 5, dtype=torch.int64)
    s = AttemptStreams(2 ** 40 + 17, a, salt=99)
    n, dev, packed = streams.pack_words(s.seed, s.salt, (a, 0), (a, 32))
    assert (n, dev.type) == (8, "cpu")
    assert packed[0] == (None, 0, 0, 17) and packed[1] == (None, 0, 0, 99)
    assert packed[2][0] is a and packed[2][1:3] == (1, 0)
    assert packed[3][0] is a and packed[3][1:3] == (1, 32)
    reads = _kernel_reads(packed, n)
    # philox_words's inputs as the streams computed them before the fill
    for got, want in zip(reads, (17, 99, a & M32, (a >> 32) & M32)):
        assert torch.equal(got, torch.as_tensor(want).expand(n))
    assert [int(v) for v in reads[3]] == [0] * 3 + [1] * 5
    values = streams.packed_values(packed)
    assert values[:2] == [17, 99]
    assert torch.equal(values[2], a & M32)
    assert torch.equal(values[3], (a >> 32) & M32)


def test_packing_of_per_row_key_columns():
    """The Rayleigh generator's (n, 2) key: two strided columns read in
    place; its counter's low word; a scalar high word."""
    key = torch.randint(0, 2 ** 32, (6, 2), dtype=torch.int64,
                        generator=torch.Generator().manual_seed(1))
    c = torch.arange(6, dtype=torch.int64) + 2 ** 32 - 2
    n, _, packed = streams.pack_words(key[:, 0], key[:, 1], (c, 0), 1)
    assert [p[1] for p in packed[:3]] == [2, 2, 1]
    reads = _kernel_reads(packed, n)
    assert torch.equal(reads[0], key[:, 0])
    assert torch.equal(reads[1], key[:, 1])
    assert torch.equal(reads[2], c & M32)
    assert torch.equal(reads[3], torch.ones(6, dtype=torch.int64))


def test_packing_rejects_what_the_kernel_cannot_read():
    a = torch.arange(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="one length"):
        streams.pack_words(0, 0, a, a[:3])
    with pytest.raises(ValueError, match="tensor"):
        streams.pack_words(0, 0, 1, 2)
    with pytest.raises(ValueError, match="shift"):
        streams.pack_words(0, 0, (a, 64), a)
    with pytest.raises(ValueError, match="kind"):
        streams.philox_draw("gauss", 0, 0, a, a, 4)


@pytest.mark.parametrize("m", [1, 7, 2049])
def test_plain_draws_are_philox_composed_by_hand(m):
    """Bits, masked integers, uniforms and normals (odd m: the last pair's
    second normal dropped) of per-row keys and attempts across 2**32."""
    a = torch.arange(2 ** 32 - 5, 2 ** 32 + 6, dtype=torch.int64)
    key = torch.randint(0, 2 ** 32, (11, 2), dtype=torch.int64,
                        generator=torch.Generator().manual_seed(m))
    args = (key[:, 0], key[:, 1], (a, 0), (a, 32), m)
    words = _by_hand(key[:, 0], key[:, 1], a & M32, a >> 32, m + (m & 1))
    streams.philox_draw.reference_count = 0
    bits = streams.philox_draw("bits", *args)
    assert bits.dtype == torch.int64 and bits.shape == (11, m)
    assert torch.equal(bits, words[:, :m])
    assert torch.equal(streams.philox_draw("bits", *args, mask=15),
                       words[:, :m] & 15)
    uni = streams.philox_draw("uniform", *args)
    assert torch.equal(uni, (words[:, :m] >> 8).to(torch.float32) * 2 ** -24)
    normal = streams.philox_draw("normal", *args)
    assert normal.dtype == torch.float32 and normal.shape == (11, m)
    assert torch.equal(normal, _normals(words)[:, :m])
    assert streams.philox_draw.reference_count == 4
    assert torch.equal(streams.philox_draw_reference("normal", *args),
                       normal)
    assert torch.equal(streams.philox_words(key[:, 0], key[:, 1], a & M32,
                                            a >> 32, m), words[:, :m])


def test_attempt_streams_draw_the_words_of_their_attempts():
    """Each kind of an ``AttemptStreams`` is one draw of the Philox words
    under (seed, salt) at the attempt's counter, shaped (n, *shape)."""
    a = torch.arange(2 ** 32 - 2, 2 ** 32 + 2, dtype=torch.int64)
    s = AttemptStreams(123, a, salt=45)
    shape = (3, 5)
    words = _by_hand(123, 45, a & M32, a >> 32, 16)
    assert torch.equal(s.bits(shape), words[:, :15].reshape(4, *shape))
    assert torch.equal(s.integers(8, shape),
                       (words[:, :15] & 7).reshape(4, *shape))
    assert torch.equal(s.uniform(shape), ((words[:, :15] >> 8).to(
        torch.float32) * 2 ** -24).reshape(4, *shape))
    assert torch.equal(s.normal(shape),
                       _normals(words)[:, :15].reshape(4, *shape))


def test_split_salts_use_the_integer_philox():
    """``philox4x32_10_int`` is the tensor Philox on Python ints (and the
    Random123 answer), so a split's salts are the ones torch gave."""
    assert philox.philox4x32_10_int(0, 0, 0, 0, 0, 0) == (
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)
    rng = np.random.default_rng(4)
    for row in rng.integers(0, 2 ** 32, (32, 6), dtype=np.int64):
        args = [int(v) for v in row]
        assert philox.philox4x32_10_int(*args) == tuple(
            int(w) for w in philox.philox4x32_10(*args))
    s = AttemptStreams(77, torch.arange(3, dtype=torch.int64), salt=5)
    base = int(philox.philox4x32_10(5, 0x5EED, 0, 0, 77, 0x57A17)[0])
    assert [c.salt for c in s.split(3)] == [
        (base + 0x9E3779B9 * (i + 1)) & M32 for i in range(3)]


def test_rayleigh_samples_are_one_normal_draw():
    """The generator's CN(0, 1) samples: normals of its key at the counter
    (j, 0, counter, 1), scaled by sqrt(1/2), real and imaginary parts
    interleaved."""
    gen = RayleighSampleGenerator(shape=(2,), device="cpu")
    key = np.array([[1, 2], [3, 2 ** 32 - 1]], np.uint32)
    state = RayleighState.from_numpy(key, counter=[5, 2 ** 32 + 1],
                                     device="cpu")
    samples, nxt = gen.generate(state, 3)
    assert samples.shape == (2, 2, 3)
    k = torch.as_tensor(key.astype(np.int64))
    words = _by_hand(k[:, 0], k[:, 1], torch.tensor([5, 1]), 1, 12)
    z = _normals(words) * np.float32(math.sqrt(0.5))
    want = torch.complex(z[:, 0::2], z[:, 1::2]).reshape(2, 2, 3)
    assert torch.equal(samples, want)
    assert nxt.counter.tolist() == [6, 2 ** 32 + 2]


def _ulps(a, b):
    def ordered(t):
        i = t.view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i + 2 ** 31), i)
    return int((ordered(a) - ordered(b)).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bits", "uniform", "normal"])
@pytest.mark.parametrize("per_row_key", [False, True])
def test_fill_matches_the_plain_version_bitwise(kind, per_row_key):
    """On the card: one launch a draw; bits and uniforms equal to the plain
    version and to the CPU route bit for bit, normals equal to the plain
    version (the CPU's log / cos / sin are other functions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    a = torch.arange(2 ** 32 - 200, 2 ** 32 + 57, dtype=torch.int64,
                     device="cuda")
    if per_row_key:
        key = torch.randint(0, 2 ** 32, (a.shape[0], 2), dtype=torch.int64,
                            device="cuda")
        k0, k1 = key[:, 0], key[:, 1]
    else:
        k0, k1 = 0x12345678, 0x9ABCDEF
    args = (k0, k1, (a, 0), (a, 32), 1001)
    before = streams.philox_draw.launch_count
    got = streams.philox_draw(kind, *args)
    assert streams.philox_draw.launch_count == before + 1
    plain = streams.philox_draw_reference(kind, *args)
    cpu = streams.philox_draw(kind, *(
        w.cpu() if isinstance(w, torch.Tensor) else w for w in (k0, k1)),
        (a.cpu(), 0), (a.cpu(), 32), 1001)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    if kind == "normal":
        assert _ulps(got.cpu(), cpu) <= 4
    else:
        assert torch.equal(got.cpu(), cpu)


# one launch of the fill covers 2,112 blocks x 256 threads, a counter (four
# words) a thread; beyond that every thread strides over the rest
_FILL_GRID_COUNTERS = 132 * 16 * 256


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bits", "uniform", "normal"])
def test_fill_beyond_one_grid_matches_the_plain_version(kind):
    """On the card, at the time-domain chain step's noise draw (256
    attempts x 36,182 draws, 4.3 grids of counters, so every thread takes
    the grid-stride step several times) with per-row keys and attempts
    across 2**32: the fill equals its plain version bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    n, m = 256, 36182
    assert n * (m + 3) // 4 > 4 * _FILL_GRID_COUNTERS
    a = torch.arange(2 ** 32 - n // 2, 2 ** 32 + n // 2, dtype=torch.int64,
                     device="cuda")
    g = torch.Generator(device="cuda").manual_seed(11)
    key = torch.randint(0, 2 ** 32, (n, 2), dtype=torch.int64,
                        device="cuda", generator=g)
    args = (key[:, 0], key[:, 1], (a, 0), (a, 32), m)
    got = streams.philox_draw(kind, *args)
    plain = streams.philox_draw_reference(kind, *args)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("mask", [1, 3, 0xFF])
def test_fill_masked_bits_match_the_plain_version(mask):
    """On the card, bits under a mask narrower than the word (what
    ``AttemptStreams.integers(mask + 1)`` draws; the comp_BD data symbols
    take mask 3 at 3,000 a row) over a split stream's attempts across
    2**32: one launch, equal to the plain version and to the CPU route bit
    for bit, and every word within the mask."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    n, m = 512, 3000
    s = AttemptStreams.from_range(21, 2 ** 32 - n // 2, n, "cuda").split(5)[2]
    args = (s.seed, s.salt, (s.attempts, 0), (s.attempts, 32), m, mask)
    before = streams.philox_draw.launch_count
    got = streams.philox_draw("bits", *args)
    assert streams.philox_draw.launch_count == before + 1
    plain = streams.philox_draw_reference("bits", *args)
    cpu = streams.philox_draw("bits", s.seed, s.salt, (s.attempts.cpu(), 0),
                              (s.attempts.cpu(), 32), m, mask)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    assert torch.equal(got.cpu(), cpu)
    assert int(got.min()) == 0 and int(got.max()) == mask
    assert torch.equal(s.integers(mask + 1, (m,)), got)
