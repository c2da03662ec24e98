"""The data flow of the BD and IA kernels' wide forms, checked on the CPU
(the CUDA kernels run only on the card): a torch mirror of the BD wide
form's Gram-once solve against the JAX kernel body, and a Python mirror
of the kernels' launch plan (the storage rule of ``ops/csrc/wide.cuh`` and
the state sizes of ``mc_bd.cu`` / ``mc_ia.cu``, from the sources'
constants) against hand-computed values. On the card the libraries report
their launch themselves (``mc_*_launch_info``), and ``chip_smoke.py``
prints it.

Tolerances and why:

* the mirror's per-tile capacity sums (1,024 solves) against the JAX
  body's: rel 2e-4, chip_smoke.py's tolerance between the CUDA kernel and
  its plain version. The mirror takes B and Y as blocks of one Gram H H^H
  (whose lower triangle is summed on its own row, the conjugate of the
  upper one within rounding), runs the back substitution from the last
  column down and sums T's Gram over the columns as a butterfly: each is a
  difference of float32 rounding, not of the function.
* the stream gains, element by element: within 1e-4 of the element's
  largest gain (a projection on a null space cancels, so a small gain
  carries the absolute rounding of the large ones).
* the launch plans: exact.

JAX runs its body eagerly once a geometry (the solve of every user, ~4-15
s); the other two modes run the JAX body's water-filling and guard on the
stream gains that call computed (its per-user solves then return those
gains), so that every mode is JAX's own code on JAX's own gains.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import pyphysim_tpu.ops.bd_pallas as bd_pallas  # noqa: E402
from pyphysim_tpu.ops.bd_pallas import MonteCarloBD as J_BD  # noqa: E402
from pyphysim_tpu_torch.ops.bd_kernel import MonteCarloBD  # noqa: E402
from pyphysim_tpu_torch.ops.ia_kernel import MonteCarloMaxSinr  # noqa: E402
from pyphysim_tpu_torch.ops.planes import EPS, herm2_eigvals  # noqa: E402

REL = 2e-4
GAIN_TOL = 1e-4
MODES = ("normalized", "global", "none")


# -- the BD wide form's data flow, mirrored ---------------------------------

def _group_sum(cols, lanes):
    """The sum over the columns ``cols`` as the kernel's group adds it: lane
    g the columns g, g + lanes, ... in order, then the lanes by
    ``wide::group_sum``'s butterfly (every lane ends with lane 0's sum)."""
    vals = [torch.zeros_like(cols[0]) for _ in range(lanes)]
    for c, v in enumerate(cols):
        vals[c % lanes] = vals[c % lanes] + v
    off = lanes // 2
    while off:
        vals = [vals[i] + vals[i ^ off] for i in range(lanes)]
        off //= 2
    return vals[0]


def gram_once_gains(H, K, NR):
    """The stream gains of ``mc_bd.cu``'s wide form: one Gram G = H H^H an
    element (each entry summed over the columns in order), every user's B
    and Y^H blocks of it, W = B^-1 Y^H by the LDL^H of
    ``wide::group_ldl_solve`` (the back substitution from the last column
    down), T = Hk - W^H tilde over every row of H (W 0 on the user's own
    rows), and T's Gram summed a column at a time, then across columns as
    the group's butterfly. ``H``: complex64 (..., NT, NT)."""
    NT, M = K * NR, (K - 1) * NR
    G = H[..., :, None, 0] * H[..., None, :, 0].conj()
    for c in range(1, NT):
        G = G + H[..., :, None, c] * H[..., None, :, c].conj()
    gains = []
    for k in range(K):
        own = NR * k
        oth = [t if t < own else t + NR for t in range(M)]
        B = G[..., oth, :][..., :, oth]
        x = G[..., oth, :][..., :, own:own + NR].clone()     # (M, NR)
        L = torch.zeros_like(B)
        D = []
        for j in range(M):
            d = B[..., j, j].real
            acc = B[..., j + 1:, j]
            for q in range(j):
                d = d - (L[..., j, q].abs() ** 2) * D[q]
                acc = acc - L[..., j + 1:, q] * L[..., j, q, None].conj() * \
                    D[q][..., None]
            d = torch.clamp(d, min=EPS)
            D.append(d)
            L[..., j + 1:, j] = acc * (1.0 / d)[..., None]
        for j in range(M - 1):                       # forward, j in order
            x[..., j + 1:, :] = x[..., j + 1:, :] - \
                L[..., j + 1:, j, None] * x[..., j, None, :]
        x = x * torch.stack([1.0 / d for d in D], dim=-1)[..., None]
        for j in range(M - 1, 0, -1):                # back, from the last
            x[..., :j, :] = x[..., :j, :] - \
                x[..., j, None, :] * L[..., j, :j, None].conj()
        W = torch.zeros(H.shape[:-2] + (NT, NR), dtype=H.dtype)
        W[..., oth, :] = x
        acc = W[..., 0, None, :].conj() * H[..., 0, :, None]   # (NT, NR)
        for a in range(1, NT):
            acc = acc + W[..., a, None, :].conj() * H[..., a, :, None]
        T = H[..., own:own + NR, :].transpose(-1, -2) - acc    # (NT, NR)
        lanes = _lanes_for(-(-NT // 4), 4)   # a user's sub-group
        p = _group_sum([T[..., c, 0].abs() ** 2 for c in range(NT)], lanes)
        if NR == 1:
            gains.append(torch.clamp(p, min=0.0))
            continue
        r = _group_sum([T[..., c, 1].abs() ** 2 for c in range(NT)], lanes)
        q = _group_sum([T[..., c, 0] * T[..., c, 1].conj()
                        for c in range(NT)], lanes)
        l0, l1 = herm2_eigvals((p, q, r))
        gains += [torch.clamp(l0, min=0.0), torch.clamp(l1, min=0.0)]
    return gains


class GramOnceBD(MonteCarloBD):
    """The port's plain version with the wide form's stream gains."""

    def stream_gains(self, ch_bits, dtype=torch.complex64):
        K, NR = self.K, self.Nr_u
        NT = K * NR
        reps, rows, _ = ch_bits.shape
        planes = ch_bits.reshape(reps, rows // self.tile, self.tile,
                                 self.num_planes, self.lane).transpose(-1, -2)
        from pyphysim_tpu_torch.ops.alamouti_kernel import _gauss
        g = _gauss(planes)
        H = torch.complex(g[..., 0::2], g[..., 1::2]).reshape(
            g.shape[:-1] + (NT, NT)).to(dtype)
        return gram_once_gains(H, K, NR)


def _jax_modes(K, NR, bits, monkeypatch):
    """``{mode: (per-tile capacity sums, stream gains)}`` of the JAX body on
    ``bits`` (one tile, (planes, tile, lane)): the first mode eagerly in
    full, the others with each user's solve returning the gains it found."""
    planes = [jnp.asarray(b) for b in bits]
    captured = {}
    real_guarded = J_BD._guarded

    def guarded(cap, gains):
        captured["gains"] = [np.asarray(g) for g in gains]
        return real_guarded(cap, gains)

    monkeypatch.setattr(J_BD, "_guarded", staticmethod(guarded))
    out = {}
    for i, mode in enumerate(MODES):
        jmc = J_BD(tile=8, lane=128, K=K, Nr_u=NR, mode=mode)
        if i == 1:                     # from here on: the gains found
            gains = iter(zip(captured["gains"][0::2],
                             captured["gains"][1::2]))
            for name in ("gram_full", "mat_mul", "mat_H",
                         "herm_solve_cols_ldl", "mat_sub", "gram_rows"):
                monkeypatch.setattr(bd_pallas, name, lambda *a: None)
            monkeypatch.setattr(
                bd_pallas, "herm2_eigvals",
                lambda _: tuple(jnp.asarray(g) for g in next(gains)))
        if i == 2:
            gains = iter(zip(captured["gains"][0::2],
                             captured["gains"][1::2]))
        cap = np.asarray(jmc._solve_block(planes, noise_var=1.0,
                                          iPu=10.0 / 3))
        out[mode] = (cap.sum(), list(captured["gains"]))
    return out


@pytest.mark.parametrize("K,NR", [(7, 2), (8, 2), (11, 2)])
def test_bd_gram_once_flow_matches_jax_kernel_body(K, NR, monkeypatch):
    rng = np.random.default_rng(100 + K)
    mc = GramOnceBD(tile=8, lane=128, K=K, Nr_u=NR, device="cpu")
    bits = rng.integers(0, 2 ** 32, (1, mc.tile, mc.num_planes * mc.lane),
                        dtype=np.uint32)
    jax_bits = bits[0].astype(np.int32).reshape(mc.tile, mc.num_planes,
                                                mc.lane).transpose(1, 0, 2)
    want = _jax_modes(K, NR, jax_bits, monkeypatch)
    ch = torch.from_numpy(bits.astype(np.int64).astype(np.int32))
    gains = torch.stack(mc.stream_gains(ch)).reshape(2 * K, mc.tile,
                                                     mc.lane).numpy()
    jgains = np.stack(want[MODES[0]][1])
    scale = jgains.max(axis=0)
    assert np.abs(gains - jgains).max(axis=0).max() <= GAIN_TOL * \
        scale.max()
    assert (np.abs(gains - jgains) <= GAIN_TOL * scale).all()
    for mode in MODES:
        mc.mode = mode
        got = float(mc.build_inject(1, 1)(bits)[0, 0])
        np.testing.assert_allclose(got, want[mode][0], rtol=REL)
        assert 2.0 < got / mc.solves_per_grid_step < 60.0


def test_gram_once_flow_is_the_plain_version_within_rounding():
    """At a menu-sized wide geometry the mirror and the port's plain
    version (the kernel's yardstick) agree to rounding, element by
    element, in every mode."""
    rng = np.random.default_rng(5)
    mirror = GramOnceBD(tile=8, lane=128, K=5, Nr_u=2, device="cpu")
    bits = rng.integers(0, 2 ** 32, (1, 16, mirror.num_planes * 128),
                        dtype=np.uint32)
    ch = torch.from_numpy(bits.astype(np.int64).astype(np.int32))
    for mode in MODES:
        plain = MonteCarloBD(tile=8, lane=128, K=5, Nr_u=2, mode=mode,
                             device="cpu")
        mirror.mode = mode
        want = plain.element_capacities(ch)
        got = mirror.element_capacities(ch)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4)


# -- the launch plan, mirrored -----------------------------------------------
# A plan is a dict: ``form`` ("tile": the prebuilt BD kernel's form;
# "thread": one element a thread; "group": a group of lanes an element),
# ``lanes`` (an element), ``threads`` and ``elems`` (a block),
# ``shared_bytes`` (dynamic shared memory a block, 0 past it), ``scratch``
# (the state in the scratch buffer) and ``parts`` (partial sums a (rep,
# tile) cell).

_CSRC = Path(__file__).resolve().parents[1] / "pyphysim_tpu_torch" / "ops" \
    / "csrc"
_F2 = 8                       # bytes of a float2 entry


@functools.lru_cache(maxsize=None)
def _source_constant(source, name):
    """The ``constexpr int`` ``name`` of ``ops/csrc/<source>``."""
    m = re.search(rf"constexpr int {name} = (\d+);",
                  (_CSRC / source).read_text())
    if m is None:
        raise RuntimeError(f"{source} defines no {name}")
    return int(m.group(1))


def _wide(name):
    return _source_constant("wide.cuh", name)


def _lanes_for(n, lo):
    """``wide::lanes_for``: the power of two >= n within [lo, a warp]."""
    lanes = lo
    while lanes < n and lanes < _wide("kMaxLanes"):
        lanes *= 2
    return lanes


def _group_stride(entries, lanes):
    if lanes == 32:
        return (entries + 1) // 2 * 2
    return (entries + 15) // 16 * 16 + _wide("kBankSkew") // 2


def _with_parts(plan, mc):
    plan["parts"] = -(-mc.tile * mc.lane // plan["elems"])
    return plan


def _group_plan(entries, lanes, mc):
    """The lane-group layout (``wide::group_stride`` / ``group_warps``) for
    ``entries`` float2 entries of state an element, ``lanes`` an element."""
    per_warp = 32 // lanes
    warp_bytes = per_warp * _group_stride(entries, lanes) * _F2
    smem = _wide("kMaxSmem")
    warps = (_wide("kMaxWarps") if warp_bytes * _wide("kMaxWarps") <= smem
             else 2 if warp_bytes * 2 <= smem else 1)
    nbytes = warps * warp_bytes
    scratch = nbytes > smem
    return _with_parts({"form": "group", "lanes": lanes,
                        "threads": 32 * warps, "elems": per_warp * warps,
                        "shared_bytes": 0 if scratch else nbytes,
                        "scratch": scratch}, mc)


def _bd_entries(K, NR, users):
    NT, M = K * NR, (K - 1) * NR
    shared = NT * NT + NT * (NT + 1) // 2
    factor = M * (M - 1) // 2
    return shared + shared % 2 + users * (factor + factor % 2 + NT * NR)


def bd_plan(mc):
    """``mc_bd.cu``'s launch of ``mc`` (a ``MonteCarloBD``): up to
    ``kTileFormMaxNt`` (unless its library asks for ``MC_BD_WIDE``) the
    prebuilt kernel's form, ``kThreads`` elements a block, NT^2 KB of
    shared memory; above it the wide form (struct Wide): Lu lanes a user,
    the power of two, at least 4, that leaves a lane at most 4 rows; U
    users at once, the fewest (a power of two within a warp) whose warps
    leave shared memory for ``kRoomWarps`` warps; H and the lower triangle
    of its Gram (NT^2 + NT (NT + 1) / 2, rounded up to even) and for each
    sub-group the strictly lower LDL^H factor (M (M - 1) / 2, rounded up to
    even) and W (NT Nr_u) an element."""
    K, NR = mc.K, mc.Nr_u
    geometry = mc.geometry_build()
    defines = geometry[1] if geometry else {}
    NT = K * NR
    if not (defines and (defines.get("MC_BD_WIDE") or NT > _source_constant(
            "mc_bd.cu", "kTileFormMaxNt"))):
        threads = _source_constant("mc_bd.cu", "kThreads")
        return _with_parts({"form": "tile", "lanes": 1, "threads": threads,
                            "elems": threads,
                            "shared_bytes": NT * NT * threads * _F2,
                            "scratch": False}, mc)
    lu = _lanes_for(-(-NT // 4), 4)

    def warp_bytes(u):
        return 32 // (u * lu) * _group_stride(_bd_entries(K, NR, u),
                                              u * lu) * _F2
    users = 1
    while (warp_bytes(users) * _wide("kRoomWarps") > _wide("kMaxSmem")
           and 2 * users * lu <= 32 and users < K):
        users *= 2
    return _group_plan(_bd_entries(K, NR, users), users * lu, mc)


def ia_plan(mc):
    """``mc_ia.cu``'s launch of ``mc`` (a ``MonteCarloMaxSinr``): the
    closed body (N, Ns) = (2, 1) one element a thread, ``kClosedThreads`` a
    block in the prebuilt kernel, one warp and its channels' columns in a
    geometry's library; the general body (struct GroupIA) Lu lanes a user,
    the power of two >= N / 2 (two rows a lane), 2 users at once (1 past 32
    lanes a user), with the links and the two filter sets (K^2 N^2 + 2 K
    Ns N, rounded up to even) and for each sub-group T and the strictly
    lower LDL^H factor (K Ns N + N (N - 1) / 2, rounded up to even) an
    element."""
    K, N, NS = mc.K, mc.N, mc.Ns
    if (N, NS) == (2, 1):
        if mc.geometry_build() is None:
            threads = _source_constant("mc_ia.cu", "kClosedThreads")
            return _with_parts({"form": "thread", "lanes": 1,
                                "threads": threads, "elems": threads,
                                "shared_bytes": 0, "scratch": False}, mc)
        threads = _wide("kThreads")
        nbytes = K * K * N * N * 2 * threads * 4
        scratch = nbytes > _wide("kMaxSmem")
        return _with_parts({"form": "thread", "lanes": 1, "threads": threads,
                            "elems": threads,
                            "shared_bytes": 0 if scratch else nbytes,
                            "scratch": scratch}, mc)
    lu = _lanes_for(-(-N // 2), 1)
    users = 2 if lu < 32 else 1
    shared = K * K * N * N + 2 * K * NS * N
    own = K * NS * N + N * (N - 1) // 2
    return _group_plan(shared + shared % 2 + users * (own + own % 2),
                       users * lu, mc)


def _consts():
    c = {n: _wide(n) for n in (
        "kThreads", "kMaxSmem", "kMaxWarps", "kMaxLanes", "kBankSkew",
        "kRoomWarps")}
    c["kTileFormMaxNt"] = _source_constant("mc_bd.cu", "kTileFormMaxNt")
    c["bd_threads"] = _source_constant("mc_bd.cu", "kThreads")
    c["ia_threads"] = _source_constant("mc_ia.cu", "kClosedThreads")
    return c


def test_the_plan_reads_the_sources_constants():
    """The mirror's constants are the sources', and its rules are the
    sources' expressions (struct Wide, struct GroupIA)."""
    assert _consts() == {"kThreads": 32, "kMaxSmem": 232448, "kMaxWarps": 4,
                         "kMaxLanes": 32, "kBankSkew": 8, "kRoomWarps": 8,
                         "kTileFormMaxNt": 8, "bd_threads": 128,
                         "ia_threads": 128}
    with pytest.raises(RuntimeError, match="defines no kNothing"):
        _source_constant("wide.cuh", "kNothing")
    assert [_lanes_for(n, 8) for n in (3, 8, 9, 14, 16, 17, 22, 40)] \
        == [8, 8, 16, 16, 16, 32, 32, 32]
    assert [_lanes_for(n, 1) for n in (2, 3, 4, 5)] == [2, 4, 4, 8]
    bd = (_CSRC / "mc_bd.cu").read_text()
    assert "static constexpr int Lu = wide::lanes_for((NT + 3) / 4, 4);" \
        in bd and "static constexpr int U = default_users();" in bd
    ia = (_CSRC / "mc_ia.cu").read_text()
    assert "static constexpr int Lu = wide::lanes_for((N + 1) / 2, 1);" \
        in ia and "static constexpr int U = Lu < 32 ? 2 : 1;" in ia


def _group(lanes, threads, elems, shared, parts, scratch=False):
    return {"form": "group", "lanes": lanes, "threads": threads,
            "elems": elems, "shared_bytes": shared, "scratch": scratch,
            "parts": parts}


# hand-computed at tile = 8, lane = 512 (4,096 solves a (rep, tile) cell):
# entries an element (BD: NT^2 + NT (NT + 1) / 2 rounded up to even, then
# for each of the U users solved at once M (M - 1) / 2 rounded up to even
# + NT NR; IA: K^2 N^2 + 2 K Ns N rounded up to even, then for each user
# updated at once K Ns N + N (N - 1) / 2 rounded up to even), rounded up to
# 16 and 4 past it (the bank skew) with several elements a warp, to even
# with one; BD Lu lanes a user (a power of two, at least 4, at most 4 rows
# a lane) and U the fewest users whose warps leave room for 8 warps in
# 232,448 bytes; IA two rows a lane and 2 users; 4 warps a block while they
# fit in 232,448 bytes; 8 bytes an entry
BD_PLANS = {
    # (3, 1) forced wide: 9 + 6 -> 16, + (1 -> 2, + 3) = 21 -> 36, 1 user
    (3, 1, 1): _group(4, 128, 32, 32 * 36 * 8, 128),
    # (7, 2): 196 + 105 -> 302, + 66 + 28 = 396 -> 404, 1 user x 4 lanes
    # (8 warps of 8 elements: 206,848 bytes)
    (7, 2, 0): _group(4, 128, 32, 32 * 404 * 8, 128),
    # (8, 2): 256 + 136 = 392, + 2 x (91 -> 92, + 32) = 640 -> 644: one user
    # would take 8 x 34,304 bytes, so 2 users x 4 lanes
    (8, 2, 0): _group(8, 128, 16, 16 * 644 * 8, 256),
    # (11, 2): 484 + 253 -> 738, + 2 x (190 + 44) = 1206 -> 1220, 2 users
    # x 8 lanes (one: 8 x 31,360 bytes)
    (11, 2, 0): _group(16, 128, 8, 8 * 1220 * 8, 512),
    # (21, 1): 441 + 231 = 672, + 190 + 21 = 883 -> 900, 1 user x 8 lanes
    # (8 x 28,800 = 230,400 bytes)
    (21, 1, 0): _group(8, 128, 16, 16 * 900 * 8, 256),
}
IA_PLANS = {
    # (3, 4, 2): 144 + 48 = 192, + 2 x (24 + 6) = 252 -> 260, 2 users x 2
    # lanes (two rows a lane), 8 a warp
    (3, 4, 2): _group(4, 128, 32, 32 * 260 * 8, 128),
    # (4, 4, 2): 256 + 64 = 320, + 2 x (32 + 6) = 396 -> 404
    (4, 4, 2): _group(4, 128, 32, 32 * 404 * 8, 128),
    # (2, 3, 1): 36 + 12 = 48, + 2 x (6 + 3 -> 10) = 68 -> 84, 2 x 2 lanes
    (2, 3, 1): _group(4, 128, 32, 32 * 84 * 8, 128),
    # (14, 4, 2): 3,136 + 224 = 3,360, + 2 x (112 + 6) = 3,596 -> 3,604;
    # a warp 230,656 bytes: one a block, still in shared memory
    (14, 4, 2): _group(4, 32, 8, 8 * 3604 * 8, 512),
    # (15, 4, 2): 3,600 + 240 = 3,840, + 2 x (120 + 6) = 4,092 -> 4,100; a
    # warp 262,400 bytes: one a block, in the scratch buffer
    (15, 4, 2): _group(4, 32, 8, 0, 512, scratch=True),
}


@pytest.mark.parametrize("key", list(BD_PLANS))
def test_bd_launch_plan(key):
    K, NR, forced = key
    mc = MonteCarloBD(tile=8, lane=512, K=K, Nr_u=NR, device="cpu")
    if forced:
        source, defines = mc.geometry_build()
        mc.geometry_build = lambda: (source, {**defines, "MC_BD_WIDE": 1})
    assert bd_plan(mc) == BD_PLANS[key]


@pytest.mark.parametrize("geometry", list(IA_PLANS))
def test_ia_launch_plan(geometry):
    K, N, Ns = geometry
    mc = MonteCarloMaxSinr(tile=8, lane=512, K=K, N=N, Ns=Ns, device="cpu")
    assert ia_plan(mc) == IA_PLANS[geometry]


def test_launch_plans_of_the_other_forms():
    """The prebuilt BD form (and a geometry's library up to NT = 8), the IA
    closed body one element a thread, and a BD group's state past shared
    memory (one warp a block, the scratch buffer)."""
    tile = {"form": "tile", "lanes": 1, "threads": 128, "elems": 128,
            "scratch": False, "parts": 32}
    assert bd_plan(MonteCarloBD(tile=8, lane=512, K=3, Nr_u=2,
                                device="cpu")) == \
        {**tile, "shared_bytes": 36 * 128 * 8}
    assert bd_plan(MonteCarloBD(tile=8, lane=512, K=3, Nr_u=1,
                                device="cpu")) == \
        {**tile, "shared_bytes": 9 * 128 * 8}
    assert ia_plan(MonteCarloMaxSinr(tile=8, lane=512, K=3,
                                     device="cpu")) == \
        {**tile, "form": "thread", "shared_bytes": 0}
    assert ia_plan(MonteCarloMaxSinr(tile=8, lane=512, K=5,
                                     device="cpu")) == \
        {"form": "thread", "lanes": 1, "threads": 32, "elems": 32,
         "shared_bytes": 25 * 4 * 2 * 32 * 4, "scratch": False, "parts": 128}
    # K = 61, Nr_u = 2: 122^2 + 7,503 = 22,387 -> 22,388, + 7,140 + 244 =
    # 29,772 entries, 238,176 bytes an element: one a block, in the
    # scratch buffer (K = 60 still fits: 28,804 entries, 230,432 bytes)
    assert bd_plan(MonteCarloBD(tile=8, lane=512, K=61, Nr_u=2,
                                device="cpu")) == \
        _group(32, 32, 1, 0, 4096, scratch=True)
    assert bd_plan(MonteCarloBD(tile=8, lane=512, K=60, Nr_u=2,
                                device="cpu")) == \
        _group(32, 32, 1, 230432, 4096)
