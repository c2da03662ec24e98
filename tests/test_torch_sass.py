"""The SASS instruction counter (``pyphysim_tpu_torch/ops/sass.py``) on a
listing written in ``cuobjdump -sass``'s format with every shape the
counting rules name: the slow path of a 64-bit integer division (if /
else) and of an f32 division (if only), a loop, an ``erfinvf`` tail, the
out-of-line routines after the last ``EXIT``, and the final self-branch;
and a listing of two loops with trip counts of their own. The real listings come from the card's build (``chip_smoke.py``)."""

import subprocess

import pytest

from pyphysim_tpu_torch.ops import sass
from pyphysim_tpu_torch.ops.alamouti_kernel import MonteCarloAlamouti
from pyphysim_tpu_torch.ops.bd_kernel import MonteCarloBD

_BODY = [
    (0x000, "", "S2R R0, SR_TID.X"),
    (0x010, "", "UIADD3 UR4, UR4, 0x1, URZ"),
    (0x020, "", "ISETP.NE.U32.AND P0, PT, R4, RZ, PT"),
    (0x030, "@!P0", "BRA 0x70"),              # int64 division: fast at 0x70
    (0x040, "", "MOV R0, 0x60"),
    (0x050, "", "CALL.REL.NOINC 0x1b0"),
    (0x060, "", "BRA 0x90"),
    (0x070, "", "IMAD.HI.U32 R5, R3, R4, RZ"),
    (0x080, "", "IADD3 R5, R5, 0x1, RZ"),
    (0x090, "", "FFMA R2, R2, R3, R4"),       # loop head
    (0x0a0, "", "MUFU.LG2 R6, R2"),
    (0x0b0, "", "FSETP.GEU.AND P1, PT, R6, -8.1999998092651367188, PT"),
    (0x0c0, "@!P1", "BRA 0x100"),
    (0x0d0, "", "FFMA R7, -R6, R8, 0.88622689247131347656"),
    (0x0e0, "", "FMUL R7, R2, R7"),
    (0x0f0, "", "BRA 0x120"),
    (0x100, "", "MUFU.RSQ R9, -R6"),          # erfinvf tail
    (0x110, "", "FMUL R7, R9, R2"),
    (0x120, "", "LOP3.LUT R10, R10, R7, RZ, 0x96, !PT"),
    (0x130, "", "ISETP.GE.AND P2, PT, R11, UR5, PT"),
    (0x140, "@!P2", "BRA 0x90"),              # loop back
    (0x150, "", "FCHK P0, R11, R8"),
    (0x160, "@!P0", "BRA 0x190"),             # f32 division, if only
    (0x170, "", "MOV R21, 0x190"),
    (0x180, "", "CALL.REL.NOINC 0x1d0"),
    (0x190, "", "STG.E desc[UR4][R2.64], R7"),
    (0x1a0, "", "EXIT"),
    (0x1b0, "", "SHF.L.U32 R4, R4, 0x1, RZ"),
    (0x1c0, "", "RET.REL.NODEC R20 0x0"),
    (0x1d0, "", "IADD3 R4, R4, 0x1, RZ"),
    (0x1e0, "", "RET.REL.NODEC R21 0x0"),
    (0x1f0, "", "BRA 0x1f0"),
    (0x200, "", "NOP"),
]


def _listing(body):
    lines = ['\t.headerflags\t@"EF_CUDA_SM90"']
    for addr, pred, text in body:
        lines.append(f"        /*{addr:04x}*/  {pred:>14s} {text} ;"
                     f"      /* 0x000fe20000000f00 */")
        lines.append("                                  "
                     "/* 0x000fc40000000000 */")
    return "\n".join(lines)


def test_counts_follow_the_rules():
    """Loop x3, the erfinvf tail x3p, both division slow paths and the
    routines after EXIT x0 (see the listing's comments)."""
    p = sass.ERFINV_TAIL
    got = sass.pipe_counts(_listing(_BODY), loop_trips=3, loops=1)
    want = {"fp32": 9 + 3 * p, "imad": 1, "alu": 12, "xu": 3 + 3 * p,
            "uniform": 1, "other": 14}
    want["total"] = sum(want.values())
    assert got == pytest.approx(want, rel=1e-12)


_TWO_LOOPS = [
    (0x000, "", "S2R R0, SR_TID.X"),
    (0x010, "", "FFMA R2, R2, R3, R4"),       # loop 1 head
    (0x020, "", "IADD3 R5, R5, 0x1, RZ"),
    (0x030, "", "ISETP.GE.AND P0, PT, R5, UR4, PT"),
    (0x040, "@!P0", "BRA 0x10"),              # loop 1 back
    (0x050, "", "FMUL R6, R6, R2"),           # loop 2 head
    (0x060, "", "MUFU.EX2 R6, R6"),
    (0x070, "", "ISETP.GE.AND P1, PT, R7, UR5, PT"),
    (0x080, "@!P1", "BRA 0x50"),              # loop 2 back
    (0x090, "", "STG.E desc[UR4][R2.64], R6"),
    (0x0a0, "", "EXIT"),
    (0x0b0, "", "BRA 0xb0"),
]


@pytest.mark.parametrize("trips, a, b", [
    ([3, 7], 3, 7),          # one trip count per loop, in listing order
    ((0.8, 2.5), 0.8, 2.5),  # fractional: a mean over the threads
    (4, 4, 4),               # a scalar: every loop
])
def test_trips_per_loop(trips, a, b):
    got = sass.pipe_counts(_listing(_TWO_LOOPS), loop_trips=trips, loops=2)
    want = {"fp32": a + b, "imad": 0, "alu": 2 * a + b, "xu": b,
            "uniform": 0, "other": a + b + 3}
    want["total"] = sum(want.values())
    assert got == pytest.approx(want, rel=1e-12)


def test_trips_per_loop_must_match_the_loops():
    with pytest.raises(ValueError, match="3 trip counts for 2 loops"):
        sass.pipe_counts(_listing(_TWO_LOOPS), loop_trips=[1, 2, 3], loops=2)


def test_erfinv_tail_is_the_uniform_tail_probability():
    # |x| > sqrt(1 - 2^-8.2) for x uniform on (-1, 1)
    assert sass.ERFINV_TAIL == pytest.approx(1.70174e-3, rel=1e-5)


@pytest.mark.parametrize("change, match", [
    ({}, "loops"),                                     # loops=0 below
    ({0x160: ("", "NOP")}, "common path"),             # no range check
    ({0x1f0: ("", "NOP")}, "self-branch"),
    ({0x0c0: ("@!P3", "BRA 0x100")}, "erfinvf split"),
])
def test_unexpected_listings_raise(change, match):
    body = [(a, *change.get(a, (p, t))) for a, p, t in _BODY]
    loops = 0 if not change else 1
    with pytest.raises(ValueError, match=match):
        sass.pipe_counts(_listing(body), loop_trips=3, loops=loops)


@pytest.mark.parametrize("counts, limit, per_thread", [
    ({"other": 128}, "issue", 1.0),
    ({"alu": 100}, "alu", 100 / 64),
    ({"fp32": 100, "alu": 60}, "issue", 160 / 128),
    ({"imad": 100}, "fmaheavy", 100 / 64),
    ({"xu": 10}, "xu", 10 / 16),
])
def test_issue_bound(counts, limit, per_thread):
    full = dict.fromkeys(("fp32", "imad", "alu", "xu", "uniform", "other"),
                         0.0)
    full.update(counts)
    full["total"] = sum(counts.values())
    threads = 1 << 20
    ms, got = sass.issue_bound_ms(full, threads)
    assert got == limit
    assert ms == pytest.approx(
        threads * per_thread / (sass.SMS * sass.CLOCK_HZ) * 1e3, rel=1e-12)


def test_function_sass_picks_one_kernel(monkeypatch, tmp_path):
    text = ("\tcode for sm_90a\n"
            "\t\tFunction : _ZN2ns12mc_bd_kernelILi3ELi2ELi0ELb0EEEvNS_6P\n"
            "A\n"
            "\t\tFunction : _ZN2ns12mc_bd_kernelILi3ELi2ELi1ELb0EEEvNS_6P\n"
            "B\n")
    monkeypatch.setattr(sass, "_cuobjdump", lambda: "cuobjdump")
    monkeypatch.setattr(
        sass.subprocess, "run",
        lambda *a, **k: subprocess.CompletedProcess(a, 0, stdout=text))
    lib = tmp_path / "lib.so"
    assert sass.function_sass(lib, "ILi3ELi2ELi1ELb0EE").strip() == "B"
    with pytest.raises(RuntimeError, match="2 kernels"):
        sass.function_sass(lib, "mc_bd_kernel")


def test_kernel_profiles():
    ala = MonteCarloAlamouti(tile=64, lane=256, device="cpu")
    assert ala.prng_kernel_profile(512, 4) == {
        "pattern": "mc_alamouti_kernelILb0EE", "threads": 512 * 4 * 2 * 256,
        "loops": 0, "loop_trips": 1}
    bd = MonteCarloBD(tile=8, lane=512, K=2, Nr_u=1, mode="none",
                      device="cpu")
    assert bd.prng_kernel_profile(128, 4) == {
        "pattern": "mc_bd_kernelILi2ELi1ELi2ELb0EE",
        "threads": 128 * 4 * 8 * 512, "loops": 5,
        "loop_trips": [2, 2, 2, 2, 2]}


def _bd_shape(users):
    """A listing of the BD kernel's shape: the Philox calls that store a
    thread's channel to shared memory, then the users (unrolled), each with
    two passes over the columns of H around its solve; then the block's
    reduction, whose shuffles have an out-of-line fallback for a diverged
    warp that jumps back to the join."""
    body = [
        (0x000, "", "S2R R0, SR_TID.X"),
        (0x010, "", "ISETP.GE.AND P0, PT, R0, UR4, PT"),
        (0x020, "", "IMAD R2, R3, 0x80, R0"),         # the element
        (0x030, "", "IMAD.HI.U32 R5, R2, R3, RZ"),    # Philox loop head
        (0x040, "", "LOP3.LUT R6, R5, R7, RZ, 0x96, !PT"),
        (0x050, "", "STS.64 [R4], R6"),
        (0x060, "", "ISETP.NE.AND P1, PT, R5, UR5, PT"),
        (0x070, "@P1", "BRA 0x30"),                   # Philox loop back
    ]
    for u in range(users):
        a = 0x080 + 0x80 * u
        body += [
            (a, "", "LDS.64 R8, [R4]"),               # column pass 1 head
            (a + 0x10, "", "FFMA R10, R8, R9, R10"),
            (a + 0x20, "@P2", f"BRA {a:#x}"),         # column pass 1 back
            (a + 0x30, "", "MUFU.RCP R11, R10"),      # the solve
            (a + 0x40, "", "LDS.64 R8, [R4+0x400]"),  # column pass 2 head
            (a + 0x50, "", "FMUL R13, R8, R11"),
            (a + 0x60, "@P3", f"BRA {a + 0x40:#x}"),  # column pass 2 back
            (a + 0x70, "", "FSEL R14, R13, R14, P4"),
        ]
    a = 0x080 + 0x80 * users
    return body + [
        (a, "", "MUFU.LG2 R15, R14"),                 # capacities
        (a + 0x10, "", f"BRA.DIV UR6, {a + 0x60:#x}"),
        (a + 0x20, "", "SHFL.DOWN PT, R12, R10, 0x10, 0x1f"),
        (a + 0x30, "", "BAR.SYNC.DEFER_BLOCKING 0x0"),  # join
        (a + 0x40, "", "STG.E desc[UR4][R2.64], R12"),
        (a + 0x50, "", "EXIT"),
        (a + 0x60, "", f"WARPSYNC.COLLECTIVE R6, {a + 0x80:#x}"),  # fallback
        (a + 0x70, "", "SHFL.DOWN P0, R4, R7, R8, R9"),
        (a + 0x80, "", f"BRA {a + 0x30:#x}"),         # back to the join
        (a + 0x90, "", f"BRA {a + 0x90:#x}"),
    ]


def test_bd_profile_counts_a_listing_of_its_shape():
    """The BD profile's loops run their trips in listing order (Philox
    calls, two column passes a user), the threads are the launch's, one a
    solve, and the shuffle fallback's jump back after the ``EXIT`` is no
    loop and counts 0."""
    profile = MonteCarloBD(tile=8, lane=512,
                           device="cpu").prng_kernel_profile(128, 4)
    C, N, K = 2 * 6 * 6 // 4, 6, 3
    assert profile["loops"] == 2 * K + 1
    assert profile["loop_trips"] == [C] + [N] * (2 * K)
    assert profile["threads"] == 128 * 4 * 8 * 512
    listing = _listing(_bd_shape(K))
    counts = sass.pipe_counts(listing, profile["loop_trips"],
                              profile["loops"])
    want = {"fp32": 2 * K * N, "imad": 1 + C, "alu": 1 + 2 * C + K,
            "xu": K + 1, "uniform": 0, "other": 6 + 2 * C + 4 * K * N}
    want["total"] = sum(want.values())
    assert counts == pytest.approx(want, rel=1e-12)
    ms, limit = sass.issue_bound_ms(counts, profile["threads"])
    assert limit == "issue"
    assert ms == pytest.approx(profile["threads"] * want["total"] / (
        128 * sass.SMS * sass.CLOCK_HZ) * 1e3, rel=1e-12)
    with pytest.raises(ValueError, match="loops"):
        sass.pipe_counts(listing, profile["loop_trips"], profile["loops"] + 1)
