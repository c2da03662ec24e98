"""The rooflines count work from the calls' shapes alone: two traces of
the same calls read the same work, whatever kernels ran them."""

import pytest

from perfbench.harness import cells, work
from perfbench.harness.trace import Trace


def test_flagship_work_from_shapes():
    # the bench chunk on COST259-TU: 32 reps x 4 tiles x 1,024 symbols,
    # 16 taps x 16 rays, 300 bins
    flops = work.mc_flops(32, 4, 1024, 16, 16, 300)
    assert flops == 32 * 4 * 1024 * (8 * 16 * 300 + 2 * 256)
    assert work.mc_bytes(32, 4, 16, 300) == 8 * 16 * 300 + 4 * 128
    assert work.mc_least_seconds(32, 4, 1024, 16, 16, 300) == \
        pytest.approx(flops / 67e12)


def test_fir_work_from_shapes():
    offsets = [0, 4, 10, 43]
    assert work.fir_bytes(1024, 564, offsets) == \
        8 * 1024 * (564 + 4 + 564 + 43)
    assert work.fir_flops(1024, 564, 4) == 8 * 1024 * 564 * 4
    assert work.fir_least_seconds(1024, 564, offsets) == pytest.approx(
        max(work.fir_flops(1024, 564, 4) / 67e12,
            work.fir_bytes(1024, 564, offsets) / 3.35e12))


def _ctx(name, kernels, calls):
    bench = cells.load_benchmark()
    entry = cells.cell(bench, name)
    tr = Trace((0.0, 1e6), kernels, {})
    return cells.Context(entry, cells.workload(name),
                         cells.config(entry["config"]), {}, tr, calls)


@pytest.mark.parametrize("metric,cell,kernel", [
    ("kernel.roofline.mc_ofdm_tdl", "tu.bulk", "mc_ofdm_tdl_kernel<16>"),
    ("kernel.roofline.mc_ofdm_tdl", "exp250.bulk",
     "mc_ofdm_tdl_general_kernel"),
    ("kernel.roofline.block_fir", "tu.perkey", "block_fir_kernel")])
def test_roofline_reads_the_same_work_whatever_implements_it(metric, cell,
                                                              kernel):
    read = cells.reader(metric)
    calls = [32, 32, 16, 8, 4]
    one = _ctx(cell, [(kernel, 0.0, 1000.0)], calls)
    # another implementation: two launches a call, another name, the same
    # device time
    two = _ctx(cell, [(kernel + "_v2_part1", 0.0, 500.0),
                      (kernel + "_v2_part2", 600.0, 1100.0)], calls)
    assert read(one) == pytest.approx(read(two))
    # the work is the calls' shapes': twice the calls, twice the share
    assert read(_ctx(cell, [(kernel, 0.0, 1000.0)], calls * 2)) == \
        pytest.approx(2 * read(one))


def test_no_kernel_no_roofline():
    ctx = _ctx("tu.bulk", [("some_other_kernel", 0.0, 10.0)], [32])
    assert cells.reader("kernel.roofline.mc_ofdm_tdl")(ctx) is None
