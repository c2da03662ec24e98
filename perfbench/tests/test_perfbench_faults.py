"""The check of ``correct`` at the cells' own limits: the control (the
program's lower-precision path) and each fault a cell can have, planted
underneath the timed path, come out as not correct; the sound run as
correct. Tiny CPU versions of the cells: the harness's look for a card is
skipped, the rest of a run is driven."""

import pytest

from perfbench.tests import tiny

BULK_FAULTS = [tiny.bulk_state_unchanged, tiny.bulk_half_batch,
               tiny.bulk_answer_altered]
PERKEY_FAULTS = [tiny.perkey_state_unchanged, tiny.perkey_half_batch,
                 tiny.perkey_answer_altered]


@pytest.fixture(autouse=True)
def _restore_program():
    """The faults patch the program's classes in this process: put them
    back after each test."""
    from pyphysim_tpu_torch.chain import ChainStep
    from pyphysim_tpu_torch.ops.mc_kernel import MonteCarloOfdmTdl
    saved = (MonteCarloOfdmTdl.build, ChainStep.step)
    yield
    MonteCarloOfdmTdl.build, ChainStep.step = saved


@pytest.mark.parametrize("cell", ["tu.bulk", "exp250.bulk", "tu.perkey"])
def test_sound_run_is_correct(cell):
    res = tiny.run_tiny(cell)
    assert res["correct"], res["compare"]


@pytest.mark.parametrize("cell", ["tu.bulk", "exp250.bulk", "tu.perkey"])
def test_control_is_not_correct(cell):
    from perfbench.harness import cells
    wl = cells.workload(cell)
    res = tiny.run_tiny(cell, dtype=wl["control_dtype"], seconds=0.1)
    assert not res["correct"], res["compare"]


@pytest.mark.parametrize("fault", BULK_FAULTS, ids=lambda f: f.__name__)
def test_bulk_fault_is_not_correct(fault):
    fault()
    res = tiny.run_tiny("tu.bulk", seconds=0.1)
    assert not res["correct"], res["compare"]


@pytest.mark.parametrize("fault", PERKEY_FAULTS, ids=lambda f: f.__name__)
def test_perkey_fault_is_not_correct(fault):
    fault()
    res = tiny.run_tiny("tu.perkey", seconds=0.1)
    assert not res["correct"], res["compare"]


@pytest.mark.parametrize("cell,fault", [
    ("tu.bulk", None), ("tu.bulk", tiny.bulk_state_unchanged),
    ("tu.perkey", None), ("tu.perkey", tiny.perkey_answer_altered)])
def test_traffic_without_a_stop_rule(cell, fault):
    """``"stop": null`` in a traffic file: every point runs rep_max
    attempts (speculative dispatch on), judged by the same replay."""
    if fault is not None:
        fault()
    res = tiny.run_tiny(cell, seconds=0.1, stop=None)
    assert res["correct"] == (fault is None), res["compare"]
