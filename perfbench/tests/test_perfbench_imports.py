"""Nothing a run loads has the top-level name jax, jaxlib, flax or
pyphysim_tpu (compared whole: pyphysim_tpu_torch passes), and the plain
reference imports nothing of the program."""

import json
import subprocess
import sys

from perfbench import run
from perfbench.tests.conftest import ROOT


def test_top_level_names_are_compared_whole():
    assert run.forbidden_modules(["pyphysim_tpu_torch",
                                  "pyphysim_tpu_torch.ops.mc_kernel",
                                  "jax_like", "numpy"]) == []
    assert run.forbidden_modules(["pyphysim_tpu.ops", "jaxlib.xla_client",
                                  "flax", "jax"]) == [
        "flax", "jax", "jaxlib", "pyphysim_tpu"]


_RUN = """
import json, sys
sys.path.insert(0, {root!r})
from perfbench.tests.tiny import run_tiny
run_tiny("tu.bulk", trace=True)
run_tiny("tu.perkey")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

_REF = """
import json, sys
sys.path.insert(0, {root!r})
import perfbench.reference.flagship, perfbench.reference.engine
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_names(code):
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    names = _top_level_names(_RUN)
    assert "pyphysim_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "pyphysim_tpu"}


def test_the_reference_imports_nothing_of_the_program():
    names = _top_level_names(_REF)
    assert not names & {"pyphysim_tpu_torch", "pyphysim_tpu", "jax",
                        "apps"}
