"""Nothing the harness runs loads JAX or the JAX package, compared by whole
top-level name, and the reference loads nothing of the program."""

import subprocess
import sys

from portbench import cell as cells

HARNESS = """
import sys
from portbench import adapt, calibrate, cell, run, trace
c = cell.load_cell("trend_rff.hmc_n65536", cfg_overrides={"n": 512, "rff_features": 16,
                   "m_total": 32}, traffic_overrides={"chains": 2, "leapfrogs": 2})
inp = cell.make_inputs(c, 3, "cpu")
prog = cell.build_program(c, inp, 3, "cpu")
cell.drive(prog, 0.0, "cpu", max_transitions=1)
for p in sorted((cell.ROOT / "metrics").glob("*.py")):
    cell.load_module(p)
print(",".join(sorted(sys.modules)))
"""

REFERENCE = """
import sys
from portbench import cell, peaks, reference
for p in sorted((cell.ROOT / "configs").glob("*.py")):
    cell.load_module(p)
print(",".join(sorted(sys.modules)))
"""


def _modules(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], cwd=cells.REPO, capture_output=True,
                         text=True, timeout=300, check=True)
    return out.stdout.strip().splitlines()[-1].split(",")


def test_forbidden_modules_compares_whole_top_level_names():
    assert cells.forbidden_modules(["gaplac_tpu_torch", "gaplac_tpu_torch.ops",
                                    "jaxtyping", "flaxen"]) == []
    assert cells.forbidden_modules(["gaplac_tpu", "gaplac_tpu.ops", "jax", "jaxlib.xla",
                                    "flax"]) == ["flax", "gaplac_tpu", "gaplac_tpu.ops",
                                                 "jax", "jaxlib.xla"]


def test_harness_and_program_load_no_jax():
    mods = _modules(HARNESS)
    assert "gaplac_tpu_torch" in mods
    assert cells.forbidden_modules(mods) == []


def test_reference_loads_nothing_of_the_program():
    mods = _modules(REFERENCE)
    assert not [m for m in mods if m.split(".")[0] == "gaplac_tpu_torch"]
    assert cells.forbidden_modules(mods) == []
