"""The import guard compares whole top-level names, and nothing the harness
runs loads JAX or the JAX package."""
from __future__ import annotations

import subprocess
import sys

from litemat_bench.run import foreign_modules
from litemat_bench.spec import ROOT


def test_whole_top_level_names():
    assert foreign_modules(["repro_torch", "repro_torch.core", "jaxtyping",
                            "reproduce", "numpy"]) == []
    assert foreign_modules(["repro", "repro.core.engine", "jax.numpy",
                            "jaxlib", "flax.linen", "repro_torch"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core.engine"]


def test_harness_and_program_load_no_jax():
    code = (
        "import sys; sys.path.insert(0, 'src')\n"
        "import litemat_bench.run, litemat_bench.drive, litemat_bench.control\n"
        "import litemat_bench.reference.rdfs\n"
        "import repro_torch.core.engine, repro_torch.serving.runtime\n"
        "from litemat_bench.run import foreign_modules\n"
        "print(foreign_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    code = ("import sys\nimport litemat_bench.reference.rdfs\n"
            "import litemat_bench.checks\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('repro', 'repro_torch', 'jax')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
