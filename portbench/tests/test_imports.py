"""Nothing a run loads is JAX or the JAX package, by whole top-level name;
the reference loads nothing of the program."""

import subprocess
import sys

from portbench.run import forbidden_modules
from portbench.tests.conftest import ROOT


def test_top_level_names_compared_whole():
    bad = ["jax", "jax.numpy", "jaxlib", "jaxlib.xla_client", "flax",
           "flax.linen", "dspsr_tpu", "dspsr_tpu.ops.megakernel"]
    good = ["dspsr_tpu_torch", "dspsr_tpu_torch.ops.megakernel", "jaxtyping",
            "flaxen", "portbench", "dspsr", "torch"]
    assert forbidden_modules(bad + good) == sorted(bad)


def _run(code):
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    return p.stdout.strip().splitlines()[-1]


def test_a_run_loads_neither():
    code = (
        "import sys\n"
        "from portbench.run import run_cell, forbidden_modules\n"
        "from portbench.tests.conftest import tiny_cell\n"
        "run_cell(tiny_cell(), 5, 0.05, False, device='cpu')\n"
        "print(forbidden_modules(sys.modules),"
        " 'dspsr_tpu_torch' in sys.modules)\n")
    assert _run(code) == "[] True"


def test_reference_loads_nothing_of_the_program():
    code = (
        "import sys\n"
        "import portbench.reference.filterbank, portbench.reference.fold\n"
        "import portbench.work\n"
        "print(sorted(n for n in sys.modules if n.split('.')[0] in"
        " ('dspsr_tpu_torch', 'dspsr_tpu', 'jax')))\n")
    assert _run(code) == "[]"
