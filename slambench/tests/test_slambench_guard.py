"""The no-JAX check compares whole top-level module names, and what a run
imports loads none of JAX or the JAX package."""
import os
import subprocess
import sys

import pytest

from slambench.harness import guard

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.parametrize("names, found", [
    (["orb_slam2_tpu_torch", "orb_slam2_tpu_torch.pipeline.system"], []),
    (["orb_slam2_tpu"], ["orb_slam2_tpu"]),
    (["orb_slam2_tpu.pipeline", "numpy"], ["orb_slam2_tpu.pipeline"]),
    (["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen"],
     ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client"]),
    (["jaxtyping", "flax_like", "orb_slam2_tpu_extra", "torch"], []),
])
def test_whole_top_level_names(names, found):
    assert guard.forbidden_modules(names) == found


def test_a_run_imports_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import slambench.run\n"
        "from slambench.harness import spec, guard, faults\n"
        "b = spec.Bench(%r)\n"
        "for w in b.data['workloads']:\n"
        "    b.entry(b.traffic(w['traffic'])['entry'])\n"
        "    for m in b.metrics('per_layer', w['name']):\n"
        "        b.reader(m['name'])\n"
        "import importlib; importlib.import_module('slambench.tools.readings')\n"
        "print(guard.forbidden_modules())\n" % (ROOT, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from slambench.harness import reference, mapgen, counts, trace, spec\n"
            "print(sorted(n for n in sys.modules if n.split('.')[0].startswith('orb_slam2')"
            " or n.split('.')[0] in ('jax', 'jaxlib', 'flax')))\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
