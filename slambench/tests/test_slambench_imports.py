"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the program. Module names are compared by their
whole top-level name (the part before the first dot): the port's name
begins with the JAX package's."""

import ast
import subprocess
import sys

from slambench.tests.conftest import ROOT

HARNESS = ["slambench.run", "slambench.trace", "slambench.stats", "slambench.roofline",
           "slambench.world", "slambench.drivers.reloc", "slambench.reference.strategy"]


def _loaded_top_levels(modules, extra=""):
    code = ("import sys; sys.path.insert(0, %r)\n" % str(ROOT)
            + "".join(f"import {m}\n" for m in modules) + extra
            + "print(sorted({n.split('.')[0] for n in sys.modules}))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       cwd=ROOT)
    assert p.returncode == 0, p.stderr
    return set(eval(p.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    from slambench import run

    readers = "".join(f"run.load_reader({m['name']!r})\n"
                      for m in run.load_benchmark()["per_layer"])
    loaded = _loaded_top_levels(HARNESS, "from slambench import run\n" + readers)
    assert "orbslam2_nmi_torch" in loaded  # the system under test
    assert not loaded & {"jax", "jaxlib", "flax", "orbslam2_nmi_tpu"}


def test_reference_loads_nothing_of_the_program():
    mods = [f"slambench.reference.{p.stem}" for p in (ROOT / "slambench" / "reference").glob("*.py")
            if p.stem != "__init__"]
    loaded = _loaded_top_levels(mods)
    assert not loaded & {"orbslam2_nmi_torch", "orbslam2_nmi_tpu", "jax", "jaxlib", "flax"}


def test_reference_sources_name_nothing_of_the_program():
    for p in (ROOT / "slambench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in {"orbslam2_nmi_torch", "orbslam2_nmi_tpu", "jax"}, p
