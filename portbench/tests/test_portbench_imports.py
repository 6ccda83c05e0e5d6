"""Nothing the benchmark runs loads JAX or the JAX package (compared by
whole top-level module names: ``repro_torch`` is not ``repro``), and the
plain reference imports nothing of the system under test."""
import ast
import json
import os
import subprocess
import sys

from _tiny import ROOT

PROBE = r"""
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(imports: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = PROBE.format(root=str(ROOT), src=str(ROOT / "src"),
                        imports=imports)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = _top_level(
        "import portbench.run\n"
        "from portbench.harness import cell, spec, families, check\n"
        "from portbench.harness.cell import Program\n"
        "from repro_torch.launch.train import FederatedTrainer\n"
        "from repro_torch.launch.mesh import spawn\n"
        "from repro_torch.models import small, transformer, layers\n"
        "from repro_torch.core import client, round, server_opt\n"
        "from repro_torch.kernels.fedmom_update import ops\n"
        "for m in spec.load_benchmark()['per_layer']:\n"
        "    spec.reader(m['name'])\n")
    assert "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_reference_imports_nothing_of_the_system():
    mods = _top_level("from portbench.reference import lenet, moe_lm, "
                      "rounds, threefry, precision")
    assert not mods & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] in {"__future__", "math", "numpy",
                                           "torch", "contextlib"}, \
                    (path.name, n)
