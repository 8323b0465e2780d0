"""Nothing the benchmark runs loads JAX or the JAX package (top-level
names compared whole: the program's name begins with the JAX
package's), and the reference loads nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

from .tiny import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "voxblox_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(REPO, "mapbench", "reference",
                                       "*.py")):
        bad = _imports(path) & (FORBIDDEN | {"voxblox_tpu_torch", "mapbench"})
        assert not bad, (path, bad)
    code = ("import sys; sys.path.insert(0, %r); "
            "import mapbench.reference.tsdf, mapbench.reference.merged, "
            "mapbench.yardstick, mapbench.scene; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'voxblox_tpu_torch', 'voxblox_tpu', 'jax'}))" % REPO)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert p.stdout.strip() == "[]", p.stderr


def test_no_jax_after_a_run(tmp_path):
    """A whole tiny run on the CPU, in a fresh process: afterwards no
    module of JAX or the JAX package is loaded."""
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
import torch
from mapbench.tests import tiny
from mapbench import harness
harness.WINDOW_SCANS_MAX = 4
root = tiny.make_root({str(tmp_path)!r})
res, _ = tiny.run(root)
from mapbench import run
print("FORBIDDEN", run.forbidden_modules(), "voxblox_tpu_torch" in sys.modules)
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=900)
    line = [x for x in p.stdout.splitlines() if x.startswith("FORBIDDEN")]
    assert line == ["FORBIDDEN [] True"], p.stderr[-3000:]


def test_harness_sources_name_no_jax():
    for path in glob.glob(os.path.join(REPO, "mapbench", "**", "*.py"),
                          recursive=True):
        assert not (_imports(path) & FORBIDDEN), path
