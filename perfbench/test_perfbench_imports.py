"""What a run may load: nothing of JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` begins with
``repro``), and the references nothing of the program either."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from perfbench.run import FORBIDDEN, forbidden_modules

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

_DRY_RUN = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
from perfbench import bench
from perfbench.smoke import small_cell
r = bench.run(small_cell({cell!r}), 7, 0.2, {trace}, device="cpu")
assert r["correct"], r["checks"]
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_after(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_dry_run_loads_no_jax_and_no_repro():
    for cell, trace in (("glm4-9b.train-4k", True),
                        ("mamba2-1.3b.train-2k", False)):
        names = _top_level_after(_DRY_RUN.format(
            src=str(ROOT / "src"), root=str(ROOT), cell=cell, trace=trace))
        assert "repro_torch" in names and "perfbench" in names
        assert not names & set(FORBIDDEN), names & set(FORBIDDEN)


def test_the_check_compares_whole_names():
    assert forbidden_modules(["repro_torch", "repro_torch.train.step",
                              "jaxtyping", "flaxen", "torch"]) == []
    assert forbidden_modules(["repro.core", "jax.numpy", "jaxlib",
                              "flax.linen", "repro_torch"]) == \
        ["flax", "jax", "jaxlib", "repro"]


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_the_references_import_nothing_of_the_program():
    files = sorted((HERE / "reference").glob("*.py"))
    assert {f.name for f in files} >= {"common.py", "dense.py",
                                       "mamba2.py"}
    for f in files:
        assert _imports(f) <= {"__future__", "contextlib", "dataclasses",
                               "hashlib", "math", "typing", "torch",
                               "perfbench"}, f
    code = ("import sys, json\nsys.path[:0] = [{!r}]\n"
            "import perfbench.reference.dense, perfbench.reference.mamba2\n"
            "print(json.dumps(sorted({{m.split('.')[0] for m in "
            "sys.modules}})))").format(str(ROOT))
    names = _top_level_after(code)
    assert not names & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
