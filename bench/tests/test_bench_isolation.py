"""What the benchmark loads: nothing of JAX, Flax or the JAX package
(top-level module names compared whole: the port's name begins with the
JAX package's), and a reference that imports nothing of the program."""

import ast
import subprocess
import sys

from harness import main, registry

BENCH = registry.BENCH

DRY_IMPORT = """
import sys
sys.path[:0] = [{bench!r}, {src!r}]
import torch
from harness import main, registry, trace, weights
runner = registry.module("runners", "train")
for family in ("moe", "hybrid"):
    registry.module("reference", family)
for name in registry.names("metrics", ".py"):
    registry.module("metrics", name)
for name in registry.names("roofline", ".py"):
    registry.module("roofline", name)
from repro_torch.configs import ARCHS
from repro_torch.models.model import init_params
from repro_torch.runtime.train_loop import make_train_step
from repro_torch.optim.adamw import OptConfig, init_opt_state
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_dry_import_loads_no_jax_nor_the_jax_package():
    code = DRY_IMPORT.format(bench=str(BENCH), src=str(BENCH.parent / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top
    assert not top & set(main.FORBIDDEN), top & set(main.FORBIDDEN)


def test_forbidden_names_compare_whole_top_level_names():
    sys.modules.setdefault("repro_torch_fake_probe", sys)
    try:
        assert "repro" not in main.forbidden_modules()
    finally:
        del sys.modules["repro_torch_fake_probe"]


def imported(path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    files = sorted((BENCH / "reference").glob("*.py"))
    assert files
    for f in files:
        names = imported(f)
        assert not names & {"repro_torch", "repro", "jax", "jaxlib", "flax",
                            "harness"}, (f.name, names)
        assert names <= {"torch", "math", "typing", "layers", "__future__"}, \
            (f.name, names)


def test_harness_imports_nothing_of_the_jax_side():
    for f in BENCH.rglob("*.py"):
        if "tests" in f.parts:
            continue
        assert not imported(f) & set(main.FORBIDDEN), f
