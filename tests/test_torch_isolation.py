"""The port stands alone: importing it loads neither JAX nor the JAX
package, and no module of it (nor ``chip_smoke.py`` or ``tools/*.py``)
imports either."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_import(path):
    assert not imported_roots(path) & set(FORBIDDEN)


def test_import_leaves_jax_and_reference_unloaded():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels.ops\n"
        "import repro_torch.kernels.build, repro_torch.kernels.ref\n"
        "import repro_torch.core.convert, repro_torch.online\n"
        "import repro_torch.faults, repro_torch.search\n"
        "import repro_torch.kernels.sched_score\n"
        "import repro_torch.configs, repro_torch.models\n"
        "import repro_torch.runtime, repro_torch.launch\n"
        "import repro_torch.launch.serve, repro_torch.models.convert\n"
        "import repro_torch.kernels.rmsnorm, repro_torch.kernels.flash_attention\n"
        "import repro_torch.kernels.flash_decode\n"
        "import repro_torch.kernels.ssd_scan, repro_torch.models.ssm\n"
        "import repro_torch.analysis, repro_torch.analysis.verify\n"
        "import repro_torch.analysis.ir_lint, repro_torch.search.device\n"
        "import repro_torch.analysis.lint, repro_torch.analysis.tracecheck\n"
        "import repro_torch.analysis.entrypoints\n"
        "import repro_torch.core.executor, repro_torch.models.moe\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
