"""The port's AST lint against the reference's, and its torch device
scope: the reference's ``deprecated-api`` and ``frozen-mutation``
snippets give the same (rule, line) in both packages with the paths
mapped from ``src/repro`` to ``src/repro_torch``; ``host-sync`` and
``dtype-promotion`` fire on torch code inside the device scope only, and
pragmas silence them; ``python -m repro_torch.analysis.lint`` is clean on
the port's tree and fails on a planted ``.item()``."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis.lint import lint_source as ref_lint_source
from repro_torch.analysis import lint as port_lint
from repro_torch.analysis.lint import lint_source

ROOT = Path(__file__).resolve().parents[1]


def rules(out):
    return sorted((v.rule, v.line) for v in out)


def port_path(path):
    return path.replace("src/repro/", "src/repro_torch/")


# ---------------------------------------------------------------------------
# parity: the reference's snippets (tests/test_analysis.py), paths mapped
# ---------------------------------------------------------------------------

DEPRECATED_IMPORT = "from repro.core.engine import comm_matrices\n"
DEPRECATED_ATTRS = ("from repro.core import engine\n"
                    "from repro.kernels import sched_ref\n"
                    "M = engine.comm_matrices(g, m)\n"
                    "D = sched_ref.drain_matrix(batch)\n")
FROZEN = "object.__setattr__(obj, 'cache', 1)\n"

PARITY = [
    ("deprecated-import", DEPRECATED_IMPORT, "src/repro/foo.py"),
    ("deprecated-pragma",
     DEPRECATED_IMPORT.rstrip() + "  # lint: deprecated-ok\n",
     "src/repro/foo.py"),
    ("deprecated-definer", DEPRECATED_IMPORT, "src/repro/core/engine.py"),
    ("deprecated-attrs", DEPRECATED_ATTRS, "benchmarks/bench.py"),
    ("frozen-outside", FROZEN, "src/repro/search/ga.py"),
    ("frozen-pragma", FROZEN.rstrip() + "  # lint: frozen-ok\n",
     "src/repro/search/ga.py"),
    *[(f"frozen-allowed-{m}", FROZEN, f"src/repro/{m}")
      for m in ("core/lowering.py", "core/sim_engine.py",
                "faults/script.py", "search/encoding.py")],
]


@pytest.mark.parametrize("src,path", [p[1:] for p in PARITY],
                         ids=[p[0] for p in PARITY])
def test_lint_rules_match_the_reference(src, path):
    want = rules(ref_lint_source(src, path))
    assert rules(lint_source(src, port_path(path))) == want


def test_parity_snippets_fire_where_the_reference_does():
    assert rules(lint_source(DEPRECATED_IMPORT, "src/repro_torch/foo.py")) \
        == [("deprecated-api", 1)]
    assert rules(lint_source(DEPRECATED_ATTRS, "benchmarks/bench.py")) \
        == [("deprecated-api", 3), ("deprecated-api", 4)]
    assert rules(lint_source(FROZEN, "src/repro_torch/search/ga.py")) \
        == [("frozen-mutation", 1)]


# ---------------------------------------------------------------------------
# the torch device scope
# ---------------------------------------------------------------------------

SYNCS = textwrap.dedent("""\
    import random
    import numpy as np
    import torch

    def step(x, n: int, flag, y):
        a = x.item()
        b = x.tolist()
        c = x.cpu()
        d = x.numpy()
        torch.cuda.synchronize()
        e = float(flag)
        f = int(n)
        g = bool(y)
        h = np.random.rand()
        i = random.random()
        return x.sum()
    """)
SYNC_LINES = [6, 7, 8, 9, 10, 11, 13, 14, 15]   # int(n): a host int


@pytest.mark.parametrize("path,scoped", [
    ("src/repro_torch/kernels/x.py", True),
    ("src/repro_torch/models/x.py", True),
    ("src/repro_torch/search/device.py", True),
    ("src/repro_torch/search/ga.py", False),
    ("src/repro_torch/online/policies.py", False),
    ("chip_smoke.py", False),
])
def test_host_sync_fires_in_the_device_scope_only(path, scoped):
    got = rules(lint_source(SYNCS, path))
    assert got == ([("host-sync", n) for n in SYNC_LINES] if scoped else [])


def test_host_sync_in_a_module_forward_anywhere_in_the_port():
    src = textwrap.dedent("""\
        import torch.nn as nn

        class Head(nn.Module):
            def forward(self, x):
                return x.item()

            def describe(self, x):
                return x.item()

        class Plain:
            def forward(self, x):
                return x.item()
        """)
    assert rules(lint_source(src, "src/repro_torch/online/x.py")) \
        == [("host-sync", 5)]


def test_nested_functions_are_in_their_holders_scope():
    src = textwrap.dedent("""\
        def outer(x):
            def inner(t):
                return float(t)
            return inner(x)
        """)
    assert rules(lint_source(src, "src/repro_torch/kernels/x.py")) \
        == [("host-sync", 3)]


F64 = textwrap.dedent("""\
    import numpy as np
    import torch

    def widen(x):
        a = x.to(torch.float64)
        b = x.to(torch.double)
        c = np.float64(2.0)
        d = torch.zeros(3, dtype="float64")
        e = x.double()
        f = x.to(torch.float32)
        g = x.double()  # lint: dtype-ok
        return a, b, c, d, e, f, g
    """)


def test_dtype_promotion_in_and_out_of_the_device_scope():
    assert rules(lint_source(F64, "src/repro_torch/models/x.py")) \
        == [("dtype-promotion", n) for n in (5, 6, 7, 8, 9)]
    assert lint_source(F64, "src/repro_torch/core/lowering.py") == []


def test_sync_pragma_silences_only_its_own_rule():
    src = ("def f(x):\n"
           "    return x.item()  # lint: sync-ok the result\n"
           "def g(x):\n"
           "    return x.item()  # lint: dtype-ok\n")
    assert rules(lint_source(src, "src/repro_torch/kernels/x.py")) \
        == [("host-sync", 4)]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_the_ports_tree_is_lint_clean():
    bad = port_lint.lint_paths(port_lint.default_paths())
    assert bad == [], "\n".join(str(v) for v in bad)
    assert port_lint.main([]) == 0


def test_cli_fails_on_a_planted_item(tmp_path):
    bad = tmp_path / "src" / "repro_torch" / "kernels" / "planted.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("def read(x):\n    return x.item()\n")
    assert port_lint.main([str(bad)]) == 1
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", str(bad)],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                       "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 1
    assert f"{bad}:2: host-sync" in out.stdout
    clean = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                       "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120)
    assert clean.returncode == 0, clean.stdout
