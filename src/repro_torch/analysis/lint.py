"""AST-based repo lint: rules specific to the port's hot paths.

Generic linters cannot know which of the port's functions run on the
card between kernel launches, that the lowering dataclasses are frozen
*contracts* with exactly four sanctioned cache-mutation modules, or that
``engine.comm_matrices`` / ``sched_ref.drain_matrix`` are the reference's
deprecated aliases. This module does. Rules:

* **The torch device scope.** PyTorch runs eagerly, so there is no
  ``jit`` to key a scope on (the reference's lint keys on ``jax.jit`` and
  ``pallas_call``). The port's device scope is every function of
  ``repro_torch/kernels/``, ``repro_torch/models/`` and
  ``repro_torch/search/device.py`` (the kernels' wrappers, the model
  stack, the device GA: the code that launches work on the card), plus
  every ``forward`` of an ``nn.Module`` subclass anywhere in the port.
  Nested functions are scanned with the function that holds them.
* ``host-sync`` — inside the device scope: ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize()``, and
  ``float()/int()/bool()`` on a parameter (not one annotated as a
  Python scalar) — each waits for the card to drain its stream, and
  each stops the scope from being captured in a CUDA graph; host RNG
  (``np.random``, stdlib ``random``), which cannot run on the card
  either.
* ``frozen-mutation`` — ``object.__setattr__`` (the only way to write
  a frozen lowering dataclass) outside the sanctioned cache modules
  (``repro_torch/core/lowering.py``, ``core/sim_engine.py``,
  ``faults/script.py``, ``search/encoding.py``).
* ``deprecated-api`` — importing or calling the deprecated
  ``engine.comm_matrices`` / ``sched_ref.drain_matrix`` aliases
  anywhere but their defining modules: callers use ``core.lowering``
  (the port carries neither alias).
* ``dtype-promotion`` — inside the device scope: ``torch.float64`` /
  ``torch.double`` / ``np.float64`` (and the complex128 names),
  ``dtype="float64"`` strings and ``.double()``: float64 on the card runs
  at a small fraction of the float32 rate, and one such value widens
  every float it meets. The trace-level twin of this rule lives in
  :mod:`repro_torch.analysis.tracecheck` (pass 4) — this one fires at
  review time, that one on the ops a call really runs.

Suppress a finding by appending ``# lint: <rule>-ok`` to its line
(rules map to ``deprecated-ok`` / ``sync-ok`` / ``frozen-ok`` /
``dtype-ok``), with a few words on why.
Runnable as ``python -m repro_torch.analysis.lint`` over
``src/repro_torch``, ``tests/test_torch_*.py``, ``chip_smoke.py`` and
``tools/`` — exit 1 on any violation.
"""

from __future__ import annotations

import ast
import sys
from dataclasses import dataclass
from pathlib import Path

__all__ = ["LintViolation", "lint_file", "lint_paths", "lint_source",
           "main"]

#: deprecated alias -> the module basename that is allowed to define it
_DEPRECATED = {"comm_matrices": "engine", "drain_matrix": "sched_ref"}

#: modules whose ``object.__setattr__`` cache writes are the sanctioned
#: mutation sites for frozen lowering/fault containers
_FROZEN_ALLOW = ("repro_torch/core/lowering.py",
                 "repro_torch/core/sim_engine.py",
                 "repro_torch/faults/script.py",
                 "repro_torch/search/encoding.py")

#: modules whose every function is device scope (prefixes are packages)
_DEVICE_MODULES = ("repro_torch/kernels/", "repro_torch/models/",
                   "repro_torch/search/device.py")

_PRAGMA = {"deprecated-api": "deprecated-ok", "host-sync": "sync-ok",
           "frozen-mutation": "frozen-ok",
           "dtype-promotion": "dtype-ok"}

#: zero-argument tensor methods that copy to the host and wait for it
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")

#: float64 / complex128 dtype names
_F64_NAMES = ("torch.float64", "torch.double", "torch.complex128",
              "np.float64", "numpy.float64", "np.double", "numpy.double",
              "np.complex128", "numpy.complex128")


@dataclass(frozen=True)
class LintViolation:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.message}"


def _dotted(node: ast.AST) -> str:
    """``a.b.c`` for a Name/Attribute chain, '' for anything else."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _param_names(fn: ast.FunctionDef) -> set[str]:
    a = fn.args
    names = {p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)}
    if a.vararg:
        names.add(a.vararg.arg)
    if a.kwarg:
        names.add(a.kwarg.arg)
    return names


def _scalar_params(fn: ast.FunctionDef) -> set[str]:
    """Parameters annotated as Python scalars (``bool``, ``int``,
    ``float``, optionally ``| None``): host values, whose ``int()`` is no
    sync."""
    a = fn.args
    out = set()
    for p in a.posonlyargs + a.args + a.kwonlyargs:
        names = {n.id for n in ast.walk(p.annotation)
                 if isinstance(n, ast.Name)} if p.annotation else set()
        if names and names <= {"bool", "int", "float", "None"}:
            out.add(p.arg)
    return out


def _is_module_class(cls: ast.ClassDef) -> bool:
    return any(_dotted(b) in ("nn.Module", "torch.nn.Module", "Module")
               for b in cls.bases)


def _device_functions(tree: ast.Module, whole_module: bool
                      ) -> list[ast.FunctionDef]:
    """The outermost functions of the device scope: every top-level
    function and method of a device module, or else each ``forward`` of
    an ``nn.Module`` subclass."""
    fns: list[ast.FunctionDef] = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if whole_module:
                fns.append(node)
        elif isinstance(node, ast.ClassDef):
            module_class = _is_module_class(node)
            for item in node.body:
                if not isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                if whole_module or (module_class and item.name == "forward"):
                    fns.append(item)
    return fns


def _scan_device_scope(fn: ast.FunctionDef, emit) -> None:
    """Flag host syncs and float64 anywhere inside a device function
    (nested defs run in the same scope, so they are scanned too — their
    parameters join the set that ``float()`` and friends may not read)."""
    params: set[str] = set()
    inner: set[int] = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            params |= _param_names(node) - _scalar_params(node)
        elif isinstance(node, ast.Lambda):
            params |= _param_names(node)
        elif isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Attribute):
            inner.add(id(node.value))   # report only the outermost chain
    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute) and id(node) not in inner:
            chain = _dotted(node)
            if chain.startswith(("np.random.", "numpy.random.",
                                 "random.")) or \
                    chain in ("np.random", "numpy.random"):
                emit(node.lineno, "host-sync",
                     f"host RNG `{chain}` in device-scope `{fn.name}` — it "
                     f"runs on the host; draw from a torch.Generator on "
                     f"the tensors' device")
            elif chain in _F64_NAMES:
                emit(node.lineno, "dtype-promotion",
                     f"`{chain}` in device-scope `{fn.name}` — float64 on "
                     f"the card runs at a fraction of the float32 rate "
                     f"and widens every float it meets")
        elif isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute) and not node.args \
                    and not node.keywords:
                if func.attr in _SYNC_METHODS:
                    emit(node.lineno, "host-sync",
                         f"`.{func.attr}()` in device-scope `{fn.name}` — "
                         f"a copy to the host that waits for the card")
                elif func.attr == "double":
                    emit(node.lineno, "dtype-promotion",
                         f"`.double()` in device-scope `{fn.name}` — a "
                         f"float64 copy on the card")
            if _dotted(func) in ("torch.cuda.synchronize",
                                 "cuda.synchronize"):
                emit(node.lineno, "host-sync",
                     f"`torch.cuda.synchronize()` in device-scope "
                     f"`{fn.name}` — the host waits for the card")
            elif isinstance(func, ast.Name) \
                    and func.id in ("float", "int", "bool") \
                    and node.args and isinstance(node.args[0], ast.Name) \
                    and node.args[0].id in params:
                emit(node.lineno, "host-sync",
                     f"`{func.id}({node.args[0].id})` on a parameter in "
                     f"device-scope `{fn.name}` — a device sync when it "
                     f"is a tensor")
            for kw in node.keywords:
                if kw.arg == "dtype" and isinstance(kw.value, ast.Constant) \
                        and kw.value.value in ("float64", "double",
                                               "complex128"):
                    emit(node.lineno, "dtype-promotion",
                         f"explicit float64 dtype in device-scope "
                         f"`{fn.name}` — accidental float64 in a "
                         f"float32/bf16 path")


def lint_source(src: str, path: str = "<memory>") -> list[LintViolation]:
    """Lint one module's source. ``path`` scopes the per-module
    allowlists (deprecated-alias definers, sanctioned cache modules) and
    the device scope (see the module docstring)."""
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [LintViolation(path, e.lineno or 0, "syntax",
                              f"unparseable: {e.msg}")]
    lines = src.splitlines()
    norm = path.replace("\\", "/")
    out: list[LintViolation] = []

    def emit(line: int, rule: str, message: str) -> None:
        text = lines[line - 1] if 0 < line <= len(lines) else ""
        if f"# lint: {_PRAGMA.get(rule, 'ok')}" in text:
            return
        out.append(LintViolation(path, line, rule, message))

    # --- deprecated-api -------------------------------------------------
    stem = Path(norm).stem
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mod = (node.module or "").rsplit(".", 1)[-1]
            for alias in node.names:
                definer = _DEPRECATED.get(alias.name)
                if definer and mod == definer and stem != definer:
                    emit(node.lineno, "deprecated-api",
                         f"import of deprecated `{definer}."
                         f"{alias.name}` — use core.lowering")
        elif isinstance(node, ast.Attribute):
            definer = _DEPRECATED.get(node.attr)
            if definer and _dotted(node.value).rsplit(".", 1)[-1] \
                    == definer and stem != definer:
                emit(node.lineno, "deprecated-api",
                     f"use of deprecated `{definer}.{node.attr}` — "
                     f"use core.lowering")

    # --- frozen-mutation ------------------------------------------------
    if not norm.endswith(_FROZEN_ALLOW):
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) \
                    and _dotted(node.func) == "object.__setattr__":
                emit(node.lineno, "frozen-mutation",
                     "`object.__setattr__` outside the sanctioned cache"
                     " modules — frozen lowering contracts are "
                     "immutable")

    # --- host-sync, dtype-promotion -------------------------------------
    whole = any(m in norm for m in _DEVICE_MODULES)
    for fn in _device_functions(tree, whole):
        _scan_device_scope(fn, emit)
    return out


def lint_file(path: Path) -> list[LintViolation]:
    return lint_source(path.read_text(), str(path))


def _files(paths) -> list[Path]:
    out: list[Path] = []
    for root in paths:
        root = Path(root)
        out.extend(sorted(root.rglob("*.py")) if root.is_dir() else [root])
    return out


def lint_paths(paths) -> list[LintViolation]:
    out: list[LintViolation] = []
    for f in _files(paths):
        out.extend(lint_file(f))
    return out


def default_paths() -> list[Path]:
    """The port's tree: its package, its tests, ``chip_smoke.py`` and
    ``tools/``."""
    repo = Path(__file__).resolve().parents[3]
    return [repo / "src" / "repro_torch",
            *sorted((repo / "tests").glob("test_torch_*.py")),
            repo / "chip_smoke.py", repo / "tools"]


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="the port's AST lint (host-sync, frozen-mutation, "
                    "deprecated-api, dtype-promotion)")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories (default: the port's "
                         "package, tests, chip_smoke.py and tools/)")
    args = ap.parse_args(argv)
    paths = args.paths or default_paths()
    violations = lint_paths(paths)
    for v in violations:
        print(v)
    print(f"{len(violations)} violation(s) in {len(_files(paths))} files",
          file=sys.stderr)
    return 1 if violations else 0


if __name__ == "__main__":
    raise SystemExit(main())
