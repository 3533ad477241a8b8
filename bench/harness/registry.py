"""Everything of one configuration, traffic mix, metric, kernel count,
reference family, runner or cell's limits is a file of its own, found
by its name in ``BENCHMARK.json`` or in another such file:

* ``configs/<config>.json``: the configuration (the cell's ``file``);
* ``traffic/<traffic>.json``: a traffic mix's parameters, whose ``kind``
  names its runner;
* ``runners/<kind>.py``: ``run(job)``;
* ``metrics/<metric>.py``: ``read(run)``, a per-layer metric's reader;
* ``roofline/<kernel>.py``: ``work(cfg, traffic)``, a kernel's FLOPs and
  bytes a step;
* ``reference/<family>.py``: the plain reference of a family;
* ``limits/<workload>.json``: the limits that decide ``correct``.

Adding one of these is adding a file; no file here lists them.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def module(kind: str, name: str, root: Path = BENCH):
    """The module ``root/kind/name.py``, loaded by path (names may hold
    dots); a missing file raises ``FileNotFoundError``."""
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    key = f"bench_{kind}_{name}".replace(".", "_").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    # a reference module imports its sibling layers.py by name
    sys.path.insert(0, str(path.parent))
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(path.parent))
    return mod


def data(kind: str, name: str, root: Path = BENCH) -> dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return load_json(path)


def names(kind: str, suffix: str, root: Path = BENCH) -> list[str]:
    """The names that ``root/kind`` holds files of."""
    return sorted(p.name[:-len(suffix)] for p in (root / kind).glob(
        f"*{suffix}") if not p.name.startswith("__"))


def benchmark(repo: Path) -> dict:
    return load_json(repo / "BENCHMARK.json")


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                   f"({', '.join(w['name'] for w in bench['workloads'])})")


def config_of(bench: dict, repo: Path, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(repo / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def metrics_for(bench: dict, workload: str, section: str) -> list[dict]:
    """The ``section`` ("end_to_end" or "per_layer") metrics that the
    cell reports: those that list it, or list no cells (a per-layer one
    only where it moves an end-to-end metric the cell reports)."""
    def listed(m):
        return workload in m.get("workloads", [workload])
    e2e = [m for m in bench["end_to_end"] if listed(m)]
    if section == "end_to_end":
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"] if listed(m)
            and m["moves"] in moved]
