"""BENCHMARK.json against the contract's static rules, and the harness
finding what a cell needs by name alone."""

import json
import re
import shutil

import pytest

from harness import registry

REPO = registry.BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return registry.benchmark(REPO)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
        assert (REPO / p).is_dir()
    assert len(bench["command"]) <= 32
    for word in bench["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in bench["paths"])


def test_names_units_and_one_line_fields(bench):
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [x["name"] for x in bench["configs"] + bench["workloads"]]
    names += [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("bench/") and (REPO / c["file"]).is_file()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for text in [c["why"] for c in bench["configs"]] + \
            [w["why"] for w in bench["workloads"]] + \
            [c["source"] for c in bench["configs"]] + \
            [m["layer"] for m in bench["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e


def test_configs_hold_the_catalog_numbers(bench):
    """Each configuration's file names its source and its cuts, and no
    cut is of a width."""
    widths = re.compile(r"(_size$|_dim$|_rank$|intermediate|latent|d_state|"
                        r"headdim|expand|experts_per_tok|kv_channels)")
    for c in bench["configs"]:
        cfg = registry.load_json(REPO / c["file"])
        assert cfg["source"] == c["source"]
        assert set(c["reduced"]) <= set(cfg["reduced"])
        for k in c["reduced"]:
            assert not widths.search(k), k
        assert c["name"] == cfg["name"]


def test_every_cell_resolves_by_name(bench):
    used = set()
    for w in bench["workloads"]:
        used.add(w["config"])
        cfg = registry.config_of(bench, REPO, w["config"])
        traffic = registry.data("traffic", w["traffic"])
        registry.module("runners", traffic["kind"])
        registry.module("reference", cfg["family"])
        limits = {k for k in registry.data("limits", w["name"])
                  if not k.startswith("_")}
        assert limits and limits <= {"loss_gap", "grad_gap",
                                     "grad_gap_median", "change_gap",
                                     "change_gap_median", "route_gap"}
        reported = registry.metrics_for(bench, w["name"], "per_layer")
        assert reported, w["name"]
        assert len(registry.metrics_for(bench, w["name"], "end_to_end")) >= 2
        for m in reported:
            assert callable(registry.module("metrics", m["name"]).read)
    assert used == {c["name"] for c in bench["configs"]}


def test_added_files_are_found_by_name(tmp_path):
    """A configuration, traffic mix, metric and kernel count dropped into
    their folders are found by name, with no file edited."""
    root = tmp_path / "bench"
    shutil.copytree(registry.BENCH, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "configs" / "new-model.json").write_text(json.dumps(
        {"name": "new-model", "family": "moe"}))
    (root / "traffic" / "train-b8-s4096.json").write_text(json.dumps(
        {"kind": "train", "batch": 8, "seq_len": 4096}))
    (root / "metrics" / "optimizer_ms.train.py").write_text(
        "def read(run):\n    return 1.5\n")
    (root / "roofline" / "adamw.py").write_text(
        "def work(call, dtype):\n    return 1.0, 2.0\n")
    assert "new-model" in registry.names("configs", ".json", root)
    assert registry.data("traffic", "train-b8-s4096", root)["batch"] == 8
    assert registry.module("metrics", "optimizer_ms.train", root).read(
        None) == 1.5
    assert registry.module("roofline", "adamw", root).work({}, "x") == \
        (1.0, 2.0)
    for p, data in before.items():
        assert p.read_bytes() == data
    with pytest.raises(FileNotFoundError):
        registry.module("metrics", "no_such_metric", root)


def test_run_seconds_fits_the_full_check(bench):
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
