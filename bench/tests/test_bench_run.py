"""Whole runs of both cells at tiny widths on the CPU (the harness's look
for a card skipped): the reference agreeing with the port, the result
line's keys, and ``correct`` coming out false under each fault a
training cell can have and under the control."""

import contextlib
import io
import json

import pytest

import tiny
from harness import faults, main

CELLS = tiny.CELLS


def line_of(job) -> tuple[dict, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert main.report(main.execute(job)) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1]), \
        err.getvalue()


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_the_port(workload):
    """float32 on both sides: the reference's equations are the port's."""
    line, err = line_of(tiny.job(workload))
    assert line["correct"] is True
    for name, (gap, limit) in line["checks"].items():
        assert gap < 1e-4, (name, gap)
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [x.split()[1] for x in tail] == list(line["checks"])


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(workload, trace):
    line, _ = line_of(tiny.job(workload, trace=trace))
    keys = list(line)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[:5] == want
    assert keys[-1] == "checks"
    assert ("breakdown" in keys) == trace
    assert set(keys) == set(want) | {"checks"} | ({"breakdown"} if trace
                                                   else set())
    assert line["attempted"] >= 1 and line["failed"] == 0
    if trace:
        b = line["breakdown"]
        assert set(b) == {"device_ops", "idle_gaps"}
        assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
        assert "train_host_ms_per_step" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"}
        for m in line["metrics"].values():
            assert m["value"] > 0


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [faults.unchanged, faults.half_batch,
                                   faults.answer_altered])
def test_faults_are_not_correct(workload, fault):
    line, _ = line_of(tiny.job(workload, wrapper=fault))
    assert line["correct"] is False


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload, monkeypatch):
    """The reference on fp8 operands, put in the program's place."""
    runner = tiny.registry.module("runners", "train")
    real = runner.first_steps

    def control(job, step, state, pool, spec, sync):
        family = tiny.registry.module("reference", job.config["family"])
        return runner.reference_outputs(job, family, spec, pool, "fp8"), 0.0
    monkeypatch.setattr(runner, "first_steps", control)
    try:
        line, _ = line_of(tiny.job(workload))
    finally:
        monkeypatch.setattr(runner, "first_steps", real)
    assert line["correct"] is False
