"""The port's spans (``repro_torch.spans``): nothing recorded while no
profiler records; under ``torch.profiler`` each layer's span once for its
forward and once for its recomputation under remat full, and
``optim.adamw`` once a step; the same numbers whether a profiler records
or not. Torch alone, on the CPU."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import ARCHS, reduced
from repro_torch.models import ShardCtx, block_plan
from repro_torch.optim.adamw import OptConfig, apply_updates
from repro_torch.runtime.train_loop import (init_train_state, make_grad_fn,
                                            make_train_step)
from repro_torch.spans import launch, span

FAMILIES = ("deepseek-v2-lite-16b", "zamba2-7b")
OPT = OptConfig(lr=1e-2, warmup_steps=1, total_steps=4)
B, S = 2, 16


def tiny(name):
    return reduced(ARCHS[name]).replace(dtype="float32", remat="full")


def batches(cfg, n, seed=3):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg.vocab, (n, B, S + 1), generator=g)
    return [{"tokens": r[:, :-1].contiguous(),
             "labels": r[:, 1:].contiguous()} for r in ids]


def state_of(cfg, seed=0):
    return init_train_state(cfg, OPT, torch.Generator().manual_seed(seed))


def expected(cfg, steps):
    """{span: times entered} over ``steps`` train steps under remat
    full: each layer's span for the forward and the recomputation."""
    kinds = cfg.layer_kinds()
    attn = sum(what == "shared" for what, _ in block_plan(cfg)) \
        + sum(k != "ssm" for k in kinds)
    want = {"optim.adamw": steps,
            "model.attention": 2 * steps * attn,
            "model.moe": 2 * steps * sum(k.startswith("moe") for k in kinds),
            "model.mamba2": 2 * steps * kinds.count("ssm")}
    return {k: v for k, v in want.items() if v}


class Spy:
    """``torch.profiler.record_function`` counted by name."""

    def __init__(self, monkeypatch):
        self.names, real = [], torch.profiler.record_function

        def counted(name, *args, **kwargs):
            self.names.append(name)
            return real(name, *args, **kwargs)
        monkeypatch.setattr(torch.profiler, "record_function", counted)


@pytest.mark.parametrize("name", FAMILIES)
def test_no_record_function_without_a_profiler(name, monkeypatch):
    cfg = tiny(name)
    step = make_train_step(cfg, OPT, ShardCtx())
    state = state_of(cfg)
    spy = Spy(monkeypatch)
    for b in batches(cfg, 2):
        state, _ = step(state, b)
    assert spy.names == []
    with profile(activities=[ProfilerActivity.CPU]):
        with span("probe"):
            pass
    assert spy.names == ["probe"]


def test_span_without_a_profiler_is_one_shared_no_op():
    assert span("optim.adamw") is span("model.moe")
    with span("model.moe") as entered:
        assert entered is None


def test_launch_marks_an_operation_only_under_the_profiler():
    """``launch`` is the shared no-op without a profiler; under one it
    records a host operation of its name, not a span (a user
    annotation), so the kernels launched in it link to it."""
    assert launch("adamw.update") is span("optim.adamw")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("optim.adamw"):
            with launch("adamw.update"):
                pass
    kinds = {e.name(): e.is_user_annotation()
             for e in prof.profiler.kineto_results.events()}
    assert kinds == {"optim.adamw": True, "adamw.update": False}


@pytest.mark.parametrize("name", FAMILIES)
def test_spans_under_the_profiler(name):
    cfg = tiny(name)
    step = make_train_step(cfg, OPT, ShardCtx())
    state = state_of(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for b in batches(cfg, 2):
            state, _ = step(state, b)
    seen = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            seen[e.name()] = seen.get(e.name(), 0) + 1
    assert seen == expected(cfg, 2)


def two_steps(cfg, profiled: bool) -> dict:
    """Losses, gradient norms and learning rates, each step's gradients,
    and the parameters and moments after two steps from one seed, the
    steps under a CPU profiler or not."""
    grad_fn = make_grad_fn(cfg, ShardCtx())
    state = state_of(cfg)
    out = {"stats": [], "grads": []}

    def run():
        params, opt = state["params"], state["opt"]
        for b in batches(cfg, 2):
            grads, loss, _ = grad_fn(params, b)
            out["grads"].append({k: g.clone() for k, g in grads.items()})
            _, opt, stats = apply_updates(params, grads, opt, OPT)
            out["stats"] += [loss, stats["grad_norm"], stats["lr"]]
        out["params"] = {k: p.detach().clone()
                         for k, p in params.named_parameters()}
        out["m"], out["v"] = dict(opt["m"]), dict(opt["v"])
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            run()
    else:
        run()
    return out


def assert_same_bits(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same_bits(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same_bits(x, y)
    else:
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", FAMILIES)
def test_profiled_steps_are_bit_for_bit_the_unprofiled(name):
    cfg = tiny(name)
    off, on = two_steps(cfg, False), two_steps(cfg, True)
    assert_same_bits(off, on)
    assert len(off["grads"]) == 2 and off["grads"][0]
